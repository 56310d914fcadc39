"""Copy of columbiaimagesearch_tpu/common/conf_reader.py:1-46.

Prefix-keyed flat-JSON configuration reader.

Same contract as the reference's ConfReader
(reference: cufacesearch/common/conf_reader.py:4-78): a flat JSON dict (or
file) in which every component reads its keys through a string prefix
(``SEARCHLOPQ_``, ``KVI_``, ...), with ``get_param``/``get_required_param``
and the ``set_pp`` pretty-print-name convention.
"""

import json


class ConfReader:
    def __init__(self, global_conf_in, prefix=""):
        self.pp = None
        self.set_pp()
        self.verbose = 0
        if isinstance(global_conf_in, dict):
            self.global_conf = global_conf_in
        else:
            with open(global_conf_in, "rt") as f:
                self.global_conf = json.load(f)
        self.prefix = prefix
        self.read_conf()

    def set_pp(self, pp=None):
        self.pp = pp if pp else type(self).__name__

    def read_conf(self):
        verbose = self.get_param("verbose")
        if verbose:
            self.verbose = int(verbose)

    def get_param(self, param, default=None):
        key = self.prefix + param
        if key in self.global_conf:
            return self.global_conf[key]
        return default

    def get_required_param(self, param):
        value = self.get_param(param)
        if value is None:
            msg = (f"[{self.pp}.get_required_param: error] {self.prefix}{param}"
                   " not defined in configuration")
            raise ValueError(msg)
        return value
