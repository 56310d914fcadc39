"""Write a component conf JSON from environment variables (copy of
scripts/generate_conf.py:1-58, with the port's generators).

The reference generates per-component confs from docker env vars at
container start (reference: setup/ConfGenerator/create_conf_{ingester,
extractor,searcher}.py, invoked from setup/all-in-one/*.yml service
commands). The compose services in setup/ run this step before exec'ing
their role script.

Usage:
    python -m columbiaimagesearch_tpu_torch.common.generate_conf \\
        <searcher|extractor|ingester> [...] [-o OUT]

Several roles merge into one conf, in the order given; the default path is
``conf/generated/conf_<roles>.json``. The conf content comes from the
port's ``common/factory.py`` ``generate_conf_*``. Writing a conf computes
nothing, so this entry point needs no card (an ingester's container may
have none) and has no ``--cpu``, as the JAX script has none.
"""

import argparse
import json
import os
import sys

from columbiaimagesearch_tpu_torch.common.factory import (
    generate_conf_extractor,
    generate_conf_ingester,
    generate_conf_searcher,
)

GENERATORS = {"searcher": generate_conf_searcher,
              "extractor": generate_conf_extractor,
              "ingester": generate_conf_ingester}


def main(argv=None):
    """Write the conf of the roles in ``argv``; returns its path."""
    ap = argparse.ArgumentParser()
    ap.add_argument("roles", nargs="+",
                    choices=["searcher", "extractor", "ingester"],
                    help="one or more roles; multiple roles merge into "
                         "one conf (e.g. 'extractor ingester' for a "
                         "processor that consumes a broker)")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default: conf/generated/"
                         "conf_<roles>.json)")
    args = ap.parse_args(argv)

    conf = {}
    for role in args.roles:
        conf.update(GENERATORS[role]())
    out = args.out or os.path.join("conf", "generated",
                                   f"conf_{'_'.join(args.roles)}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(conf, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"wrote {out} ({len(conf)} keys)", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
