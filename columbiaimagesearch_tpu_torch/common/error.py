"""Copy of columbiaimagesearch_tpu/common/error.py.

Error reporting helper (reference: cufacesearch/common/error.py:1-14)."""

import sys
import traceback


def full_trace_error(msg):
    print(msg, file=sys.stderr)
    traceback.print_exc(file=sys.stderr)
    sys.stderr.flush()
