"""ctypes bindings for the repository's native C++ host code, built with
g++ at first use into ``build/native/`` (port of
columbiaimagesearch_tpu/native/__init__.py): the image pipeline
(``native/imgpipe.cpp``, ``native/imgpipe.py``), the port's JPEG
coefficient reader (``native/csrc/jpegcoef.cpp``, bound in
``native/imgpipe.py``) and the persistent PQ-code store
(``native/codestore.cpp``, ``native/codestore.py``)."""
