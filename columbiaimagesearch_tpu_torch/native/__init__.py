"""ctypes bindings for the repository's native C++ image pipeline
(``native/imgpipe.cpp``), built with g++ at first use into
``build/native/`` (port of columbiaimagesearch_tpu/native/__init__.py)."""
