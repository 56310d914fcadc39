"""The reference's LOPQ model schema (``lopq_model.proto``, package
com.flickr.vision.lopq) and its generated module, copied from
columbiaimagesearch_tpu/index/protos/. Imported only by
``index/proto.py``, and only when a proto file is read or written: it
needs the ``protobuf`` package."""
