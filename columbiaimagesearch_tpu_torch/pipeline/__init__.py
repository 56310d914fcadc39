"""The ingest pipeline (port of columbiaimagesearch_tpu/pipeline/): image
messages -> checker -> updates -> processor -> feature columns in the
KV store. Exports as columbiaimagesearch_tpu/pipeline/__init__.py:1-10."""

from columbiaimagesearch_tpu_torch.pipeline.ingest import (
    GenericIngester,
    GenericPusher,
    LocalDirIngester,
    MemoryBus,
    MemoryBusIngester,
    MemoryBusPusher,
)
from columbiaimagesearch_tpu_torch.pipeline.checker import ExtractionChecker
from columbiaimagesearch_tpu_torch.pipeline.processor import ExtractionProcessor
