from columbiaimagesearch_tpu_torch.store.kvindexer import KVIndexer
from columbiaimagesearch_tpu_torch.store.storer import (
    GenericStorer,
    LocalStorer,
    MemoryStorer,
    get_storer,
)
