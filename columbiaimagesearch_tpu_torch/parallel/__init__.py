from columbiaimagesearch_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SHARD_AXIS,
    Mesh,
    make_mesh,
    shard_rows,
)
from columbiaimagesearch_tpu_torch.parallel.sharded import (
    ShardedLOPQIndex,
    ShardedLOPQSearcher,
    dp_encode,
    dp_lloyd_step,
)
