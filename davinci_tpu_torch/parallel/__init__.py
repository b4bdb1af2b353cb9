from davinci_tpu_torch.parallel.mesh import (
    distributed_init,
    get_mesh,
    shard_batch,
)

__all__ = ["distributed_init", "get_mesh", "shard_batch"]
