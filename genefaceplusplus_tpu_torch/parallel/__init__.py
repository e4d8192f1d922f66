from genefaceplusplus_tpu_torch.parallel.mesh import (
    RAY_AXIS,
    Mesh,
    broadcast,
    init_distributed,
    make_mesh,
    map_blocks,
    pad_to_multiple,
    replicated,
    shard_rays,
)

__all__ = ["RAY_AXIS", "Mesh", "broadcast", "init_distributed", "make_mesh", "map_blocks", "pad_to_multiple", "replicated",
           "shard_rays"]
