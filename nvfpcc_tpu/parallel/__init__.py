"""Block-data-parallel sharding over a device mesh (SURVEY §2.4)."""

from nvfpcc_tpu.parallel.mesh import (  # noqa: F401
    BLOCK_AXIS,
    block_sharding,
    make_mesh,
    pad_blocks,
    padded_block_count,
    replicate,
    replicated_sharding,
    shard_block_tree,
    shard_train_arrays,
)
