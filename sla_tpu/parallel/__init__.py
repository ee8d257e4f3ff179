from .sharding import (  # noqa: F401
    BLOCK_AXIS,
    CHANNEL_AXIS,
    batch_sharding,
    make_mesh,
    shard_batch,
    sharded_decode_step,
    sharded_encode_stage1,
    sharded_encode_stage2,
    sharded_encode_step,
)
