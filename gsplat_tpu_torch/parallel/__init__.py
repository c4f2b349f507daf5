from gsplat_tpu_torch.parallel.sharding import (
    make_mesh,
    shard_params,
    sharded_render,
    sharded_train_step,
)
