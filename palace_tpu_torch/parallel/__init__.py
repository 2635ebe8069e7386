from palace_tpu_torch.parallel.mesh import (
    best_mesh_shape,
    data_sharding,
    make_mesh,
    replicate,
    shard_params_for_gcn,
)
