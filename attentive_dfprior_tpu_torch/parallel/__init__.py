from attentive_dfprior_tpu_torch.parallel.sharding import (  # noqa: F401
    RayShards,
    init_distributed,
    mesh_from_config,
    ray_block,
    replicate,
    sharded_mapping_step,
)
