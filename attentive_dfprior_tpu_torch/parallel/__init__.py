from attentive_dfprior_tpu_torch.parallel.sharding import (  # noqa: F401
    AgentGroups,
    RayShards,
    init_distributed,
    mesh_from_config,
    ray_block,
    replicate,
    shared_groups,
    sharded_mapping_step,
    split_counts,
    split_groups_from_config,
)
