from repro_torch.distributed.sharding import (P, PartitionSpec,
                                              ShardingPolicy, batch_specs,
                                              cache_specs_tree, local_zeros,
                                              make_param_specs, make_policy,
                                              shard_params, spec_bytes)

__all__ = ["P", "PartitionSpec", "ShardingPolicy", "batch_specs",
           "cache_specs_tree", "local_zeros", "make_param_specs",
           "make_policy", "shard_params", "spec_bytes"]
