"""Distributed serving of the port: the sharding rules and activation
policy of ``repro.distributed``, and the tensor-parallel executor that
takes GSPMD's place (``tp``)."""
from repro_torch.distributed import policy
from repro_torch.distributed.sharding import (P, ShardingDegraded,
                                              batch_spec, cache_shardings,
                                              decode_state_shardings,
                                              gather_tree, input_shardings,
                                              mesh_axes, param_shardings,
                                              shard_tree,
                                              should_shard_fsdp_serving)

__all__ = ["P", "ShardingDegraded", "batch_spec", "cache_shardings",
           "decode_state_shardings", "gather_tree", "input_shardings",
           "mesh_axes", "param_shardings", "policy", "shard_tree",
           "should_shard_fsdp_serving"]
