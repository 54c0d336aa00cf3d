"""Distribution layer (port of `repro/parallel`): sharding rules, activation
constraints, remat policies, microbatching, the expert-parallel MoE
(`parallel.expert_parallel`) and the GPipe pipeline."""

from repro_torch.parallel.remat import remat_wrap
from repro_torch.parallel.sharding import (
    ShardingRules,
    default_rules,
    named_sharding_tree,
    resolve_pspec,
    resolve_tree,
)
from repro_torch.parallel.microbatch import accumulate_gradients
from repro_torch.parallel.pipeline import pipeline_apply

__all__ = [
    "ShardingRules",
    "accumulate_gradients",
    "default_rules",
    "named_sharding_tree",
    "pipeline_apply",
    "remat_wrap",
    "resolve_pspec",
    "resolve_tree",
]
