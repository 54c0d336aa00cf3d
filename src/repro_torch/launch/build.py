"""Sharding rules for one (arch × cell × mesh) (port of the rule part of
`repro/launch/build.py`).

The reference's `build_cell` assembles (step fn, abstract inputs,
shardings) for the dry-run, the tuner and sharded training; it and
`BuiltCell` come with ROADMAP Queue 1 item 17c.  `rules_for` is here now:
the expert-parallel MoE runs under the rules it gives.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs import ArchSpec, ShapeCell
from repro_torch.launch.mesh import data_axes, model_axis
from repro_torch.parallel.sharding import ShardingRules, default_rules

__all__ = ["rules_for"]


def rules_for(spec: ArchSpec, cell: ShapeCell, mesh, *,
              overrides: Optional[Dict] = None) -> ShardingRules:
    """Default rules for a cell: FSDP per exec config; sequence parallelism
    under ``seq_shard``; the hybrid family's KV caches on the data axes."""
    da = data_axes(mesh)
    rules = default_rules(
        data_axes=da,
        model_axis=model_axis(mesh) or "model",
        fsdp=spec.exec.fsdp,
    )
    if spec.exec.seq_shard:
        rules = rules.override(seq=model_axis(mesh) or "model")
    if spec.model.family == "hybrid":
        # The shared-attention site caches ride the layer scan's carry in
        # the reference; a model-axis-sharded carry made its partitioner
        # reshard every iteration.  Keep the hybrid cache on the data axes.
        rules = rules.override(cache_seq=da if len(da) > 1 else da[0])
    if overrides:
        rules = rules.override(**overrides)
    return rules
