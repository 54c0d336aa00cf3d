"""Assemble (step fn, abstract inputs, shardings) for any (arch × cell × mesh)
(port of `repro/launch/build.py`).

This is the single place where model specs, shape cells, sharding rules and
step factories meet; the dry-run, the tuner and sharded training
(``train --mesh``) all call `build_cell`.

The reference's abstract inputs are `jax.ShapeDtypeStruct`s, and
``lower(mesh).compile()`` hands the step to XLA's SPMD partitioner.  Here
each abstract input is a `DTensor` of the placements its resolved spec
gives (`parallel.sharding.named_sharding_tree`), its local shard a tensor
on the ``meta`` device (`parallel.spmd.abstract_tree`): a kimi-k2 state of
1.04 T parameters is built without allocating a byte.  `BuiltCell.lower`
runs the step once on them as rank 0 of the mesh under a
`launch.hlo_analysis.StepCounter`, which stands in for the compiled
program's ``memory_analysis()`` and for the cost analysis of its HLO.

The port trains on per-layer tensors (`Model.params_tree`), while the
specs are stacked: each layer's tensor takes its stack's spec without the
layer axis (`train_state_specs(per_layer=True)`); Adafactor's state stays
stacked, as the port holds it.  The step runs under the activation
constraints (`activation_sharding`) and `parallel.spmd.spmd_region`.

The trace takes the route of the device its mesh describes: on a mesh of
the card, a config whose attention is ``"auto"`` is traced with
``"pallas"`` where the cell's sequence is a multiple of 128, as
`models.layers._use_flash` routes it on the card, so that the flash and
SSD kernels give their outputs through their shape functions.

On the multi-pod mesh a cell traces over `launch.mesh.flat_view`, "pod" and
"data" merged into one dimension of 32, where every resolved spec of its
inputs (parameters, optimizer state, batch, cache) names them together
(`traced_mesh`): each tensor is laid out as on the 3-D mesh, and DTensor
plans over two mesh dimensions instead of three.  A cell whose specs name
one without the other stays on the 3-D mesh.  The rules and specs are the
same either way; `BuiltCell.mesh_flattened` says which mesh the step runs
on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.configs import ArchSpec, ShapeCell, input_specs
from repro_torch.configs.base import ExecConfig
from repro_torch.launch.hlo_analysis import HloCost, StepMemory, analyze_step
from repro_torch.launch.mesh import data_axes, flat_view, model_axis
from repro_torch.models.model import Model
from repro_torch.models.spec import flatten as tree_leaves, tree_map
from repro_torch.parallel import spmd
from repro_torch.parallel.constraints import activation_sharding
from repro_torch.parallel.sharding import (PartitionSpec, ShardingRules, default_rules,
                                           mesh_axis_size, named_sharding_tree, placements,
                                           resolve_tree)
from repro_torch.runtime.steps import make_serve_steps, make_train_step, train_state_specs

__all__ = ["BuiltCell", "Compiled", "build_cell", "rules_for", "traced_mesh"]


@dataclasses.dataclass
class Compiled:
    """One traced step (the counterpart of XLA's compiled executable):
    `memory_analysis` and `cost_analysis` of this rank, the kernels' calls
    by name, the ops run replicated for want of a sharding strategy (op →
    bytes gathered) and the trace's wall time."""

    memory: StepMemory
    cost: HloCost
    kernel_calls: Dict[str, int]
    replicated: Dict[str, float]
    seconds: float

    def compile(self) -> "Compiled":
        """The trace is the compile: returns itself."""
        return self

    def memory_analysis(self) -> StepMemory:
        return self.memory

    def cost_analysis(self) -> HloCost:
        return self.cost


@dataclasses.dataclass
class BuiltCell:
    """Everything needed to trace/run one (arch × cell × mesh)."""

    step_fn: Callable
    abstract_args: Tuple[Any, ...]  # DTensors on meta shards, step_fn(*args)
    in_shardings: Tuple[Any, ...]  # placements trees (None: a host value)
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    kind: str
    mesh: Any = None  # the mesh the abstract inputs live on
    mesh_flattened: bool = False  # ("pod", "data") merged (`launch.mesh.flat_view`)

    def lower(self, mesh=None) -> Compiled:
        """Run the step once on the abstract inputs, as rank 0 of their mesh,
        counting its ops and memory (`hlo_analysis.analyze_step`)."""
        spmd.REPLICATED.clear()
        t0 = time.time()
        _, cost, mem, calls = analyze_step(self.step_fn, *self.abstract_args)
        return Compiled(mem, cost, dict(calls), dict(spmd.REPLICATED), time.time() - t0)


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


def _batch_pspec_tree(batch_specs: Dict[str, Any], rules: ShardingRules, mesh):
    """Activation inputs shard on the batch dim only."""
    batch_axes = rules.get("batch")

    def pspec(leaf) -> PartitionSpec:
        entry = batch_axes
        if entry is None:
            return PartitionSpec()
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        size = 1
        kept = []
        for a in axes:
            asize = mesh_axis_size(mesh, a)
            if leaf.shape and leaf.shape[0] % (size * asize) == 0:
                kept.append(a)
                size *= asize
            else:
                break
        if not kept:
            return PartitionSpec()
        first = kept[0] if len(kept) == 1 else tuple(kept)
        return PartitionSpec(*([first] + [None] * (len(leaf.shape) - 1)))

    return tree_map(pspec, batch_specs)


def _batch_shardings(batch_specs: Dict[str, Any], rules: ShardingRules, mesh) -> Dict[str, Any]:
    """The placements of each batch input (`_batch_pspec_tree` over ``mesh``)."""
    return {k: placements(ps, mesh, k)
            for k, ps in _batch_pspec_tree(batch_specs, rules, mesh).items()}


def _traced_config(spec: ArchSpec, cell: ShapeCell, mesh) -> ArchSpec:
    """The config the trace runs: on a mesh of the card, attention "auto"
    becomes "pallas" where the card takes the flash kernel (see the module
    docstring)."""
    cfg = spec.model
    if mesh.device_type == "cuda" and cfg.attention_impl == "auto" and cell.seq_len % 128 == 0:
        return dataclasses.replace(spec, model=cfg.replace(attention_impl="pallas"))
    return spec


def traced_mesh(mesh, pspecs: Any, flatten: bool = True):
    """(the mesh a step traces on, whether it merges "pod" and "data"): the
    mesh's `flat_view` where it has both axes as dimensions of their own and
    every `PartitionSpec` of ``pspecs`` (a tree) lays out on that view, so
    names them together, in order; else ``mesh``."""
    if not flatten:
        return mesh, False
    try:
        flat = flat_view(mesh)
        for ps in tree_leaves(pspecs):
            if isinstance(ps, PartitionSpec):
                placements(ps, flat)
    except ValueError:
        return mesh, False
    return flat, True


def build_cell(
    spec: ArchSpec,
    cell: ShapeCell,
    mesh,
    *,
    rules: Optional[ShardingRules] = None,
    exec_override: Optional[ExecConfig] = None,
    flatten: bool = True,
) -> BuiltCell:
    """The cell's step and abstract inputs over ``mesh``, or over its
    `flat_view` where the cell's specs allow it and ``flatten`` (see the
    module docstring)."""
    exec_cfg = exec_override or spec.exec
    rules = rules or rules_for(spec, cell, mesh)
    cfg = _traced_config(spec, cell, mesh).model
    model = Model(cfg, device="meta")  # its steps take their parameters as arguments
    specs = input_specs(cfg, cell)
    if cell.kind == "train":
        held = train_state_specs(model, exec_cfg, per_layer=True)  # params and optimizer
        batch = specs["batch"]
    else:
        held = {"params": model.param_specs(stacked=False),
                "cache": model.cache_specs(cell.global_batch, cell.seq_len)}
        batch = specs["batch"] if cell.kind == "prefill" else {"tokens": specs["tokens"]}
    mesh, merged = traced_mesh(
        mesh, (resolve_tree(held, rules, mesh), _batch_pspec_tree(batch, rules, mesh)), flatten)
    held_sh = named_sharding_tree(held, rules, mesh)
    batch_sh = _batch_shardings(batch, rules, mesh)

    def constrained(fn):
        """Run the step under the activation-sharding context."""

        def wrapped(*args):
            with activation_sharding(rules, mesh), spmd.spmd_region():
                return fn(*args)

        return wrapped

    def replicated_metrics(fn):
        """The training step with its metrics reduced to replicated scalars
        (plain tensors, the same on every rank)."""

        def wrapped(state, batch):
            state, metrics = fn(state, batch)
            return state, {k: spmd.replicated(v) for k, v in metrics.items()}

        return wrapped

    def abstract(specs_tree, shardings):
        return spmd.abstract_tree(specs_tree, shardings, mesh)

    on_mesh = dict(mesh=mesh, mesh_flattened=merged)
    if cell.kind == "train":
        return BuiltCell(
            step_fn=replicated_metrics(constrained(make_train_step(model, exec_cfg))),
            abstract_args=(abstract(held, held_sh), abstract(batch, batch_sh)),
            in_shardings=(held_sh, batch_sh),
            # state keeps its shardings; metrics are replicated scalars
            out_shardings=(held_sh, None),
            donate_argnums=(0,),
            kind="train",
            **on_mesh,
        )

    prefill_step, decode_step = make_serve_steps(model)
    params_sh, cache_sh = held_sh["params"], held_sh["cache"]
    abstract_params = abstract(held["params"], params_sh)
    abstract_cache = abstract(held["cache"], cache_sh)

    if cell.kind == "prefill":
        return BuiltCell(
            step_fn=constrained(prefill_step),
            abstract_args=(abstract_params, abstract(batch, batch_sh), abstract_cache),
            in_shardings=(params_sh, batch_sh, cache_sh),
            out_shardings=(None, cache_sh),
            donate_argnums=(2,),
            kind="prefill",
            **on_mesh,
        )

    # decode: one new token at the cache's last position
    tokens_sh = batch_sh["tokens"]
    return BuiltCell(
        step_fn=constrained(decode_step),
        abstract_args=(abstract_params, abstract_cache,
                       abstract(batch, batch_sh)["tokens"], cell.seq_len - 1),
        in_shardings=(params_sh, cache_sh, tokens_sh, None),
        out_shardings=(None, cache_sh),
        donate_argnums=(1,),
        kind="decode",
        **on_mesh,
    )
