"""Explicit expert parallelism (port of `repro/parallel/expert_parallel.py`).

The reference writes the MoE's communication by hand in a `shard_map`
rather than leave it to its partitioner:

  * tokens are sharded over the data axes and REPLICATED over "model";
  * experts are sharded over "model" — each model shard owns E/TP experts;
  * every device routes its local tokens, keeps the (token, k)-pairs that
    hit its own experts, runs the local expert GEMMs, and contributes a
    partial combine;
  * ONE ``psum`` over "model" completes the combine.

Capacity applies per data shard: C_local = max(ceil(n_local·k·cf/E), k).

Here each rank of the mesh is a process (`torch.distributed`), and the
execution is the twin of `shard_map` over replicated global arrays: every
rank receives the full ``x`` and the full parameters (a replicated
`DTensor` is read with ``to_local()``), takes its batch slice over the
kept batch axes and its E/TP experts, routes with `layers.moe_route` (f32
router products, softmax, a stable top-k), ranks the pairs that hit its
experts k-major, runs `layers.moe_experts`, all-reduces the float32
partial combine over the model axis and rounds it once to the compute
dtype, takes the mean of ``aux`` over the batch axes and all-gathers the
batch slices: the full (b, t, d) output on every rank.  Under FSDP the
reference gathers each expert's embed shards inside its body; here every
rank holds the whole weight already.  At TP = 1 and one data shard no
collective runs, and the route is `moe_apply`'s local one, bit for bit.

Gradients: the loss downstream is computed identically on every rank, so
the output's cotangent is replicated.  The collectives are autograd
Functions whose backward is `shard_map`'s transpose on such cotangents:
the output all-gather's is this rank's slice, the model all-reduce's the
identity, the batch mean's a scale by 1/(data shards · TP) (the TP ranks of
a data shard compute the same ``aux``).  Each rank's backward then holds
its part of the gradients of ``x`` and of the parameters (its tokens, its
experts), and `_Enter`'s backward sums the parts (x: over the model axis,
then gathered over the batch axes; the router: over every axis; the
experts: over the batch axes, then gathered over the model axis), so every
rank ends with the full single-device gradients.

Inside a step over DTensors (`launch.build`: sharded inputs and
parameters) the same body runs on each rank's local shards, and the
combine, the mean of ``aux`` and the gradients reduce as DTensors
(`_moe_dtensor`).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import moe_experts, moe_route
from repro_torch.parallel.constraints import current_context
from repro_torch.parallel.sharding import mesh_axis_names, mesh_axis_size, mesh_dims

__all__ = ["moe_shard_map_available", "moe_apply_shard_map"]


def _axes_tuple(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def moe_shard_map_available(cfg: ModelConfig, x_shape) -> bool:
    """Expert-parallel path is usable when a context with a model axis is
    active and the expert count divides over it."""
    ctx = current_context()
    if ctx is None or cfg.moe is None:
        return False
    rules, mesh = ctx
    maxis = rules.get("experts")
    if maxis is None or not isinstance(maxis, str) or maxis not in mesh_axis_names(mesh):
        return False
    return cfg.moe.num_experts % mesh_axis_size(mesh, maxis) == 0


class _Layout:
    """This rank's share: its batch slice ``rows`` and experts ``experts``,
    and the process groups of the axes it communicates over."""

    def __init__(self, mesh, batch_axes: Tuple[str, ...], maxis: str, b: int, e: int):
        (mdim,) = mesh_dims(mesh, (maxis,), "experts")
        bdims = mesh_dims(mesh, batch_axes, "tokens") if batch_axes else ()
        self.tp = mesh.size(mdim)
        self.model = mesh.get_group(mdim) if self.tp > 1 else None
        self.batch = [(mesh.get_group(m), mesh.size(m)) for m in bdims]
        self.shards = 1
        index = 0
        for m in bdims:  # row-major over the batch dims, as a tuple spec entry
            index = index * mesh.size(m) + mesh.get_local_rank(m)
            self.shards *= mesh.size(m)
        per = b // self.shards
        self.rows = slice(index * per, (index + 1) * per)
        e_local = e // self.tp
        first = mesh.get_local_rank(mdim) * e_local
        self.experts = slice(first, first + e_local)

    def all_reduce(self, t: torch.Tensor, model: bool = True, batch: bool = True) -> torch.Tensor:
        if model and self.model is not None:
            dist.all_reduce(t, group=self.model)
        if batch:
            for group, n in self.batch:
                if n > 1:
                    dist.all_reduce(t, group=group)
        return t

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The batch slices of every shard, in order, along dim 0."""
        for group, n in reversed(self.batch):  # the minor axis first
            if n > 1:
                parts = [torch.empty_like(t) for _ in range(n)]
                dist.all_gather(parts, t.contiguous(), group=group)
                t = torch.cat(parts, 0)
        return t

    def gather_experts(self, t: torch.Tensor) -> torch.Tensor:
        if self.model is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.tp)]
        dist.all_gather(parts, t.contiguous(), group=self.model)
        return torch.cat(parts, 0)


class _Enter(torch.autograd.Function):
    """(x, router, wi_gate, wi_up, wo) → this rank's batch slice of x, the
    router, and its experts' weights; the backward sums every rank's part
    of the gradients into the full ones (module docstring)."""

    @staticmethod
    def forward(ctx, lay: _Layout, x, router, wi_gate, wi_up, wo):
        ctx.lay, ctx.shape = lay, x.shape
        e = lay.experts
        return x[lay.rows], router.view_as(router), wi_gate[e], wi_up[e], wo[e]

    @staticmethod
    def backward(ctx, gx, grouter, *gw):
        lay, need = ctx.lay, ctx.needs_input_grad
        out = [None, None, None, None, None, None]
        if need[1]:
            out[1] = lay.gather_rows(lay.all_reduce(gx.contiguous(), batch=False))
        if need[2]:
            out[2] = lay.all_reduce(grouter.contiguous())
        for i, g in enumerate(gw, start=3):
            if need[i]:
                out[i] = lay.gather_experts(lay.all_reduce(g.contiguous(), model=False))
        return tuple(out)


class _Combine(torch.autograd.Function):
    """The partial combine summed over the model axis (the reference's
    ``psum``); the cotangent is replicated, so the backward is the identity."""

    @staticmethod
    def forward(ctx, lay: _Layout, y):
        return lay.all_reduce(y.clone(), batch=False)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _GatherRows(torch.autograd.Function):
    """All-gather of the batch slices; backward: this rank's slice."""

    @staticmethod
    def forward(ctx, lay: _Layout, y):
        ctx.lay = lay
        return lay.gather_rows(y)

    @staticmethod
    def backward(ctx, g):
        return None, g[ctx.lay.rows]


class _MeanAux(torch.autograd.Function):
    """``aux`` averaged over the batch axes (the reference's ``pmean``);
    backward: 1/(data shards · TP) of the cotangent, since the TP ranks of
    a data shard compute the same ``aux`` and their gradients are summed."""

    @staticmethod
    def forward(ctx, lay: _Layout, aux):
        ctx.scale = 1.0 / (lay.shards * lay.tp)
        if lay.shards == 1:
            return aux.clone()
        return lay.all_reduce(aux.clone(), model=False) / lay.shards

    @staticmethod
    def backward(ctx, g):
        return None, g * ctx.scale


def _local(t: torch.Tensor) -> torch.Tensor:
    """A replicated DTensor's full value; a plain tensor as it is."""
    if isinstance(t, DTensor):
        if not all(isinstance(pl, Replicate) for pl in t.placements):
            raise ValueError(f"the expert-parallel MoE takes replicated inputs, got "
                             f"placements {t.placements}")
        return t.to_local()
    return t


def _kept_batch_axes(rules, mesh, b: int) -> Tuple[str, ...]:
    """The batch axes the tokens shard over: a prefix whose product divides b."""
    names = mesh_axis_names(mesh)
    batch_axes = [a for a in _axes_tuple(rules.get("batch"))
                  if a in names and b % mesh_axis_size(mesh, a) == 0]
    keep, size = [], 1
    for a in batch_axes:
        if b % (size * mesh_axis_size(mesh, a)) == 0:
            keep.append(a)
            size *= mesh_axis_size(mesh, a)
    return tuple(keep)


def _local_moe(router, wg, wu, wo, cfg: ModelConfig, x_l: torch.Tensor, first: int,
               e_local: int):
    """The shard_map body on this rank's tokens and experts: the float32
    partial combine (nb·t, d) and this shard's ``aux``."""
    nb, t, d = x_l.shape
    xf = x_l.reshape(nb * t, d)
    r = moe_route(router, cfg.moe, xf)  # capacity from this shard's nb·t tokens
    cap = r["capacity"]
    flat_ids = r["expert_ids"].T.reshape(-1)  # (k*n,) k-major
    mine = r["keep"] & (flat_ids >= first) & (flat_ids < first + e_local)
    slot = torch.where(mine, r["slot"] - first * cap, torch.full_like(r["slot"], e_local * cap))
    return moe_experts(wg, wu, wo, cfg, xf, r, mine, slot), r["aux"]


def _moe_dtensor(p: Dict[str, Any], cfg: ModelConfig, x: DTensor, rules, mesh):
    """The same body over DTensors (a step built by `launch.build`): x is laid
    out over the kept batch axes and replicated over "model", the router
    whole, the experts split over "model"; each rank runs the body on its
    local shards, and the partial combine (Partial over "model") and the
    batch mean of ``aux`` (Partial over the batch axes) reduce as DTensors.
    The local views' gradients are partial sums over the axes whose ranks
    hold other tokens or other experts (``grad_placements``), which
    DTensor's backward reduces: the reference's ``shard_map`` transpose."""
    (mdim,) = mesh_dims(mesh, (rules.get("experts"),), "experts")
    kept = _kept_batch_axes(rules, mesh, x.shape[0])
    bdims = list(mesh_dims(mesh, kept, "tokens")) if kept else []
    shards = 1
    for m in bdims:
        shards *= mesh.size(m)

    def layout(batch=None, model=None, partial=()):
        pl = [Replicate()] * mesh.ndim
        for m in bdims:
            pl[m] = batch or Replicate()
        if model is not None:
            pl[mdim] = model
        for m in partial:
            pl[m] = Partial()
        return tuple(pl)

    def local(t, pl, grad_pl):
        return t.redistribute(mesh, pl).to_local(grad_placements=grad_pl)

    x_pl = layout(batch=Shard(0))
    x_l = local(x, x_pl, layout(batch=Shard(0), partial=(mdim,)))
    router = local(p["router"], layout(), layout(partial=bdims + [mdim]))
    w_pl = layout(model=Shard(0))
    wg, wu, wo = (local(p[n], w_pl, layout(model=Shard(0), partial=bdims))
                  for n in ("wi_gate", "wi_up", "wo"))
    e_local = cfg.moe.num_experts // mesh.size(mdim)
    first = mesh.get_local_rank(mdim) * e_local
    y, aux = _local_moe(router, wg, wu, wo, cfg, x_l, first, e_local)
    y = DTensor.from_local(y.reshape(x_l.shape), mesh, layout(batch=Shard(0), model=Partial()),
                           run_check=False)
    y = y.redistribute(mesh, x_pl).to(cfg.cdtype)
    aux = DTensor.from_local(aux / shards, mesh, layout(partial=bdims), run_check=False)
    return y, aux.redistribute(mesh, layout())


def moe_apply_shard_map(p: Dict[str, Any], cfg: ModelConfig,
                        x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in replacement for the local moe dispatch (experts/router only —
    the shared expert and the dense residual are added by the caller)."""
    rules, mesh = current_context()
    if isinstance(x, DTensor) and not all(isinstance(pl, Replicate) for pl in x.placements):
        return _moe_dtensor(p, cfg, x, rules, mesh)
    moe = cfg.moe
    x = _local(x)
    b, t, d = x.shape
    e, k = moe.num_experts, moe.top_k
    maxis = rules.get("experts")  # "model"
    keep = _kept_batch_axes(rules, mesh, b)
    lay = _Layout(mesh, tuple(keep), maxis, b, e)

    x_l, router, wg, wu, wo = _Enter.apply(
        lay, x, *(_local(p[n]) for n in ("router", "wi_gate", "wi_up", "wo")))
    nb = x_l.shape[0]
    xf = x_l.reshape(nb * t, d)
    r = moe_route(router, moe, xf)  # capacity from this shard's nb·t tokens
    cap, first = r["capacity"], lay.experts.start
    flat_ids = r["expert_ids"].T.reshape(-1)  # (k*n,) k-major
    mine = r["keep"] & (flat_ids >= first) & (flat_ids < lay.experts.stop)
    e_local = lay.experts.stop - first
    slot = torch.where(mine, r["slot"] - first * cap, torch.full_like(r["slot"], e_local * cap))
    y = moe_experts(wg, wu, wo, cfg, xf, r, mine, slot)  # float32 partial combine
    y = _Combine.apply(lay, y).to(cfg.cdtype).reshape(nb, t, d)
    return _GatherRows.apply(lay, y), _MeanAux.apply(lay, r["aux"])
