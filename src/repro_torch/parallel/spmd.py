"""Running a step on DTensors: the port's counterpart of the reference's
``jax.jit(step, in_shardings=..., out_shardings=...)``.

The reference hands XLA a step and the shardings of its inputs, and the SPMD
partitioner writes the per-device program.  Here each input is a
`DTensor` whose local shard lives on this rank, and DTensor's sharding
propagation runs each op on the shards, inserting the collectives it needs.
The pieces:

  * `local_shape` and `abstract_tree`: the shard of a `TensorSpec` on this
    rank, as a `DTensor` whose local tensor is on the ``meta`` device (shape
    and dtype, no allocation), so a step over a 1-trillion-parameter model
    can run for its shapes, costs and memory (`launch.build`);
  * `distribute_tree`: real tensors distributed with a placements tree;
  * `spmd_region`: what a step runs under: plain tensors made inside the
    step (positions, masks, constants) count as replicated, and an op for
    which DTensor has no sharding strategy runs on gathered (replicated)
    inputs, each such site recorded with the bytes gathered (`REPLICATED`);
  * `gathered`: a parameter tree whose DTensors are gathered over the data
    axes (their FSDP shards) each time the model reads one, as ZeRO-3
    gathers a layer's weights for its use only; the gradient comes back
    through the gather's backward as a reduce-scatter onto the shards;
  * `logsumexp_last` and `pick_last`: the loss's two reductions over a
    vocab-sharded last dimension without gathering the logits;
  * `query_blocks`: an attention in plain torch (dense or chunked) on this
    rank's block of queries, the keys and values whole along the sequence;
  * `cache_write` and `cache_shards`: new keys and values written into this
    rank's slice of a KV cache's length, and an attention over the cache on
    that slice, the softmax combined across the slices by all-reduces;
  * `project`: an activation × weight einsum on this rank's shards, so no
    view inside it merges two split dimensions (a batch- and sequence-split
    activation's (B, T, D) → (B·T, D)), whatever DTensor's version can
    shard, and a batch-1 product's contraction split over a mesh dim that
    splits neither operand;
  * `redistribute`: DTensor's redistribution, but for a shard moved from one
    tensor dimension to another, which runs as an all-to-all of the port's
    own on every mesh (on a CPU mesh DTensor gathers the whole tensor);
  * `sharded_call`: a kernel's call on its local shards, the inputs laid out
    over the dimensions the kernel may split (batch and heads), the output
    wrapped back; the flash-attention op takes this route for DTensor
    inputs, and so does the SSM's whole chunked scan.
"""

from __future__ import annotations

import contextlib
import math
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only

from repro_torch.parallel.sharding import POD_DATA, mesh_axes

__all__ = ["REPLICATED", "abstract_tree", "cache_shards", "cache_write", "distribute_tree",
           "gathered", "local_shape", "logsumexp_last", "pick_last", "project", "query_blocks",
           "redistribute", "replicated", "sharded_call", "split_moved", "spmd_region"]

# Ops that ran replicated for want of a sharding strategy: op name → bytes
# gathered to this rank (summed over calls).  `spmd_region` adds to it.
REPLICATED: Dict[str, float] = defaultdict(float)


def replicated(x: Any) -> Any:
    """A DTensor gathered whole on every rank, as a plain tensor (partial
    sums reduced); anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def local_shape(shape: Sequence[int], placements: Sequence[Any], mesh) -> Tuple[int, ...]:
    """The shard of a tensor of ``shape`` on this rank.  The resolved specs
    keep only mesh axes that divide their dimension (`resolve_pspec`), so
    every shard has the same shape."""
    out = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if out[p.dim] % n:
                raise ValueError(f"dimension {p.dim} of {tuple(shape)} does not split {n} ways")
            out[p.dim] //= n
    return tuple(out)


def _contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(d, 1)
    return tuple(reversed(stride))


def _abstract(spec_shape, dtype, placements, mesh) -> DTensor:
    local = torch.empty(local_shape(spec_shape, placements, mesh), dtype=dtype, device="meta")
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False,
                              shape=torch.Size(spec_shape), stride=_contiguous_stride(spec_shape))


def _zip_map(fn: Callable, a: Any, b: Any) -> Any:
    """``fn(leaf_a, leaf_b)`` over two trees of one structure (dicts, lists,
    tuples, NamedTuples); ``b``'s leaves are placements tuples."""
    if isinstance(a, dict):
        return {k: _zip_map(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(_zip_map(fn, v, w) for v, w in zip(a, b)))
    if isinstance(a, (list, tuple)):
        return type(a)(_zip_map(fn, v, w) for v, w in zip(a, b))
    return fn(a, b)


def abstract_tree(specs: Any, shardings: Any, mesh) -> Any:
    """Each `TensorSpec` of ``specs`` as a `DTensor` of its placements in
    ``shardings`` over ``mesh``, its local shard on the ``meta`` device.
    Tensors (e.g. `configs.input_specs`' meta stand-ins) take their shape
    and dtype."""
    def leaf(s, placements):
        return _abstract(tuple(s.shape), s.dtype, placements, mesh)

    return _zip_map(leaf, specs, shardings)


def distribute_tree(tree: Any, shardings: Any, mesh) -> Any:
    """Real tensors of ``tree`` as DTensors of the placements ``shardings``
    over ``mesh`` (every rank holds the same values, as each drew them from
    the same seed; rank 0's are the ones kept; on a mesh of one rank the
    tensors themselves).  A leaf that needs gradients keeps needing them."""
    from torch.distributed.tensor import distribute_tensor

    def leaf(t, placements):
        t = torch.as_tensor(t)
        if mesh.size() == 1:  # the whole tensor is the one shard: no copy
            d = DTensor.from_local(t.detach(), mesh, tuple(placements), run_check=False)
        else:
            d = distribute_tensor(t.detach(), mesh, tuple(placements))
        return d.requires_grad_(t.requires_grad)

    return _zip_map(leaf, tree, shardings)


# ---------------------------------------------------------------------------
# FSDP: parameters gathered over the data axes where they are read
# ---------------------------------------------------------------------------


def _gather_data_axes(x: DTensor) -> DTensor:
    """``x`` gathered over the mesh dimensions of the data axes: one
    all-gather where the mesh merges them (`launch.mesh.flat_view`)."""
    data = {m for a, _, m in mesh_axes(x.device_mesh) if a in POD_DATA}
    pl = [Replicate() if m in data and isinstance(p, Shard) else p
          for m, p in enumerate(x.placements)]
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def _gathered(v: Any) -> Any:
    if isinstance(v, dict):
        return _GatheredDict(v)
    if isinstance(v, list):
        return _GatheredList(v)
    if isinstance(v, DTensor):
        return _gather_data_axes(v)
    return v


class _GatheredDict(dict):
    """A parameter dict that gathers each DTensor it gives out (see `gathered`)."""

    def __getitem__(self, key):
        return _gathered(dict.__getitem__(self, key))

    def get(self, key, default=None):
        return self[key] if key in self else default

    def items(self):
        return [(k, self[k]) for k in self]

    def values(self):
        return [self[k] for k in self]


class _GatheredList(list):
    def __getitem__(self, i):
        return _gathered(list.__getitem__(self, i))

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def gathered(params: Any) -> Any:
    """``params`` as the model reads it under FSDP: a DTensor leaf read from
    it comes gathered over the data axes ("pod", "data"), its other shards
    kept (tensor and expert parallelism over "model"); on a mesh that merges
    them, one all-gather over the merged dimension.  A tree without
    DTensors is returned as it is."""
    if not any(isinstance(t, DTensor) for t in tree_flatten(params)[0]):
        return params
    return _gathered(params)


# ---------------------------------------------------------------------------
# The step's region: implicit replication and the replicate-at-op fallback
# ---------------------------------------------------------------------------


def _propagation_failed(err: BaseException) -> bool:
    """DTensor found no sharding for an op: no strategy registered, none for
    these inputs (a view that cannot split a sharded dimension), or one whose
    local view does not fit its shard (a view across a dimension merged
    from sharded ones)."""
    msg = str(err)
    return ("sharding strategy" in msg or "Sharding propagation failed" in msg
            or "is invalid for input of size" in msg)


def _local_bytes(tree: Any) -> int:
    return sum(a.to_local().numel() * a.element_size()
               for a in tree_flatten(tree)[0] if isinstance(a, DTensor))


class _ReplicateUnsupported(TorchDispatchMode):
    """Runs an op that DTensor cannot shard on inputs replicated over more
    and more mesh dimensions, last first (a view that cannot split the
    "model" shards of a merged dimension runs once they are gathered), and
    at last, for an op with no strategy at all, on whole inputs
    (`full_tensor`) with replicated outputs.  Each gather is a collective
    the step's counter sees; `REPLICATED` records the op and the bytes it
    gathered to this rank.  An in-place op re-raises: its target cannot be
    replicated."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dts = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, DTensor)]
        try:
            return func(*args, **kwargs)
        except (NotImplementedError, RuntimeError) as err:
            if not dts or not _propagation_failed(err) or func._schema.is_mutable:
                raise
            # (no reference to ``err`` outlives this clause: its traceback
            # holds the callers' frames, and their tensors, in a cycle)
            no_strategy = "sharding strategy" in str(err)
        mesh = dts[0].device_mesh
        before = _local_bytes((args, kwargs))
        for keep in range(mesh.ndim - 1, -1, -1):  # mesh dims [keep, ndim) replicated
            def gather(a: DTensor) -> DTensor:
                pl = [p if m < keep else Replicate() for m, p in enumerate(a.placements)]
                return a.redistribute(a.device_mesh, pl)

            new_args, new_kwargs = tree_map_only(DTensor, gather, (args, kwargs))
            try:
                out = func(*new_args, **new_kwargs)
            except (NotImplementedError, RuntimeError) as err:
                if not _propagation_failed(err):
                    raise
                continue
            REPLICATED[str(func)] += _local_bytes((new_args, new_kwargs)) - before
            return out
        if not no_strategy:
            return func(*args, **kwargs)  # raises DTensor's own error again
        full_args, full_kwargs = tree_map_only(DTensor, lambda a: a.full_tensor(), (args, kwargs))
        REPLICATED[str(func)] += sum(
            a.numel() * a.element_size() for a in tree_flatten((full_args, full_kwargs))[0]
            if isinstance(a, torch.Tensor)) - before
        out = func(*full_args, **full_kwargs)
        rep = [Replicate()] * mesh.ndim
        return tree_map_only(torch.Tensor,
                             lambda o: DTensor.from_local(o, mesh, rep, run_check=False), out)


@contextlib.contextmanager
def spmd_region() -> Iterator[None]:
    """The context a step over DTensors runs in: plain tensors count as
    replicated (`implicit_replication`), and the replicate-at-op fallback."""
    with implicit_replication(), _ReplicateUnsupported():
        yield


# ---------------------------------------------------------------------------
# A shard moved from one tensor dimension to another: an all-to-all
# ---------------------------------------------------------------------------


def _all_to_all(local: torch.Tensor, mesh, m: int, gather: int, split: int) -> torch.Tensor:
    """This rank's block after one all-to-all over mesh dim ``m`` that makes
    dimension ``gather`` whole and splits dimension ``split``: chunk j of
    ``split`` goes to the group's rank j, and the blocks received are laid
    end to end along ``gather`` in rank order, as DTensor lays out shards.
    It is the op DTensor runs for this move on the card
    (``_dtensor.shard_dim_alltoall``, gloo's all-to-all on CPU tensors), so
    a step counts the same bytes and memory on a CPU mesh as on the card's."""
    group = mesh.get_group(m).group_name
    return torch.ops._dtensor.shard_dim_alltoall(local.contiguous(), gather, split, group)


class _ShardMove(torch.autograd.Function):
    """``x`` with its shard on mesh dim ``m`` moved from tensor dimension
    ``a`` to ``b`` by one all-to-all; the backward is the reverse one."""

    @staticmethod
    def forward(ctx, x, m, a, b):
        mesh = x.device_mesh
        out_pl = list(x.placements)
        out_pl[m] = Shard(b)
        ctx.meta = (mesh, m, a, b, tuple(x.placements), tuple(out_pl), x.shape, x.stride())
        out = _all_to_all(x.to_local(), mesh, m, gather=a, split=b)
        return DTensor.from_local(out, mesh, out_pl, run_check=False, shape=x.shape,
                                  stride=x.stride())

    @staticmethod
    def backward(ctx, g):
        mesh, m, a, b, x_pl, out_pl, shape, stride = ctx.meta
        g = redistribute(g, out_pl).to_local()
        back = _all_to_all(g, mesh, m, gather=b, split=a)
        return (DTensor.from_local(back, mesh, x_pl, run_check=False, shape=shape,
                                   stride=stride), None, None, None)


def _shard_move(x: DTensor, placements: Tuple[Any, ...]):
    """(m, a, b) where ``placements`` differ from ``x``'s only in moving the
    shard on mesh dim m from tensor dimension a to b, no later mesh dim
    splits either (earlier ones split the block the group of m shares, as
    DTensor nests shards in mesh order), and both split evenly; else None."""
    diff = [m for m, (p, q) in enumerate(zip(x.placements, placements)) if p != q]
    if len(diff) != 1:
        return None
    (m,) = diff
    p, q = x.placements[m], placements[m]
    if not (type(p) is Shard and type(q) is Shard):  # (not `_StridedShard`)
        return None
    a, b = p.dim, q.dim
    mesh = x.device_mesh

    def ways(d, pl):
        return math.prod(mesh.size(i) for i, r in enumerate(pl) if isinstance(r, Shard)
                         and r.dim == d)

    if any(isinstance(r, Shard) and r.dim in (a, b) for r in x.placements[m + 1:]) \
            or x.shape[a] % ways(a, x.placements) or x.shape[b] % ways(b, placements):
        return None
    return m, a, b


def redistribute(x: DTensor, placements: Sequence[Any]) -> DTensor:
    """``x.redistribute(x.device_mesh, placements)``, but a move of one mesh
    dim's shard from tensor dimension a to b (Shard(a) → Shard(b), all else
    equal) runs as one all-to-all of the port's own (`_ShardMove`) on every
    mesh.  It is the op DTensor runs for that move on the card; on a CPU
    mesh DTensor takes all-gather + chunk instead, which holds the whole
    tensor on every rank (its premise that gloo has no all-to-all no longer
    holds)."""
    placements = tuple(placements)
    move = _shard_move(x, placements)
    if move is not None:
        return _ShardMove.apply(x, *move)
    return x.redistribute(x.device_mesh, placements)


def split_moved(x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """``x`` with the mesh dims that split its dimension ``src`` splitting
    ``dst`` instead, where ``dst`` divides among them (`redistribute`: one
    all-to-all a mesh dim); a plain tensor, or one whose ``src`` is whole,
    as it is."""
    if not isinstance(x, DTensor):
        return x
    dims = _split_dims(x, src)
    if not dims or x.shape[dst] % math.prod(x.device_mesh.size(m) for m in dims):
        return x
    return redistribute(x, [Shard(dst) if m in dims else p for m, p in enumerate(x.placements)])


# ---------------------------------------------------------------------------
# Activation × weight products on local shards
# ---------------------------------------------------------------------------


class _LocalOf(torch.autograd.Function):
    """The local tensor of ``w`` laid out as ``placements``; its gradient
    goes back as a DTensor of ``grad_placements`` (partial sums where the
    product's other operand was split), unmoved: the redistribution that
    gave ``w`` (an FSDP gather, `gathered`) reduce-scatters it onto its
    shards."""

    @staticmethod
    def forward(ctx, w, placements, grad_placements, back=None):
        ctx.meta = (w.device_mesh, grad_placements, back, w.shape, w.stride())
        return redistribute(w, placements).to_local()

    @staticmethod
    def backward(ctx, g):
        mesh, grad_pl, back, shape, stride = ctx.meta
        g = DTensor.from_local(g, mesh, grad_pl, run_check=False, shape=shape, stride=stride)
        return (g if back is None else g.redistribute(mesh, back)), None, None, None


def _letter(p: Any, subs: str):
    """The einsum letter of the tensor dimension ``p`` splits, or None."""
    return subs[p.dim] if isinstance(p, Shard) else None


def _project_plan(eq: str, x: DTensor, w: DTensor):
    """The layouts of `project`: x's and w's placements for the local
    product, the output's, and x's and w's gradients'."""
    xs, ws, os_ = _einsum_subscripts(eq)
    contracted, outs = set(xs) & set(ws), set(os_)
    if contracted & outs:
        raise ValueError(f"project: {eq!r} has a batch letter on both operands")
    mesh = x.device_mesh
    x_pl, w_pl, out_pl, gx, gw = [], [], [], [], []
    for m in range(mesh.ndim):
        px, pw = x.placements[m], w.placements[m]
        lx, lw = _letter(px, xs), _letter(pw, ws)
        if mesh.size(m) == 1:  # one rank holds it all: any layout is the whole tensor
            x_pl.append(px), w_pl.append(pw), gx.append(px), gw.append(pw)
            out = next((l for l in (lx, lw) if l in outs), None)
            out_pl.append(Shard(os_.index(out)) if out else Replicate())
            continue
        if lx in contracted and lw != lx:  # a split contracted dimension: whole
            lx = None
        if lw in contracted and lx != lw:
            lw = None
        if lx in outs and lw in outs:  # one mesh dim cannot split two output dims
            if _local_bytes(x) < _local_bytes(w):
                lx = None
            else:
                lw = None
        x_pl.append(Shard(xs.index(lx)) if lx else Replicate())
        w_pl.append(Shard(ws.index(lw)) if lw else Replicate())
        if lx and lx == lw:  # both split the contracted dimension: partial sums
            out_pl.append(Partial())
            gx.append(x_pl[-1]), gw.append(w_pl[-1])
            continue
        split = lx or lw
        out_pl.append(Shard(os_.index(split)) if split else Replicate())
        gx.append(x_pl[-1] if lx else Partial() if lw else Replicate())
        gw.append(w_pl[-1] if lw else Partial() if lx else Replicate())
    _split_free_dims(mesh, x, w, (xs, ws, os_), x_pl, w_pl, out_pl, gx, gw)
    return tuple(x_pl), tuple(w_pl), tuple(out_pl), tuple(gx), tuple(gw)


def _split_free_dims(mesh, x, w, subs, x_pl, w_pl, out_pl, gx, gw) -> None:
    """`_project_plan`'s lists, a contracted dimension split alike in both
    operands over each mesh dim (of more than one rank) that splits neither
    (either may be a partial sum there: x's is then reduce-scattered, not
    all-reduced), where the output's local bytes are no more than the
    weight's (a batch-1 decode's (1, 1, d) by a (d, f) weight): the output
    is a partial sum there, not the whole product on every rank.  The first
    contracted dimension (in x's order) that the mesh dims splitting it then
    divide, and that no later mesh dim splits already, is taken (DTensor
    nests shards in mesh order, so m then cuts each rank's block in place,
    where an earlier m would move the blocks); without one, or with a
    larger output, the plan stays."""
    xs, ws, os_ = subs
    size = dict(zip(xs, x.shape)) | dict(zip(ws, w.shape))

    def ways(pl, subs_, letter):
        return math.prod(mesh.size(m) for m, p in enumerate(pl)
                         if isinstance(p, Shard) and subs_[p.dim] == letter)

    for m in range(mesh.ndim):
        if mesh.size(m) == 1 or any(isinstance(a.placements[m], Shard) for a in (x, w)):
            continue
        out_bytes = math.prod(size[c] // ways(out_pl, os_, c) for c in os_) * x.element_size()
        w_bytes = math.prod(size[c] // ways(w_pl, ws, c) for c in ws) * w.element_size()
        if out_bytes > w_bytes:
            continue
        for c in xs:
            later = any(isinstance(p, Shard) and xs[p.dim] == c for p in x_pl[m + 1:])
            if c in ws and not later and size[c] % (ways(x_pl, xs, c) * mesh.size(m)) == 0:
                x_pl[m], w_pl[m], out_pl[m] = Shard(xs.index(c)), Shard(ws.index(c)), Partial()
                gx[m], gw[m] = x_pl[m], w_pl[m]
                break


def _einsum_subscripts(eq: str) -> Tuple[str, str, str]:
    ins, out = eq.replace(" ", "").split("->")
    xs, ws = ins.split(",")
    return xs, ws, out


def project(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` of an activation ``x`` by a weight ``w``
    (two operands, every letter of ``w`` contracted or in the output).  On
    plain tensors it is that einsum.  Over DTensors it runs on this rank's
    shards, so that no view inside the einsum merges two split dimensions
    (DTensor shards such a view on some versions and replicates it on
    others): x keeps its splits of output dimensions (batch, sequence);
    w is laid out with its contracted dimensions whole and its output
    dimensions split only over mesh dims x leaves free, unless w's local
    shard is the smaller to gather, in which case x gives up that mesh dim
    instead (the unembedding, whose vocabulary outweighs a rank's
    activations); a contracted dimension split alike in both stays split,
    and the output is a partial sum there.  A mesh dim that splits neither
    operand splits a contracted dimension of both where the output is no
    larger than the weight's shard (`_split_free_dims`), and that small
    output is summed over it at once (an all-reduce), so that what follows
    reads it whole, as before.  The plain einsum runs on the
    local tensors, and the result is wrapped back in the layout that
    follows.  Gradients: x's come back in the layout x came in, w's as a
    partial sum over the mesh dims on which x is split and w is not."""
    if not (isinstance(x, DTensor) or isinstance(w, DTensor)):
        return torch.einsum(eq, x, w)
    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    rep = [Replicate()] * mesh.ndim
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, rep, run_check=False)
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, mesh, rep, run_check=False)
    x_pl, w_pl, out_pl, gx, gw = _project_plan(eq, x, w)
    free = [m for m, p in enumerate(out_pl) if isinstance(p, Partial)
            and not any(isinstance(a.placements[m], Shard) for a in (x, w))]
    xl = redistribute(x, x_pl).to_local(grad_placements=gx)
    wl = _LocalOf.apply(w, w_pl, gw, [Replicate() if m in free else p for m, p in
                                      enumerate(gw)] if free else None)
    out = torch.einsum(eq, xl, wl)
    xs, ws, os_ = _einsum_subscripts(eq)
    size = dict(zip(xs, x.shape)) | dict(zip(ws, w.shape))
    shape = tuple(size[c] for c in os_)
    out = DTensor.from_local(out, mesh, out_pl, run_check=False, shape=torch.Size(shape),
                             stride=_contiguous_stride(shape))
    if free:  # the partial sums over a split free dim (`_split_free_dims`)
        out = out.redistribute(mesh, [Replicate() if m in free else p
                                      for m, p in enumerate(out_pl)])
    return out


# ---------------------------------------------------------------------------
# Kernels on their local shards
# ---------------------------------------------------------------------------


def _shard_index(mesh, mesh_dims: Sequence[int]) -> int:
    """This rank's index among the shards of a dimension split over
    ``mesh_dims`` (major first, in mesh order, as DTensor lays them out)."""
    coord = mesh.get_coordinate()
    idx = 0
    for m in mesh_dims:
        idx = idx * mesh.size(m) + coord[m]
    return idx


def _layout(x: DTensor, keep: Dict[int, Sequence[int]]) -> List[Any]:
    """Placements of ``x`` keeping ``Shard(d)`` on the mesh dims ``keep[d]``
    and replicating every other mesh dim."""
    out: List[Any] = [Replicate()] * x.device_mesh.ndim
    for d, dims in keep.items():
        for m in dims:
            out[m] = Shard(d)
    return out


def _local(x: DTensor, placements: Sequence[Any], partial: Sequence[int] = ()) -> torch.Tensor:
    """``x``'s local tensor laid out as ``placements``; its gradient comes
    back in that layout, but as a partial sum over the mesh dims
    ``partial`` (where the ranks holding one block each add their share)."""
    grads = tuple(Partial() if m in partial else p for m, p in enumerate(placements))
    return redistribute(x, placements).to_local(grad_placements=grads)


def _split_dims(x: DTensor, d: int) -> List[int]:
    return [m for m, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == d]


def query_blocks(fn: Callable, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_offset: Any = None) -> torch.Tensor:
    """``fn(q, k, v, q_offset=q_offset)``, an attention in plain torch over
    (B, T, H, D) queries and (B, S, KV, D) keys and values.  Over DTensors
    split alike over batch and sequence only (a sequence-split training
    step), it runs on this rank's block of queries: the keys and values
    whole along the sequence, the block's first position added to
    ``q_offset``, the output in the queries' layout; the keys' and values'
    gradients are partial sums over the mesh dims that split the queries'
    sequence, reduce-scattered back onto their shards.  Any other input
    takes ``fn`` as it is (DTensor's own route)."""
    dts = (q, k, v)
    if not (all(isinstance(a, DTensor) for a in dts)
            and q.placements == k.placements == v.placements
            and all(isinstance(p, Replicate) or (type(p) is Shard and p.dim in (0, 1))
                    for p in q.placements)):
        return fn(q, k, v, q_offset=q_offset)
    mesh, seq = q.device_mesh, _split_dims(q, 1)
    whole = [Replicate() if m in seq else p for m, p in enumerate(q.placements)]
    grads = [Partial() if m in seq else p for m, p in enumerate(q.placements)]
    ql = q.to_local()
    kl, vl = (redistribute(a, whole).to_local(grad_placements=grads) for a in (k, v))
    start = _shard_index(mesh, seq) * ql.shape[1] + (q_offset or 0)
    out = fn(ql, kl, vl, q_offset=start)
    return DTensor.from_local(out, mesh, q.placements, run_check=False, shape=q.shape,
                              stride=_contiguous_stride(q.shape))


def _cache_layouts(q: DTensor, k: DTensor) -> Tuple[List[Any], List[Any], List[int]]:
    """The layouts of `cache_shards`: the queries' and the cache's
    placements for the local call, and the mesh dims that split the cache
    length.  Each mesh dim keeps the cache's split: of its length (the
    queries whole there), batch or KV heads (the queries alike).  Where the
    cache is whole on a mesh dim, the queries keep a batch split, or a
    split of heads that falls on whole GQA groups (the cache then sliced
    alike, a local copy); any other split of the queries is gathered."""
    mesh, kv = q.device_mesh, k.shape[2]
    q_pl: List[Any] = [Replicate()] * mesh.ndim
    kv_pl: List[Any] = [Replicate()] * mesh.ndim
    seq: List[int] = []
    heads = 1  # the shards of the KV heads so far
    for m in range(mesh.ndim):
        n = mesh.size(m)
        pk, pq = k.placements[m], q.placements[m]
        dk = pk.dim if type(pk) is Shard else None
        dq = pq.dim if type(pq) is Shard else None
        if n == 1:
            continue
        if dk == 1:
            seq.append(m)
            kv_pl[m] = Shard(1)
        elif dk == 0 or (dk is None and dq == 0):
            q_pl[m] = kv_pl[m] = Shard(0)
        elif dk == 2 or (dk is None and dq == 2 and kv % (heads * n) == 0):
            heads *= n
            q_pl[m] = kv_pl[m] = Shard(2)
    return q_pl, kv_pl, seq


def cache_write(cache: torch.Tensor, new: torch.Tensor, index: int) -> None:
    """``cache[:, index:index + T] = new`` in place, for a (B, S, ...) cache
    and (B, T, ...) new entries.  Over DTensors each rank writes the part of
    [index, index + T) that falls in its slice of the cache length, into
    its local shard (DTensor's own setitem on a length-split cache writes
    into a gathered copy, and the cache keeps its old values): the new
    entries come laid out as the cache, their length whole, unless they are
    the whole cache already split as it is (a prefill from 0)."""
    t = new.shape[1]
    if not isinstance(cache, DTensor):
        cache[:, index:index + t] = new
        return
    mesh = cache.device_mesh
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim, run_check=False)
    local = cache.to_local()
    if index == 0 and t == cache.shape[1] and tuple(new.placements) == tuple(cache.placements):
        local.copy_(new.to_local())
        return
    seq = _split_dims(cache, 1)
    whole = [Replicate() if m in seq else p for m, p in enumerate(cache.placements)]
    new = redistribute(new, whole).to_local()
    start = _shard_index(mesh, seq) * local.shape[1]
    lo, hi = max(index, start), min(index + t, start + local.shape[1])
    if lo < hi:
        local[:, lo - start:hi - start] = new[:, lo - index:hi - index]


def cache_shards(fn: Callable, parts: Callable, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, q_offset: Any = None) -> torch.Tensor:
    """``fn(q, k, v, q_offset=q_offset)``, an attention over (B, T, H, D)
    queries and a KV cache (B, S, KV, D) in plain torch.  On plain tensors
    it is that call.  Over DTensors it runs on this rank's shards
    (`_cache_layouts`), the cache never moved: each rank attends over its
    slice of the cache length, ``parts(q, k, v, q_offset=..., k_offset=...)``
    giving, at global key positions from ``k_offset`` (its slice's first),
    the row maximum and sum of exponentials (B, T, H) and the unnormalised
    P·V (B, T, H, D), all float32; over the mesh dims that split the
    length, an all-reduce of the maxima, a rescale and an all-reduce of the
    sums combine them.  No rank holds the logits whole along S.  The output,
    in v's dtype, returns in the queries' layout (splits the local call
    gathered are re-split locally).  Only serving passes a cache: over
    DTensors there is no gradient, and asking for one raises."""
    dts = [a for a in (q, k, v) if isinstance(a, DTensor)]
    if not dts:
        return fn(q, k, v, q_offset=q_offset)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
        raise RuntimeError("cache_shards: the attention over a sharded cache has no gradient")
    from torch.distributed import _functional_collectives as funcol

    mesh = dts[0].device_mesh
    rep = [Replicate()] * mesh.ndim
    q, k, v = (a if isinstance(a, DTensor) else DTensor.from_local(a, mesh, rep, run_check=False)
               for a in (q, k, v))
    q_pl, kv_pl, seq = _cache_layouts(q, k)
    ql = redistribute(q, q_pl).to_local()
    kl, vl = (redistribute(a, kv_pl).to_local() for a in (k, v))
    start = _shard_index(mesh, seq) * kl.shape[1]
    row_max, row_sum, pv = parts(ql, kl, vl, q_offset=q_offset, k_offset=start)
    if seq:
        top = row_max
        for m in seq:
            top = funcol.all_reduce(top, "max", (mesh, m))
        scale = torch.exp(row_max - top)
        both = torch.cat([pv * scale[..., None], (row_sum * scale)[..., None]], dim=-1)
        for m in seq:
            both = funcol.all_reduce(both, "sum", (mesh, m))
        pv, row_sum = both[..., :-1], both[..., -1]
    out = (pv / row_sum[..., None]).to(v.dtype)
    shape = q.shape[:3] + v.shape[3:]
    whole = DTensor.from_local(out, mesh, q_pl, run_check=False, shape=shape,
                               stride=_contiguous_stride(shape))
    return redistribute(whole, q.placements)


def sharded_call(kind: str, fn: Callable, *args: torch.Tensor) -> torch.Tensor:
    """``fn`` (a kernel op on plain tensors) on this rank's shards of DTensor
    ``args``.  ``kind`` names the layout:

      * ``"attention"``: ``fn(q, k, v)`` over (B, T, H, D) queries and (B, S,
        KV, D) keys and values.  Batch shards stay; query heads are sharded
        over the other mesh dims (or over those that shard them already, if
        the heads do not split over all), when each shard holds whole
        groups of the GQA mapping (keys and values then shard with them) or
        lies inside one group (each rank then takes its one KV head);
        everything else, a sharded sequence included, is gathered.
      * ``"ssd_chunked"``: ``fn(x, dt, A, B, C, initial_state=s) -> (y,
        state)``, the whole chunked scan (`models.ssm.ssd_chunked`), or
        one decode step over inputs of length 1 (`ssm._decode_as_scan`), over
        (B, L, H, ·) inputs, A (H,), B and C per group (B, L, G, N), and an
        optional sixth argument, the initial state s (B, H, N, P).  Batch
        shards stay, heads as above with groups in the place of KV heads,
        and the sequence is whole on each rank, so its chunks and the
        recurrence across them are local; y takes x's layout, the states
        their batch and heads shards.

    The output takes the queries' (or x's) layout.  Differentiable: the
    gradients come back through the same layouts, as partial sums where
    several ranks read one block (a KV head or group shared by the ranks of
    its query heads; A over the batch shards)."""
    lead = args[0]
    mesh = lead.device_mesh
    batch = _split_dims(lead, 0)
    hdim = 2  # the heads of q and of x
    h = lead.shape[hdim]
    free = [m for m in range(mesh.ndim) if m not in batch and mesh.size(m) > 1]
    heads = free if h % math.prod(mesh.size(m) for m in free) == 0 else _split_dims(lead, hdim)
    g = args[1].shape[2] if kind == "attention" else args[3].shape[hdim]
    n = math.prod(mesh.size(m) for m in heads)
    per = h // g  # query heads per KV head (or per group)
    h_local = h // n if h % n == 0 else 0
    if h_local and h_local % per == 0:
        group_keep, take = heads, None  # whole groups per shard: shard them too
    elif h_local and per % h_local == 0:
        group_keep, take = [], (_shard_index(mesh, heads) * h_local) // per
    else:
        heads, group_keep, take = [], [], None
    main = _layout(lead, {0: batch, hdim: heads})
    grouped = _layout(lead, {0: batch, hdim: group_keep})

    def pick(t: DTensor) -> torch.Tensor:
        """This rank's KV heads (or groups); where ranks share one, each
        gives back its share of that one's gradient, a partial sum over the
        heads' mesh dims."""
        if take is None:
            return _local(t, grouped)
        return _local(t, grouped, partial=heads).narrow(hdim, take, 1)

    if kind == "attention":
        q, k, v = args
        out = fn(_local(q, main), pick(k), pick(v))
    elif kind == "ssd_chunked":
        x, dt, A, B_, C_, *init = args
        rep = [Replicate()] * mesh.ndim
        A, *init = (a if isinstance(a, DTensor) else
                    DTensor.from_local(a, mesh, rep, run_check=False) for a in [A] + init)
        state_pl = _layout(lead, {0: batch, 1: heads})
        y, state = fn(_local(x, main), _local(dt, _layout(lead, {0: batch, 2: heads})),
                      # A (H,) has no batch: each batch shard adds its tokens' share
                      _local(A, _layout(lead, {0: heads}), partial=batch), pick(B_), pick(C_),
                      initial_state=_local(init[0], state_pl) if init else None)
        return (DTensor.from_local(y, mesh, tuple(main), run_check=False),
                DTensor.from_local(state, mesh, tuple(state_pl), run_check=False))
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return DTensor.from_local(out, mesh, tuple(main), run_check=False)


# ---------------------------------------------------------------------------
# Reductions over a sharded last dimension (the loss over vocab shards)
# ---------------------------------------------------------------------------


def logsumexp_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(x, -1)``; over a DTensor as max + log Σ exp(x − max)
    in ops DTensor shards (its max and sum over a sharded dimension are
    all-reduces of the (…,) result), never gathering ``x``."""
    if not isinstance(x, DTensor):
        return torch.logsumexp(x, dim=-1)
    m = x.detach().amax(dim=-1, keepdim=True)
    return torch.log(torch.exp(x - m).sum(dim=-1)) + m[..., 0]


def _out_placements(x: DTensor) -> Tuple[Any, ...]:
    """``x``'s placements with its last dimension reduced away."""
    last = x.ndim - 1
    return tuple(p if isinstance(p, Shard) and p.dim < last else Replicate()
                 for p in x.placements)


class _PickLast(torch.autograd.Function):
    """``x[..., i]`` at integer ``index`` (…,) of a DTensor, on its local
    shard: where the last dimension is sharded, each rank picks the entries
    in its slice (0 elsewhere), and an all-reduce over the slicing mesh dims
    sums them."""

    @staticmethod
    def forward(ctx, x, index):
        from torch.distributed import _functional_collectives as funcol

        mesh, out_pl = x.device_mesh, _out_placements(x)
        index = index.redistribute(mesh, out_pl).to_local().long()
        local = x.to_local()
        vdims = _split_dims(x, x.ndim - 1)
        width = local.shape[-1]
        shifted = index - _shard_index(mesh, vdims) * width
        inside = (shifted >= 0) & (shifted < width)
        safe = shifted.clamp(0, width - 1)
        picked = local.gather(-1, safe[..., None])[..., 0] * inside
        for m in vdims:
            picked = funcol.all_reduce(picked, "sum", (mesh, m))
        ctx.save_for_backward(safe, inside)
        ctx.meta = (mesh, tuple(x.placements), out_pl, tuple(local.shape), local.dtype)
        return DTensor.from_local(picked, mesh, out_pl, run_check=False)

    @staticmethod
    def backward(ctx, g):
        safe, inside = ctx.saved_tensors
        mesh, x_pl, out_pl, shape, dtype = ctx.meta
        g = g.redistribute(mesh, out_pl).to_local()
        grad = torch.zeros(shape, dtype=dtype, device=g.device)
        grad.scatter_(-1, safe[..., None], (g * inside).to(dtype)[..., None])
        return DTensor.from_local(grad, mesh, x_pl, run_check=False), None


def pick_last(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``torch.gather(x, -1, index[..., None])[..., 0]``; over a DTensor
    without gathering ``x``."""
    if isinstance(x, DTensor):  # (the gather's own backward makes a global-size zeros)
        return _PickLast.apply(x, index)
    return torch.gather(x, -1, index[..., None])[..., 0]
