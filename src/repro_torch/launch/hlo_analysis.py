"""Cost analysis of one step, counted as it runs (port of
`repro/launch/hlo_analysis.py`).

The reference parses the optimized HLO text of a compiled SPMD step and
multiplies each loop body by its trip count.  PyTorch has no compiled SPMD
program to read, so the port counts one execution of the step instead:
`StepCounter` is a `TorchDispatchMode` that sees every op the step runs on
this rank's shards (DTensor's sharding propagation hands the local ops and
its collectives down to it), normally on the ``meta`` device, where nothing
is allocated (`launch.build`).  Every loop runs, so loops scale as they
execute.  It gives the reference's three terms and a memory trace:

  * ``flops``            — 2·M·N·K per matrix product (``mm``, ``bmm``,
                           ``addmm``, ``baddbmm``; batch dims included) and
                           the two products of each attention call
                           (``scaled_dot_product_*``, and the flash and SSD
                           kernels by the formula of their oracles' products,
                           full T×S, as the reference's CPU lowering counts
                           its oracle); nothing else, as the reference
                           counts only ``dot``;
  * ``collective_bytes`` — the result bytes on this rank of each
                           collective: all-reduce, all-gather,
                           reduce-scatter, all-to-all (DTensor's move of a
                           shard between dimensions included), and send/recv as
                           collective-permute (bytes received), by kind in
                           ``collective_breakdown``; a collective over
                           several mesh dimensions that DTensor runs as one
                           per dimension counts each step's result, while
                           over a mesh that merges them
                           (`launch.mesh.flat_view`) it is one collective
                           over the merged group, as XLA's one replica
                           group;
  * ``hbm_bytes``        — 2 × the bytes each materializing op writes (once
                           written, once read downstream): views are free;
                           an in-place op writes its target (a slice, for a
                           copy into a view), and ``index_put``, ``scatter``
                           and ``index_add`` write only their update.  Eager
                           PyTorch materializes every elementwise result
                           that XLA would fuse, so this count runs above the
                           reference's;
  * the live bytes of this rank's storages after each op, and their peak:
    each storage is counted from the op that made it until its last
    tensor (autograd's saved tensors included) is freed.

The reference's ``analyze_hlo`` parses HLO text, which the port does not
have; `analyze_step` runs a step under the counter in its place.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from collections import Counter
from typing import Any, Dict, Iterable, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_flatten

from repro_torch import kernels

__all__ = ["HloCost", "StepCounter", "StepMemory", "analyze_step"]

_COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "recv_": "collective-permute",
}
# Ops that write nothing (their outputs alias or only describe storage).
_NO_WRITE = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "detach",
             "alias", "lift_fresh", "wait_tensor", "_local_scalar_dense", "set_", "resize_",
             "send", "record_stream"}
# Ops whose written bytes are their update operand's, by argument position.
_UPDATE_ARG = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2, "scatter": 3,
               "scatter_": 3, "scatter_add": 3, "scatter_add_": 3, "scatter_reduce": 3,
               "scatter_reduce_": 3, "index_add": 3, "index_add_": 3}


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    collective_bytes: float = 0.0
    hbm_bytes: float = 0.0
    collective_breakdown: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __add__(self, other: "HloCost") -> "HloCost":
        bd = dict(self.collective_breakdown)
        for k, v in other.collective_breakdown.items():
            bd[k] = bd.get(k, 0.0) + v
        return HloCost(
            self.flops + other.flops,
            self.collective_bytes + other.collective_bytes,
            self.hbm_bytes + other.hbm_bytes,
            bd,
        )

    def scaled(self, n: float) -> "HloCost":
        return HloCost(
            self.flops * n,
            self.collective_bytes * n,
            self.hbm_bytes * n,
            {k: v * n for k, v in self.collective_breakdown.items()},
        )


@dataclasses.dataclass
class StepMemory:
    """One rank's memory over a step, in the terms of XLA's
    ``memory_analysis()``: argument and output bytes, the output bytes that
    are argument storages updated in place (``alias``), and the temporaries
    at the peak beyond the arguments and the new outputs (``temp``).  The
    reference's peak formula, argument + output − alias + temp, is the peak
    of the live bytes."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    alias_size_in_bytes: int
    temp_size_in_bytes: int

    @property
    def peak_bytes(self) -> int:
        return (self.argument_size_in_bytes + self.output_size_in_bytes
                - self.alias_size_in_bytes + self.temp_size_in_bytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local_tensors(tree: Any) -> Iterable[torch.Tensor]:
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, DTensor):
            yield leaf._local_tensor
        elif isinstance(leaf, torch.Tensor):
            yield leaf


def _storage_key(t: torch.Tensor):
    try:
        s = t.untyped_storage()
    except (RuntimeError, NotImplementedError):  # a tensor without storage
        return None, None
    return s._cdata, s


class StepCounter(TorchDispatchMode):
    """Counts the ops of one step on this rank (see the module docstring).
    Ops on DTensors go on to DTensor's dispatch (``NotImplemented``), whose
    local ops and collectives come back here; the ops DTensor's sharding
    propagation runs on global shapes, under a `FakeTensorMode`, are
    passed through uncounted.  ``kernel_calls`` counts the flash and SSD
    kernels' calls on meta tensors by name."""

    def __init__(self):
        super().__init__()
        self.cost = HloCost()
        self.kernel_calls: Counter = Counter()
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}

    # -- memory --------------------------------------------------------------

    def hold(self, tree: Any) -> None:
        """Count the storages of ``tree``'s tensors (their local shards) as live."""
        for t in _local_tensors(tree):
            self._track(t)

    def _release(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        key, storage = _storage_key(t)
        if key is None or key in self._storages:
            return
        size = storage.nbytes()
        self._storages[key] = size
        self.live += size
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._release, key)

    def storage_bytes(self, tree: Any) -> Tuple[int, set]:
        """(bytes, storage keys) of the distinct storages under ``tree``."""
        seen: Dict[int, int] = {}
        for t in _local_tensors(tree):
            key, storage = _storage_key(t)
            if key is not None:
                seen[key] = storage.nbytes()
        return sum(seen.values()), set(seen)

    # -- counting ------------------------------------------------------------

    def __enter__(self):
        kernels.META_WATCHERS.append(self._kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.META_WATCHERS.remove(self._kernel)
        return super().__exit__(*exc)

    def _kernel(self, name: str, flops: float) -> None:
        self.kernel_calls[name] += 1
        self.cost.flops += flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(m, FakeTensorMode) for m in _get_current_dispatch_mode_stack()):
            return out  # DTensor's shape propagation
        self._count(func, args, out)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def _count(self, func, args, out) -> None:
        name = func._schema.name.split("::")[-1]
        base = func.overloadpacket.__name__
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        cost = self.cost
        if base in ("mm", "addmm", "bmm", "baddbmm"):
            a = args[1] if base in ("addmm", "baddbmm") else args[0]
            cost.flops += 2.0 * outs[0].numel() * a.shape[-1]
        elif "scaled_dot_product" in base:
            q, k, v = args[:3]
            fwd = 2.0 * math.prod(q.shape[:-1]) * k.shape[-2] * (q.shape[-1] + v.shape[-1])
            cost.flops += 2.0 * fwd if base.endswith("backward") else fwd
        kind = _COLLECTIVES.get(base) or _COLLECTIVES.get(name)
        if kind is not None:
            b = float(sum(_nbytes(t) for t in outs))
            cost.collective_bytes += b
            cost.collective_breakdown[kind] = cost.collective_breakdown.get(kind, 0.0) + b
        if base in _NO_WRITE or func.is_view:
            return
        if base in _UPDATE_ARG:
            upd = args[_UPDATE_ARG[base]]
            # a scalar scattered at each index: written where the index says
            written = (_nbytes(upd) if isinstance(upd, torch.Tensor)
                       else args[2].numel() * args[0].element_size())
        elif func._schema.is_mutable and args and isinstance(args[0], torch.Tensor):
            written = _nbytes(args[0])
        else:
            written = sum(_nbytes(t) for t in outs)
        cost.hbm_bytes += 2.0 * written


def analyze_step(fn, *args) -> Tuple[Any, HloCost, StepMemory, Counter]:
    """Run ``fn(*args)`` once under a `StepCounter`: (its output, the cost,
    this rank's memory, the kernel calls by name).  The arguments are live
    throughout, as the caller holds them."""
    counter = StepCounter()
    counter.hold(args)
    arg_bytes, arg_keys = counter.storage_bytes(args)
    with counter:
        out = fn(*args)
    out_bytes, out_keys = counter.storage_bytes(out)
    alias = sum(counter._storages.get(k, 0) for k in out_keys & arg_keys)
    temp = max(0, counter.peak - arg_bytes - (out_bytes - alias))
    mem = StepMemory(int(arg_bytes), int(out_bytes), int(alias), int(temp))
    return out, counter.cost, mem, counter.kernel_calls
