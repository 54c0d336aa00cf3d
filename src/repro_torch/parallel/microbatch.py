"""Microbatched gradient accumulation (port of `repro/parallel/microbatch.py`).

Splits the step's global batch into ``num_microbatches`` slices along the
leading dim, runs ``grad_fn`` on each in turn, and accumulates gradients
and scalar metrics: the first microbatch's, then a running sum, then
``· 1/n`` cast back to the accumulator's dtype.  The reference scans over
the slices; here a Python loop adds each slice's gradients in place.

A batch of DTensors split over its batch dimension is sliced on each
rank's shard: microbatch i takes the i-th slice of every rank's rows, so
each rank keeps its share of every microbatch (the global slice would
gather the batch).  The microbatches then hold other rows than on one
device, and the mean over them is the same.

The accumulator's dtype is ``accum_dtype`` when given, otherwise the
gradients' own: when the step casts each microbatch's gradients to
bfloat16 (``bf16_grad_reduce``), the sum runs in bfloat16, as the
reference's does.  ``1/n`` multiplies in the accumulator's dtype, as JAX's
weakly typed constant does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.models.spec import flatten, unflatten
from repro_torch.spans import TRAIN_GRADS, span

__all__ = ["accumulate_gradients"]


def accumulate_gradients(
    grad_fn: Callable[[Any, Any], Tuple[Any, Dict[str, torch.Tensor]]],
    params: Any,
    batch: Dict[str, Any],
    num_microbatches: int,
    *,
    accum_dtype: Optional[torch.dtype] = None,
) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """Run ``grad_fn(params, microbatch) -> (grads, metrics)`` over slices.

    ``batch`` leaves must have a leading batch dimension divisible by
    ``num_microbatches``.  Returns (mean grads, mean metrics).
    """
    if num_microbatches <= 1:
        return grad_fn(params, batch)
    n = num_microbatches
    for k, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} ({k}) not divisible by microbatches {n}")

    def part(x, i: int):
        if isinstance(x, DTensor) and any(isinstance(p, Shard) and p.dim == 0
                                          for p in x.placements):
            local = x.to_local()
            if local.shape[0] % n:
                raise ValueError(f"local batch {local.shape[0]} not divisible by "
                                 f"microbatches {n}")
            m = local.shape[0] // n
            return DTensor.from_local(local[i * m:(i + 1) * m], x.device_mesh, x.placements,
                                      run_check=False)
        return x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)]

    def micro(i: int) -> Dict[str, Any]:
        return {k: part(x, i) for k, x in batch.items()}

    def to_accum(g: torch.Tensor) -> torch.Tensor:
        return g.to(accum_dtype) if accum_dtype is not None else g

    tree, m_acc = grad_fn(params, micro(0))
    acc = [to_accum(g) for g in flatten(tree)]
    tree = unflatten(tree, acc)  # drops the first slice's uncast gradients
    for i in range(1, n):
        g_tree, m = grad_fn(params, micro(i))
        with span(TRAIN_GRADS):
            for a, g in zip(acc, flatten(g_tree)):
                a.add_(to_accum(g))
        del g_tree
        m_acc = {k: m_acc[k] + m[k] for k in m_acc}
    with torch.no_grad(), span(TRAIN_GRADS):
        for a in acc:
            a.mul_(torch.tensor(1.0 / n, dtype=a.dtype, device=a.device))
    metrics = {k: v * (1.0 / n) for k, v in m_acc.items()}
    return unflatten(tree, acc), metrics
