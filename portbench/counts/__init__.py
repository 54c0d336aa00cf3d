"""The yardstick's arithmetic: published peaks of one H100, the least time of
a K2 call from its shapes, and a model step's operations from the
configuration's sizes.

Frozen copies of `chip_smoke.py`'s ``PEAK_*`` constants and ``flash_bound``;
the model counts are this package's own, one module a model family
(``counts/<family>.py``, found by the configuration's ``family``: its
``forward_flops`` and ``attention_layers``).  Nothing here imports the
program.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

# H100 SXM peaks (NVIDIA data sheet, dense), at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12  # tensor cores, dense

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def flash_bound(b, t, h, kv, d, causal, itemsize) -> dict:
    """Least time for one attention forward: q, k, v read and o written once
    over HBM bandwidth, and the products over the peak for the input type
    (bfloat16: the tensor cores; float32: the CUDA cores).  The causal run
    needs the query-key pairs at or before each query, T(T+1)/2 per head,
    and each pair costs 2D for q.k and 2D for p.v."""
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    flops = 4 * d * pairs
    nbytes = itemsize * (2 * b * t * h * d + 2 * b * t * kv * d)
    peak = PEAK_BF16_PER_S if itemsize == 2 else PEAK_FP32_PER_S
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ---------------------------------------------------------------------------
# A model's operations, from the configuration file's sizes
# ---------------------------------------------------------------------------


def family(c: dict):
    """The count module of configuration ``c``'s family (``counts/<family>.py``)."""
    return importlib.import_module(f"portbench.counts.{c['family']}")


def forward_flops(c: dict, b: int, t: int, *, logits_positions: int = None) -> Dict[str, float]:
    """Operations of one forward over ``b`` sequences of ``t`` tokens, split
    into matrix products (``matmul``) and attention over the causal pairs
    (``attention``), with their ``total``.  ``logits_positions``: positions
    unembedded per sequence (a prefill unembeds only its last one); all of
    them by default."""
    pos = t if logits_positions is None else logits_positions
    out = family(c).forward_flops(c, b, t)
    out["matmul"] += 2.0 * b * pos * c["d_model"] * c["vocab_size"]  # the unembedding
    out["total"] = out["matmul"] + out["attention"]
    return out


def train_step_flops(c: dict, rows: int, t: int) -> float:
    """A training step's operations: the forward's times three (the forward
    and its two backward products), without remat's recompute."""
    return 3.0 * forward_flops(c, rows, t)["total"]


def prefill_flops(c: dict, b: int, t: int) -> float:
    return forward_flops(c, b, t, logits_positions=1)["total"]


# ---------------------------------------------------------------------------
# The kernel calls a step makes, from the same sizes
# ---------------------------------------------------------------------------


def k2_calls_train(c: dict, rows: int, t: int, microbatches: int) -> List[Tuple[tuple, int]]:
    """[(flash_bound's arguments, calls)] of one training step: a forward's
    attention layers per microbatch, twice under remat "full" (the forward
    and the backward's recompute)."""
    mb = rows // microbatches
    per = 2 if c["remat_policy"] == "full" else 1
    shape = (mb, t, c["num_heads"], c["num_kv_heads"], c["head_dim"], True,
             ITEMSIZE[c["compute_dtype"]])
    return [(shape, per * microbatches * family(c).attention_layers(c))]


def bound_ms(calls: List[Tuple[tuple, int]], fn) -> float:
    return sum(fn(*shape)["bound_ms"] * n for shape, n in calls)
