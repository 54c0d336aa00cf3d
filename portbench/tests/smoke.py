"""Smoke-width cells for the CPU tests: each configuration file cut to the
program's smoke sizes (every changed key in ``reduced``), and small traffic."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness  # noqa: E402

SMOKE_TRAIN = {"rows": 4, "seq_len": 32, "microbatches": 2, "checked_steps": 3,
               "profiled_steps": 1}
SMOKE_PREFILL = {"buckets": [[4, 16], [2, 32], [1, 64]], "checked_per_bucket": 1}


def smoke_config(name: str, **over) -> dict:
    """Configuration file ``name`` at the program's smoke widths."""
    from repro_torch.configs import get, smoke_variant

    c = copy.deepcopy(harness.config(name))
    m = smoke_variant(get(c["arch"])).model
    keys = ["num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size", "head_dim"]
    for k in keys:
        c[k] = getattr(m, k)
    c.update(over)
    c["reduced"] = sorted(set(c["reduced"]) | set(keys) | set(over))
    return c


def smoke_traffic(name: str, **over) -> dict:
    tr = copy.deepcopy(harness.traffic(name))
    tr.update(SMOKE_TRAIN if tr["kind"] == "train" else SMOKE_PREFILL)
    tr.update(over)
    return tr
