"""The numbers that decide ``correct``, and their judgement against the
cell's limits (``portbench/limits/<cell>.json``: for each number its limit
and the two readings it was set between).

Training (the first steps the window's own call ran, against the
reference's on the same weights and batches):

  * ``loss_gap``   — the largest relative gap of a step's loss;
  * ``change_gap`` — the worst leaf's gap between the norms of its change
                     over the checked steps, over the reference's norm of
                     that leaf or of the median leaf, whichever is larger.
                     Leaves whose first reference gradient is under a
                     thousandth of the median leaf's move by round-off alone
                     and are left out of it.

The norm of the first gradient as the optimizer got it is not compared: in
``granite-8b.train-4k`` its worst leaf is on every seed the embedding,
whose gradient rows the program sums in bfloat16 (PERF.md gives the
readings).

Prefill (each sampled batch's outputs against the reference's forward over
the same prompts; logits in units of the reference row's standard
deviation, states as a relative norm):

  * ``token_gap``  — the widest gap by which a served token's reference
                     logit lies below the reference's best;
  * ``logit_err``  — the largest gap of a last-position logit;
  * one number a group of the states the prefill wrote, as the family's
    ``STATE_NUMBERS`` names them: the worst layer's relative error (the
    dense family's ``kv_err``: the keys and values in the cache).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

__all__ = ["judge", "leaf_gap", "prefill_numbers", "train_detail", "train_numbers", "worst"]


def leaf_gap(got: Dict[str, float], ref: Dict[str, float], names=None) -> float:
    """max over leaves of |got - ref| / max(ref, the median leaf's ref)."""
    names = list(ref) if names is None else list(names)
    med = statistics.median(ref.values())
    return max(abs(got[n] - ref[n]) / max(ref[n], med) for n in names)


def train_numbers(got: dict, ref: dict) -> Dict[str, float]:
    med = statistics.median(ref["first_grad"].values())
    moving = [n for n, g in ref["first_grad"].items() if g >= 1e-3 * med]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
        "change_gap": leaf_gap(got["change"], {n: ref["change"][n] for n in moving}, moving),
    }


def train_detail(got: dict, ref: dict, n: int = 3) -> List[list]:
    """The leaves with the widest gaps of the change's norm, [[leaf, gap],
    ...], for a run's diagnostics."""
    med = statistics.median(ref["change"].values())
    gaps = {k: abs(got["change"][k] - r) / max(r, med) for k, r in ref["change"].items()}
    return [[k, gaps[k]] for k in sorted(gaps, key=lambda k: -gaps[k])[:n]]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a - b‖ / ‖b‖, per leading index, the worst; ``a`` read where ``b`` is."""
    a, b = a.to(b.device).float().flatten(1), b.float().flatten(1)
    return float(((a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-30)).max())


def prefill_numbers(got: dict, ref: dict, states: Dict[str, tuple]) -> Dict[str, float]:
    """One batch's numbers.  ``got``: the program's last-position logits
    (B, V), served tokens (B,) and states, on the host or the device;
    ``ref``: the reference's `prefill` outputs; ``states``: the family's
    ``STATE_NUMBERS``."""
    lg, rl = got["logits"].to(ref["logits"].device).float(), ref["logits"].float()
    std = rl.std(dim=-1)
    served = torch.as_tensor(got["tokens"], device=rl.device).long()
    valid = (served >= 0) & (served < rl.shape[-1])
    best = rl.max(dim=-1).values
    gap = (best - rl.gather(1, (served * valid)[:, None])[:, 0]) / std
    gap = torch.where(valid, gap, torch.full_like(gap, 1e30))  # no such token
    out = {"token_gap": float(gap.max()),
           "logit_err": float(((lg - rl).abs().max(dim=-1).values / std).max())}
    for number, names in states.items():
        out[number] = max(_rel(got[k], ref[k]) for k in names)
    return out


def worst(per_batch: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(d[k] for d in per_batch) for k in per_batch[0]}


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> Tuple[bool, Dict[str, list]]:
    """(correct, {name: [number, limit]}) over the numbers the cell's limits
    name: correct when each was read and lies at or under its limit, and
    the cell has limits at all.  A number the limits do not name is not
    compared (PERF.md says why for each)."""
    table = {k: [numbers.get(k), x["limit"]] for k, x in limits.items()}
    ok = bool(table) and all(v is not None and v == v and v <= lim for v, lim in table.values())
    return ok, table
