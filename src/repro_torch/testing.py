"""The one tie-aware comparator of the port against a reference.

Used by the CPU tests (port against the JAX package) and by
`chip_smoke.py` (the kernel against its plain version, the fused layout
against the feature layout, the port against the golden fixture).

Rules:

  * Float outputs agree within ``rtol·|ref| + atol`` (`assert_close`).
  * A discrete pick agrees when it equals the reference's, or when the
    reference's own EI at the port's pick lies within ``EI_RTOL·|max EI| +
    EI_ATOL`` of the reference's max EI (`pick_agrees`): the two picks are
    then a tie that float32 cannot separate.  The head's own discrete pick,
    the (lengthscale, noise) grid point of largest log marginal likelihood,
    can tie too: the reference's EI is then taken under every grid point
    whose likelihood lies within ``LML_RTOL·(1 + |max|)`` of the largest
    (`tied_grid_points`), and the port's pick must tie under one of them.
  * Two search traces agree step by step (`compare_traces`).  At the first
    step where they differ, a certified tie ends the comparison of that
    trace there, and the result says so (``tie_at``); such a trace is
    reported, not counted as a match.  Anything else raises.

Tolerances, float32 throughout.  EI's normal CDF is ``0.5·(1 + erf(z))``:
for z ≪ 0 the sum cancels to within an ulp of 1 (6e-8), so an EI value
carries an absolute error of about 6e-8 times the improvement, which is of
the order of the costs (about 1 for the paper's normalized costs): hence
``EI_ATOL = 1e-6``.  Above that floor, the posterior runs through (B,B)
Cholesky factorizations with noise down to 1e-4, which amplify float32
rounding: on the Table II jobs the port's EI stays within 2.5e-5 of the
reference's maximum beyond EI_ATOL, hence ``EI_RTOL = 2e-4``.  The
expansion |x|² + |y|² - 2x·y leaves up to about 2e-6 on the diagonal of
the training block, which at lengthscale 0.1 shifts the kernel's diagonal
by about 2e-4, twice the smallest noise: on the same jobs this moves a
log marginal likelihood by up to 5.1e-4·(1 + |lml|), hence
``LML_RTOL = 1e-3``.  Plain float
outputs of the GP (means, variances, factors) agree to ``FLOAT_RTOL =
1e-4`` and ``FLOAT_ATOL = 1e-5``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "EI_ATOL",
    "EI_RTOL",
    "FLOAT_ATOL",
    "FLOAT_RTOL",
    "LML_RTOL",
    "TraceComparison",
    "assert_close",
    "compare_traces",
    "packed_state",
    "pick_agrees",
    "port_ei_at",
    "tied_grid_points",
]

FLOAT_RTOL = 1e-4
FLOAT_ATOL = 1e-5
EI_RTOL = 2e-4
EI_ATOL = 1e-6
LML_RTOL = 1e-3

# ei_at(k) -> (EI over the whole space, best observed cost) for the state
# holding the first k trials of the reference trace: EI of shape (n,), or
# (h, n) with one row per tied grid point, the selected one first.
EiAt = Callable[[int], Tuple[np.ndarray, float]]


def assert_close(ref, got, *, rtol: float = FLOAT_RTOL, atol: float = FLOAT_ATOL,
                 what: str = "value") -> float:
    """Raise unless |got - ref| <= atol + rtol·|ref| elementwise (equal
    infinities and NaNs agree).  Returns the largest absolute deviation
    over the finite entries."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    if ref.shape != got.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {ref.shape}")
    same = (ref == got) | (np.isnan(ref) & np.isnan(got))
    fin = np.isfinite(ref) & np.isfinite(got)
    with np.errstate(invalid="ignore"):
        err = np.where(fin, np.abs(got - ref), 0.0)
    bad = ~same & (~fin | (err > atol + rtol * np.abs(ref)))
    if bad.any():
        i = np.unravel_index(np.argmax(bad), bad.shape)
        raise AssertionError(
            f"{what}: {int(bad.sum())} entries outside rtol={rtol} atol={atol}; "
            f"first at {i}: got {got[i]!r}, ref {ref[i]!r}"
        )
    return float(err.max()) if err.size else 0.0


def _ei_tol(max_ei: float) -> float:
    return EI_ATOL + EI_RTOL * abs(max_ei)


def tied_grid_points(lmls) -> np.ndarray:
    """Indices of the grid points whose log marginal likelihood ties with the
    largest (within LML_RTOL), the first maximizing one first."""
    lmls = np.asarray(lmls, np.float64)
    h = int(np.argmax(lmls))
    top = lmls[h]
    if not np.isfinite(top):
        return np.array([h])
    tied = np.flatnonzero(np.isfinite(lmls) & (lmls >= top - LML_RTOL * (1.0 + abs(top))))
    return np.concatenate([[h], tied[tied != h]])


def pick_agrees(ref_pick: int, got_pick: int, ref_ei: np.ndarray) -> bool:
    """True when ``got_pick`` equals ``ref_pick`` or ties with the best pick
    under the reference's EI ``ref_ei`` (-inf outside the candidates): one
    vector (n,), or (h, n) with one row per tied grid point."""
    if int(ref_pick) == int(got_pick):
        return True
    for row in np.atleast_2d(np.asarray(ref_ei, np.float64)):
        top = float(np.max(row))
        v = float(row[int(got_pick)])
        if np.isfinite(v) and np.isfinite(top) and v >= top - _ei_tol(top):
            return True
    return False


@dataclasses.dataclass(frozen=True)
class TraceComparison:
    """How far two traces agree.  ``tie_at`` is the step (0-based trial
    index) where a certified tie ended the comparison, None for a full
    match; ``steps`` is the number of trials that agree."""

    steps: int
    tie_at: Optional[int]
    detail: str = ""

    @property
    def full(self) -> bool:
        return self.tie_at is None


def compare_traces(ref, got, ei_at: EiAt, *, ei_stop_rel: float = 0.10,
                   first_bo_step: int = 0) -> TraceComparison:
    """Compare two `SearchTrace`-like records (``tried``, ``costs``,
    ``stop_iteration``, ``phase_boundary``) step by step.

    ``first_bo_step`` is the number of scripted init trials: those come
    from the same host generator on both sides and must agree exactly.
    At each later step the stop decision and the pick must agree, or tie
    under the reference's EI at that step (``ei_at``).
    """
    n_ref, n_got = len(ref.tried), len(got.tried)
    for k in range(max(n_ref, n_got) + 1):
        s_ref, s_got = ref.stop_iteration == k, got.stop_iteration == k
        if s_ref != s_got:
            ei, best = ei_at(k)
            tops = np.max(np.atleast_2d(ei), -1)
            thr = float(np.float32(ei_stop_rel) * np.float32(best))
            if min(tops) - _ei_tol(max(tops)) <= thr <= max(tops) + _ei_tol(max(tops)):
                return TraceComparison(k, k, f"stop decision tie at step {k}: "
                                       f"max EI {tops.tolist()} vs threshold {thr!r}")
            raise AssertionError(
                f"stop iteration differs at step {k} (ref {ref.stop_iteration}, "
                f"got {got.stop_iteration}): max EI {tops.tolist()}, threshold {thr!r}"
            )
        if k >= n_ref or k >= n_got:
            if n_ref != n_got:
                raise AssertionError(f"trace lengths differ: ref {n_ref}, got {n_got}")
            break
        a, b = int(ref.tried[k]), int(got.tried[k])
        if a != b:
            if k < first_bo_step:
                raise AssertionError(f"init pick {k} differs: ref {a}, got {b}")
            ei = np.atleast_2d(ei_at(k)[0])
            what = (f"ref {a} (EI {ei[:, a].tolist()}), got {b} (EI {ei[:, b].tolist()}) "
                    f"under {len(ei)} tied grid point(s)")
            if pick_agrees(a, b, ei):
                return TraceComparison(k, k, f"pick tie at step {k}: {what}")
            raise AssertionError(f"pick differs at step {k}: {what}; not a tie")
        if float(ref.costs[k]) != float(got.costs[k]):
            raise AssertionError(f"cost of trial {k} differs for config {a}")
    if ref.phase_boundary != got.phase_boundary:
        raise AssertionError(
            f"phase boundary differs: ref {ref.phase_boundary}, got {got.phase_boundary}"
        )
    return TraceComparison(n_ref, None)


def packed_state(encoded: np.ndarray, pools: Sequence[Sequence[int]],
                 capacity: int, tried: Sequence[int], costs: Sequence[float]):
    """The search state after ``tried`` (with their ``costs``), as the
    sequential search holds it: numpy (feats, tried, py, t, obs, cand) with
    no job axis.  The candidate pool is the first pool with an untried
    configuration, as in `bayesopt._bo_loop`."""
    enc = np.asarray(encoded, np.float32)
    n, d = enc.shape
    k = len(tried)
    tr = np.full(capacity, -1, np.int32)
    tr[:k] = np.asarray(tried, np.int32)
    py = np.zeros(capacity, np.float32)
    py[:k] = np.asarray(costs, np.float32)
    feats = np.zeros((capacity, d), np.float32)
    feats[:k] = enc[tr[:k]]
    obs = np.zeros(n, bool)
    obs[tr[:k]] = True
    cand = np.zeros(n, bool)
    for pool in pools:
        m = np.zeros(n, bool)
        m[np.asarray(list(pool), np.int64)] = True
        if (m & ~obs).any():
            cand = m
            break
    return feats, tr, py, np.int32(k), obs, cand


def port_ei_at(encoded: np.ndarray, pools: Sequence[Sequence[int]], capacity: int,
               trace, device=None, xi: float = 0.0) -> EiAt:
    """``ei_at`` for `compare_traces` from the port's feature layout (plain
    PyTorch, no kernel), over the states of ``trace``."""
    import torch

    from repro_torch.core import fast_bo
    from repro_torch.device import resolve_device
    from repro_torch.kernels.ei_argmax.tile import ei_from_sqdist

    dev = resolve_device(device)
    enc = torch.from_numpy(np.ascontiguousarray(encoded, np.float32)).to(dev)[None]

    def ei_at(k: int):
        feats, tr, py, t, obs, cand = (
            torch.from_numpy(np.atleast_1d(a)).to(dev)[None]
            for a in packed_state(encoded, pools, capacity, trace.tried[:k], trace.costs[:k])
        )
        d2_bb, d2_bn = fast_bo.packed_sqdist_blocks(feats, enc, tr)
        pm, best, y_mean, y_std, ls18, lmls, chols, alphas = fast_bo._grid_factors(
            d2_bb, py, t[0])
        h = torch.from_numpy(tied_grid_points(lmls[0].cpu().numpy())).to(dev)
        m = len(h)
        ei = ei_from_sqdist(
            d2_bn.expand(m, -1, -1), pm.expand(m, -1), alphas[0, h], chols[0, h],
            ls18[h], y_mean.expand(m), y_std.expand(m), best.expand(m),
            (cand & ~obs).expand(m, -1), xi,
        )
        return ei.cpu().numpy(), float(best[0])

    return ei_at
