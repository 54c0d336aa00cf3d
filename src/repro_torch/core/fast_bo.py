"""Packed-observation Bayesian-optimization step and search-state update.

Port of `repro/core/fast_bo.py`.  At most B points are ever observed per
search (B = the trial budget), so the GP never needs full-extent linear
algebra: the state carries a packed (B,d) feature buffer of the observed
points in trial order, and each step computes the (B,B) training block and
the candidates' posterior against the static (n,d) encoding.

    layout   geometry   per-step transient   EI tail
    feature  (n,d)      O(B·n)               `tile.ei_from_sqdist` on the full (B,n) block
    fused    (n,d)      O(n) masks only      the CUDA kernel (`kernels.ei_argmax`), or its
                                             plain version on the CPU
    gather   (n,n)      O(B·n)               blocks gathered from `precompute_d2`'s
                                             tensor, then the feature layout's tail
    dense    (n,d)      O(n²), 18 O(n³)      `bo_step_core_dense`: the full-extent
                                             baseline, not a `fleet_step` layout

The gather layout holds an (n,n) tensor for the search's lifetime, an O(n²)
wall near n = 10⁴; it is kept, as in the reference, to cross-check the
feature layout.  The dense step and `_masked_posterior` are the references
the packed math is checked against.

Every tensor carries a leading job axis J: the sequential probe runs J = 1,
and the fleet engine (`repro_torch.fleet`) runs the same `fleet_step` over a
lockstep chunk of J jobs.  A row's result does not depend on the other rows:
each op is batched over J, and no reduction crosses it.

Padding is exact: packed slots ≥ t are masked, their kernel rows and
columns zeroed and their diagonal set to 1, so the (B,B) Cholesky factor
block-decouples and padded slots contribute exactly 0 to alpha, the mean
and the variance.  Finite garbage in padded slots is inert.

A failed Cholesky: the reference relies on JAX returning a NaN factor,
whose likelihood then maps to -inf.  `torch.linalg.cholesky_ex` returns a
finite partial factor instead, so the port sets the lower triangle of the
factor of every grid point with ``info != 0`` to NaN, as JAX does: its
likelihood is then -inf and, if all 18 fail, `argmax` picks grid point 0
with a NaN factor, as the reference does.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.gp import (
    LENGTHSCALES,
    NOISES,
    GPParams,
    matern52,
    matern52_from_sqdist,
    pairwise_sqdist,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ei_argmax.ops import ei_argmax
from repro_torch.kernels.ei_argmax.tile import ei_from_sqdist

__all__ = [
    "FleetState",
    "SequentialProbe",
    "bo_step",
    "bo_step_core",
    "bo_step_core_dense",
    "bo_step_core_fused",
    "bo_step_core_gather",
    "encode_features",
    "fleet_step",
    "gather_sqdist_blocks",
    "packed_sqdist_blocks",
    "precompute_d2",
]

_JITTER = 1e-8
_LAYOUTS = ("feature", "gather", "fused")


def _check_layout(layout: str) -> None:
    if layout not in _LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; want one of {_LAYOUTS}")


def encode_features(encoded) -> np.ndarray:
    """Canonical float32 host view of the encoded space (the rows the feature
    buffer is filled with)."""
    return np.asarray(encoded, np.float32)


def _pairwise_sqdist_f32(encoded: torch.Tensor) -> torch.Tensor:
    return pairwise_sqdist(encoded.to(torch.float32))


def precompute_d2(encoded, device: DeviceLike = None) -> torch.Tensor:
    """(n,n) raw pairwise squared distances over the encoded space, float32,
    on ``device``: the gather layout's geometry, computed once per space."""
    enc = torch.from_numpy(np.ascontiguousarray(encode_features(encoded)))
    return _pairwise_sqdist_f32(enc.to(resolve_device(device)))


def packed_sqdist_blocks(
    feats: torch.Tensor,  # (J, B, d) packed features of observed points
    encoded: torch.Tensor,  # (J, n, d) static encoding of the space
    tried: torch.Tensor,  # (J, B) i32 trial log, -1 padded
) -> Tuple[torch.Tensor, torch.Tensor]:
    """((J,B,B), (J,B,n)) raw squared-distance blocks from the feature buffer.

    The (B,B) training block is a column gather of the cross block by
    `tried`, as in the reference (padded slots gather column 0, masked
    downstream).
    """
    d2_bn = pairwise_sqdist(feats, encoded)
    b = tried.shape[-1]
    idx = tried.clamp_min(0).long()[:, None, :].expand(-1, b, -1)
    return torch.gather(d2_bn, 2, idx), d2_bn


def gather_sqdist_blocks(
    d2: torch.Tensor,  # (J, n, n) precomputed raw squared distances
    tried: torch.Tensor,  # (J, B) i32 trial log, -1 padded
) -> Tuple[torch.Tensor, torch.Tensor]:
    """((J,B,B), (J,B,n)) blocks gathered from the precomputed tensor; padded
    slots gather row and column 0 (finite garbage, masked downstream)."""
    b = tried.shape[-1]
    idx = tried.clamp_min(0).long()
    d2_bn = torch.gather(d2, 1, idx[..., None].expand(-1, -1, d2.shape[-1]))
    return torch.gather(d2_bn, 2, idx[:, None, :].expand(-1, b, -1)), d2_bn


def _masked_posterior(
    x: torch.Tensor,  # (n, d)
    obs_mask: torch.Tensor,  # (n,) bool
    y_n: torch.Tensor,  # (n,) standardized targets, 0 where unobserved
    lengthscale: torch.Tensor,
    noise: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference form of the exact-masking construction: (lml, mean, var)
    over all n points for one (lengthscale, noise), the observed set masked
    in place at extent n (the packed steps compute the same math with it
    packed into (B,) buffers)."""
    m = obs_mask.to(x.dtype)
    params = GPParams(lengthscale=lengthscale, amplitude=torch.ones((), dtype=x.dtype,
                                                                    device=x.device),
                      noise=noise)
    k = matern52(x, x, params)
    k_eff = k * (m[:, None] * m[None, :]) + torch.diag(
        torch.where(obs_mask, noise + _JITTER, torch.ones_like(m)))
    chol = torch.linalg.cholesky(k_eff)
    alpha = torch.cholesky_solve((y_n * m)[:, None], chol)[:, 0]
    lml = (
        -0.5 * (y_n * m) @ alpha
        - torch.sum(torch.log(torch.diagonal(chol)) * m)
        - 0.5 * torch.sum(m) * math.log(2.0 * math.pi)
    )
    k_star = k * m[:, None]
    mean_n = k_star.T @ alpha
    v = torch.linalg.solve_triangular(chol, k_star, upper=False)
    var_n = torch.clamp_min(1.0 - torch.sum(v * v, 0), 1e-12)
    return lml, mean_n, var_n


def _grid_factors(
    d2_bb: torch.Tensor,  # (J, B, B) raw squared distances, training block
    py: torch.Tensor,  # (J, B) f32 packed observed costs, trial order
    t: torch.Tensor,  # (J,) i32 observations made
) -> Tuple[torch.Tensor, ...]:
    """Training-side math at extent B for all 18 (lengthscale, noise) grid
    points: target standardization and masked Cholesky factorizations.

    Returns ``(pm, best, y_mean, y_std, ls18, lmls, chols, alphas)`` with
    ``ls18`` (18,) and ``lmls`` (J,18), ``chols`` (J,18,B,B), ``alphas``
    (J,18,B) in the reference's lengthscale-major grid order.
    """
    pmask = torch.arange(py.shape[1], device=py.device)[None, :] < t[:, None]
    return _masked_grid_factors(d2_bb, py, pmask)


def _masked_grid_factors(
    d2: torch.Tensor,  # (J, m, m) raw squared distances among the m slots
    y: torch.Tensor,  # (J, m) observed costs, finite garbage where unobserved
    pmask: torch.Tensor,  # (J, m) bool observed slots
) -> Tuple[torch.Tensor, ...]:
    """`_grid_factors` over any set of observed slots: the packed layouts'
    prefix of t slots, or the dense step's observation mask over all n."""
    dev = y.device
    pm = pmask.to(torch.float32)

    y = y.to(torch.float32)
    n_obs = torch.clamp_min(pm.sum(-1), 1.0)
    y_mean = torch.sum(y * pm, -1) / n_obs
    y_var = torch.sum(pm * (y - y_mean[:, None]) ** 2, -1) / n_obs
    y_std = torch.clamp_min(torch.sqrt(y_var), 1e-8)
    y_train = torch.where(pmask, (y - y_mean[:, None]) / y_std[:, None], 0.0)

    ls = torch.tensor(LENGTHSCALES, dtype=torch.float32, device=dev)
    nz = torch.tensor(NOISES, dtype=torch.float32, device=dev)
    n_nz = nz.shape[0]
    ks = matern52_from_sqdist(d2[:, None], ls[None, :, None, None])  # (J,6,m,m)
    mm = pm[:, :, None] * pm[:, None, :]
    ks18 = (ks * mm[:, None]).repeat_interleave(n_nz, dim=1)  # (J,18,m,m)
    nz18 = nz.repeat(ls.shape[0])  # ls-major: combo h = (h // 3, h % 3)
    diag = torch.where(pmask[:, None, :], nz18[None, :, None] + _JITTER, 1.0)
    chols, info = torch.linalg.cholesky_ex(ks18 + torch.diag_embed(diag))
    failed = (info != 0)[..., None, None]
    chols = torch.where(failed, torch.full_like(chols, math.nan).tril(), chols)
    alphas = torch.cholesky_solve(
        y_train[:, None, :, None].expand(-1, chols.shape[1], -1, -1), chols
    )[..., 0]  # (J,18,m)
    lmls = (
        -0.5 * torch.sum(y_train[:, None, :] * alphas, -1)
        - torch.sum(torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)) * pm[:, None, :], -1)
        - 0.5 * pm.sum(-1)[:, None] * math.log(2.0 * math.pi)
    )
    lmls = torch.where(torch.isfinite(lmls), lmls, -math.inf)
    best = torch.amin(torch.where(pmask, y, math.inf), -1)
    return pm, best, y_mean, y_std, ls.repeat_interleave(n_nz), lmls, chols, alphas


def _select(factors) -> Tuple[torch.Tensor, ...]:
    """Marginal-likelihood selection over the 18 grid points' factors:
    ``(pm, best, ls_sel, chol, alpha, y_mean, y_std)``, each with the
    leading job axis."""
    pm, best, y_mean, y_std, ls18, lmls, chols, alphas = factors
    best_h = torch.argmax(lmls, -1)  # (J,)
    rows = torch.arange(lmls.shape[0], device=lmls.device)
    return (
        pm, best, ls18[best_h], chols[rows, best_h], alphas[rows, best_h],
        y_mean, y_std,
    )


def _packed_head(
    d2_bb: torch.Tensor,  # (J, B, B) raw squared distances, training block
    py: torch.Tensor,  # (J, B) f32 packed observed costs, trial order
    t: torch.Tensor,  # (J,) i32 observations made
) -> Tuple[torch.Tensor, ...]:
    """The 18-point grid (`_grid_factors`) and marginal-likelihood selection.

    Returns ``(pm, best, ls_sel, chol, alpha, y_mean, y_std)``, each with
    the leading job axis.
    """
    return _select(_grid_factors(d2_bb, py, t))


def _packed_core(d2_bb, d2_bn, py, t, obs_mask, cand_mask, xi: float):
    """Everything downstream of the distance blocks in the feature layout."""
    pm, best, ls_sel, chol, alpha, y_mean, y_std = _packed_head(d2_bb, py, t)
    ei = ei_from_sqdist(
        d2_bn, pm, alpha, chol, ls_sel, y_mean, y_std, best,
        cand_mask & ~obs_mask, xi,
    )
    return torch.argmax(ei, -1), torch.amax(ei, -1), best


def bo_step_core(
    encoded: torch.Tensor,  # (J, n, d) f32 static encoding of the space
    feats: torch.Tensor,  # (J, B, d) packed features, trial order
    tried: torch.Tensor,  # (J, B) i32 trial log, -1 padded
    py: torch.Tensor,  # (J, B) f32 packed observed costs
    t: torch.Tensor,  # (J,) i32 observations made
    obs_mask: torch.Tensor,  # (J, n) bool configurations already tried
    cand_mask: torch.Tensor,  # (J, n) bool current candidate pool
    xi: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One feature-layout BO iteration: (pick, max_ei, best), each (J,)."""
    d2_bb, d2_bn = packed_sqdist_blocks(feats, encoded, tried)
    return _packed_core(d2_bb, d2_bn, py, t, obs_mask, cand_mask, xi)


def bo_step_core_fused(
    encoded: torch.Tensor,
    feats: torch.Tensor,
    tried: torch.Tensor,
    py: torch.Tensor,
    t: torch.Tensor,
    obs_mask: torch.Tensor,
    cand_mask: torch.Tensor,
    xi: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused BO iteration: (pick, max_ei, best), each (J,).

    The extent-B head runs as in the feature layout; the extent-n tail is
    `kernels.ei_argmax`, which never holds the (B,n) block.  The training
    block is computed directly from the tried rows of the encoding.

    The reference hands d = 1 to the feature layout because XLA:CPU fuses
    the degenerate (·,1)·(1,·) matmul differently in different programs.
    PyTorch runs each op as it stands, so here the kernel serves d = 1
    like any other width.
    """
    d = encoded.shape[-1]
    idx = tried.clamp_min(0).long()[..., None].expand(-1, -1, d)
    d2_bb = pairwise_sqdist(feats, torch.gather(encoded, 1, idx))
    pm, best, ls_sel, chol, alpha, y_mean, y_std = _packed_head(d2_bb, py, t)
    pick, max_ei = ei_argmax(
        encoded, cand_mask & ~obs_mask, feats, pm, alpha, chol,
        ls_sel, y_mean, y_std, best, xi=xi,
    )
    return pick, max_ei, best


def bo_step_core_gather(
    d2: torch.Tensor,  # (J, n, n) raw pairwise squared distances (precompute_d2)
    tried: torch.Tensor,  # (J, B) i32 trial log, -1 padded
    py: torch.Tensor,  # (J, B) f32 packed observed costs
    t: torch.Tensor,  # (J,) i32 observations made
    obs_mask: torch.Tensor,  # (J, n) bool configurations already tried
    cand_mask: torch.Tensor,  # (J, n) bool current candidate pool
    xi: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One gather-layout BO iteration: (pick, max_ei, best), each (J,).  The
    blocks come from the search's (n,n) tensor instead of the feature
    buffer; everything after them is the feature layout's."""
    d2_bb, d2_bn = gather_sqdist_blocks(d2, tried)
    return _packed_core(d2_bb, d2_bn, py, t, obs_mask, cand_mask, xi)


def bo_step_core_dense(
    encoded: torch.Tensor,  # (J, n, d) standardized features of the space
    obs_mask: torch.Tensor,  # (J, n) bool configurations already tried
    y: torch.Tensor,  # (J, n) observed costs, finite garbage where not observed
    cand_mask: torch.Tensor,  # (J, n) bool current candidate pool
    xi: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The full-extent BO step, 18 O(n³) factorizations a call:
    (pick, max_ei, best), each (J,).  The baseline the packed layouts are
    checked and timed against; neither engine runs it."""
    x = encoded.to(torch.float32)
    d2 = pairwise_sqdist(x)
    pm, best, ls_sel, chol, alpha, y_mean, y_std = _select(
        _masked_grid_factors(d2, y, obs_mask))
    ei = ei_from_sqdist(
        d2, pm, alpha, chol, ls_sel, y_mean, y_std, best, cand_mask & ~obs_mask, xi,
    )
    return torch.argmax(ei, -1), torch.amax(ei, -1), best


class FleetState(NamedTuple):
    """Search state with a leading job axis J, resident on one device.

    The packed buffers (`tried`, `py`, `feats`) have capacity B; slot k
    holds the k-th observation in trial order.
    """

    obs: torch.Tensor  # (J, n) bool observation mask
    tried: torch.Tensor  # (J, B) i32 trial log, -1 padded
    py: torch.Tensor  # (J, B) f32 packed observed costs
    feats: torch.Tensor  # (J, B, d) f32 packed features
    t: torch.Tensor  # (J,) i32 trials made
    stop: torch.Tensor  # (J,) i32 stop-criterion iteration, -1 = not yet
    pb: torch.Tensor  # (J,) i32 phase boundary, -1 = still in phase 0
    done: torch.Tensor  # (J,) bool
    last_ei: torch.Tensor  # (J,) f32 max EI of the latest BO step
    last_best: torch.Tensor  # (J,) f32 best observed cost at the latest step

    @classmethod
    def from_numpy(cls, arrays, device: DeviceLike = None) -> "FleetState":
        """State from numpy arrays, as a mapping or an object with these
        fields (a reference `FleetState` after `np.asarray` of each field).
        An unbatched state (``obs`` of rank 1) gains a job axis of 1."""
        dev = resolve_device(device)
        get = arrays.__getitem__ if isinstance(arrays, Mapping) else (
            lambda k: getattr(arrays, k))
        batched = np.asarray(get("obs")).ndim == 2
        out = {}
        for name, dtype in _FIELD_DTYPES.items():
            a = np.array(get(name), dtype)  # a copy: the state is updated in place
            out[name] = torch.from_numpy(a if batched else a[None]).to(dev)
        return cls(**out)

    def to_numpy(self) -> dict:
        """Each field as a numpy array, job axis kept."""
        return {k: v.detach().cpu().numpy() for k, v in self._asdict().items()}


_FIELD_DTYPES = {
    "obs": np.bool_, "tried": np.int32, "py": np.float32, "feats": np.float32,
    "t": np.int32, "stop": np.int32, "pb": np.int32, "done": np.bool_,
    "last_ei": np.float32, "last_best": np.float32,
}


def fleet_step(
    state: FleetState,
    geom: torch.Tensor,  # (J, n, d) f32 encoding [feature, fused] | (J, n, n) d2 [gather]
    costs: torch.Tensor,  # (J, n) f32 full observation table
    prio_mask: torch.Tensor,  # (J, n) bool priority pool (phase 0)
    rem_mask: torch.Tensor,  # (J, n) bool remaining pool (phase 1)
    init_picks: torch.Tensor,  # (J, I) i32 scripted random initialization
    init_count: torch.Tensor,  # (J,) i32
    max_trials: torch.Tensor,  # (J,) i32 trial budget
    min_obs: torch.Tensor,  # (J,) i32 no stopping before this many trials
    ei_stop_rel: torch.Tensor,  # (J,) f32 stop when max EI < rel·best
    to_exhaustion: torch.Tensor,  # (J,) bool record the stop but keep going
    xi: float = 0.0,
    layout: str = "feature",
) -> FleetState:
    """One search iteration per job: candidate pools → BO step → stop and
    phase bookkeeping → observation.  Semantics mirror the reference's
    `fleet_step` and `_bo_loop`; a no-op for a job that is done.

    Updates ``state``'s tensors in place and returns it: the state stays
    resident on its device across a whole search with no per-step copies
    (the role JAX buffer donation plays in the reference).  Nothing here
    waits for the device.

    ``layout`` "feature" and "fused" take the (J,n,d) encoding as ``geom``
    and keep the packed feature buffer; "gather" takes the (J,n,n) distance
    tensor and leaves ``state.feats`` untouched.
    """
    _check_layout(layout)
    obs, tried, py, feats, t = state.obs, state.tried, state.py, state.feats, state.t
    J, b = tried.shape
    rows = torch.arange(J, device=obs.device)

    budget_left = t < max_trials
    live = ~state.done & budget_left
    prio_left = prio_mask & ~obs
    rem_left = rem_mask & ~obs
    in_phase0 = prio_left.any(-1)
    cand = torch.where(in_phase0[:, None], prio_left, rem_left)
    has_cand = cand.any(-1)
    # Entering the remaining phase with a non-empty pool records the
    # boundary; gated on ~done only, not on the budget (as the reference).
    pb = torch.where(
        ~state.done & (state.pb < 0) & ~in_phase0 & rem_left.any(-1), t, state.pb
    )

    is_init = t < init_count
    if layout == "gather":
        bo_pick, max_ei, best = bo_step_core_gather(geom, tried, py, t, obs, cand, xi)
    else:
        step = bo_step_core if layout == "feature" else bo_step_core_fused
        bo_pick, max_ei, best = step(geom, feats, tried, py, t, obs, cand, xi)
    scripted = init_picks[rows, t.clamp(0, init_picks.shape[1] - 1).long()]
    pick = torch.where(is_init, scripted, bo_pick.to(torch.int32))

    fire = (
        live & has_cand & ~is_init & (state.stop < 0) & (t >= min_obs)
        & (max_ei < ei_stop_rel * best)
    )
    stop = torch.where(fire, t, state.stop)
    halt = fire & ~to_exhaustion
    observe = live & has_cand & ~halt

    slot = t.clamp(max=b - 1).long()
    pick_l = pick.long()
    obs[rows, pick_l] = obs[rows, pick_l] | observe
    tried[rows, slot] = torch.where(observe, pick, tried[rows, slot])
    py[rows, slot] = torch.where(observe, costs[rows, pick_l], py[rows, slot])
    if layout != "gather":
        feats[rows, slot] = torch.where(observe[:, None], geom[rows, pick_l], feats[rows, slot])
    # A job is done when its candidates ran out, its stop criterion halted
    # it, or its trial budget is exhausted.
    done = state.done | (live & (~has_cand | halt)) | ~budget_left
    t += observe.to(t.dtype)
    state.stop.copy_(stop)
    state.pb.copy_(pb)
    state.done.copy_(done)
    state.last_ei.copy_(torch.where(live, max_ei, state.last_ei))
    state.last_best.copy_(torch.where(live, best, state.last_best))
    return state


class SequentialProbe:
    """Device-resident sequential BO stepper over the shared `fleet_step`.

    Holds one J = 1 search state on the device across a whole search and
    updates it in place: per step one f32 scalar goes up (the latest
    observed cost) and (pick, max_ei, best) come back in one transfer.

    ``capacity`` is the trial budget (`bayesopt.trial_budget`), the static
    extent B of every (B,B) factorization.  ``layout`` is "feature", "fused"
    (the CUDA kernel on the card) or "gather" (the (n,n) distance tensor
    held on the device for the search's lifetime).

    The reference donates a batch-extent-2 state to a jitted probe
    (`_probe_step`); here the J = 1 state is updated in place, which needs
    neither.
    """

    def __init__(self, encoded, capacity: int, xi: float = 0.0,
                 layout: str = "feature", device: DeviceLike = None):
        _check_layout(layout)
        self._dev = resolve_device(device)
        enc = encode_features(encoded)
        self._n, self._d = enc.shape
        self._b = max(int(capacity), 1)
        self._xi = float(xi)
        self._layout = layout
        self._enc = enc
        dev = self._dev
        if layout == "gather":
            self._geom = precompute_d2(enc, dev)[None]
        else:
            self._geom = torch.from_numpy(np.ascontiguousarray(enc)).to(dev)[None]
        # Observation values are irrelevant inside the probe: the real cost
        # arrives with the next call and is patched into the packed buffer.
        self._costs = torch.zeros((1, self._n), dtype=torch.float32, device=dev)
        self._rem = torch.zeros((1, self._n), dtype=torch.bool, device=dev)
        self._init_picks = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        self._zero_i = torch.zeros(1, dtype=torch.int32, device=dev)  # no init, min_obs 0
        self._zero_f = torch.zeros(1, dtype=torch.float32, device=dev)  # never stops
        self._true = torch.ones(1, dtype=torch.bool, device=dev)  # never halts
        self._rows = torch.zeros(1, dtype=torch.long, device=dev)
        self._pool = None
        self._state = None

    def set_pool(self, pool_mask) -> None:
        """Install the current phase's candidate pool (one upload)."""
        self._pool = torch.from_numpy(np.array(pool_mask, bool)).to(self._dev)[None]

    def start(self, obs_mask, trial_order: Sequence[int], trial_costs) -> None:
        """Build the device state from the host-side search history."""
        k = len(trial_order)
        if k > self._b:
            raise ValueError(f"{k} observations exceed packed capacity {self._b}")
        order = np.asarray(trial_order, np.int32)
        tried = np.full(self._b, -1, np.int32)
        py = np.zeros(self._b, np.float32)
        feats = np.zeros((self._b, self._d), np.float32)
        tried[:k] = order
        py[:k] = np.asarray(trial_costs, np.float32)
        feats[:k] = self._enc[order]
        self._state = FleetState.from_numpy(
            {
                "obs": np.asarray(obs_mask, bool), "tried": tried, "py": py,
                "feats": feats, "t": np.int32(k), "stop": np.int32(-1),
                "pb": np.int32(-1), "done": np.bool_(False),
                "last_ei": np.float32(0.0), "last_best": np.float32(np.inf),
            },
            self._dev,
        )

    def step(self, last_cost: float) -> Tuple[int, float, float]:
        """One BO iteration.  Returns (pick_index, max_ei, best_observed)."""
        if self._state is None or self._pool is None:
            raise RuntimeError("call start() and set_pool() before step()")
        st, rows = self._state, self._rows
        t_prev = st.t.clone()
        # Slot t-1 holds a placeholder from the previous observation; the
        # real cost arrives now and is patched in before any math runs.
        slot = (t_prev - 1).clamp_min(0).long()
        cost = torch.tensor([last_cost], dtype=torch.float32).to(self._dev)
        st.py[rows, slot] = torch.where(t_prev > 0, cost, st.py[rows, slot])
        fleet_step(
            st, self._geom, self._costs, self._pool, self._rem, self._init_picks,
            self._zero_i, t_prev + 1, self._zero_i, self._zero_f, self._true,
            self._xi, self._layout,
        )
        pick = st.tried[rows, t_prev.clamp(max=self._b - 1).long()]
        out = torch.stack(
            [pick.double(), st.last_ei.double(), st.last_best.double()], -1
        )[0].tolist()
        return int(out[0]), float(out[1]), float(out[2])


def bo_step(
    encoded,
    obs_mask,
    y,
    cand_mask,
    xi: float = 0.0,
    *,
    trial_order: Optional[Sequence[int]] = None,
    capacity: Optional[int] = None,
    layout: str = "feature",
    device: DeviceLike = None,
) -> Tuple[int, float, float]:
    """One standalone BO iteration.  Returns (pick_index, max_ei, best).

    Packs the observed set in ascending index order unless ``trial_order``
    is given, and probes `fleet_step` once.  ``capacity`` defaults to the
    number of observations.
    """
    obs_mask = np.asarray(obs_mask, bool)
    y = np.asarray(y, np.float32)
    order = (
        np.asarray(trial_order, np.int64)
        if trial_order is not None
        else np.flatnonzero(obs_mask)
    )
    cap = int(capacity) if capacity is not None else max(1, len(order))
    probe = SequentialProbe(encoded, cap, xi=xi, layout=layout, device=device)
    probe.set_pool(cand_mask)
    probe.start(obs_mask, order, y[order])
    last = float(y[order][-1]) if len(order) else 0.0
    return probe.step(last)
