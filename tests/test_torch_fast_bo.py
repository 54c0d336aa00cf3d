"""The port's packed BO step and search-state update against the JAX package.

Seeded reference `FleetState`s are carried into the port with
`FleetState.from_numpy` (each field through `np.asarray`); one BO step of
each layout (feature, fused, gather, and the dense baseline), a run of
`fleet_step` calls, and the standalone `bo_step` must agree with the
reference's: picks exactly or as a certified EI tie
(`testing.pick_agrees`), floats at the tolerances of `repro_torch.testing`.
The gather layout's (n,n) tensor and blocks agree with the reference's to
FLOAT_RTOL/FLOAT_ATOL, and the port's feature and gather layouts agree
with each other to EI_RTOL/EI_ATOL (their distance blocks come from two
matmul shapes, (B,d)·(d,n) and (n,d)·(d,n), which may round differently).
A forced Cholesky failure in `_packed_head` must select the same grid
point as the reference; when every factorization fails, both of the
port's layouts must pick what the reference's feature layout picks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import fast_bo as ref
from repro.core.gp import matern52_from_sqdist as ref_matern
from repro.kernels.ei_argmax.tile import ei_from_sqdist as ref_tail
from repro_torch.core import fast_bo as port
from repro_torch.testing import EI_ATOL, EI_RTOL, assert_close, pick_agrees, tied_grid_points


@jax.jit
def ref_grid(d2_bb, py, t):
    """The reference's `_packed_head` at all 18 grid points, with its own
    ops: (pm, best, y_mean, y_std, ls18, lmls, chols, alphas)."""
    b = py.shape[0]
    pmask = jnp.arange(b) < t
    pm = pmask.astype(jnp.float32)
    py = py.astype(jnp.float32)
    n_obs = jnp.maximum(jnp.sum(pm), 1.0)
    y_mean = jnp.sum(py * pm) / n_obs
    y_std = jnp.maximum(jnp.sqrt(jnp.sum(pm * (py - y_mean) ** 2) / n_obs), 1e-8)
    y_train = jnp.where(pmask, (py - y_mean) / y_std, 0.0)
    ls = jnp.asarray(ref._LENGTHSCALES, jnp.float32)
    nz = jnp.asarray(ref._NOISES, jnp.float32)
    ks = jax.vmap(lambda l: ref_matern(d2_bb, l))(ls) * (pm[:, None] * pm[None, :])[None]
    idx = jnp.arange(b)

    def factorize(k_masked, noise):
        k_eff = k_masked.at[idx, idx].add(jnp.where(pmask, noise + ref._JITTER, 1.0))
        chol = jnp.linalg.cholesky(k_eff)
        alpha = jax.scipy.linalg.cho_solve((chol, True), y_train)
        lml = (-0.5 * y_train @ alpha - jnp.sum(jnp.log(jnp.diagonal(chol)) * pm)
               - 0.5 * jnp.sum(pm) * jnp.log(2.0 * jnp.pi))
        return lml, chol, alpha

    lmls, chols, alphas = jax.vmap(factorize)(jnp.repeat(ks, 3, axis=0), jnp.tile(nz, 6))
    lmls = jnp.where(jnp.isfinite(lmls), lmls, -jnp.inf)
    best = jnp.min(jnp.where(pmask, py, jnp.inf))
    return pm, best, y_mean, y_std, jnp.repeat(ls, 3), lmls, chols, alphas


@jax.jit
def _ref_all_rows(enc, feats, tried, py, t, obs, cand):
    """EI under each of the 18 grid points, their likelihoods, best cost."""
    d2_bb, d2_bn = ref.packed_sqdist_blocks(feats, enc, tried)
    pm, best, y_mean, y_std, ls18, lmls, chols, alphas = ref_grid(d2_bb, py, t)
    eis = jax.vmap(lambda a, c, l: ref_tail(d2_bn, pm, a, c, l, y_mean, y_std, best,
                                            cand & ~obs))(alphas, chols, ls18)
    return eis, lmls, best


def ref_ei_rows(enc, feats, tried, py, t, obs, cand):
    """The reference's EI over the space, one row per grid point tied with
    the selected one (`testing.tied_grid_points`), and the best cost."""
    eis, lmls, best = _ref_all_rows(*(jnp.asarray(a) for a in
                                      (enc, feats, tried, py, t, obs, cand)))
    return np.asarray(eis)[tied_grid_points(np.asarray(lmls))], float(best)


def ref_state(seed, n, d, k, cap):
    """A seeded reference FleetState (k observed of capacity cap) with its
    encoding, a candidate pool and a cost table, all numpy."""
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(n, d)).astype(np.float32)
    costs = (np.sum(enc**2, -1) + 1.0 + 0.3 * rng.normal(size=n)).astype(np.float32)
    picks = rng.choice(n, size=k, replace=False)
    tried = np.full(cap, -1, np.int32)
    tried[:k] = picks
    py = np.zeros(cap, np.float32)
    py[:k] = costs[picks]
    feats = np.zeros((cap, d), np.float32)
    feats[:k] = enc[picks]
    obs = np.zeros(n, bool)
    obs[picks] = True
    state = ref.FleetState(
        obs=jnp.asarray(obs), tried=jnp.asarray(tried), py=jnp.asarray(py),
        feats=jnp.asarray(feats), t=jnp.asarray(k, jnp.int32),
        stop=jnp.asarray(-1, jnp.int32), pb=jnp.asarray(-1, jnp.int32),
        done=jnp.asarray(False), last_ei=jnp.asarray(0.0, jnp.float32),
        last_best=jnp.asarray(np.inf, jnp.float32),
    )
    cand = rng.random(n) < 0.7
    return state, enc, costs, cand


def to_port(state):
    return port.FleetState.from_numpy({k: np.asarray(v) for k, v in state._asdict().items()},
                                      device="cpu")


def ref_ei_vector(state, enc, cand):
    """The reference's EI over the space for a state (rows per tied grid point)."""
    return ref_ei_rows(enc, state.feats, state.tried, state.py, state.t, state.obs, cand)[0]


_REF_STEP = {"feature": jax.jit(ref.bo_step_core), "fused": jax.jit(ref.bo_step_core_fused)}
_REF_FLEET_STEP = jax.jit(ref.fleet_step, static_argnames=("xi", "layout"))
_REF_HEAD = jax.jit(ref._packed_head)
CASES = [(0, 69, 4, 3, 69), (1, 69, 4, 30, 69), (2, 300, 5, 8, 12), (3, 150, 2, 1, 6),
         (4, 200, 1, 6, 10), (5, 129, 6, 2, 2)]


def test_state_round_trip():
    state, *_ = ref_state(0, 50, 3, 5, 8)
    p = to_port(state)
    back = p.to_numpy()
    for name, v in state._asdict().items():
        a = np.asarray(v)
        assert back[name].shape == (1,) + a.shape
        assert back[name].dtype == a.dtype, name
        assert np.array_equal(back[name][0], a), name


@pytest.mark.parametrize("layout", ["feature", "fused"])
@pytest.mark.parametrize("seed,n,d,k,cap", CASES)
def test_bo_step_core_per_call(layout, seed, n, d, k, cap):
    state, enc, _, cand = ref_state(seed, n, d, k, cap)
    ref_fn = _REF_STEP[layout]
    r_pick, r_ei, r_best = ref_fn(jnp.asarray(enc), state.feats, state.tried, state.py,
                                  state.t, state.obs, jnp.asarray(cand))
    p = to_port(state)
    port_fn = port.bo_step_core if layout == "feature" else port.bo_step_core_fused
    g_pick, g_ei, g_best = port_fn(torch.from_numpy(enc)[None], p.feats, p.tried, p.py, p.t,
                                   p.obs, torch.from_numpy(cand)[None])
    assert pick_agrees(int(r_pick), int(g_pick[0]), ref_ei_vector(state, enc, cand))
    assert_close(float(r_ei), float(g_ei[0]), rtol=EI_RTOL, atol=EI_ATOL, what="max EI")
    assert float(r_best) == float(g_best[0])


def test_fused_and_feature_agree_on_a_job_batch():
    """J = 3 different states in one call of each port layout."""
    states = [ref_state(20 + j, 120, 3, 4 + j, 10) for j in range(3)]
    ports = [to_port(st) for st, *_ in states]
    enc = torch.stack([torch.from_numpy(e) for _, e, _, _ in states])
    cand = torch.stack([torch.from_numpy(c) for *_, c in states])
    batch = [torch.cat([getattr(p, f) for p in ports]) for f in ("feats", "tried", "py", "t", "obs")]
    feat = port.bo_step_core(enc, *batch, cand)
    fused = port.bo_step_core_fused(enc, *batch, cand)
    for j, (st, e, _, c) in enumerate(states):
        ei = ref_ei_vector(st, e, c)
        assert pick_agrees(int(feat[0][j]), int(fused[0][j]), ei)
        assert_close(float(feat[1][j]), float(fused[1][j]), rtol=EI_RTOL, atol=EI_ATOL)
        assert float(feat[2][j]) == float(fused[2][j])


def _head_pick(d2_bb, py, t):
    rh = _REF_HEAD(jnp.asarray(d2_bb), jnp.asarray(py), jnp.asarray(t, jnp.int32))
    ph = port._packed_head(torch.from_numpy(d2_bb)[None], torch.from_numpy(py)[None],
                           torch.tensor([t], dtype=torch.int32))
    return rh, ph


@pytest.mark.parametrize("near", [0.0, 0.2])
def test_forced_cholesky_failure_selects_reference_grid_point(near):
    """A non-metric distance block (0~1 and 1~2 near, 0~2 far) makes
    K + noise·I indefinite: at near = 0 for every grid point (both pick
    grid point 0, lengthscale 0.1, and its factor is NaN), at near = 0.2
    only for the long lengthscales (both pick the same surviving point).
    `cholesky_ex`'s finite partial factor must not be selected."""
    far = 1e6
    d2 = np.array([[0, near, far], [near, 0, near], [far, near, 0]], np.float32)
    py = np.array([1.0, 2.0, 0.5], np.float32)
    rh, ph = _head_pick(d2, py, 3)
    assert float(rh[2]) == float(ph[2][0])
    ref_chol, port_chol = np.asarray(rh[3]), ph[3][0].numpy()
    assert np.array_equal(np.isnan(ref_chol), np.isnan(port_chol))
    if near == 0.0:
        assert float(ph[2][0]) == float(np.float32(0.1)) and np.isnan(port_chol[np.tril_indices(3)]).all()
    else:
        assert np.isfinite(port_chol).all()
        assert_close(ref_chol, port_chol)
        assert_close(np.asarray(rh[4]), ph[4][0].numpy())


def test_all_failed_cholesky_fused_pick_matches_reference_feature_layout(monkeypatch):
    """When all 18 factorizations fail, EI is NaN at every unmasked
    candidate.  The reference's feature layout then picks the lowest
    unmasked index (`jnp.argmax` takes the first NaN); its fused lane's
    fold keeps the -inf start and returns index 0.  The port's fused pick,
    kernel or plain version, follows the feature layout: both of the
    port's layouts must give the reference feature layout's pick."""
    d2_bad = np.array([[0, 0, 1e6], [0, 0, 0], [1e6, 0, 0]], np.float32)
    n, d = 40, 2
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(n, d)).astype(np.float32)
    tried = np.array([5, 9, 30], np.int32)
    py = np.array([1.0, 2.0, 0.5], np.float32)
    obs = np.zeros(n, bool)
    obs[tried] = True
    cand = np.ones(n, bool)
    cand[:3] = False  # the lowest unmasked index is 3, not 0
    ref_head, port_head = ref._packed_head, port._packed_head
    monkeypatch.setattr(ref, "_packed_head", lambda d2_bb, py, t: ref_head(jnp.asarray(d2_bad), py, t))
    monkeypatch.setattr(port, "_packed_head",
                        lambda d2_bb, py, t: port_head(torch.from_numpy(d2_bad)[None], py, t))
    r_args = (jnp.asarray(enc), jnp.asarray(enc[tried]), jnp.asarray(tried), jnp.asarray(py),
              jnp.asarray(3, jnp.int32), jnp.asarray(obs), jnp.asarray(cand))
    # Fresh jits, traced after the patch: both call the patched head.
    r_pick, r_ei, _ = jax.jit(ref.bo_step_core)(*r_args)
    r_fused_pick, _, _ = jax.jit(ref.bo_step_core_fused)(*r_args)
    assert int(r_pick) == 3 and np.isnan(float(r_ei))
    assert int(r_fused_pick) == 0  # the reference fused lane's departure
    p_args = [torch.from_numpy(np.array(a))[None] for a in r_args]
    p_args[4] = p_args[4].reshape(1)
    for step in (port.bo_step_core, port.bo_step_core_fused):
        g_pick, g_ei, _ = step(*p_args)
        assert int(g_pick[0]) == int(r_pick), step.__name__
        assert torch.isnan(g_ei[0]), step.__name__


def test_fleet_step_run_matches_reference():
    """Eight `fleet_step` calls of a two-phase search with scripted init
    picks, the stop criterion armed, from the same state on both sides."""
    n, d, cap = 60, 3, 12
    state, enc, costs, _ = ref_state(7, n, d, 0, cap)
    prio = np.zeros(n, bool)
    prio[:15] = True
    args = dict(geom=enc, costs=costs, prio_mask=prio, rem_mask=~prio,
                init_picks=np.array([3, 9, 1], np.int32), init_count=np.int32(3),
                max_trials=np.int32(cap), min_obs=np.int32(4),
                ei_stop_rel=np.float32(0.10), to_exhaustion=np.bool_(True))
    ref_args = {k: jnp.asarray(v) for k, v in args.items()}
    port_args = {k: torch.from_numpy(np.array(v))[None] for k, v in args.items()}
    p = to_port(state)
    for layout in ("feature", "fused"):
        rs, ps = state, to_port(state)
        for step in range(8):
            ei = ref_ei_vector(rs, enc, np.asarray(ref_args["prio_mask"] if
                               bool(np.any(prio & ~np.asarray(rs.obs))) else ~prio))
            rs = _REF_FLEET_STEP(rs, layout=layout, **ref_args)
            port.fleet_step(ps, layout=layout, **port_args)
            got = ps.to_numpy()
            r_pick = int(np.asarray(rs.tried)[step])
            g_pick = int(got["tried"][0, step])
            if r_pick != g_pick:  # a certified tie ends the comparison
                assert step >= 3 and pick_agrees(r_pick, g_pick, ei), (layout, step)
                break
            for name in ("obs", "tried", "py", "feats", "t", "stop", "pb", "done", "last_best"):
                assert np.array_equal(got[name][0], np.asarray(getattr(rs, name))), (name, step)
            assert_close(float(rs.last_ei), float(got["last_ei"][0]), rtol=EI_RTOL, atol=EI_ATOL)
    assert p.t.item() == 0  # from_numpy copies: the reference state was not touched


@pytest.mark.parametrize("layout", ["feature", "fused", "gather"])
@pytest.mark.parametrize("seed", range(3))
def test_standalone_bo_step(layout, seed):
    state, enc, costs, cand = ref_state(30 + seed, 90, 4, 6, 9)
    obs = np.asarray(state.obs)
    order = np.asarray(state.tried)[:6]
    r = ref.bo_step(enc, obs, costs, cand, trial_order=order, capacity=9)
    g = port.bo_step(enc, obs, costs, cand, trial_order=order, capacity=9,
                     layout=layout, device="cpu")
    assert pick_agrees(r[0], g[0], ref_ei_vector(state, enc, cand))
    assert_close(r[1], g[1], rtol=EI_RTOL, atol=EI_ATOL)
    assert r[2] == g[2]


def test_unknown_layout_raises():
    with pytest.raises(ValueError):
        port.SequentialProbe(np.zeros((4, 2)), 3, layout="sparse", device="cpu")


_REF_GATHER = jax.jit(ref.bo_step_core_gather)
_REF_DENSE = jax.jit(ref.bo_step_core_dense)


@pytest.mark.parametrize("seed,n,d,k,cap", CASES)
def test_gather_tensor_and_blocks(seed, n, d, k, cap):
    state, enc, _, _ = ref_state(seed, n, d, k, cap)
    r_d2 = np.array(ref.precompute_d2(enc))  # writable, for torch.from_numpy
    g_d2 = port.precompute_d2(enc, device="cpu")
    assert g_d2.shape == (n, n) and g_d2.dtype == torch.float32
    assert_close(r_d2, g_d2.numpy(), what="precompute_d2")
    r_bb, r_bn = ref.gather_sqdist_blocks(jnp.asarray(r_d2), state.tried)
    # The same tensor on both sides: the gathers are exact.
    g_bb, g_bn = port.gather_sqdist_blocks(torch.from_numpy(r_d2)[None], to_port(state).tried)
    assert np.array_equal(np.asarray(r_bb), g_bb[0].numpy())
    assert np.array_equal(np.asarray(r_bn), g_bn[0].numpy())
    # Against the feature layout's blocks, within the float tolerance.
    p = to_port(state)
    f_bb, f_bn = port.packed_sqdist_blocks(p.feats, torch.from_numpy(enc)[None], p.tried)
    pm = np.arange(cap) < k  # padded slots gather different garbage
    assert_close(f_bb[0].numpy()[np.ix_(pm, pm)], g_bb[0].numpy()[np.ix_(pm, pm)])
    assert_close(f_bn[0].numpy()[pm], g_bn[0].numpy()[pm])


@pytest.mark.parametrize("seed,n,d,k,cap", CASES)
def test_bo_step_core_gather_per_call(seed, n, d, k, cap):
    state, enc, _, cand = ref_state(seed, n, d, k, cap)
    r_d2 = ref.precompute_d2(enc)
    r_pick, r_ei, r_best = _REF_GATHER(r_d2, state.tried, state.py, state.t, state.obs,
                                       jnp.asarray(cand))
    p = to_port(state)
    g_pick, g_ei, g_best = port.bo_step_core_gather(
        port.precompute_d2(enc, device="cpu")[None], p.tried, p.py, p.t, p.obs,
        torch.from_numpy(cand)[None])
    ei = ref_ei_vector(state, enc, cand)
    assert pick_agrees(int(r_pick), int(g_pick[0]), ei)
    assert_close(float(r_ei), float(g_ei[0]), rtol=EI_RTOL, atol=EI_ATOL, what="max EI")
    assert float(r_best) == float(g_best[0])
    # The port's feature layout on the same state, within the EI tolerance.
    f_pick, f_ei, f_best = port.bo_step_core(torch.from_numpy(enc)[None], p.feats, p.tried,
                                             p.py, p.t, p.obs, torch.from_numpy(cand)[None])
    assert pick_agrees(int(f_pick[0]), int(g_pick[0]), ei)
    assert_close(float(f_ei[0]), float(g_ei[0]), rtol=EI_RTOL, atol=EI_ATOL)
    assert float(f_best[0]) == float(g_best[0])


@pytest.mark.parametrize("seed,n,d,k", [(0, 40, 3, 5), (1, 69, 4, 12), (2, 50, 1, 3),
                                        (3, 64, 6, 30)])
def test_bo_step_core_dense(seed, n, d, k):
    """The full-extent baseline, one job and a batch of two, against the
    reference's dense step: picks tie under the reference's EI, max EI
    within EI_RTOL/EI_ATOL, best exact."""
    state, enc, costs, cand = ref_state(seed, n, d, k, k)
    obs = np.asarray(state.obs)
    y = np.where(obs, costs, 7.0).astype(np.float32)  # finite garbage where unobserved
    r_pick, r_ei, r_best = _REF_DENSE(jnp.asarray(enc), jnp.asarray(obs), jnp.asarray(y),
                                      jnp.asarray(cand))
    T = lambda a: torch.from_numpy(np.stack([a, a]))  # noqa: E731
    g_pick, g_ei, g_best = port.bo_step_core_dense(T(enc), T(obs), T(y), T(cand))
    ei = ref_ei_vector(state, enc, cand)
    for j in range(2):
        assert pick_agrees(int(r_pick), int(g_pick[j]), ei)
        assert_close(float(r_ei), float(g_ei[j]), rtol=EI_RTOL, atol=EI_ATOL, what="max EI")
        assert float(r_best) == float(g_best[j])


@pytest.mark.parametrize("ls,noise", [(0.5, 1e-2), (1.0, 1e-1), (2.0, 1e-2)])
def test_masked_posterior(ls, noise):
    rng = np.random.default_rng(11)
    n, d = 30, 3
    x = rng.normal(size=(n, d)).astype(np.float32)
    obs = rng.random(n) < 0.4
    y_n = np.where(obs, rng.normal(size=n), 0.0).astype(np.float32)
    r = ref._masked_posterior(jnp.asarray(x), jnp.asarray(obs), jnp.asarray(y_n),
                              jnp.asarray(ls, jnp.float32), jnp.asarray(noise, jnp.float32))
    g = port._masked_posterior(torch.from_numpy(x), torch.from_numpy(obs), torch.from_numpy(y_n),
                               torch.tensor(ls), torch.tensor(noise))
    for what, a, b in zip(("lml", "mean", "var"), r, g):
        assert_close(np.asarray(a), b.numpy(), what=what)


def test_gather_fleet_step_run_matches_reference():
    """`test_fleet_step_run_matches_reference` in the gather layout: the
    (n,n) tensor as geometry, and the feature buffer left untouched."""
    n, d, cap = 60, 3, 12
    state, enc, costs, _ = ref_state(7, n, d, 0, cap)
    prio = np.zeros(n, bool)
    prio[:15] = True
    args = dict(costs=costs, prio_mask=prio, rem_mask=~prio,
                init_picks=np.array([3, 9, 1], np.int32), init_count=np.int32(3),
                max_trials=np.int32(cap), min_obs=np.int32(4),
                ei_stop_rel=np.float32(0.10), to_exhaustion=np.bool_(True))
    ref_args = {k: jnp.asarray(v) for k, v in args.items()}
    port_args = {k: torch.from_numpy(np.array(v))[None] for k, v in args.items()}
    rs, ps = state, to_port(state)
    r_d2, g_d2 = ref.precompute_d2(enc), port.precompute_d2(enc, device="cpu")[None]
    feats0 = ps.feats.clone()
    matched = 0
    for step in range(10):
        ei = ref_ei_vector(rs, enc, prio if bool(np.any(prio & ~np.asarray(rs.obs))) else ~prio)
        rs = _REF_FLEET_STEP(rs, geom=r_d2, layout="gather", **ref_args)
        port.fleet_step(ps, geom=g_d2, layout="gather", **port_args)
        got = ps.to_numpy()
        r_pick = int(np.asarray(rs.tried)[step])
        g_pick = int(got["tried"][0, step])
        if r_pick != g_pick:  # a certified tie ends the comparison
            assert step >= 3 and pick_agrees(r_pick, g_pick, ei), step
            break
        matched += 1
        for name in ("obs", "tried", "py", "t", "stop", "pb", "done", "last_best"):
            assert np.array_equal(got[name][0], np.asarray(getattr(rs, name))), (name, step)
        assert_close(float(rs.last_ei), float(got["last_ei"][0]), rtol=EI_RTOL, atol=EI_ATOL)
    assert matched >= 6
    assert torch.equal(ps.feats, feats0)
