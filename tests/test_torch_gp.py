"""The port's GP math, acquisition and shared EI tail against the JAX package.

Inputs are made with numpy from fixed seeds and fed to both packages; the
port runs on the CPU.  Float outputs agree at the float32 tolerances of
`repro_torch.testing` (FLOAT_RTOL/FLOAT_ATOL for GP quantities, EI_RTOL/
EI_ATOL for EI values); discrete outputs (selected hyperparameters) agree
exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import acquisition as ref_acq
from repro.core import fast_bo as ref_fast_bo
from repro.core import gp as ref_gp
from repro.kernels.ei_argmax.tile import ei_from_sqdist as ref_tail
from repro_torch.core import acquisition as port_acq
from repro_torch.core import fast_bo as port_fast_bo
from repro_torch.core import gp as port_gp
from repro_torch.kernels.ei_argmax.tile import ei_from_sqdist as port_tail
from repro_torch.testing import EI_ATOL, EI_RTOL, FLOAT_ATOL, assert_close


def _t(a):
    return torch.from_numpy(np.array(a))


def random_case(seed, n=18, d=3, n_obs=6):
    """The oracle inputs of tests/test_core_bo.py."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    obs_idx = rng.choice(n, size=n_obs, replace=False)
    y = (np.sum(x**2, -1) + 0.3 * rng.normal(size=n)).astype(np.float32)
    return x, obs_idx, y


@pytest.mark.parametrize("seed", range(3))
def test_pairwise_sqdist_and_matern(seed):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=(12, 4)).astype(np.float32)
    x2 = rng.normal(size=(30, 4)).astype(np.float32)
    ref = np.asarray(ref_gp.pairwise_sqdist(jnp.asarray(x1), jnp.asarray(x2)))
    got = port_gp.pairwise_sqdist(_t(x1), _t(x2)).numpy()
    assert_close(ref, got, what="pairwise_sqdist")
    assert (got >= 0).all()
    for ls in port_gp.LENGTHSCALES:
        assert_close(
            np.asarray(ref_gp.matern52_from_sqdist(jnp.asarray(ref), ls)),
            port_gp.matern52_from_sqdist(_t(ref), ls).numpy(),
            what=f"matern52_from_sqdist ls={ls}",
        )
    rp = ref_gp.GPParams(lengthscale=jnp.float32(0.5), amplitude=jnp.float32(1.0),
                         noise=jnp.float32(1e-2))
    pp = port_gp.GPParams(lengthscale=torch.tensor(0.5), amplitude=torch.tensor(1.0),
                          noise=torch.tensor(1e-2))
    assert_close(
        np.asarray(ref_gp.matern52(jnp.asarray(x1), jnp.asarray(x2), rp)),
        port_gp.matern52(_t(x1), _t(x2), pp).numpy(), what="matern52",
    )


@jax.jit
def _ref_fit_predict(x_obs, y_obs, x):
    post = ref_gp.fit_gp(x_obs, y_obs)
    mean, std = ref_gp.gp_predict(post, x)
    return (post.params.lengthscale, post.params.noise, post.chol, post.alpha,
            post.y_mean, post.y_std, mean, std)


@pytest.mark.parametrize("seed", range(4))
def test_fit_gp_and_predict(seed):
    x, obs, y = random_case(seed)
    r_ls, r_nz, r_chol, r_alpha, r_mean, r_std, rm, rs = _ref_fit_predict(
        jnp.asarray(x[obs]), jnp.asarray(y[obs]), jnp.asarray(x))
    ppost = port_gp.fit_gp(_t(x[obs]), _t(y[obs]))
    assert float(r_ls) == float(ppost.params.lengthscale)
    assert float(r_nz) == float(ppost.params.noise)
    assert_close(np.asarray(r_chol), ppost.chol.numpy(), what="chol")
    assert_close(np.asarray(r_alpha), ppost.alpha.numpy(), what="alpha")
    assert_close(float(r_mean), float(ppost.y_mean), what="y_mean")
    assert_close(float(r_std), float(ppost.y_std), what="y_std")
    pm, ps = port_gp.gp_predict(ppost, _t(x))
    assert_close(np.asarray(rm), pm.numpy(), what="posterior mean")
    # var = 1 - |L^-1 k|^2 cancels near observed points: its error is
    # absolute (about 1e-7 of the prior variance), so compare variances.
    y_var = float(r_std) ** 2
    assert_close(np.asarray(rs) ** 2, ps.numpy() ** 2, atol=FLOAT_ATOL * y_var,
                 what="posterior variance")


@pytest.mark.parametrize("xi", [0.0, 0.05])
def test_acquisitions(xi):
    rng = np.random.default_rng(11)
    mean = rng.normal(1.0, 0.5, size=200).astype(np.float32)
    std = np.abs(rng.normal(0.0, 0.3, size=200)).astype(np.float32)
    std[:5] = 0.0  # the 1e-12 clamp
    best = np.float32(0.8)
    assert_close(
        np.asarray(ref_acq.expected_improvement(jnp.asarray(mean), jnp.asarray(std), best, xi)),
        port_acq.expected_improvement(_t(mean), _t(std), torch.tensor(best), xi).numpy(),
        rtol=EI_RTOL, atol=EI_ATOL, what="expected_improvement",
    )
    assert_close(
        np.asarray(ref_acq.probability_of_improvement(
            jnp.asarray(mean), jnp.asarray(std), best, xi)),
        port_acq.probability_of_improvement(_t(mean), _t(std), torch.tensor(best), xi).numpy(),
        what="probability_of_improvement",
    )


def packed_case(seed, n, d, k, capacity):
    """A packed BO-step instance (tests/test_ei_argmax_kernel.py's `_case`)."""
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sum(enc**2, -1) + 0.3 * rng.normal(size=n)).astype(np.float32)
    picks = rng.choice(n, size=k, replace=False)
    tried = np.full(capacity, -1, np.int32)
    tried[:k] = picks
    py = np.zeros(capacity, np.float32)
    py[:k] = y[picks]
    obs = np.zeros(n, bool)
    obs[picks] = True
    feats = enc[np.maximum(tried, 0)]
    return enc, feats, tried, py, np.int32(k), obs, np.ones(n, bool)


@pytest.mark.parametrize("seed,n,d,k,cap", [
    (0, 69, 4, 3, 69), (1, 69, 4, 40, 69), (2, 200, 5, 10, 10), (3, 150, 2, 7, 16),
])
def test_packed_head_and_ei_tail(seed, n, d, k, cap):
    """The extent-B head (selection, factors) and the shared EI tail, with
    the reference's head outputs fed to both tails."""
    enc, feats, tried, py, t, obs, cand = packed_case(seed, n, d, k, cap)
    r_bb, r_bn = jax.jit(ref_fast_bo.packed_sqdist_blocks)(
        jnp.asarray(feats), jnp.asarray(enc), jnp.asarray(tried))
    p_bb, p_bn = port_fast_bo.packed_sqdist_blocks(_t(feats)[None], _t(enc)[None],
                                                   _t(tried)[None])
    assert_close(np.asarray(r_bb), p_bb[0].numpy(), what="d2_bb")
    assert_close(np.asarray(r_bn), p_bn[0].numpy(), what="d2_bn")
    rh = jax.jit(ref_fast_bo._packed_head)(r_bb, jnp.asarray(py), jnp.asarray(t))
    ph = port_fast_bo._packed_head(_t(np.asarray(r_bb))[None], _t(py)[None],
                                   torch.tensor([int(t)], dtype=torch.int32))
    names = ("pm", "best", "ls_sel", "chol", "alpha", "y_mean", "y_std")
    assert float(rh[2]) == float(ph[2][0]), "selected lengthscale"
    for name, a, b in zip(names, rh, ph):
        assert_close(np.asarray(a), b[0].numpy(), what=name)
    mask = cand & ~obs
    ref_ei = np.asarray(jax.jit(ref_tail)(r_bn, rh[0], rh[4], rh[3], rh[2], rh[5], rh[6],
                                          rh[1], jnp.asarray(mask)))
    args = [_t(np.asarray(a))[None] for a in (rh[0], rh[4], rh[3], rh[2], rh[5], rh[6], rh[1])]
    got_ei = port_tail(_t(np.asarray(r_bn))[None], *args, _t(mask)[None])[0].numpy()
    assert_close(ref_ei, got_ei, rtol=EI_RTOL, atol=EI_ATOL, what="EI tail")
    assert np.isneginf(got_ei[~mask]).all()
