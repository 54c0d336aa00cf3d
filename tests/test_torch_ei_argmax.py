"""The port's fused EI/argmax against the JAX package's `ei_argmax`.

On the CPU the port's dispatch takes the plain version
(`ops.ei_argmax_plain`, the twin of the reference's `lax.scan` lane); it is
held against the reference's scan lane AND its Pallas kernel under the
interpreter (``interpret=True``), on identical inputs: tile widths
128-1024, ragged n, manufactured cross-tile ties (the lowest index must
win), an all-masked pool, and garbage in the padded packed slots.  Picks
agree exactly or tie under the reference's EI (`testing.pick_agrees`);
max EI agrees at EI_RTOL/EI_ATOL.

The CUDA kernel itself runs only on the card: `tests/test_torch_cuda.py`
holds it against the plain version there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import fast_bo as ref_fast_bo
from repro.core.gp import pairwise_sqdist as ref_sqdist
from repro.kernels.ei_argmax import ei_argmax as ref_ei_argmax
from repro.kernels.ei_argmax.tile import ei_from_sqdist as ref_tail
from repro_torch.kernels import build
from repro_torch.kernels.ei_argmax import kernel as port_kernel
from repro_torch.kernels.ei_argmax.ops import _pick_tile, ei_argmax, ei_argmax_plain
from repro_torch.testing import EI_ATOL, EI_RTOL, assert_close, pick_agrees

pytestmark = pytest.mark.kernel

_REF_HEAD = jax.jit(ref_fast_bo._packed_head)
_REF_EI_ARGMAX = jax.jit(ref_ei_argmax, static_argnames=("tile", "interpret"))


@jax.jit
def _ref_full_ei(enc, mask, feats, pm, alpha, chol, ls, y_mean, y_std, best):
    return ref_tail(ref_sqdist(feats, enc), pm, alpha, chol, ls, y_mean, y_std, best, mask)


def _t(a):
    return torch.from_numpy(np.array(a))


def make_case(seed, n, d, k, cap, *, garbage=False):
    """Reference head outputs for a packed state, as numpy: the tail's
    inputs (enc, mask, feats, pm, alpha, chol, ls, y_mean, y_std, best)."""
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sum(enc**2, -1) + 0.3 * rng.normal(size=n)).astype(np.float32)
    picks = rng.choice(n, size=k, replace=False)
    tried = np.full(cap, -1, np.int32)
    tried[:k] = picks
    py = np.zeros(cap, np.float32)
    py[:k] = y[picks]
    feats = enc[np.maximum(tried, 0)]
    if garbage:
        g = np.random.default_rng(99)
        tried[k:] = g.integers(0, n, size=cap - k)
        py[k:] = 1e6 * g.standard_normal(cap - k)
        feats[k:] = 1e6 * g.standard_normal((cap - k, d))
    mask = np.ones(n, bool)
    mask[picks] = False
    d2_bb = jax.jit(ref_sqdist)(jnp.asarray(feats), jnp.asarray(enc[np.maximum(tried, 0)]))
    pm, best, ls, chol, alpha, y_mean, y_std = _REF_HEAD(
        d2_bb, jnp.asarray(py), jnp.asarray(k, jnp.int32))
    return [np.asarray(a) for a in
            (enc, mask, feats, pm, alpha, chol, ls, y_mean, y_std, best)]


def ref_full_ei(case):
    return np.asarray(_ref_full_ei(*(jnp.asarray(a) for a in case)))


def ref_lanes(case, tile):
    """(idx, val) from the reference's scan lane and its interpreted kernel."""
    args = [jnp.asarray(a) for a in case]
    return [_REF_EI_ARGMAX(*args, tile=tile, interpret=interp) for interp in (None, True)]


def port_plain(case, tile):
    """The port's pick: the CPU dispatch (which takes the plain version) at
    the default tile, the plain version itself at a set ``tile``."""
    args = [_t(a)[None] for a in case]
    idx, val = ei_argmax(*args) if tile is None else ei_argmax_plain(*args, tile=tile)
    return int(idx[0]), float(val[0])


def check_against_reference(case, tile=None, *, expect_idx=None):
    got_idx, got_val = port_plain(case, tile)
    ei = ref_full_ei(case)
    for lane, (r_idx, r_val) in zip(("scan", "interpret"), ref_lanes(case, tile)):
        assert pick_agrees(int(r_idx), got_idx, ei), (lane, int(r_idx), got_idx)
        assert_close(float(r_val), got_val, rtol=EI_RTOL, atol=EI_ATOL, what=f"{lane} max EI")
    if expect_idx is not None:
        assert got_idx == expect_idx
    return got_idx, got_val


@pytest.mark.parametrize("tile", [128, 256, 512, 1024])
def test_tile_widths(tile):
    """n = 1500 is ragged at every width: padding is exact."""
    check_against_reference(make_case(3, 1500, 3, 10, 16), tile)


@pytest.mark.parametrize("seed,n,d,k,cap", [
    (0, 69, 4, 40, 69), (1, 69, 5, 3, 24), (2, 600, 7, 24, 24), (3, 1025, 2, 5, 12),
    (4, 50, 2, 2, 2), (5, 200, 1, 5, 12),
])
def test_shapes_and_fills(seed, n, d, k, cap):
    """Paper-grid exhaustion, ragged n, the B = 2 / d = 2 edges, and d = 1
    (which the reference's engine never sends to its kernel; the port's
    kernel serves it)."""
    check_against_reference(make_case(seed, n, d, k, cap))


def test_pick_tile_matches_reference():
    from repro.kernels.ei_argmax.ops import _pick_tile as ref_pick_tile

    for n in (1, 69, 128, 129, 512, 1023, 1024, 1500, 131072):
        assert _pick_tile(n, None) == ref_pick_tile(n, None)
    assert _pick_tile(1500, 256) == 256
    with pytest.raises(ValueError):
        _pick_tile(10, 0)


def test_cross_tile_tie_takes_lowest_index():
    """A clone of the winning column three tiles later (and one three tiles
    earlier) computes the same EI bits: the lower index must win."""
    tile = 256
    case = make_case(5, 2048, 3, 6, 12)
    j1, _ = port_plain(case, tile)
    j2 = j1 - 3 * tile if j1 >= 3 * tile else j1 + 3 * tile
    case[0][j2] = case[0][j1]
    case[1][j2] = True
    check_against_reference(case, tile, expect_idx=min(j1, j2))


def test_all_masked_pool():
    case = make_case(7, 128, 3, 8, 16)
    case[1][:] = False
    idx, val = check_against_reference(case)
    assert idx == 0 and val == float("-inf")


def test_garbage_in_padded_slots_is_inert():
    clean = port_plain(make_case(4, 400, 4, 7, 20), None)
    dirty_case = make_case(4, 400, 4, 7, 20, garbage=True)
    assert check_against_reference(dirty_case) == clean


def test_plain_version_batches_jobs():
    """Rows of a J = 3 call are the J = 1 calls (batched BLAS calls may
    round differently, so at the EI tolerance)."""
    cases = [make_case(s, 300, 4, 6, 12) for s in (10, 11, 12)]
    batched = [torch.stack([_t(c[i]) for c in cases]) for i in range(10)]
    idx, val = ei_argmax_plain(*batched)
    for j, c in enumerate(cases):
        one_idx, one_val = port_plain(c, None)
        assert pick_agrees(one_idx, int(idx[j]), ref_full_ei(c))
        assert_close(one_val, float(val[j]), rtol=EI_RTOL, atol=EI_ATOL)


def test_cuda_dispatch_never_reaches_plain_version():
    """Only a CPU tensor takes the plain version: other devices raise, and
    the CUDA wrapper refuses CPU tensors instead of computing anything."""
    case = [_t(a)[None] for a in make_case(8, 100, 3, 4, 8)]
    meta = [a.to("meta") for a in case]
    with pytest.raises(ValueError):
        ei_argmax(*meta)
    scal = torch.stack([case[6], case[7], case[8], case[9]], -1)
    with pytest.raises(ValueError):
        port_kernel.ei_argmax_cuda(*case[:6], scal)
    assert port_kernel.ei_argmax_cuda.launches == 0


def test_missing_nvcc_raises(monkeypatch):
    """No fallback when the kernel cannot be built: a missing compiler raises."""
    monkeypatch.setattr(build.os, "access", lambda *a, **k: False)
    monkeypatch.setattr(build.shutil, "which", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()
