"""The port's hand-written CUDA kernels against their plain versions, on the card.

These tests need a CUDA card (and `nvcc` to build the kernel at first
use); without one they skip with the reason.  They import neither JAX nor
the JAX package, so they run on a machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py

`chip_smoke.py` makes the same comparison at the main path's shapes and
times both.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import fast_bo
from repro_torch.core.gp import pairwise_sqdist
from repro_torch.kernels.ei_argmax import kernel
from repro_torch.kernels.ei_argmax.ops import ei_argmax, ei_argmax_plain
from repro_torch.kernels.ei_argmax.tile import ei_from_sqdist
from repro_torch.testing import EI_ATOL, EI_RTOL, assert_close, pick_agrees

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is built by nvcc and runs only there")
    return torch.device("cuda")


def case(dev, seed, n, d, k, cap):
    """Tail inputs for a packed state, from the port's own head, on ``dev``."""
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sum(enc**2, -1) + 0.3 * rng.normal(size=n)).astype(np.float32)
    picks = rng.choice(n, size=k, replace=False)
    tried = np.full(cap, -1, np.int32)
    tried[:k] = picks
    py = np.zeros(cap, np.float32)
    py[:k] = y[picks]
    mask = np.ones(n, bool)
    mask[picks] = False
    enc_t = torch.from_numpy(enc).to(dev)[None]
    feats = enc_t[:, np.maximum(tried, 0)]
    d2_bb = pairwise_sqdist(feats, feats)
    pm, best, ls, chol, alpha, y_mean, y_std = fast_bo._packed_head(
        d2_bb, torch.from_numpy(py).to(dev)[None], torch.tensor([k], dtype=torch.int32, device=dev))
    return (enc_t, torch.from_numpy(mask).to(dev)[None], feats, pm, alpha, chol,
            ls, y_mean, y_std, best)


@pytest.mark.parametrize("seed,n,d,k,cap", [
    (0, 69, 4, 40, 69), (1, 1500, 6, 24, 24), (2, 200, 1, 5, 12), (3, 2000, 4, 100, 128),
    (4, 130, 6, 2, 2),
])
def test_kernel_matches_plain_version(dev, seed, n, d, k, cap):
    args = case(dev, seed, n, d, k, cap)
    before = kernel.ei_argmax_cuda.launches
    k_idx, k_val = ei_argmax(*args)
    p_idx, p_val = ei_argmax_plain(*args)
    torch.cuda.synchronize()
    assert kernel.ei_argmax_cuda.launches == before + 1
    full = ei_from_sqdist(pairwise_sqdist(args[2], args[0]), *args[3:], args[1])
    assert pick_agrees(int(p_idx[0]), int(k_idx[0]), full[0].cpu().numpy())
    assert_close(float(p_val[0]), float(k_val[0]), rtol=EI_RTOL, atol=EI_ATOL)


def test_kernel_rejects_what_it_cannot_take(dev):
    args = list(case(dev, 5, 300, 3, 5, 8))
    scal = torch.stack([args[6], args[7], args[8], args[9]], -1)
    with pytest.raises(TypeError):
        kernel.ei_argmax_cuda(args[0].double(), *args[1:6], scal)
    with pytest.raises(ValueError):
        kernel.ei_argmax_cuda(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                              *args[1:6], scal)
