"""The port's SSD intra-chunk op (K3) against the JAX package's, on the CPU.

On the CPU the port's op takes the plain version (`ops.ssd_diag_plain`:
the kernel's arithmetic tile by tile, in torch).  It, the dispatching op
and the port's `ssd_diag_ref` are held against the reference's Pallas
kernel under the interpreter (``interpret=True``) and its `ssd_diag_ref`,
on identical numpy inputs, at the shapes of `tests/test_kernels.py` plus a
ragged one (Q, P and N off the kernel's tile multiples), with its
tolerances: rtol and atol 1e-4 (float32 sums in another order), against
the exact result (the oracle in float64).  Against the reference's own
float32 lanes the limit grows by the reference's distance from that exact
result: XLA's float32 cumsum over a 256-step chunk (log-decays summing to
-200) strays from the exact sum by up to 1.8e-5, which moves the
reference's result by up to 4.9e-4 (1.55 times its limit), where the
port's sequential sum strays by 7.5e-6 and stays within 0.012 of the limit
(ROADMAP Queue 3).
Gradients in x, B and C through the port's `autograd.Function` are held
against `jax.grad` through the reference's op at atol 1e-4, the
reference's own tolerance for its VJP against the oracle's.

The CUDA kernel itself runs only on the card: `tests/test_torch_cuda.py`
holds it against the plain version there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.ssd import ops as ref_ops
from repro.kernels.ssd import ref as ref_ref
from repro_torch.kernels.ssd import kernel as port_kernel
from repro_torch.kernels.ssd import ops as port_ops
from repro_torch.kernels.ssd.ref import ssd_diag_ref
from repro_torch.testing import assert_close

pytestmark = pytest.mark.kernel

SHAPES = [  # (b, nc, q, h, p, n), as in tests/test_kernels.py
    (1, 2, 8, 2, 16, 16),
    (2, 2, 64, 4, 32, 32),
    (1, 1, 128, 2, 64, 64),
    (1, 1, 256, 1, 64, 128),  # production chunk shape
    (1, 2, 100, 3, 20, 24),  # ragged: Q, P and N off the tile multiples
    (1, 1, 512, 2, 96, 192),  # past the Q 256, P 64, N 128 the card's kernel once took
]
TOL = dict(rtol=1e-4, atol=1e-4)


def inputs(seed, b, nc, q, h, p, n):
    """x, dt, lA, B, C as tests/test_kernels.py draws them, from numpy."""
    rng = np.random.default_rng(seed)

    def softplus(a):
        return np.logaddexp(a, 0.0).astype(np.float32)

    return (rng.standard_normal((b, nc, q, h, p)).astype(np.float32),
            softplus(rng.standard_normal((b, nc, q, h))),
            -softplus(rng.standard_normal((b, nc, q, h))),
            rng.standard_normal((b, nc, q, h, n)).astype(np.float32),
            rng.standard_normal((b, nc, q, h, n)).astype(np.float32))


def as_torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,nc,q,h,p,n", SHAPES)
def test_op_matches_reference_kernel_and_oracle(b, nc, q, h, p, n):
    a = inputs(q * h + n, b, nc, q, h, p, n)
    exact = ssd_diag_ref(*(t.double() for t in as_torch(a))).numpy()
    ref_kernel = np.asarray(ref_ops.ssd_diag_chunk(*map(jnp.asarray, a), True))
    ref_oracle = np.asarray(ref_ref.ssd_diag_ref(*map(jnp.asarray, a)))
    before = port_kernel.ssd_diag_cuda.launches
    got = port_ops.ssd_diag_chunk(*as_torch(a))
    assert port_kernel.ssd_diag_cuda.launches == before  # the CPU never launches
    assert got.shape == (b, nc, q, h, p) and got.dtype == torch.float32
    assert_close(exact, got.numpy(), **TOL, what="op vs exact")
    assert_close(exact, ssd_diag_ref(*as_torch(a)).numpy(), **TOL, what="port oracle vs exact")
    for what, ref in (("reference kernel", ref_kernel), ("reference oracle", ref_oracle)):
        limit = TOL["atol"] + TOL["rtol"] * np.abs(ref) + np.abs(ref - exact)
        assert (np.abs(got.numpy() - ref) <= limit).all(), f"op vs {what}"
    plain = port_ops.ssd_diag_plain(*as_torch(a))
    assert torch.equal(plain, got)  # the op's CPU route is the plain version


def test_plain_version_does_not_depend_on_its_tiles():
    a = as_torch(inputs(5, 1, 2, 256, 2, 64, 128))
    base = port_ops.ssd_diag_plain(*a)
    for bq, bk in ((8, 8), (16, 64), (64, 32), (256, 256), (100, 7)):
        got = port_ops.ssd_diag_plain(*a, block_q=bq, block_k=bk)
        # float32 rounding of sums of up to 256 terms in another grouping
        assert_close(base.numpy(), got.numpy(), rtol=1e-5, atol=1e-5, what=f"{bq}x{bk}")


def test_strong_decay_keeps_the_output_finite():
    """Large log-decays: the decay above the diagonal would overflow, and
    must not leak into the result."""
    x, dt, lA, B_, C_ = inputs(6, 1, 1, 64, 2, 8, 8)
    lA = 40.0 * lA
    got = port_ops.ssd_diag_chunk(*as_torch((x, dt, lA, B_, C_)))
    assert bool(torch.isfinite(got).all())
    assert_close(np.asarray(ref_ref.ssd_diag_ref(*map(jnp.asarray, (x, dt, lA, B_, C_)))),
                 got.numpy(), **TOL)


def test_head_broadcast_view_equals_a_copy():
    """B and C as a stride-0 view over heads (as `ssd_chunked` passes them)
    give what their head-expanded copies give."""
    x, dt, lA, B_, C_ = as_torch(inputs(7, 2, 2, 16, 4, 8, 8))
    Bg, Cg = B_[:, :, :, :1], C_[:, :, :, :1]
    view = port_ops.ssd_diag_chunk(x, dt, lA, Bg.expand_as(B_), Cg.expand_as(C_))
    copy = port_ops.ssd_diag_chunk(x, dt, lA, Bg.repeat(1, 1, 1, 4, 1), Cg.repeat(1, 1, 1, 4, 1))
    assert torch.equal(view, copy)


def test_gradients_match_reference():
    """As tests/test_kernels.py: d/d(x, B, C) of sum(y²), shape (1,1,8,2,4), N = 4."""
    a = inputs(9, 1, 1, 8, 2, 4, 4)
    ref = jax.grad(lambda *v: jnp.sum(ref_ops.ssd_diag_chunk(*v, True) ** 2),
                   argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, a))
    leaves = [t.requires_grad_() for t in as_torch(a)]
    (port_ops.ssd_diag_chunk(*leaves) ** 2).sum().backward()
    for name, r, t in zip(("x", "dt", "lA", "B", "C"), ref, leaves):
        assert_close(np.asarray(r), t.grad.numpy(), rtol=0.0, atol=1e-4, what=f"grad {name}")


def test_gradients_match_reference_at_q512():
    """d/d(x, dt, lA, B, C) of sum(y²) at Q = 512, P = 96, N = 192, where the
    gradients reach 5.7e5, held as the op is held: against the exact
    gradient (the port's oracle in float64) within 1e-6 of its largest
    component (float32 sums in another order), and against `jax.grad`
    through the reference's op within that plus the reference's own
    distance from the exact one (its float32 cumsum: 2.9e-5 of the largest
    component here)."""
    a = inputs(9, 1, 1, 512, 1, 96, 192)
    ref = jax.grad(lambda *v: jnp.sum(ref_ops.ssd_diag_chunk(*v, True) ** 2),
                   argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, a))
    leaves = [t.requires_grad_() for t in as_torch(a)]
    (port_ops.ssd_diag_chunk(*leaves) ** 2).sum().backward()
    exact = [t.double().requires_grad_() for t in as_torch(a)]
    (ssd_diag_ref(*exact) ** 2).sum().backward()
    for name, r, t, e in zip(("x", "dt", "lA", "B", "C"), ref, leaves, exact):
        got, want, r = t.grad.numpy(), e.grad.numpy(), np.asarray(r)
        tol = 1e-6 * np.abs(want).max()
        assert_close(want, got, rtol=0.0, atol=tol, what=f"grad {name} vs exact")
        assert (np.abs(got - r) <= tol + np.abs(r - want)).all(), f"grad {name} vs reference"


def test_grouped_b_and_c_equal_their_head_copies():
    """B and C per group, (..., G, N) with G dividing H (as `ssd_chunked`
    passes them): head h reads group h // (H // G), in the op and in its
    gradients, as the head-expanded copies give."""
    x, dt, lA, B_, C_ = as_torch(inputs(8, 1, 2, 16, 6, 4, 8))
    Bg, Cg = B_[:, :, :, :2], C_[:, :, :, :2]  # G = 2 groups of 3 heads
    grouped = [t.clone().requires_grad_() for t in (Bg, Cg)]
    copies = [t.repeat_interleave(3, dim=3).requires_grad_() for t in (Bg, Cg)]
    y_g = port_ops.ssd_diag_chunk(x, dt, lA, *grouped)
    y_c = port_ops.ssd_diag_chunk(x, dt, lA, *copies)
    assert torch.equal(y_g, y_c)
    (y_g ** 2).sum().backward()
    (y_c ** 2).sum().backward()
    for g, c in zip(grouped, copies):
        summed = c.grad.reshape(*c.shape[:3], 2, 3, c.shape[-1]).sum(4)
        assert_close(summed.numpy(), g.grad.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        port_ops.ssd_diag_chunk(x, dt, lA, B_[:, :, :, :4], C_[:, :, :, :4])


def test_dispatch_refuses_other_devices():
    a = as_torch(inputs(0, 1, 1, 8, 1, 4, 4))
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_ops.ssd_diag_chunk(*(t.to("meta") for t in a))
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_kernel.ssd_diag_cuda(a[0][0], a[1][0], a[2][0], a[3][0], a[4][0])
