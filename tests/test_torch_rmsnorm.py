"""The port's fused-RMSNorm op (K4) against the JAX package's, on the CPU.

On the CPU the port's op takes the plain version (`ops.rmsnorm_plain`: the
kernel's arithmetic per row, in torch).  It, the dispatching op and the
port's `rmsnorm_ref` are held against the reference's Pallas kernel under
the interpreter (``rmsnorm(x, s, 1e-6, 256, True)``: rows padded to its
256-row tile) and its `rmsnorm_ref`, on identical numpy inputs, at the
shapes of `tests/test_kernels.py` (one of them padded, one with fewer rows
than a tile) and an nd input.  Tolerances: float32 1e-5 absolute, the
reference's own (sums of squares in another order); bfloat16 one step of
the output (2^-7 relative): both round the same float32 value once, and a
float32 difference in the last bits can only carry it across one rounding
boundary.  Gradients in x and scale through the port's
`autograd.Function` are held against `jax.grad` through the reference's op
at 1e-4 absolute, the reference's own tolerance for its VJP.

The CUDA kernel itself runs only on the card: `tests/test_torch_cuda.py`
holds it against the plain version there.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.rmsnorm import ops as ref_ops
from repro.kernels.rmsnorm import ref as ref_ref
from repro_torch.kernels.rmsnorm import kernel as port_kernel
from repro_torch.kernels.rmsnorm import ops as port_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.testing import assert_close

pytestmark = pytest.mark.kernel

SHAPES = [  # (x shape, dtype), as in tests/test_kernels.py
    ((256, 64), "float32"),
    ((300, 128), "float32"),  # the reference pads to 512 rows
    ((512, 384), "bfloat16"),
    ((64, 1024), "float32"),  # fewer rows than the reference's tile
    ((2, 7, 96), "float32"),  # nd input, flattened to 14 rows
]
TOL = {"float32": dict(rtol=0.0, atol=1e-5), "bfloat16": dict(rtol=2.0**-7, atol=0.0)}


def inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    s = rng.standard_normal(shape[-1:]).astype(np.float32)
    if dtype == "bfloat16":  # values exactly representable in bfloat16, for both packages
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
        s = np.asarray(jnp.asarray(s, jnp.bfloat16), np.float32)
    return x, s


def f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_op_and_plain_version_match_reference(shape, dtype):
    x, s = inputs(sum(shape), shape, dtype)
    jx, js = jnp.asarray(x, dtype), jnp.asarray(s, dtype)
    ref_kernel = ref_ops.rmsnorm(jx, js, 1e-6, 256, True)
    ref_oracle = ref_ref.rmsnorm_ref(jx, js)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ts = torch.from_numpy(s).to(getattr(torch, dtype))
    for name, out in (("op", port_ops.rmsnorm(tx, ts)),
                      ("plain", port_ops.rmsnorm_plain(tx, ts)),
                      ("oracle", rmsnorm_ref(tx, ts))):
        assert out.shape == tx.shape and out.dtype == tx.dtype
        for what, ref in (("kernel", ref_kernel), ("oracle", ref_oracle)):
            assert_close(f32(ref), f32(out), **TOL[dtype], what=f"{name} vs reference {what}")


def test_eps_and_large_rows():
    """A wide row (the Qwen3-8B d_model) and another eps."""
    x, s = inputs(5, (3, 4096), "float32")
    x[1] *= 1e-4  # a row whose mean square is near eps
    ref = ref_ref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(s), 1e-5)
    out = port_ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-5)
    assert_close(np.asarray(ref), out.numpy(), **TOL["float32"])


def test_gradients_match_reference():
    x, s = inputs(2, (32, 64), "float32")
    gref = jax.grad(lambda a, b: jnp.sum(ref_ops.rmsnorm(a, b, 1e-6, 256, True) ** 2),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(s).requires_grad_()
    (port_ops.rmsnorm(tx, ts) ** 2).sum().backward()
    for name, r, t in (("x", gref[0], tx), ("scale", gref[1], ts)):
        assert_close(np.asarray(r), t.grad.numpy(), rtol=0.0, atol=1e-4, what=f"grad {name}")


def test_cuda_tensor_never_reaches_plain_version(monkeypatch):
    """A CUDA tensor goes to the kernel's wrapper and nowhere else; other
    devices raise; the wrapper refuses CPU tensors without counting."""
    def no_plain(*a, **k):
        raise AssertionError("the plain version was reached")

    calls = []
    monkeypatch.setattr(port_ops, "rmsnorm_plain", no_plain)
    monkeypatch.setattr(port_ops, "rmsnorm_cuda", lambda *a, **k: calls.append(a) or fake)
    fake = types.SimpleNamespace(device=torch.device("cuda"), shape=(2, 3, 8))
    fake.reshape = lambda *a: fake
    fake.contiguous = lambda: fake
    fake.to = lambda *a: fake
    assert port_ops._forward(fake, fake, 1e-6) is fake
    assert len(calls) == 1
    x = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        port_ops._forward(x, x[0], 1e-6)
    monkeypatch.undo()
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_kernel.rmsnorm_cuda(x, x[0])
    assert port_kernel.rmsnorm_cuda.launches == 0
