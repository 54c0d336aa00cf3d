"""The port's flash attention against the JAX package's, on the CPU.

On the CPU the port's op takes the plain version
(`ops.flash_attention_plain`: the kernel's online softmax over key tiles,
in torch).  It, the dispatching op and the port's `attention_ref` are held
against the reference's Pallas kernel under the interpreter
(``interpret=True``) and its `attention_ref`, on identical numpy inputs, at
the shapes and dtypes of `tests/test_kernels.py` and with its tolerances:
float32 atol 2e-5 and rtol 1e-4 (sums in another order), bfloat16 atol
2e-2 (one rounding of the output, whose values stay below 2 in size).
Gradients through the port's `autograd.Function` are held against the
reference's custom VJP at atol 1e-3, the reference's own tolerance for its
VJP against the oracle's.

The plain version follows the kernel that the dtype and D select
(`kernel.route`): its default tiles are that kernel's, and on both routes
it multiplies the float32 probabilities into V (the tensor-core kernel
feeds them to the bfloat16 tensor cores as two terms, about 16 bits), so a
bfloat16 input rounds only the output.

The CUDA kernels themselves run only on the card: `tests/test_torch_cuda.py`
holds them against the plain version there.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention import ref as ref_ref
from repro_torch.kernels.flash_attention import kernel as port_kernel
from repro_torch.kernels.flash_attention import ops as port_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.testing import assert_close

pytestmark = pytest.mark.kernel

SHAPES = [  # (b, t, h, kv, d, causal), as in tests/test_kernels.py
    (1, 128, 4, 4, 64, True),
    (2, 128, 4, 2, 64, True),   # GQA
    (1, 256, 8, 1, 32, True),   # MQA
    (2, 128, 4, 2, 128, True),  # head_dim 128
    (1, 128, 4, 4, 64, False),  # bidirectional
    (1, 100, 4, 2, 64, False),  # ragged T
    (1, 200, 6, 3, 48, True),   # ragged T, causal
]
F32 = dict(rtol=1e-4, atol=2e-5)
BF16 = dict(rtol=0.0, atol=2e-2)
BF16_SHAPES = SHAPES + [(1, 1024, 8, 2, 128, True)]  # and a longer head_dim-128 causal case


def qkv(seed, b, t, h, kv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, d)).astype(np.float32),
            rng.standard_normal((b, t, kv, d)).astype(np.float32),
            rng.standard_normal((b, t, kv, d)).astype(np.float32))


def ref_kernel(q, k, v, causal, dtype=jnp.float32):
    out = ref_ops.flash_attention(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
                                  causal, None, 128, 128, True)
    return np.asarray(out.astype(jnp.float32))


def ref_oracle(q, k, v, causal, dtype=jnp.float32):
    out = ref_ref.attention_ref(*(jnp.asarray(a).astype(dtype) for a in (q, k, v)), causal=causal)
    return np.asarray(out.astype(jnp.float32))


def bf16(*arrays):
    return tuple(torch.from_numpy(a).to(torch.bfloat16) for a in arrays)


@pytest.mark.parametrize("b,t,h,kv,d,causal", SHAPES)
def test_plain_version_matches_reference(b, t, h, kv, d, causal):
    q, k, v = qkv(t * h + d, b, t, h, kv, d)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain = port_ops.flash_attention_plain(tq, tk, tv, causal=causal).numpy()
    op = port_ops.flash_attention(tq, tk, tv, causal).numpy()
    oracle = attention_ref(tq, tk, tv, causal=causal).numpy()
    ref_k = ref_kernel(q, k, v, causal)
    assert_close(ref_k, plain, **F32, what="plain vs reference kernel")
    assert_close(ref_oracle(q, k, v, causal), plain, **F32, what="plain vs reference oracle")
    assert_close(ref_oracle(q, k, v, causal), oracle, **F32, what="port oracle")
    assert np.array_equal(op, plain)  # the CPU dispatch is the plain version


@pytest.mark.parametrize("b,t,h,kv,d,causal", BF16_SHAPES)
def test_bf16_plain_version_matches_reference(b, t, h, kv, d, causal):
    """bfloat16 inputs take the tensor-core route's tiles; the plain version
    stays within the reference's bfloat16 limit of its kernel (interpreted)
    and its oracle, both run on the same bfloat16 inputs."""
    q, k, v = qkv(t * h + d, b, t, h, kv, d)
    tq, tk, tv = bf16(q, k, v)
    assert port_kernel.route(tq.dtype, d) == "tensor_core"
    plain = port_ops.flash_attention_plain(tq, tk, tv, causal=causal)
    assert plain.dtype == torch.bfloat16
    args = (tq.float().numpy(), tk.float().numpy(), tv.float().numpy(), causal)
    assert_close(ref_kernel(*args, jnp.bfloat16), plain.float().numpy(), **BF16,
                 what="bf16 plain vs reference kernel")
    assert_close(ref_oracle(*args, jnp.bfloat16), plain.float().numpy(), **BF16,
                 what="bf16 plain vs reference oracle")


@pytest.mark.parametrize("d", [32, 48, 128])
def test_bf16_plain_version_rounds_only_the_output(d):
    """On the tensor-core route the probabilities stay float32 into P.V (the
    kernel splits them into two bfloat16 terms, exact to about 2^-17): the
    bfloat16 plain version is the float32 computation on the same values,
    on the same tiles, rounded once at the end, bit for bit."""
    tq, tk, tv = bf16(*qkv(d, 1, 200, 4, 2, d))
    out = port_ops.flash_attention_plain(tq, tk, tv)
    f32 = port_ops.flash_attention_plain(tq.float(), tk.float(), tv.float(),
                                         block_q=port_kernel.WGMMA_BLOCK_Q,
                                         block_k=port_kernel.WGMMA_BLOCK_K)
    assert torch.equal(out, f32.to(torch.bfloat16))


@pytest.mark.parametrize("dtype,d,route,tiles", [
    (torch.bfloat16, 64, "tensor_core", (128, 128)),
    (torch.bfloat16, 48, "tensor_core", (128, 128)),
    (torch.bfloat16, 12, "cuda_core", (64, 64)),  # D % 8 != 0
    (torch.float32, 64, "cuda_core", (64, 64)),
    (torch.float32, 128, "cuda_core", (64, 64)),
])
def test_plain_version_takes_the_selected_kernels_tiles(dtype, d, route, tiles):
    assert port_kernel.route(dtype, d) == route
    assert port_kernel.tiles(dtype, d) == tiles
    q, k, v = (x.to(dtype) for x in (torch.from_numpy(a) for a in qkv(3, 1, 300, 4, 2, d)))
    default = port_ops.flash_attention_plain(q, k, v)
    explicit = port_ops.flash_attention_plain(q, k, v, block_q=tiles[0], block_k=tiles[1])
    assert torch.equal(default, explicit)


@pytest.mark.parametrize("block_q,block_k", [(64, 64), (128, 128), (32, 96)])
def test_plain_version_tiles_do_not_change_the_result(block_q, block_k):
    q, k, v = (torch.from_numpy(a) for a in qkv(5, 1, 200, 6, 3, 48))
    out = port_ops.flash_attention_plain(q, k, v, block_q=block_q, block_k=block_k)
    assert_close(ref_oracle(q.numpy(), k.numpy(), v.numpy(), True), out.numpy(), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtype_sweep(dtype):
    q, k, v = qkv(0, 1, 128, 2, 2, 64)
    tdt = getattr(torch, dtype)
    out = port_ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), True)
    assert out.dtype == tdt
    ref = ref_kernel(q, k, v, True, getattr(jnp, dtype))
    assert_close(ref, out.float().numpy(), **(BF16 if dtype == "bfloat16" else F32))


def test_gradients_match_reference_custom_vjp():
    q, k, v = qkv(1, 1, 128, 2, 2, 32)

    def ref_loss(q, k, v):
        return jnp.sum(ref_ops.flash_attention(q, k, v, True, None, 128, 128, True) ** 2)

    ref_grads = jax.grad(ref_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (port_ops.flash_attention(*leaves, True) ** 2).sum().backward()
    for r, p in zip(ref_grads, leaves):
        assert_close(np.asarray(r), p.grad.numpy(), rtol=0.0, atol=1e-3)


def test_online_softmax_is_stable_at_large_logits():
    q = torch.full((1, 128, 1, 64), 10.0)
    v = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 128, 1, 64))
                         .astype(np.float32))
    out = port_ops.flash_attention(q, q, v, True)
    assert bool(torch.isfinite(out).all())
    ref = ref_kernel(q.numpy(), q.numpy(), v.numpy(), True)
    assert_close(ref, out.numpy(), **F32)


def test_cuda_tensor_never_reaches_plain_version(monkeypatch):
    """A CUDA tensor goes to the kernel's wrapper and nowhere else; other
    devices raise; the wrapper refuses CPU tensors without counting."""
    def no_plain(*a, **k):
        raise AssertionError("the plain version was reached")

    calls = []
    monkeypatch.setattr(port_ops, "flash_attention_plain", no_plain)
    monkeypatch.setattr(port_ops, "flash_attention_cuda",
                        lambda *a, **k: calls.append(a) or "kernel")
    fake = types.SimpleNamespace(device=torch.device("cuda"))
    fake.contiguous = lambda: fake
    assert port_ops._forward(fake, fake, fake, True, None) == "kernel"
    assert len(calls) == 1
    q = torch.zeros((1, 128, 2, 32), device="meta")
    with pytest.raises(ValueError):
        port_ops._forward(q, q, q, True, None)
    monkeypatch.undo()
    q = torch.zeros((1, 128, 2, 32))
    with pytest.raises(ValueError):
        port_kernel.flash_attention_cuda(q, q, q)
    fa = port_kernel.flash_attention_cuda
    assert (fa.launches, fa.tensor_core_launches, fa.cuda_core_launches) == (0, 0, 0)
