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

The backward: on the CPU the op differentiates through the port's
`attention_ref` (held against the reference's custom VJP below); a CUDA
tensor on the tensor-core route runs the backward kernel, whose plain
version `ops.flash_attention_backward_plain` is held here against autograd
through `attention_ref`, in float32, dq, dk and dv each on its own.

The CUDA kernels themselves run only on the card: `tests/test_torch_cuda.py`
holds them against the plain versions there.
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
    with pytest.raises(ValueError):
        port_kernel.flash_attention_bwd_cuda(q, q, q, q, torch.zeros((1, 2, 128)), q)
    fa = port_kernel.flash_attention_cuda
    assert (fa.launches, fa.tensor_core_launches, fa.cuda_core_launches) == (0, 0, 0)
    assert port_kernel.flash_attention_bwd_cuda.launches == 0


# ---------------------------------------------------------------- the backward

BWD_CASES = [  # (b, t, s, h, kv, d, causal, tolerance): float32, sums in another order
    (1, 128, 128, 4, 4, 64, True, F32),     # no grouping
    (1, 200, 200, 8, 2, 112, True, F32),    # 4 query heads a KV head, D = 112, ragged T
    (2, 130, 130, 8, 1, 128, False, F32),   # 8 a KV head, bidirectional, ragged T
    (1, 150, 150, 32, 4, 64, True, F32),    # 8 a KV head, causal, ragged T
    (1, 77, 77, 4, 4, 128, True, F32),      # one partial tile
    (1, 333, 200, 8, 1, 64, False, F32),    # T > S, bidirectional
    (1, 200, 333, 4, 1, 128, False, F32),   # T < S, bidirectional
    (1, 333, 200, 4, 2, 64, True, F32),     # T > S, causal: late queries see every key
]


def grad_inputs(seed, b, t, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d), (b, t, h, d)))


def oracle_grads(q, k, v, g, causal):
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    return torch.autograd.grad(attention_ref(*leaves, causal=causal), leaves, g)


@pytest.mark.parametrize("b,t,s,h,kv,d,causal,tol", BWD_CASES)
def test_backward_plain_version_matches_oracle_autograd(b, t, s, h, kv, d, causal, tol):
    """The backward kernel's arithmetic (Di from the output, p from the
    saved log-sum-exp, dk and dv summed over a KV head's query heads) gives
    autograd's dq, dk and dv through the oracle, each held on its own."""
    q, k, v, g = grad_inputs(t + s + h + d, b, t, s, h, kv, d)
    o, lse = port_ops.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    got = port_ops.flash_attention_backward_plain(q, k, v, o, lse, g, causal=causal)
    for name, x, want, ref in zip("qkv", got, (q, k, v), oracle_grads(q, k, v, g, causal)):
        assert x.shape == want.shape and x.dtype == want.dtype
        assert_close(ref.numpy(), x.numpy(), **tol, what=f"d{name}")


@pytest.mark.parametrize("b,t,s,h,kv,d,causal", [
    (1, 200, 200, 8, 2, 64, True), (2, 130, 130, 4, 4, 128, False), (1, 333, 200, 4, 2, 48, True),
    (1, 100, 250, 6, 3, 32, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_forward_lse_is_logsumexp_of_the_oracles_logits(b, t, s, h, kv, d, causal, dtype):
    """The row log-sum-exp the forward hands the backward: torch.logsumexp
    over the oracle's scaled, masked float32 logits, (B, H, T)."""
    q, k, v, _ = (x.to(dtype) for x in grad_inputs(t + d, b, t, s, h, kv, d))
    _, lse = port_ops.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    logits = torch.einsum("bthd,bshd->bhts", q.float(),
                          k.float().repeat_interleave(h // kv, dim=2)) / d ** 0.5
    if causal:
        logits = logits.masked_fill(torch.arange(t)[:, None] < torch.arange(s)[None, :], -1e30)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, t)
    assert_close(torch.logsumexp(logits, -1).numpy(), lse.numpy(), **F32, what="lse")


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.bfloat16, 64),
                                     (torch.bfloat16, 12)])
def test_cpu_backward_is_autograd_through_the_oracle(monkeypatch, dtype, d):
    """A CPU tensor's backward reaches neither the backward kernel's wrapper
    nor its plain version: it is autograd through `attention_ref`, bit for
    bit."""
    def refuse(*a, **k):
        raise AssertionError("the CPU backward reached the backward kernel's path")

    monkeypatch.setattr(port_ops, "flash_attention_bwd_cuda", refuse)
    monkeypatch.setattr(port_ops, "flash_attention_backward_plain", refuse)
    q, k, v, g = (x.to(dtype) for x in grad_inputs(d, 1, 150, 150, 4, 2, d))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    port_ops.flash_attention(*leaves, True).backward(g)
    for x, ref in zip(leaves, oracle_grads(q, k, v, g, True)):
        assert torch.equal(x.grad, ref)


@pytest.mark.parametrize("device", ["cuda", "cpu", "meta"])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128), (torch.bfloat16, 112),
                                     (torch.bfloat16, 64), (torch.bfloat16, 8),
                                     (torch.bfloat16, 12), (torch.bfloat16, 4),
                                     (torch.float32, 128), (torch.float32, 64)])
def test_backward_takes_the_kernel_exactly_on_the_tensor_core_route(device, dtype, d):
    fake = types.SimpleNamespace(device=torch.device(device), dtype=dtype, shape=(1, 128, 4, d))
    want = device == "cuda" and port_kernel.route(dtype, d) == "tensor_core"
    assert port_ops._kernel_backward(fake) == want


@pytest.mark.parametrize("kernel_route", [True, False], ids=["kernel", "oracle"])
def test_op_backward_wiring(monkeypatch, kernel_route):
    """Where `_kernel_backward` holds and a gradient is wanted, the op's
    forward asks for the log-sum-exp and its backward hands the backward
    kernel q, k, v, the output, the log-sum-exp and the gradient, once, and
    never reaches the oracle; elsewhere the forward asks for no log-sum-exp
    and the backward is the oracle's.  The backward kernel is stood in for
    by its plain version, on the CPU."""
    calls = {"lse": [], "bwd": 0, "oracle": 0}
    oracle, plain = port_ops.attention_ref, port_ops.flash_attention_plain

    def fwd(q, k, v, *, causal, sm_scale, return_lse):
        calls["lse"].append(return_lse)
        return plain(q, k, v, causal=causal, sm_scale=sm_scale, return_lse=return_lse)

    def bwd(q, k, v, o, lse, g, *, causal, sm_scale):
        calls["bwd"] += 1
        return port_ops.flash_attention_backward_plain(q, k, v, o, lse, g, causal=causal,
                                                       sm_scale=sm_scale)

    def counted_oracle(*a, **kw):
        calls["oracle"] += 1
        return oracle(*a, **kw)

    monkeypatch.setattr(port_ops, "_kernel_backward", lambda q: kernel_route)
    monkeypatch.setattr(port_ops, "flash_attention_plain", fwd)
    monkeypatch.setattr(port_ops, "flash_attention_bwd_cuda", bwd)
    monkeypatch.setattr(port_ops, "attention_ref", counted_oracle)
    q, k, v, g = grad_inputs(9, 2, 130, 130, 8, 2, 64)
    with torch.no_grad():  # no backward to come: the forward asks for no log-sum-exp
        port_ops.flash_attention(q, k, v, True)
    assert calls == {"lse": [False], "bwd": 0, "oracle": 0}
    leaves = [x.clone().requires_grad_() for x in (q, k.transpose(1, 2).contiguous().transpose(1, 2), v)]
    port_ops.flash_attention(*leaves, True).backward(g)
    assert calls == ({"lse": [False, True], "bwd": 1, "oracle": 0} if kernel_route
                     else {"lse": [False, False], "bwd": 0, "oracle": 1})
    for x, ref in zip(leaves, oracle_grads(q, k, v, g, True)):
        assert_close(ref.numpy(), x.grad.numpy(), **F32)
