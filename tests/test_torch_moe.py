"""The port's MoE family (kimi-k2, arctic) against the JAX package's, on the CPU.

Covered: the routing (`moe_route`: the top-k picks, exact ties broken to
the lower expert as `lax.top_k` breaks them, the capacity drops ranked
k-major, the aux loss), `moe_apply` with and without drops, chunked
attention (`_chunked_sdpa`, arctic's ``attention_impl="chunked"``), the
smoke models' forward, loss, prefill and three decode steps (the config's
capacity, and a capacity factor of 0.5 so that tokens drop), the serving
loop, `cast_weights_`, training from the command line with a resume, and
one kimi-k2 layer at full width with its 384 experts cut to 8 (top 8 of
8).

The reference's routing is read from its own run: its softmax, top-k and
keep mask are recorded on their way through `jax.nn.softmax`,
`jax.lax.top_k` and the `jnp.where` that turns the keep mask into slots,
in an eager run.  A pick of the port that differs from the reference's
must be a certified tie: the reference's probabilities of the two experts
within ``TIE_ATOL`` (float32 cannot separate them); every run so far has
none.  The smoke models run in bfloat16 parameters and compute, as the
configs give them; the float32 cases set both to float32 (the models held
end to end to `MODEL_F32_TOL`).  Helpers and tolerances: `tests/torch_zoo.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as ref_configs
from repro.models import layers as RL
from repro.runtime.decode_loop import ServeLoop as RefServeLoop
from repro.runtime.steps import make_serve_steps as ref_serve_steps
from repro_torch.launch import serve
from repro_torch.models import layers as PL
from repro_torch.models.convert import _tensor
from repro_torch.testing import assert_close, compare_token_traces
from torch_zoo import (TOL, hold_decode_against_forward, hold_forward, hold_prefill_and_decode,
                       make_inputs, normal, np_f32, np_values, pair, port_config, reference_mode,
                       zero_cache, train_cli_and_resume)

MOE_ARCHS = ["kimi-k2-1t-a32b", "arctic-480b"]
# Two router probabilities closer than this are a tie float32 cannot
# separate: the router's logits are float32 sums of 64 products of size
# about 1, each off by up to 2^-24 relative.
TIE_ATOL = 1e-6


def moe_cfg(arch, cd="bfloat16", capacity=None, **kw):
    ref_cfg = ref_configs.smoke(arch).model.replace(**kw)
    if cd == "float32":
        ref_cfg = ref_cfg.replace(param_dtype="float32", compute_dtype="float32")
    if capacity is not None:
        ref_cfg = ref_cfg.replace(moe=dataclasses.replace(ref_cfg.moe, capacity_factor=capacity))
    return ref_cfg


def typed(specs, seed):
    return jax.tree.map(lambda s, v: jnp.asarray(v, s.dtype), specs, np_values(specs, seed),
                        is_leaf=lambda s: hasattr(s, "init"))


def to_port(tree):
    return jax.tree.map(_tensor, tree)


def reference_routing(monkeypatch, ref_p, ref_cfg, x):
    """The reference's `moe_apply` on ``x``, run eagerly, with its softmax,
    top-k picks and keep mask recorded on their way."""
    seen = {}
    n = x.shape[0] * x.shape[1]
    k = ref_cfg.moe.top_k
    softmax, top_k, where = jax.nn.softmax, jax.lax.top_k, jnp.where

    def rec_softmax(a, *args, **kw):
        out = softmax(a, *args, **kw)
        if out.shape == (n, ref_cfg.moe.num_experts):
            seen.setdefault("probs", np.asarray(out))
        return out

    def rec_top_k(a, kk):
        out = top_k(a, kk)
        seen.setdefault("ids", np.asarray(out[1]))
        return out

    def rec_where(cond, *args):
        if cond.shape == (k * n,) and cond.dtype == jnp.bool_:
            seen.setdefault("keep", np.asarray(cond))
        return where(cond, *args)

    monkeypatch.setattr(jax.nn, "softmax", rec_softmax)
    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(jnp, "where", rec_where)
    with jax.disable_jit():
        y, aux = RL.moe_apply(ref_p, ref_cfg, x)
    monkeypatch.undo()
    return np_f32(y), float(aux), seen


def certify_picks(ref_probs, ref_ids, ids):
    """The port's picks equal the reference's but for certified ties;
    returns the number of ties."""
    ties = 0
    for tok in np.nonzero((ref_ids != ids).any(-1))[0]:
        for a, b in zip(ref_ids[tok], ids[tok]):
            gap = abs(ref_probs[tok, a] - ref_probs[tok, b])
            assert gap <= TIE_ATOL, f"token {tok}: picks {ids[tok]} vs {ref_ids[tok]} ({gap:.2e})"
        ties += 1
    return ties


@pytest.mark.parametrize("capacity", [None, 0.5], ids=["config capacity", "drops"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_reference_with_its_drops(arch, cd, capacity, monkeypatch):
    ref_cfg = moe_cfg(arch, cd, capacity)
    cfg = port_config(ref_cfg)
    ref_p = typed(RL.moe_specs(ref_cfg), 3)
    p = to_port(ref_p)
    x = normal(np.random.default_rng(4), (2, 16, 64))
    ref_y, ref_aux, seen = reference_routing(monkeypatch, ref_p, ref_cfg,
                                             jnp.asarray(x, getattr(jnp, cd)))
    xt = torch.from_numpy(x).to(getattr(torch, cd))
    route = PL.moe_route(p["router"], cfg.moe, xt.reshape(32, 64))
    ids = route["expert_ids"].numpy()
    assert certify_picks(seen["probs"], seen["ids"], ids) == 0
    assert_close(seen["probs"], route["probs"].numpy(), rtol=1e-5, atol=1e-7, what="probs")
    keep = route["keep"].numpy()
    assert np.array_equal(keep, seen["keep"])  # the same dropped (token, slot) pairs
    if capacity is not None:
        assert 0 < (~keep).sum() < keep.size
    with torch.no_grad():
        y, aux = PL.moe_apply(p, cfg, xt)
    assert y.dtype == cfg.cdtype
    assert_close(ref_y, np_f32(y), **TOL[cd], what="moe output")
    assert_close(ref_aux, float(aux), **TOL[cd], what="aux")


def test_exact_ties_go_to_the_lower_expert(monkeypatch):
    """Two identical router columns give two experts exactly equal
    probabilities: both packages pick the lower expert first."""
    ref_cfg = moe_cfg("kimi-k2-1t-a32b", "float32")
    ref_p = typed(RL.moe_specs(ref_cfg), 5)
    router = np.array(ref_p["router"])
    for a, b in ((1, 5), (2, 3), (0, 7)):
        router[:, b] = router[:, a]
    ref_p = dict(ref_p, router=jnp.asarray(router))
    x = normal(np.random.default_rng(6), (1, 24, 64))
    _, _, seen = reference_routing(monkeypatch, ref_p, ref_cfg, jnp.asarray(x))
    route = PL.moe_route(torch.from_numpy(router), port_config(ref_cfg).moe,
                         torch.from_numpy(x).reshape(24, 64))
    ids = route["expert_ids"].numpy()
    probs = route["probs"].numpy()
    tied = [t for t in range(24) if any(probs[t, a] == probs[t, b] and a in ids[t]
                                        for a, b in ((1, 5), (2, 3), (0, 7)))]
    assert tied  # the ties are there, and both sides broke them the same way
    assert np.array_equal(ids, seen["ids"])
    for t in tied:
        for a, b in ((1, 5), (2, 3), (0, 7)):
            if a in ids[t] and b in ids[t]:
                assert list(ids[t]).index(a) < list(ids[t]).index(b)


@pytest.mark.parametrize("causal,q_offset,kv_len,t,s", [
    (True, None, None, 32, 32),  # the teacher-forced forward
    (True, 0, 20, 20, 48),  # a prefill into a longer cache
    (True, 7, 10, 3, 48),  # a continuation
    (False, None, None, 12, 40),  # ragged S: the reference's fallback to _sdpa
])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_chunked_sdpa_matches_reference(cd, causal, q_offset, kv_len, t, s):
    rng = np.random.default_rng(7)
    q, k, v = normal(rng, (2, t, 8, 16)), normal(rng, (2, s, 2, 16)), normal(rng, (2, s, 2, 16))
    jdt, tdt = getattr(jnp, cd), getattr(torch, cd)
    ref = RL._chunked_sdpa(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal, chunk=8,
                           q_offset=None if q_offset is None else jnp.int32(q_offset),
                           kv_len=None if kv_len is None else jnp.int32(kv_len))
    got = PL._chunked_sdpa(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal,
                           chunk=8, q_offset=q_offset, kv_len=kv_len)
    assert got.dtype == tdt
    assert_close(np_f32(ref), np_f32(got), **TOL[cd])


VARIANTS = {  # (arch, capacity factor, extra config)
    "kimi": ("kimi-k2-1t-a32b", None, {}),
    "kimi drops": ("kimi-k2-1t-a32b", 0.5, {}),
    "arctic": ("arctic-480b", None, {}),
    "arctic chunked": ("arctic-480b", None, {"attention_chunk": 8}),
}


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_matches_reference(variant, cd):
    """Forward, aux loss, loss, prefill and three decode steps; with
    ``attention_chunk`` 8 arctic's forward (T = 32) and prefill (a 64-slot
    cache) take `_chunked_sdpa`."""
    arch, capacity, extra = VARIANTS[variant]
    ref_model, ref_p, model = pair(moe_cfg(arch, cd, capacity, **extra), seed=1)
    batch = make_inputs(model.cfg, 2, 32, seed=8)
    _, aux = hold_forward(ref_model, ref_p, model, batch, cd)
    assert float(aux) > 0
    hold_prefill_and_decode(ref_model, ref_p, model, dict(batch, tokens=batch["tokens"][:, :24]),
                            cd, max_len=64)


def test_chunked_route_is_taken(monkeypatch):
    """Arctic's forward and prefill call `_chunked_sdpa` where the
    sequence allows, decode never."""
    _, _, model = pair(moe_cfg("arctic-480b", "float32", attention_chunk=8), seed=2)
    calls = []
    chunked = PL._chunked_sdpa
    monkeypatch.setattr(PL, "_chunked_sdpa", lambda *a, **kw: calls.append(a[0].shape[1])
                        or chunked(*a, **kw))
    tokens = np.random.default_rng(9).integers(0, 256, size=(1, 32)).astype(np.int32)
    with torch.no_grad():
        model.forward({"tokens": tokens})
        assert calls == [32, 32]  # one per layer
        cache = model.init_cache(1, 64)
        model.prefill({"tokens": tokens[:, :20]}, cache)
        assert calls == [32, 32, 20, 20]
        model.decode_step(cache, tokens[:, 20:21], 20)
        assert calls == [32, 32, 20, 20]


def test_decode_agrees_with_teacher_forced_forward():
    _, _, model = pair(moe_cfg("kimi-k2-1t-a32b", "float32"), seed=3)
    batch = make_inputs(model.cfg, 2, 30, seed=10, loss_mask=False)
    # Capacity depends on the number of tokens routed together: a decode
    # step routes B tokens, the forward B·T, so no capacity may bind.
    model.cfg = model.cfg.replace(moe=dataclasses.replace(model.cfg.moe, capacity_factor=8.0))
    hold_decode_against_forward(model, batch, 20, 32)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_serve_loop_tokens_equal_reference_up_to_ties(cd):
    ref_model, ref_p, model = pair(moe_cfg("arctic-480b", cd), seed=4)
    prompt = serve.make_batch(model.cfg, 2, 16, seed=4)["tokens"]
    new = 6
    with reference_mode(cd):
        prefill, decode = ref_serve_steps(ref_model)
        ref_loop = RefServeLoop(prefill_step=jax.jit(prefill), decode_step=jax.jit(decode),
                                params=ref_p, eos_id=-1,
                                init_cache=lambda: zero_cache(ref_model, 2, 32))
        ref_tokens = ref_loop.generate({"tokens": jnp.asarray(prompt)}, new)["tokens"]
    # The logits that chose each reference token: the reference's own
    # prefill and decode steps over its tokens.
    with reference_mode(cd):
        cache = zero_cache(ref_model, 2, 32)
        steps = [jax.jit(ref_model.prefill)(ref_p, {"tokens": jnp.asarray(prompt)}, cache)]
        for i in range(new - 1):
            steps.append(jax.jit(ref_model.decode_step)(
                ref_p, steps[-1][1], jnp.asarray(ref_tokens[:, i:i + 1]), jnp.int32(16 + i)))
    ref_logits = np.concatenate([np.asarray(s[0]) for s in steps], 1)
    out = serve.serve_loop(model, 2, 32).generate({"tokens": torch.from_numpy(prompt)}, new)
    cmp = compare_token_traces(ref_tokens, out["tokens"], ref_logits, atol=TOL[cd]["atol"])
    if cd == "float32":
        assert cmp.matched == 2, cmp.ties
    assert cmp.matched + len(cmp.ties) == 2


def test_cast_weights_keeps_the_router_in_float32():
    _, _, model = pair(moe_cfg("kimi-k2-1t-a32b", "float32").replace(compute_dtype="bfloat16"),
                       seed=5)
    tokens = np.random.default_rng(11).integers(0, 256, size=(2, 16)).astype(np.int32)
    with torch.no_grad():
        before, _ = model.forward({"tokens": tokens})
        model.cast_weights_()
        after, _ = model.forward({"tokens": tokens})
    moe = model.layers[0]["moe"]
    assert moe["router"].dtype == torch.float32
    for k in ("wi_gate", "wi_up", "wo"):
        assert moe[k].dtype == torch.bfloat16
        assert moe["shared"][k].dtype == torch.bfloat16
    assert torch.equal(before, after)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_cli_trains_and_resumes(arch, tmp_path):
    """The MoE configs train from the command line (Adafactor over the
    stacked tree, bfloat16 accumulation) and resume from a checkpoint."""
    train_cli_and_resume(arch, tmp_path)


def test_one_full_width_kimi_k2_layer_matches_reference():
    """One kimi-k2 layer at full width (d_model 7168, 64 query heads and 8 KV
    heads of 112, the shared expert of 2048), its 384 experts cut to 8 (so
    top 8 of 8, and no token drops at T = 32) and the vocabulary to 4096;
    bfloat16 parameters and compute, the reference run eagerly."""
    ref_cfg = ref_configs.get("kimi-k2-1t-a32b").model
    ref_cfg = ref_cfg.replace(num_layers=1, vocab_size=4096,
                              moe=dataclasses.replace(ref_cfg.moe, num_experts=8))
    ref_model, ref_p, model = pair(ref_cfg, seed=13)
    cfg = model.cfg
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.moe.d_ff_expert,
            cfg.moe.top_k) == (7168, 64, 8, 112, 2048, 8)
    tokens = np.random.default_rng(14).integers(0, 4096, size=(1, 32)).astype(np.int32)
    with reference_mode("bfloat16"):
        ref_logits, ref_aux = ref_model.forward(ref_p, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        logits, aux = model.forward({"tokens": tokens})
    assert_close(np.asarray(ref_logits), logits.numpy(), **TOL["bfloat16"], what="logits")
    assert_close(float(ref_aux), float(aux), **TOL["bfloat16"], what="aux")
