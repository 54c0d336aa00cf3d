"""The port's model zoo (dense family) against the JAX package's, on the CPU.

Both packages get the same parameters and inputs, drawn with numpy from a
seed; the reference's values reach the port through
`repro_torch.models.convert.params_from_jax`.  Tolerances
(`repro_torch.testing`): float32 compute agrees to FLOAT_RTOL / FLOAT_ATOL,
bfloat16 compute to BF16_RTOL / BF16_ATOL (the reasons are in that
module).  Covered: the Qwen3-8B spec tree; configs; the layers (norms,
RoPE, qk-norm, `_sdpa`, `attn_apply` without a cache, at prefill and at
decode, the MLPs, embedding and unembedding); a two-layer GQA Qwen3-like
model's forward, loss, prefill and decode under every attention route;
one Qwen3-8B layer at full width; every reference architecture's config,
smoke variant and spec tree; the other dense configs' smoke models
(granite-8b, granite-34b, qwen1.5-32b; `tests/torch_zoo.py`); the
reference's parameters of every family carried into the port
(`params_from_jax`); and the serve CLI for the eight architectures ported
with the other families.

On the CPU, ``attention_impl="pallas"`` runs the reference's oracle
(`attention_ref`, its CPU route for the flash op) and the port's plain
version of the flash kernel; "auto" and "dense" run `_sdpa` in both.

In bfloat16 compute the reference runs eagerly (`jax.disable_jit`): under
`jax.jit`, XLA may keep a bfloat16 intermediate in float32 ("excess
precision"), so it rounds at fewer places than the code states, and a
rounding it skips in a layer's attention moves a value of the next layer's
cache by up to 10 %.  Run op by op, the reference rounds where its code
says, as the port does.
"""

import contextlib

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as ref_configs
from repro.models import Model as RefModel
from repro.models import active_params as ref_active_params
from repro.models import total_params as ref_total_params
from repro.models import tree_bytes as ref_tree_bytes
from repro.models import layers as RL
from repro.models.spec import is_spec as ref_is_spec
import repro_torch.configs as port_configs
from repro_torch.models import layers as PL
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model as PortModel
from repro_torch.models.model import _param_specs, active_params, total_params
from repro_torch.models.spec import count_params, init_tree, leaves, tree_bytes
from repro_torch.testing import BF16_ATOL, BF16_RTOL, FLOAT_ATOL, FLOAT_RTOL, assert_close
import torch_zoo as zoo

TOL = {"float32": dict(rtol=FLOAT_RTOL, atol=FLOAT_ATOL),
       "bfloat16": dict(rtol=BF16_RTOL, atol=BF16_ATOL)}
QWEN3_8B_PARAMS = 8_190_735_360

TINY = dict(name="qwen3-tiny", family="dense", num_layers=2, d_model=64, num_heads=8,
            num_kv_heads=2, d_ff=128, vocab_size=512, head_dim=16, qk_norm=True)


def configs(**kw):
    """The same ModelConfig in both packages."""
    ref_cfg = ref_configs.get("qwen3-8b").model.replace(**kw)
    return ref_cfg, PortConfig(**dataclasses.asdict(ref_cfg))


def np_params(ref_specs, seed):
    """Numpy values for the reference's spec tree, drawn as its initializers
    draw (norm scales perturbed off 1 so that they matter)."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if s.init == "zeros":
            return np.zeros(s.shape, np.float32)
        if s.init == "ones":
            return 1 + 0.1 * rng.standard_normal(s.shape, dtype=np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = s.init_scale if s.init == "normal" else s.init_scale / np.sqrt(fan_in)
        return rng.standard_normal(s.shape, dtype=np.float32) * np.float32(std)

    return jax.tree.map(leaf, ref_specs, is_leaf=ref_is_spec)


def reference_mode(cd):
    """Eager JAX for bfloat16 compute (see the module docstring)."""
    return jax.disable_jit() if cd == "bfloat16" else contextlib.nullcontext()


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_port(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def np_f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------- specs and configs


def _ref_leaves(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=ref_is_spec)
    return {".".join(k.key for k in path): s for path, s in flat}


def test_qwen3_8b_spec_tree_matches_reference():
    ref_cfg = ref_configs.get("qwen3-8b").model
    port_cfg = port_configs.get("qwen3-8b").model
    ref_specs = _ref_leaves(RefModel(ref_cfg).param_specs())
    port_specs = dict(leaves(_param_specs(port_cfg)))
    assert list(port_specs) == list(ref_specs)  # same names, same order
    for name, s in ref_specs.items():
        p = port_specs[name]
        assert p.shape == s.shape and p.axes == s.axes and p.init == s.init, name
        assert p.init_scale == s.init_scale and str(p.dtype).split(".")[-1] == str(s.dtype)
    assert count_params(_param_specs(port_cfg)) == total_params(port_cfg) == QWEN3_8B_PARAMS
    assert ref_total_params(ref_cfg) == QWEN3_8B_PARAMS
    assert tree_bytes(_param_specs(port_cfg)) == ref_tree_bytes(RefModel(ref_cfg).param_specs())
    assert tree_bytes(_param_specs(port_cfg)) == 4 * QWEN3_8B_PARAMS


def test_configs_match_reference():
    for get in ("get", "smoke"):
        ref_spec = getattr(ref_configs, get)("qwen3-8b")
        port_spec = getattr(port_configs, get)("qwen3-8b")
        assert port_spec.name == ref_spec.name
        assert dataclasses.asdict(port_spec.model) == dataclasses.asdict(ref_spec.model)
        assert dataclasses.asdict(port_spec.exec) == dataclasses.asdict(ref_spec.exec)
    assert port_configs.get("qwen3-8b").model.pdtype == torch.float32
    assert port_configs.get("qwen3-8b").model.cdtype == torch.bfloat16


def _spec_rows(leaves_by_name):
    return {name: (s.shape, s.axes, s.init, s.init_scale, str(s.dtype).split(".")[-1])
            for name, s in leaves_by_name.items()}


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_arch_config_and_spec_tree_match_reference(arch):
    """Every reference architecture is registered, in the reference's order,
    and its config, smoke variant and parameter tree (names, shapes, axes,
    initializers, dtypes) are the reference's."""
    assert port_configs.ARCHS == ref_configs.ARCHS
    for get in ("get", "smoke"):
        ref_spec = getattr(ref_configs, get)(arch)
        port_spec = getattr(port_configs, get)(arch)
        assert port_spec.name == ref_spec.name
        assert dataclasses.asdict(port_spec.model) == dataclasses.asdict(ref_spec.model)
        assert dataclasses.asdict(port_spec.exec) == dataclasses.asdict(ref_spec.exec)
        assert port_spec.notes == ref_spec.notes
        ref_specs = _ref_leaves(RefModel(ref_spec.model).param_specs())
        port_specs = dict(leaves(_param_specs(port_spec.model)))
        assert list(port_specs) == list(ref_specs)  # same names, same order
        assert _spec_rows(port_specs) == {
            name: (s.shape, s.axes, s.init, s.init_scale, jnp.dtype(s.dtype).name)
            for name, s in ref_specs.items()}
        assert total_params(port_spec.model) == ref_total_params(ref_spec.model)
        assert active_params(port_spec.model) == ref_active_params(ref_spec.model)
        assert tree_bytes(_param_specs(port_spec.model)) == \
            ref_tree_bytes(RefModel(ref_spec.model).param_specs())


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        port_configs.get("no-such-arch")
    with pytest.raises(KeyError, match="unknown arch"):
        port_configs.smoke("no-such-arch")


def test_init_tree_is_seeded_and_scaled():
    _, cfg = configs(**TINY)
    specs = PL.attn_specs(cfg)
    a = init_tree(torch.Generator().manual_seed(3), specs, "cpu")
    b = init_tree(torch.Generator().manual_seed(3), specs, "cpu")
    c = init_tree(torch.Generator().manual_seed(4), specs, "cpu")
    for name, s in leaves(specs):
        assert tuple(a[name.split(".")[-1]].shape) == s.shape
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wq"], c["wq"])
    assert torch.equal(a["q_norm"], torch.ones(16))
    big = init_tree(torch.Generator().manual_seed(0),
                    PL.mlp_specs(cfg.replace(d_model=1024, d_ff=256)), "cpu")
    assert abs(float(big["wi_up"].std()) * 32 - 1) < 0.02  # 1/sqrt(fan_in = 1024)


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_norm_apply(norm, cd):
    ref_cfg, cfg = configs(**TINY, norm=norm, compute_dtype=cd)
    rng = np.random.default_rng(0)
    p = {"scale": normal(rng, (64,)) + 1, "bias": normal(rng, (64,))}
    if norm == "rmsnorm":
        del p["bias"]
    x = normal(rng, (2, 5, 64), 3.0)
    ref = RL.norm_apply(to_jax(p), ref_cfg, jnp.asarray(x))
    got = PL.norm_apply(to_port(p), cfg, torch.from_numpy(x))
    assert got.dtype == cfg.cdtype
    assert_close(np_f32(ref), np_f32(got), **TOL[cd])


def test_rope_and_head_norm():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 4096, size=(2, 7)).astype(np.int32)
    rc, rs = RL.rope_tables(jnp.asarray(pos), 128, 1e6)
    pc, ps = PL.rope_tables(torch.from_numpy(pos), 128, 1e6)
    # angles up to 4096 rad: one float32 step of the frequency moves them by ~2e-4
    assert_close(np.asarray(rc), pc.numpy(), rtol=0.0, atol=1e-3)
    assert_close(np.asarray(rs), ps.numpy(), rtol=0.0, atol=1e-3)
    small = np.arange(128, dtype=np.int32)[None]
    rc, rs = RL.rope_tables(jnp.asarray(small), 16, 1e4)
    pc, ps = PL.rope_tables(torch.from_numpy(small), 16, 1e4)
    assert_close(np.asarray(rc), pc.numpy())
    assert_close(np.asarray(rs), ps.numpy())
    x = normal(rng, (1, 128, 4, 16))
    for dt, tdt, cd in ((jnp.float32, torch.float32, "float32"),
                        (jnp.bfloat16, torch.bfloat16, "bfloat16")):
        ref = RL.apply_rope(jnp.asarray(x, dt), rc[:, :, None], rs[:, :, None])
        got = PL.apply_rope(torch.from_numpy(x).to(tdt), pc[:, :, None], ps[:, :, None])
        assert got.dtype == tdt
        assert_close(np_f32(ref), np_f32(got), **TOL[cd])
        scale = normal(rng, (16,)) + 1
        ref = RL._rms_head_norm(jnp.asarray(x, dt), jnp.asarray(scale))
        got = PL._rms_head_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale))
        assert_close(np_f32(ref), np_f32(got), **TOL[cd])


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,q_offset,kv_len,t", [
    (True, None, None, 12), (True, 5, 9, 4), (False, None, 7, 3), (True, 9, 10, 1),
])
def test_sdpa(cd, causal, q_offset, kv_len, t):
    rng = np.random.default_rng(2)
    q, k, v = normal(rng, (2, t, 8, 16)), normal(rng, (2, 12, 2, 16)), normal(rng, (2, 12, 2, 16))
    jdt, tdt = getattr(jnp, cd), getattr(torch, cd)
    ref = RL._sdpa(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal=causal,
                   q_offset=None if q_offset is None else jnp.int32(q_offset),
                   kv_len=None if kv_len is None else jnp.int32(kv_len))
    got = PL._sdpa(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), causal=causal,
                   q_offset=q_offset, kv_len=kv_len)
    assert got.dtype == tdt
    assert_close(np_f32(ref), np_f32(got), **TOL[cd])


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["auto", "dense", "pallas"])
def test_attn_apply_without_cache_at_prefill_and_at_decode(cd, impl):
    ref_cfg, cfg = configs(**TINY, compute_dtype=cd, attention_impl=impl)
    p = np_params(RL.attn_specs(ref_cfg), 3)
    rng = np.random.default_rng(4)
    x = normal(rng, (2, 10, 64))
    jdt, tdt = getattr(jnp, cd), getattr(torch, cd)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    ref, _ = RL.attn_apply(to_jax(p), ref_cfg, jnp.asarray(x, jdt), positions=jnp.asarray(pos))
    got, none = PL.attn_apply(to_port(p), cfg, torch.from_numpy(x).to(tdt),
                              positions=torch.from_numpy(pos.copy()))
    assert none is None
    assert_close(np_f32(ref), np_f32(got), **TOL[cd], what="no cache")

    zeros = np.zeros((2, 16, 2, 16), np.float32)
    ref_cache = {"k": jnp.asarray(zeros, jdt), "v": jnp.asarray(zeros, jdt)}
    cache = {"k": torch.zeros((2, 16, 2, 16), dtype=tdt), "v": torch.zeros((2, 16, 2, 16), dtype=tdt)}
    ref, ref_cache = RL.attn_apply(to_jax(p), ref_cfg, jnp.asarray(x, jdt),
                                   positions=jnp.asarray(pos), cache=ref_cache,
                                   cache_index=jnp.int32(0))
    got, cache = PL.attn_apply(to_port(p), cfg, torch.from_numpy(x).to(tdt),
                               positions=torch.from_numpy(pos.copy()), cache=cache, cache_index=0)
    assert_close(np_f32(ref), np_f32(got), **TOL[cd], what="prefill")
    for kv in ("k", "v"):
        assert_close(np_f32(ref_cache[kv]), np_f32(cache[kv]), **TOL[cd], what=f"prefill {kv}")

    x1 = normal(rng, (2, 1, 64))
    pos1 = np.full((2, 1), 10, np.int32)
    ref, ref_cache = RL.attn_apply(to_jax(p), ref_cfg, jnp.asarray(x1, jdt),
                                   positions=jnp.asarray(pos1), cache=ref_cache,
                                   cache_index=jnp.int32(10))
    got, cache = PL.attn_apply(to_port(p), cfg, torch.from_numpy(x1).to(tdt),
                               positions=torch.from_numpy(pos1), cache=cache, cache_index=10)
    assert_close(np_f32(ref), np_f32(got), **TOL[cd], what="decode")
    for kv in ("k", "v"):
        assert_close(np_f32(ref_cache[kv]), np_f32(cache[kv]), **TOL[cd], what=f"decode {kv}")
    with pytest.raises(ValueError, match="cannot take"):
        PL.attn_apply(to_port(p), cfg, torch.from_numpy(x).to(tdt),
                      positions=torch.from_numpy(pos.copy()), cache=cache, cache_index=10)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_mlp_apply(act, cd):
    ref_cfg, cfg = configs(**TINY, mlp_act=act, use_bias=act == "gelu", compute_dtype=cd)
    p = np_params(RL.mlp_specs(ref_cfg), 5)
    if act == "gelu":
        p = {k: v + 0.1 if k.startswith("b") else v for k, v in p.items()}
    x = normal(np.random.default_rng(6), (2, 5, 64))
    ref = RL.mlp_apply(to_jax(p), ref_cfg, jnp.asarray(x, getattr(jnp, cd)))
    got = PL.mlp_apply(to_port(p), cfg, torch.from_numpy(x).to(getattr(torch, cd)))
    assert_close(np_f32(ref), np_f32(got), **TOL[cd])


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_embed_and_unembed(tie, cd):
    ref_cfg, cfg = configs(**TINY, tie_embeddings=tie, compute_dtype=cd)
    p = np_params(RL.embedding_specs(ref_cfg), 7)
    tokens = np.random.default_rng(8).integers(0, 512, size=(2, 9)).astype(np.int32)
    ref = RL.embed_apply(to_jax(p), ref_cfg, jnp.asarray(tokens))
    got = PL.embed_apply(to_port(p), cfg, torch.from_numpy(tokens).long())
    assert got.dtype == cfg.cdtype
    assert np.array_equal(np_f32(ref), np_f32(got))  # a gather and one cast
    x = normal(np.random.default_rng(9), (2, 9, 64))
    ref = RL.unembed_apply(to_jax(p), ref_cfg, jnp.asarray(x, getattr(jnp, cd)))
    got = PL.unembed_apply(to_port(p), cfg, torch.from_numpy(x).to(getattr(torch, cd)))
    assert got.dtype == torch.float32
    assert_close(np.asarray(ref), got.numpy(), **TOL[cd])


# ---------------------------------------------------------------- the model


def tiny_pair(cd, impl, seed=0, **kw):
    ref_cfg, cfg = configs(**TINY, compute_dtype=cd, attention_impl=impl, **kw)
    ref_model = RefModel(ref_cfg)
    p = np_params(ref_model.param_specs(), seed)
    return ref_model, to_jax(p), PortModel(cfg, params=params_from_jax(p, cfg), device="cpu")


@pytest.mark.parametrize("t", [128, 100])
@pytest.mark.parametrize("impl", ["auto", "dense", "pallas"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_forward_and_loss_match_reference(cd, impl, t):
    ref_model, ref_p, model = tiny_pair(cd, impl)
    rng = np.random.default_rng(t)
    batch = {"tokens": rng.integers(0, 512, size=(2, t)).astype(np.int32),
             "loss_mask": (rng.random((2, t)) < 0.8).astype(np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with reference_mode(cd):
        ref_logits, ref_aux = jax.jit(ref_model.forward)(ref_p, jbatch)
        ref_loss, ref_m = jax.jit(ref_model.loss_fn)(ref_p, jbatch)
    with torch.no_grad():
        logits, aux = model.forward(batch)
        loss, metrics = model.loss_fn(batch)
    assert logits.shape == (2, t, 512) and logits.dtype == torch.float32
    assert_close(np.asarray(ref_logits), logits.numpy(), **TOL[cd], what="logits")
    assert float(aux) == float(ref_aux) == 0.0
    for k in ("loss", "ce", "z_loss"):
        assert_close(float(ref_m[k]), float(metrics[k]), **TOL[cd], what=k)
    assert float(metrics["tokens"]) == float(ref_m["tokens"])
    assert_close(float(ref_loss), float(loss), **TOL[cd])


@pytest.mark.parametrize("impl", ["auto", "dense", "pallas"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(cd, impl):
    ref_model, ref_p, model = tiny_pair(cd, impl, seed=1)
    prompt = np.random.default_rng(11).integers(0, 512, size=(2, 100)).astype(np.int32)
    ref_cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                             ref_model.cache_specs(2, 128), is_leaf=ref_is_spec)
    cache = model.init_cache(2, 128)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in ref_cache.items()}
    with reference_mode(cd):
        ref_logits, ref_cache = jax.jit(ref_model.prefill)(
            ref_p, {"tokens": jnp.asarray(prompt)}, ref_cache)
    with torch.no_grad():
        logits, cache = model.prefill({"tokens": prompt}, cache)
    assert logits.shape == (2, 1, 512)
    assert_close(np.asarray(ref_logits), logits.numpy(), **TOL[cd], what="prefill logits")
    decode = jax.jit(ref_model.decode_step)
    for step in range(3):
        tok = np.asarray(jnp.argmax(ref_logits[:, -1], -1)).astype(np.int32)[:, None]
        with reference_mode(cd):
            ref_logits, ref_cache = decode(ref_p, ref_cache, jnp.asarray(tok),
                                           jnp.int32(100 + step))
        with torch.no_grad():
            logits, cache = model.decode_step(cache, tok, 100 + step)
        assert_close(np.asarray(ref_logits), logits.numpy(), **TOL[cd], what=f"decode {step}")
    for kv in ("k", "v"):
        assert_close(np_f32(ref_cache[kv]), np_f32(cache[kv]), **TOL[cd], what=f"cache {kv}")


def test_decode_agrees_with_teacher_forced_forward():
    _, _, model = tiny_pair("float32", "pallas", seed=2)
    tokens = np.random.default_rng(12).integers(0, 512, size=(2, 40)).astype(np.int32)
    with torch.no_grad():
        full, _ = model.forward({"tokens": tokens})
        cache = model.init_cache(2, 64)
        last, cache = model.prefill({"tokens": tokens[:, :32]}, cache)
        steps = [last]
        for i in range(32, 40):
            step, cache = model.decode_step(cache, tokens[:, i:i + 1], i)
            steps.append(step)
    assert_close(full[:, 31:40].numpy(), torch.cat(steps, 1)[:, :9].numpy(),
                 rtol=FLOAT_RTOL, atol=FLOAT_ATOL)


@pytest.fixture(scope="module")
def qwen3_8b_layer():
    """One Qwen3-8B layer at full width, vocab cut to 4096: the reference
    model and parameters and their numpy values."""
    ref_cfg = ref_configs.get("qwen3-8b").model.replace(num_layers=1, vocab_size=4096)
    ref_model = RefModel(ref_cfg)
    return ref_cfg, ref_model, np_params(ref_model.param_specs(), 13)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_one_full_width_qwen3_8b_layer_matches_reference(qwen3_8b_layer, impl):
    ref_cfg, ref_model, p = qwen3_8b_layer
    ref_cfg = ref_cfg.replace(attention_impl=impl)
    cfg = PortConfig(**dataclasses.asdict(ref_cfg))
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff) == \
        (4096, 32, 8, 128, 12288)
    tokens = np.random.default_rng(14).integers(0, 4096, size=(1, 128)).astype(np.int32)
    with reference_mode("bfloat16"):
        ref_logits, _ = RefModel(ref_cfg).forward(to_jax(p), {"tokens": jnp.asarray(tokens)})
    model = PortModel(cfg, params=params_from_jax(p, cfg), device="cpu")
    with torch.no_grad():
        logits, _ = model.forward({"tokens": tokens})
    assert_close(np.asarray(ref_logits), logits.numpy(), rtol=BF16_RTOL, atol=BF16_ATOL)


def test_cast_weights_keeps_the_numbers():
    _, _, model = tiny_pair("bfloat16", "auto", seed=3)
    tokens = np.random.default_rng(15).integers(0, 512, size=(1, 64)).astype(np.int32)
    with torch.no_grad():
        before, _ = model.forward({"tokens": tokens})
        model.cast_weights_()
        after, _ = model.forward({"tokens": tokens})
    assert model.layers[0]["attn"]["wq"].dtype == torch.bfloat16
    assert model.layers[0]["attn"]["q_norm"].dtype == torch.float32
    assert torch.equal(before, after)


# ---------------------------------------------------------------- the other configs

NEW_ARCHS = [a for a in ref_configs.ARCHS if a not in ("qwen3-8b", "mamba2-370m")]


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite-8b", "granite-34b", "qwen1.5-32b"])
def test_dense_configs_match_reference(arch, cd):
    """The other dense configs' smoke variants (granite-34b's one KV head,
    qwen1.5's QKV biases): forward, loss, prefill and three decode steps,
    held as the new families are (`tests/torch_zoo.py`)."""
    ref_model, ref_p, model = zoo.pair(ref_configs.smoke(arch).model.replace(compute_dtype=cd),
                                       seed=1)
    assert model.cfg.num_kv_heads == {"granite-8b": 4, "granite-34b": 1, "qwen1.5-32b": 4}[arch]
    assert ("bq" in model.layers[0]["attn"]) == (arch == "qwen1.5-32b")
    batch = zoo.make_inputs(model.cfg, 2, 20, seed=2)
    zoo.hold_forward(ref_model, ref_p, model, batch, cd)
    zoo.hold_prefill_and_decode(ref_model, ref_p, model,
                                dict(batch, tokens=batch["tokens"][:, :12]), cd, max_len=32)


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_params_from_jax_carries_every_leaf(arch):
    """Every leaf of the reference's tree lands in the port's model with
    its values and dtype (bfloat16 for the MoE configs), each stacked group
    (decoder or SSM layers, ``encoder.layers``, ``hybrid.mamba``) split
    into its layers."""
    ref_cfg = ref_configs.smoke(arch).model
    ref_p = zoo.ref_params(RefModel(ref_cfg), 20)
    cfg = zoo.port_config(ref_cfg)
    model = PortModel(cfg, params=params_from_jax(ref_p, cfg), device="cpu")
    port = dict(leaves(model.params_tree()))
    stacked = {"layers": cfg.num_layers, "hybrid.mamba": cfg.num_layers,
               "encoder.layers": cfg.encoder.num_layers if cfg.encoder else 0}
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_p)
    seen = 0
    for path, a in flat:
        name = ".".join(k.key for k in path)
        group = next((g for g in stacked if name.startswith(g + ".")), None)
        if group is None:
            pairs = [(name, np.asarray(a))]
        else:
            rest = name[len(group) + 1:]
            pairs = [(f"{group}.{i}.{rest}", np.asarray(a)[i]) for i in range(stacked[group])]
        for port_name, want in pairs:
            got = port[port_name]
            assert str(got.dtype).split(".")[-1] == want.dtype.name, port_name
            assert np.array_equal(got.float().numpy(), want.astype(np.float32)), port_name
            seen += 1
    assert seen == len(port)
    if ref_cfg.family == "moe":
        assert port["layers.0.moe.wi_gate"].dtype == torch.bfloat16
        assert port["layers.0.moe.router"].dtype == torch.float32


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--prompt-len", "8",
                "--max-new-tokens", "4", "--max-len", "32", "--batch", "2"])
    out = capsys.readouterr().out
    assert "[serve] device=cpu" in out and "new=4" in out
