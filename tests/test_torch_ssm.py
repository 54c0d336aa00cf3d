"""The port's Mamba-2 SSM family against the JAX package's, on the CPU.

Both packages get the same parameters and inputs, drawn with numpy from a
seed; the reference's parameter values reach the port through
`repro_torch.models.convert.params_from_jax`.  Covered: the mamba2-370m
configuration and spec tree; the SSD core (`ssd_chunked` with and without
the kernel route, `ssd_decode_step`, the chunked-then-decode
continuation); the layer's pieces (`_causal_conv`, `_gated_norm`,
`ssm_apply` without state, at prefill with state and at decode); the
two-layer smoke model's forward, prefill, decode and `ServeLoop` tokens;
one mamba2-370m layer at full width; `cast_weights_` and the serve CLI.

On the CPU ``use_kernel=True`` runs the plain version of the SSD kernel
(`repro_torch.kernels.ssd.ops.ssd_diag_plain`); the reference runs its
einsum route, as its `Model` does.

Tolerances.  The SSD core in float32 is held to the exact result (a
float64 recurrence) at rtol and atol 1e-4, the reference's own limit
against its recurrence (`tests/test_ssm.py`), and to the reference with
that limit plus the reference's own distance from the exact result: over
a 256-step chunk XLA's float32 cumsum of the log-decays strays by about
1e-5 (see `tests/test_torch_ssd.py`), the port's float64-accumulated one
by half a float32 step.  Layers and models in float32 compute agree to
FLOAT_RTOL / FLOAT_ATOL, in bfloat16 to BF16_RTOL / BF16_ATOL, with the
reference run eagerly (`jax.disable_jit`) in bfloat16 (the reasons are in
`repro_torch.testing` and `tests/test_torch_models.py`).
"""

import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as ref_configs
from repro.models import Model as RefModel
from repro.models import ssm as RS
from repro.models import total_params as ref_total_params
from repro.models.spec import is_spec as ref_is_spec
from repro.runtime.decode_loop import ServeLoop as RefServeLoop
from repro.runtime.steps import make_serve_steps as ref_serve_steps
import repro_torch.configs as port_configs
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.launch import serve
from repro_torch.models import ssm as PS
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.config import SSMConfig as PortSSMConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model, _param_specs, total_params
from repro_torch.models.spec import count_params, leaves, tree_bytes
from repro_torch.testing import (BF16_ATOL, BF16_RTOL, FLOAT_ATOL, FLOAT_RTOL, assert_close,
                                 compare_token_traces)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mamba2-370m"
MAMBA2_370M_PARAMS = 368_338_432
TOL = {"float32": dict(rtol=FLOAT_RTOL, atol=FLOAT_ATOL),
       "bfloat16": dict(rtol=BF16_RTOL, atol=BF16_ATOL)}
SSD_TOL = dict(rtol=1e-4, atol=1e-4)


def port_config(ref_cfg):
    """The reference's ModelConfig as the port's."""
    kw = dataclasses.asdict(ref_cfg)
    kw["ssm"] = PortSSMConfig(**kw["ssm"])
    return PortConfig(**kw)


def smoke_configs(cd="float32", **kw):
    ref_cfg = ref_configs.smoke(ARCH).model.replace(compute_dtype=cd, **kw)
    return ref_cfg, port_config(ref_cfg)


def np_params(ref_specs, seed):
    """Numpy values for the reference's spec tree, drawn as its initializers
    draw (scales and biases perturbed off 1 and 0 so that they matter)."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if s.init == "zeros":
            return 0.1 * rng.standard_normal(s.shape, dtype=np.float32)
        if s.init == "ones":
            return 1 + 0.1 * rng.standard_normal(s.shape, dtype=np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = s.init_scale if s.init == "normal" else s.init_scale / np.sqrt(fan_in)
        return rng.standard_normal(s.shape, dtype=np.float32) * np.float32(std)

    return jax.tree.map(leaf, ref_specs, is_leaf=ref_is_spec)


def reference_mode(cd):
    """Eager JAX for bfloat16 compute (see the module docstring)."""
    return jax.disable_jit() if cd == "bfloat16" else contextlib.nullcontext()


def to_jax(tree, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def to_port(tree, dtype=None):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def np_f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------- configs and specs


def _ref_leaves(specs):
    flat, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=ref_is_spec)
    return {".".join(k.key for k in path): s for path, s in flat}


def test_mamba2_370m_config_and_spec_tree_match_reference():
    for get in ("get", "smoke"):
        ref_spec = getattr(ref_configs, get)(ARCH)
        port_spec = getattr(port_configs, get)(ARCH)
        assert port_spec.name == ref_spec.name
        assert dataclasses.asdict(port_spec.model) == dataclasses.asdict(ref_spec.model)
        assert dataclasses.asdict(port_spec.exec) == dataclasses.asdict(ref_spec.exec)
    smoke = port_configs.smoke(ARCH).model
    assert (smoke.num_layers, smoke.d_model, smoke.ssm.d_state, smoke.ssm.head_dim,
            smoke.ssm.chunk_size) == (2, 64, 16, 16, 8)
    ref_cfg, cfg = ref_configs.get(ARCH).model, port_configs.get(ARCH).model
    ref_specs = _ref_leaves(RefModel(ref_cfg).param_specs())
    port_specs = dict(leaves(_param_specs(cfg)))
    assert list(port_specs) == list(ref_specs)  # same names, same order
    for name, s in ref_specs.items():
        p = port_specs[name]
        assert p.shape == s.shape and p.axes == s.axes and p.init == s.init, name
        assert p.init_scale == s.init_scale
        assert str(p.dtype).split(".")[-1] == jnp.dtype(s.dtype).name, name
    assert count_params(_param_specs(cfg)) == total_params(cfg) == MAMBA2_370M_PARAMS
    assert ref_total_params(ref_cfg) == MAMBA2_370M_PARAMS
    assert tree_bytes(_param_specs(cfg)) == 4 * MAMBA2_370M_PARAMS
    for batch, max_len in ((1, 16), (8, 4096)):  # the state does not grow with max_len
        ref_cache = RefModel(ref_cfg).cache_specs(batch, max_len)
        got = PS.ssm_state_specs(cfg, batch, cfg.num_layers)
        assert {k: (v.shape, v.axes, str(v.dtype).split(".")[-1]) for k, v in got.items()} == \
            {k: (v.shape, v.axes, jnp.dtype(v.dtype).name) for k, v in ref_cache.items()}


# ---------------------------------------------------------------- SSD core


def naive_ssd(x, dt, A, B_, C_, initial_state=None):
    """The literal O(L·N·P) recurrence in float64 — the exact result."""
    b, l, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    rep = h // g
    Bf = np.repeat(np.asarray(B_, np.float64), rep, axis=2)
    Cf = np.repeat(np.asarray(C_, np.float64), rep, axis=2)
    state = (np.asarray(initial_state, np.float64) if initial_state is not None
             else np.zeros((b, h, n, p)))
    ys = np.zeros((b, l, h, p))
    for t in range(l):
        decay = np.exp(dt[:, t].astype(np.float64) * A)
        state = decay[..., None, None] * state + np.einsum(
            "bh,bhn,bhp->bhnp", dt[:, t], Bf[:, t], x[:, t].astype(np.float64))
        ys[:, t] = np.einsum("bhn,bhnp->bhp", Cf[:, t], state)
    return ys, state


def ssd_inputs(seed, b=2, l=16, h=2, p=4, g=1, n=4, init=False):
    rng = np.random.default_rng(seed)
    x = normal(rng, (b, l, h, p))
    dt = np.logaddexp(normal(rng, (b, l, h)), 0.0).astype(np.float32)
    A = -np.exp(normal(rng, (h,), 0.5))
    B_, C_ = normal(rng, (b, l, g, n)), normal(rng, (b, l, g, n))
    st = normal(rng, (b, h, n, p)) if init else None
    return x, dt, A, B_, C_, st


def hold(got, ref, exact, what):
    """``got`` within SSD_TOL of ``exact``, and of ``ref`` with the reference's
    own distance from ``exact`` added to the limit."""
    got, ref = np_f32(got), np_f32(ref)
    assert_close(exact, got, **SSD_TOL, what=f"{what} vs exact")
    limit = SSD_TOL["atol"] + SSD_TOL["rtol"] * np.abs(ref) + np.abs(ref - exact)
    assert (np.abs(got - ref) <= limit).all(), f"{what} vs reference"


SSD_CASES = {  # (seed, b, l, h, p, g, n, chunk, initial state)
    "two chunks": (0, 2, 16, 2, 4, 1, 4, 8, False),
    "ragged length": (1, 2, 13, 2, 4, 1, 4, 4, False),
    "initial state": (2, 2, 16, 2, 4, 1, 4, 4, True),
    "groups": (3, 2, 16, 4, 4, 2, 4, 4, False),
    "shorter than a chunk": (4, 1, 6, 2, 4, 1, 4, 8, True),
    "production chunk, ragged": (5, 1, 300, 2, 16, 1, 32, 256, True),
}


@pytest.mark.parametrize("use_kernel", [False, True], ids=["einsum", "kernel"])
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_chunked_matches_reference(case, use_kernel):
    seed, b, l, h, p, g, n, chunk, init = SSD_CASES[case]
    x, dt, A, B_, C_, st = ssd_inputs(seed, b, l, h, p, g, n, init)
    y_exact, st_exact = naive_ssd(x, dt, A, B_, C_, st)
    j = [None if a is None else jnp.asarray(a) for a in (x, dt, A, B_, C_, st)]
    ref_y, ref_st = RS.ssd_chunked(*j[:5], chunk_size=chunk, initial_state=j[5])
    t = [None if a is None else torch.from_numpy(a) for a in (x, dt, A, B_, C_, st)]
    y, fin = PS.ssd_chunked(*t[:5], chunk_size=chunk, initial_state=t[5],
                            use_kernel=use_kernel)
    assert y.shape == (b, l, h, p) and fin.shape == (b, h, n, p)
    assert y.dtype == fin.dtype == torch.float32
    hold(y, ref_y, y_exact, "y")
    hold(fin, ref_st, st_exact, "final state")


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_decode_step_matches_reference(g):
    x, dt, A, B_, C_, st = ssd_inputs(6, b=2, l=1, h=4, p=4, g=g, n=4, init=True)
    ref_y, ref_st = RS.ssd_decode_step(jnp.asarray(st), *(jnp.asarray(a[:, 0]) for a in (x, dt)),
                                       jnp.asarray(A), jnp.asarray(B_[:, 0]), jnp.asarray(C_[:, 0]))
    y, new = PS.ssd_decode_step(torch.from_numpy(st), torch.from_numpy(x[:, 0]),
                                torch.from_numpy(dt[:, 0]), torch.from_numpy(A),
                                torch.from_numpy(B_[:, 0]), torch.from_numpy(C_[:, 0]))
    assert_close(np.asarray(ref_y), y.numpy(), **TOL["float32"], what="y")
    assert_close(np.asarray(ref_st), new.numpy(), **TOL["float32"], what="state")


@pytest.mark.parametrize("use_kernel", [False, True], ids=["einsum", "kernel"])
def test_chunked_then_decode_continuation(use_kernel):
    """As tests/test_ssm.py: chunked(A;B) == chunked(A) then chunked(B,
    initial_state); and the decode step after a chunked prefix gives the
    recurrence's next output and state."""
    x, dt, A, B_, C_, _ = ssd_inputs(7, l=17)
    t = [torch.from_numpy(a) for a in (x, dt, A, B_, C_)]
    kw = dict(chunk_size=4, use_kernel=use_kernel)
    y_full, st_full = PS.ssd_chunked(*(a[:, :16] if a.dim() > 1 else a for a in t), **kw)
    y1, st1 = PS.ssd_chunked(*(a[:, :8] if a.dim() > 1 else a for a in t), **kw)
    y2, st2 = PS.ssd_chunked(*(a[:, 8:16] if a.dim() > 1 else a for a in t),
                             initial_state=st1, **kw)
    assert_close(y_full.numpy(), torch.cat([y1, y2], 1).numpy(), rtol=1e-4, atol=1e-4)
    assert_close(st_full.numpy(), st2.numpy(), rtol=1e-4, atol=1e-4)
    y_exact, st_exact = naive_ssd(x, dt, A, B_, C_)
    y_dec, st_dec = PS.ssd_decode_step(st_full, *(a[:, 16] for a in t[:2]), t[2],
                                       t[3][:, 16], t[4][:, 16])
    assert_close(y_exact[:, 16], y_dec.numpy(), rtol=1e-4, atol=1e-4)
    assert_close(st_exact, st_dec.numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- layer pieces


@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_causal_conv(cd, with_prev):
    rng = np.random.default_rng(8)
    seq, w, bias = normal(rng, (2, 7, 6)), normal(rng, (4, 6)), normal(rng, (6,))
    prev = normal(rng, (2, 3, 6)) if with_prev else None
    jdt, tdt = getattr(jnp, cd), getattr(torch, cd)
    with reference_mode(cd):
        ref, ref_prev = RS._causal_conv(jnp.asarray(seq, jdt), jnp.asarray(w), jnp.asarray(bias),
                                        None if prev is None else jnp.asarray(prev, jdt))
    got, new_prev = PS._causal_conv(torch.from_numpy(seq).to(tdt), torch.from_numpy(w),
                                    torch.from_numpy(bias),
                                    None if prev is None else torch.from_numpy(prev).to(tdt))
    assert got.dtype == new_prev.dtype == tdt and new_prev.shape == (2, 3, 6)
    assert_close(np_f32(ref), np_f32(got), **TOL[cd], what="out")
    assert np.array_equal(np_f32(ref_prev), np_f32(new_prev))  # the last K-1 inputs


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_gated_norm(cd):
    rng = np.random.default_rng(9)
    y, z, scale = normal(rng, (2, 5, 32), 2.0), normal(rng, (2, 5, 32)), normal(rng, (32,)) + 1
    jdt, tdt = getattr(jnp, cd), getattr(torch, cd)
    with reference_mode(cd):
        ref = RS._gated_norm(jnp.asarray(y, jdt), jnp.asarray(z, jdt), jnp.asarray(scale))
    got = PS._gated_norm(torch.from_numpy(y).to(tdt), torch.from_numpy(z).to(tdt),
                         torch.from_numpy(scale))
    assert got.dtype == tdt
    assert_close(np_f32(ref), np_f32(got), **TOL[cd])


@pytest.mark.parametrize("use_kernel", [False, True], ids=["einsum", "kernel"])
@pytest.mark.parametrize("mode", ["no state", "prefill", "decode"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_ssm_apply_matches_reference(cd, mode, use_kernel):
    ref_cfg, cfg = smoke_configs(cd)
    p = np_params(RS.ssm_specs(ref_cfg), 10)
    rng = np.random.default_rng(11)
    t = 1 if mode == "decode" else 13
    u = normal(rng, (2, t, 64))
    state = None
    if mode != "no state":
        specs = RS.ssm_state_specs(ref_cfg, 2, 1)
        state = {"ssd": normal(rng, specs["ssd"].shape[1:], 0.3),
                 "conv": normal(rng, specs["conv"].shape[1:])}
    jdt, tdt = getattr(jnp, cd), getattr(torch, cd)
    with reference_mode(cd):
        ref, ref_state = RS.ssm_apply(
            to_jax(p), ref_cfg, jnp.asarray(u, jdt),
            state=None if state is None else {"ssd": jnp.asarray(state["ssd"]),
                                              "conv": jnp.asarray(state["conv"], jdt)})
    got, new_state = PS.ssm_apply(
        to_port(p), cfg, torch.from_numpy(u).to(tdt), use_kernel=use_kernel,
        state=None if state is None else {"ssd": torch.from_numpy(state["ssd"]),
                                          "conv": torch.from_numpy(state["conv"]).to(tdt)})
    assert got.dtype == tdt and got.shape == (2, t, 64)
    assert_close(np_f32(ref), np_f32(got), **TOL[cd], what="out")
    assert new_state["ssd"].dtype == torch.float32 and new_state["conv"].dtype == tdt
    for k in ("ssd", "conv"):
        assert_close(np_f32(ref_state[k]), np_f32(new_state[k]), **TOL[cd], what=k)


# ---------------------------------------------------------------- the smoke model


def smoke_pair(cd, seed=0):
    ref_cfg, cfg = smoke_configs(cd)
    ref_model = RefModel(ref_cfg)
    p = np_params(ref_model.param_specs(), seed)
    return ref_model, to_jax(p), Model(cfg, params=params_from_jax(p, cfg), device="cpu")


@pytest.mark.parametrize("t", [16, 13])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_forward_and_loss_match_reference(cd, t):
    ref_model, ref_p, model = smoke_pair(cd)
    rng = np.random.default_rng(t)
    batch = {"tokens": rng.integers(0, 256, size=(2, t)).astype(np.int32),
             "loss_mask": (rng.random((2, t)) < 0.8).astype(np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with reference_mode(cd):
        ref_logits, _ = jax.jit(ref_model.forward)(ref_p, jbatch)
    before = ssd_kernel.ssd_diag_cuda.launches
    with torch.no_grad():
        logits, aux = model.forward(batch)
    assert ssd_kernel.ssd_diag_cuda.launches == before  # the CPU takes the plain version
    assert logits.shape == (2, t, 256) and logits.dtype == torch.float32
    assert float(aux) == 0.0
    assert_close(np.asarray(ref_logits), logits.numpy(), **TOL[cd], what="logits")
    if cd == "float32":  # the loss is the dense family's code, on these logits
        _, ref_m = jax.jit(ref_model.loss_fn)(ref_p, jbatch)
        with torch.no_grad():
            _, metrics = model.loss_fn(batch)
        for k in ("loss", "ce", "z_loss"):
            assert_close(float(ref_m[k]), float(metrics[k]), **TOL[cd], what=k)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(cd):
    ref_model, ref_p, model = smoke_pair(cd, seed=1)
    prompt = np.random.default_rng(12).integers(0, 256, size=(2, 12)).astype(np.int32)
    ref_cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                             ref_model.cache_specs(2, 64), is_leaf=ref_is_spec)
    cache = model.init_cache(2, 64)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in ref_cache.items()}
    with reference_mode(cd):
        ref_logits, ref_cache = jax.jit(ref_model.prefill)(
            ref_p, {"tokens": jnp.asarray(prompt)}, ref_cache)
    with torch.no_grad():
        logits, cache = model.prefill({"tokens": prompt}, cache)
    assert logits.shape == (2, 1, 256)
    assert_close(np.asarray(ref_logits), logits.numpy(), **TOL[cd], what="prefill logits")
    decode = jax.jit(ref_model.decode_step)
    for step in range(3):
        tok = np.asarray(jnp.argmax(ref_logits[:, -1], -1)).astype(np.int32)[:, None]
        with reference_mode(cd):
            ref_logits, ref_cache = decode(ref_p, ref_cache, jnp.asarray(tok),
                                           jnp.int32(12 + step))
        with torch.no_grad():
            logits, cache = model.decode_step(cache, tok, 12 + step)
        assert_close(np.asarray(ref_logits), logits.numpy(), **TOL[cd], what=f"decode {step}")
    for k in ("ssd", "conv"):
        assert_close(np_f32(ref_cache[k]), np_f32(cache[k]), **TOL[cd], what=f"cache {k}")


def test_decode_agrees_with_teacher_forced_forward():
    _, _, model = smoke_pair("float32", seed=2)
    tokens = np.random.default_rng(13).integers(0, 256, size=(2, 29)).astype(np.int32)
    with torch.no_grad():
        full, _ = model.forward({"tokens": tokens})
        cache = model.init_cache(2, 64)
        last, cache = model.prefill({"tokens": tokens[:, :19]}, cache)
        steps = [last]
        for i in range(19, 29):
            step, cache = model.decode_step(cache, tokens[:, i:i + 1], i)
            steps.append(step)
    assert_close(full[:, 18:29].numpy(), torch.cat(steps, 1)[:, :11].numpy(),
                 rtol=FLOAT_RTOL, atol=FLOAT_ATOL)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_serve_loop_tokens_equal_reference_up_to_ties(cd):
    ref_model, ref_p, model = smoke_pair(cd, seed=3)
    prompt = serve.make_batch(model.cfg, 2, 16, seed=4)["tokens"]
    new = 8
    with reference_mode(cd):
        prefill, decode = ref_serve_steps(ref_model)
        ref_loop = RefServeLoop(prefill_step=jax.jit(prefill), decode_step=jax.jit(decode),
                                params=ref_p, eos_id=-1,
                                init_cache=lambda: jax.tree.map(
                                    lambda s: jnp.zeros(s.shape, s.dtype),
                                    ref_model.cache_specs(2, 64), is_leaf=ref_is_spec))
        ref_tokens = ref_loop.generate({"tokens": jnp.asarray(prompt)}, new)["tokens"]
        # The logits that chose each reference token: teacher-forced over
        # the prompt and the reference's own tokens.
        seq = np.concatenate([prompt, ref_tokens[:, :-1]], 1)
        ref_logits = np.asarray(ref_model.forward(ref_p, {"tokens": jnp.asarray(seq)})[0])
    ref_logits = ref_logits[:, prompt.shape[1] - 1:]
    out = serve.serve_loop(model, 2, 64).generate({"tokens": torch.from_numpy(prompt)}, new,
                                                  echo_metrics=True)
    assert out["tokens"].shape == (2, new) and out["metrics"]["decoded"] == new
    cmp = compare_token_traces(ref_tokens, out["tokens"], ref_logits,
                               atol=FLOAT_ATOL if cd == "float32" else BF16_ATOL)
    if cd == "float32":
        assert cmp.matched == 2, cmp.ties
    assert cmp.matched + len(cmp.ties) == 2


def test_cast_weights_keeps_the_numbers():
    """Served after `cast_weights_`, the model gives the logits of its
    float32 parameters: only the weights read in bfloat16 are cast."""
    _, _, model = smoke_pair("bfloat16", seed=4)
    tokens = np.random.default_rng(15).integers(0, 256, size=(2, 21)).astype(np.int32)
    with torch.no_grad():
        before, _ = model.forward({"tokens": tokens})
        cache = model.init_cache(2, 64)
        pre_before, cache = model.prefill({"tokens": tokens[:, :20]}, cache)
        dec_before, _ = model.decode_step(cache, tokens[:, 20:], 20)
        model.cast_weights_()
        after, _ = model.forward({"tokens": tokens})
        cache = model.init_cache(2, 64)
        pre_after, cache = model.prefill({"tokens": tokens[:, :20]}, cache)
        dec_after, _ = model.decode_step(cache, tokens[:, 20:], 20)
    ssm = model.layers[0]["ssm"]
    for k in ("wz", "wx", "wB", "wC", "wdt", "out_proj"):
        assert ssm[k].dtype == torch.bfloat16, k
    for k in ("conv_x", "conv_B", "conv_C", "conv_bias_x", "A_log", "D", "dt_bias",
              "norm_scale"):
        assert ssm[k].dtype == torch.float32, k
    assert model.embed["embedding"].dtype == torch.bfloat16
    assert model.layers[0]["norm"]["scale"].dtype == torch.float32
    assert torch.equal(before, after)
    assert torch.equal(pre_before, pre_after) and torch.equal(dec_before, dec_after)


# ---------------------------------------------------------------- full width


@pytest.fixture(scope="module")
def mamba2_layer():
    """The mamba2-370m config and one layer's SSM parameters (numpy)."""
    ref_cfg = ref_configs.get(ARCH).model
    return ref_cfg, np_params(RS.ssm_specs(ref_cfg), 16)


# In float32, rounding through the in-projections (1024 terms), a 256-step
# SSD and the out-projection (2048 terms) leaves each package about 2e-5
# from the float64 result at outputs of RMS 1 (on this case: the reference
# 1.7e-5, the port 2.1e-5, the port's code run in float64), so they differ
# by up to 2.4e-5: FLOAT_ATOL, 1e-5, is below that, and 1e-4 is held.
FULL_WIDTH_TOL = {"float32": dict(rtol=FLOAT_RTOL, atol=1e-4), "bfloat16": TOL["bfloat16"]}


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_one_full_width_mamba2_370m_layer_matches_reference(mamba2_layer, cd):
    """d_model 1024, 32 heads of 64, state 128, B = 1, T = 512 (two chunks of
    256), the port through the plain version of the SSD kernel."""
    ref_cfg, p = mamba2_layer
    ref_cfg = ref_cfg.replace(compute_dtype=cd)
    cfg = port_config(ref_cfg)
    assert (cfg.d_model, cfg.ssm.num_heads(cfg.d_model), cfg.ssm.head_dim, cfg.ssm.d_state,
            cfg.ssm.chunk_size) == (1024, 32, 64, 128, 256)
    u = normal(np.random.default_rng(17), (1, 512, 1024))
    jdt, tdt = getattr(jnp, cd), getattr(torch, cd)
    with reference_mode(cd):
        ref, ref_state = RS.ssm_apply(to_jax(p), ref_cfg, jnp.asarray(u, jdt))
    with torch.no_grad():
        got, state = PS.ssm_apply(to_port(p), cfg, torch.from_numpy(u).to(tdt), use_kernel=True)
    assert_close(np_f32(ref), np_f32(got), **FULL_WIDTH_TOL[cd], what="out")
    assert_close(np_f32(ref_state["ssd"]), np_f32(state["ssd"]), **FULL_WIDTH_TOL[cd],
                 what="state")


# ---------------------------------------------------------------- serving entry points


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
         "--device", "cpu", "--max-new-tokens", "8"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("[serve] device=cpu batch=4 prompt=16 new=8 ")
    assert lines[1].startswith("[tokens] [")


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: Model(port_configs.smoke(ARCH).model),
                lambda: serve.build_model(ARCH, smoke=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
    model = serve.build_model(ARCH, smoke=True, device="cpu")
    assert model.layers[0]["ssm"]["wx"].dtype == torch.bfloat16  # cast once for serving
    assert model.layers[0]["ssm"]["conv_x"].dtype == torch.float32  # read in float32
