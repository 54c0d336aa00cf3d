"""The port's encoder-decoder family (whisper-tiny) against the JAX package's, on the CPU.

Covered: the sinusoidal table; the encoder stack (bidirectional, LayerNorm,
GELU, biased projections, sinusoidal positions); cross-attention through
`attn_apply(kv_source=...)`; the smoke model's forward, loss, prefill (the
encoder run once, its K/V projected into the ``xk`` / ``xv`` caches) and
three decode steps, in float32 and bfloat16, the caches included; decode
against the teacher-forced forward; the serving loop's tokens; and
training from the command line, with a resume.  The decoder's learned position table is whisper's own.
Helpers and tolerances: `tests/torch_zoo.py`; the model end to end in
float32 is held to `MODEL_F32_TOL`.

In bfloat16 the layers agree to BF16_RTOL / BF16_ATOL (the encoder and
cross-attention here, the norms, GELU MLP and attention in
`tests/test_torch_models.py`; measured on the decoder block's own inputs,
each piece lands within two bfloat16 steps of the reference's), but the
model end to end is
held at an atol of 2^-3: at the reference's initializers its activations
reach 39 (a bfloat16 step of 0.25), and the reference's own bfloat16
logits lie up to 0.69 (RMS 0.087) from its float32 ones; the port's lie
0.110 at most (RMS 0.0074) from the reference's, 64 of 10240 logits beyond
2^-5, an order of magnitude closer than either comes to float32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as ref_configs
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.runtime.decode_loop import ServeLoop as RefServeLoop
from repro.runtime.steps import make_serve_steps as ref_serve_steps
from repro_torch.launch import serve
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_jax
from repro_torch.testing import BF16_RTOL, FLOAT_ATOL, assert_close, compare_token_traces
from torch_zoo import (MODEL_F32_TOL, TOL, hold_decode_against_forward, hold_forward,
                       hold_prefill_and_decode, jax_batch, make_inputs, normal, np_f32, np_values,
                       pair, port_config, reference_mode, zero_cache, train_cli_and_resume)

ARCH = "whisper-tiny"
ENCDEC_TOL = {"float32": MODEL_F32_TOL, "bfloat16": dict(rtol=BF16_RTOL, atol=2.0**-3)}


def encdec_cfg(cd="float32", **kw):
    return ref_configs.smoke(ARCH).model.replace(compute_dtype=cd, **kw)


@pytest.mark.parametrize("length,d", [(16, 64), (1500, 384)])
def test_sinusoidal_positions_match_reference(length, d):
    ref = np.asarray(RT.sinusoidal_positions(length, d))
    got = PT.sinusoidal_positions(length, d).numpy()
    # angles up to 1500 rad: one float32 step of the frequency moves them by ~1e-4
    assert_close(ref, got, rtol=0.0, atol=1e-3 if length > 100 else FLOAT_ATOL)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_encoder_stack_matches_reference(cd):
    ref_cfg = encdec_cfg(cd)
    cfg = port_config(ref_cfg)
    specs = RT.encoder_stack_specs(ref_cfg)
    p = jax.tree.map(jnp.asarray, np_values(specs, 1))
    frames = normal(np.random.default_rng(2), (2, 16, 64), 0.5)
    with reference_mode(cd):
        ref = RT.encoder_stack_apply(p, ref_cfg, jnp.asarray(frames))
    port_p = params_from_jax({"encoder": p}, cfg)["encoder"]
    got = PT.encoder_stack_apply(port_p, cfg, torch.from_numpy(frames))
    assert got.dtype == cfg.cdtype
    assert_close(np_f32(ref), np_f32(got), **TOL[cd])


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(cd):
    ref_cfg = encdec_cfg(cd)
    cfg = port_config(ref_cfg)
    p = jax.tree.map(jnp.asarray, np_values(RL.attn_specs(ref_cfg, cross=True), 3))
    assert sorted(PL.attn_specs(cfg, cross=True)) == sorted(p)
    rng = np.random.default_rng(4)
    x, src = normal(rng, (2, 7, 64)), normal(rng, (2, 16, 64))
    jdt, tdt = getattr(jnp, cd), getattr(torch, cd)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    with reference_mode(cd):
        ref, _ = RL.attn_apply(p, ref_cfg, jnp.asarray(x, jdt), positions=jnp.asarray(pos),
                               causal=False, kv_source=jnp.asarray(src, jdt), use_rope=False)
    got, none = PL.attn_apply(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p), cfg,
                              torch.from_numpy(x).to(tdt), positions=torch.from_numpy(pos.copy()),
                              causal=False, kv_source=torch.from_numpy(src).to(tdt),
                              use_rope=False)
    assert none is None
    assert_close(np_f32(ref), np_f32(got), **TOL[cd])


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_model_matches_reference(cd):
    """Forward, loss, prefill (cross caches built from the encoder) and
    three decode steps, every cache buffer included."""
    ref_model, ref_p, model = pair(encdec_cfg(cd), seed=1)
    batch = make_inputs(model.cfg, 2, 20, seed=5)
    hold_forward(ref_model, ref_p, model, batch, cd, ENCDEC_TOL[cd])
    cache = hold_prefill_and_decode(ref_model, ref_p, model,
                                    dict(batch, tokens=batch["tokens"][:, :12]), cd, max_len=32,
                                    tol=ENCDEC_TOL[cd])
    assert set(cache) == {"k", "v", "xk", "xv"}
    assert tuple(cache["xk"].shape) == (2, 2, 16, 4, 16)  # (layers, B, source_len, KV, hd)


def test_decode_agrees_with_teacher_forced_forward():
    _, _, model = pair(encdec_cfg(), seed=2)
    batch = make_inputs(model.cfg, 2, 25, seed=6, loss_mask=False)
    hold_decode_against_forward(model, batch, 15, 32)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_serve_loop_tokens_equal_reference_up_to_ties(cd):
    ref_model, ref_p, model = pair(encdec_cfg(cd), seed=3)
    req = serve.make_batch(model.cfg, 2, 12, seed=7)
    req = {k: v for k, v in req.items() if k != "loss_mask"}
    new = 8
    with reference_mode(cd):
        prefill, decode = ref_serve_steps(ref_model)
        ref_loop = RefServeLoop(prefill_step=jax.jit(prefill), decode_step=jax.jit(decode),
                                params=ref_p, eos_id=-1,
                                init_cache=lambda: zero_cache(ref_model, 2, 32))
        ref_tokens = ref_loop.generate(jax_batch(req), new)["tokens"]
        seq = np.concatenate([req["tokens"], ref_tokens[:, :-1]], 1)
        ref_logits = np.asarray(ref_model.forward(ref_p, jax_batch(dict(req, tokens=seq)))[0])
    ref_logits = ref_logits[:, req["tokens"].shape[1] - 1:]
    out = serve.serve_loop(model, 2, 32).generate(
        {k: torch.from_numpy(v) for k, v in req.items()}, new)
    cmp = compare_token_traces(ref_tokens, out["tokens"], ref_logits,
                               atol=FLOAT_ATOL if cd == "float32" else TOL[cd]["atol"])
    if cd == "float32":
        assert cmp.matched == 2, cmp.ties
    assert cmp.matched + len(cmp.ties) == 2


def test_train_cli_trains_and_resumes(tmp_path):
    train_cli_and_resume(ARCH, tmp_path)
