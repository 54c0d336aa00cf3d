"""The port's hybrid family (zamba2) against the JAX package's, on the CPU.

Covered: the spec tree and decode state of the smoke variant and of a
five-layer one with the shared block every 2 layers (three sites); the
forward, loss, prefill and three decode steps of both, in float32 and
bfloat16, every cache buffer (the per-layer SSM states, the per-site KV
caches) held to the reference's; that the shared block runs at the sites
alone and writes only its own site's cache; decode against the
teacher-forced forward; the serving loop's tokens; training from the
command line with a resume; and one zamba2 layer at full width (the shared
attention+MLP block and one Mamba-2 layer).

The port's SSM layers send every chunked SSD call to the SSD op
(``use_kernel=True``: its plain version on the CPU); the reference's
hybrid takes its einsum route.  Float32 models are held end to end to
`MODEL_F32_TOL`.  The full-width layer runs in float32 compute, held to
FLOAT_RTOL and an atol of 1e-4, the full-width mamba2 layer's limit
(`tests/test_torch_ssm.py`: over a 256-step chunk XLA's float32 cumsum of
the log-decays strays by about 1e-5, the port's float64-accumulated one by
half a step; measured here: 7.0e-5 at most).  Not in bfloat16: at the
reference's initializers the shared block's attention logits reach 324
(no qk-norm, and a 3-D projection's fan-in is its head count, 32), where
one bfloat16 step of q (0.25 at 35) moves a logit by about 1 and swings a
near-one-hot softmax; the port's projection lands one step off the
reference's at 0.02 % of q's entries (another summation order), and at
T = 128 839 logits then leave BF16_ATOL, where the reference's jitted and
eager runs (one XLA product) agree to 0.016.  Helpers and tolerances:
`tests/torch_zoo.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as ref_configs
from repro.models import hybrid as RH
from repro.runtime.decode_loop import ServeLoop as RefServeLoop
from repro.runtime.steps import make_serve_steps as ref_serve_steps
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.launch import serve
from repro_torch.models import hybrid as PH
from repro_torch.testing import FLOAT_ATOL, FLOAT_RTOL, assert_close, compare_token_traces
from torch_zoo import (TOL, hold_decode_against_forward, hold_forward, hold_prefill_and_decode,
                       make_inputs, pair, port_config, reference_mode, zero_cache,
                       train_cli_and_resume)

ARCH = "zamba2-1.2b"
VARIANTS = {"smoke": {}, "three sites": {"num_layers": 5}}


def hybrid_cfg(cd="float32", **kw):
    return ref_configs.smoke(ARCH).model.replace(compute_dtype=cd, **kw)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_state_specs_match_reference(variant):
    ref_cfg = hybrid_cfg(**VARIANTS[variant])
    cfg = port_config(ref_cfg)
    assert PH.num_attn_sites(cfg) == RH.num_attn_sites(ref_cfg) == \
        {"smoke": 1, "three sites": 3}[variant]
    ref = RH.hybrid_state_specs(ref_cfg, 3, 40)
    got = PH.hybrid_state_specs(cfg, 3, 40)
    assert {k: (v.shape, v.axes, str(v.dtype).split(".")[-1]) for k, v in got.items()} == \
        {k: (v.shape, v.axes, jnp.dtype(v.dtype).name) for k, v in ref.items()}


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_matches_reference(variant, cd):
    """Forward (T = 20: two chunks of 8 and a ragged one), loss, prefill and
    three decode steps; the caches' SSM states and site K/V included."""
    ref_model, ref_p, model = pair(hybrid_cfg(cd, **VARIANTS[variant]), seed=1)
    batch = make_inputs(model.cfg, 2, 20, seed=2)
    before = ssd_kernel.ssd_diag_cuda.launches
    hold_forward(ref_model, ref_p, model, batch, cd)
    hold_prefill_and_decode(ref_model, ref_p, model, dict(batch, tokens=batch["tokens"][:, :13]),
                            cd, max_len=32)
    assert ssd_kernel.ssd_diag_cuda.launches == before  # the CPU takes the plain version


def test_shared_block_fires_at_the_sites_and_writes_only_its_cache(monkeypatch):
    _, _, model = pair(hybrid_cfg(num_layers=5), seed=3)
    calls = []
    block = PH._shared_attn_block

    def spy(p, cfg, x, positions, cache, cache_index):
        calls.append(None if cache is None else cache["k"].data_ptr())
        return block(p, cfg, x, positions, cache, cache_index)

    monkeypatch.setattr(PH, "_shared_attn_block", spy)
    tokens = np.random.default_rng(4).integers(0, 256, size=(2, 12)).astype(np.int32)
    with torch.no_grad():
        model.forward({"tokens": tokens})
        assert calls == [None] * 3  # layers 0, 2 and 4
        cache = model.init_cache(2, 16)
        model.prefill({"tokens": tokens}, cache)
        sites = [cache["ak"][s].data_ptr() for s in range(3)]
        assert calls[3:] == sites
        assert all(bool(cache[k][s, :, :12].abs().sum() > 0) and
                   bool((cache[k][s, :, 12:] == 0).all()) for k in ("ak", "av") for s in range(3))
        written = {k: cache[k].clone() for k in ("ak", "av")}
        model.decode_step(cache, tokens[:, :1], 12)
        assert calls[6:] == sites
        for k in ("ak", "av"):  # a decode step writes slot 12 of each site, nothing else
            changed = (cache[k] != written[k]).any(dim=(1, 3, 4))
            assert changed[:, 12].all() and not changed[:, :12].any() and \
                not changed[:, 13:].any()


def test_decode_agrees_with_teacher_forced_forward():
    _, _, model = pair(hybrid_cfg(num_layers=5), seed=5)
    batch = make_inputs(model.cfg, 2, 27, seed=6, loss_mask=False)
    hold_decode_against_forward(model, batch, 17, 32)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_serve_loop_tokens_equal_reference_up_to_ties(cd):
    ref_model, ref_p, model = pair(hybrid_cfg(cd, num_layers=5), seed=6)
    prompt = serve.make_batch(model.cfg, 2, 16, seed=7)["tokens"]
    new = 8
    with reference_mode(cd):
        prefill, decode = ref_serve_steps(ref_model)
        ref_loop = RefServeLoop(prefill_step=jax.jit(prefill), decode_step=jax.jit(decode),
                                params=ref_p, eos_id=-1,
                                init_cache=lambda: zero_cache(ref_model, 2, 32))
        ref_tokens = ref_loop.generate({"tokens": jnp.asarray(prompt)}, new)["tokens"]
        seq = np.concatenate([prompt, ref_tokens[:, :-1]], 1)
        ref_logits = np.asarray(ref_model.forward(ref_p, {"tokens": jnp.asarray(seq)})[0])
    ref_logits = ref_logits[:, prompt.shape[1] - 1:]
    out = serve.serve_loop(model, 2, 32).generate({"tokens": torch.from_numpy(prompt)}, new,
                                                  echo_metrics=True)
    assert out["tokens"].shape == (2, new) and out["metrics"]["decoded"] == new
    cmp = compare_token_traces(ref_tokens, out["tokens"], ref_logits,
                               atol=FLOAT_ATOL if cd == "float32" else TOL[cd]["atol"])
    if cd == "float32":
        assert cmp.matched == 2, cmp.ties
    assert cmp.matched + len(cmp.ties) == 2


def test_train_cli_trains_and_resumes(tmp_path):
    train_cli_and_resume(ARCH, tmp_path)


def test_one_full_width_zamba2_layer_matches_reference():
    """One zamba2 layer at full width: the shared attention+MLP block (32
    heads of 64, d_ff 8192) at site 0, then one Mamba-2 layer (d_model
    2048, 64 SSD heads of 64, state 64, chunk 256); the vocabulary cut to
    4096, T = 256 (one chunk); float32 compute (see the module docstring)."""
    ref_cfg = ref_configs.get(ARCH).model.replace(num_layers=1, vocab_size=4096,
                                                  compute_dtype="float32")
    ref_model, ref_p, model = pair(ref_cfg, seed=13)
    cfg = model.cfg
    assert (cfg.d_model, cfg.num_heads, cfg.head_dim, cfg.d_ff, cfg.ssm.d_state,
            cfg.ssm.num_heads(cfg.d_model), cfg.ssm.chunk_size) == (2048, 32, 64, 8192, 64, 64, 256)
    tokens = np.random.default_rng(14).integers(0, 4096, size=(1, 256)).astype(np.int32)
    ref_logits, _ = jax.jit(ref_model.forward)(ref_p, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        logits, _ = model.forward({"tokens": tokens})
    assert_close(np.asarray(ref_logits), logits.numpy(), rtol=FLOAT_RTOL, atol=1e-4,
                 what="logits")
