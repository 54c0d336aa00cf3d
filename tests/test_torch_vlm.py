"""The port's VLM family (llava-next-mistral-7b) against the JAX package's, on the CPU.

Covered: the smoke model (8 patch embeddings before the text) and a
variant with a learned position table: forward logits over the text
positions, loss, prefill (the patches fill the first cache slots) and
three decode steps from position P + T, in float32 and bfloat16, the cache
included; decode against the teacher-forced forward; the serving loop,
which decodes from P + T (its tokens equal the teacher-forced argmax, and
the reference's); the serve CLI, which adds the config's patches to the
prompt, as the reference's does; and training from the command line,
with a resume.  Helpers and
tolerances: `tests/torch_zoo.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as ref_configs
from repro.runtime.decode_loop import ServeLoop as RefServeLoop
from repro.runtime.steps import make_serve_steps as ref_serve_steps
from repro_torch.launch import serve
from repro_torch.testing import FLOAT_ATOL, compare_token_traces
from torch_zoo import (TOL, hold_decode_against_forward, hold_forward, hold_prefill_and_decode,
                       jax_batch, make_inputs, pair, reference_mode, zero_cache,
                       train_cli_and_resume)

ARCH = "llava-next-mistral-7b"
VARIANTS = {"smoke": {}, "learned positions": {"pos_emb": "learned", "max_position": 64}}


def vlm_cfg(cd="float32", **kw):
    return ref_configs.smoke(ARCH).model.replace(compute_dtype=cd, **kw)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_matches_reference(variant, cd):
    ref_model, ref_p, model = pair(vlm_cfg(cd, **VARIANTS[variant]), seed=1)
    assert ("pos_table" in model.params_tree()) == (variant == "learned positions")
    batch = make_inputs(model.cfg, 2, 16, seed=2)
    assert batch["patches"].shape == (2, 8, 64)
    hold_forward(ref_model, ref_p, model, batch, cd)
    cache = hold_prefill_and_decode(ref_model, ref_p, model,
                                    dict(batch, tokens=batch["tokens"][:, :10]), cd, max_len=32)
    # patches and text filled slots [0, 18), the three decode steps [18, 21)
    filled = cache["k"].abs().sum(dim=(0, 1, 3, 4)) > 0
    assert filled[:21].all() and not filled[21:].any()


def test_decode_agrees_with_teacher_forced_forward():
    _, _, model = pair(vlm_cfg(**VARIANTS["learned positions"]), seed=3)
    batch = make_inputs(model.cfg, 2, 24, seed=4, loss_mask=False)
    hold_decode_against_forward(model, batch, 14, 40)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_serve_loop_decodes_after_the_patches(cd, monkeypatch):
    """The loop's decode steps start at position P + T, and its tokens equal
    the teacher-forced forward's argmax over patches, prompt and tokens
    (exactly in float32; up to certified ties in bfloat16) and the
    reference loop's."""
    ref_model, ref_p, model = pair(vlm_cfg(cd), seed=5)
    req = serve.make_batch(model.cfg, 2, model.cfg.num_patch_tokens + 12, seed=6)
    req = {k: v for k, v in req.items() if k != "loss_mask"}
    t, new = req["tokens"].shape[1], 8
    assert t == 12
    loop = serve.serve_loop(model, 2, 40)
    indices = []
    decode = loop.decode_step
    loop.decode_step = lambda p, c, tok, index: indices.append(index) or decode(p, c, tok, index)
    out = loop.generate({k: torch.from_numpy(v) for k, v in req.items()}, new)["tokens"]
    assert indices == list(range(8 + t, 8 + t + new - 1))
    with torch.no_grad():
        seq = np.concatenate([req["tokens"], out[:, :-1]], 1)
        logits, _ = model.forward(dict(req, tokens=seq))
    logits = logits[:, t - 1:].numpy()
    cmp = compare_token_traces(logits.argmax(-1), out, logits,
                               atol=FLOAT_ATOL if cd == "float32" else TOL[cd]["atol"])
    if cd == "float32":
        assert cmp.matched == 2, cmp.ties
    assert cmp.matched + len(cmp.ties) == 2
    with reference_mode(cd):
        prefill, ref_decode = ref_serve_steps(ref_model)
        ref_loop = RefServeLoop(prefill_step=jax.jit(prefill), decode_step=jax.jit(ref_decode),
                                params=ref_p, eos_id=-1,
                                init_cache=lambda: zero_cache(ref_model, 2, 40))
        ref_tokens = ref_loop.generate(jax_batch(req), new)["tokens"]
        ref_logits = np.asarray(ref_model.forward(ref_p, jax_batch(dict(
            req, tokens=np.concatenate([req["tokens"], ref_tokens[:, :-1]], 1))))[0])
    cmp = compare_token_traces(ref_tokens, out, ref_logits[:, t - 1:],
                               atol=FLOAT_ATOL if cd == "float32" else TOL[cd]["atol"])
    if cd == "float32":
        assert cmp.matched == 2, cmp.ties
    assert cmp.matched + len(cmp.ties) == 2


def test_serve_cli_adds_the_patches_to_the_prompt(monkeypatch, capsys):
    seen = []
    requests = serve.requests
    monkeypatch.setattr(serve, "requests", lambda model, b, seq, **kw: seen.append(seq)
                        or requests(model, b, seq, **kw))
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--prompt-len", "6",
                "--max-new-tokens", "4", "--max-len", "32"])
    assert seen == [6 + 8]
    assert "[tokens]" in capsys.readouterr().out


def test_train_cli_trains_and_resumes(tmp_path):
    train_cli_and_resume(ARCH, tmp_path)
