"""The port's data pipeline and serving path against the JAX package's, on the CPU.

  * `make_batch` draws the reference's tokens exactly.
  * `ServeLoop` decodes the reference's greedy tokens, up to certified ties
    (`testing.compare_token_traces`, under the reference's teacher-forced
    logits over the prompt and its tokens), in float32 and bfloat16 compute.
  * ``python -m repro_torch.launch.serve --arch qwen3-8b --smoke --device cpu`` runs.
  * The serving entry points run on the card unless asked for the CPU, and
    raise without a card.
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
from repro.data import SyntheticDataset as RefDataset
from repro.data import make_batch as ref_make_batch
from repro.models import Model as RefModel
from repro.models.spec import is_spec as ref_is_spec
from repro.runtime.decode_loop import ServeLoop as RefServeLoop
from repro.runtime.steps import make_serve_steps as ref_serve_steps
import repro_torch.configs as port_configs
from repro_torch.data.pipeline import SyntheticDataset, make_batch
from repro_torch.launch import serve
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.testing import BF16_ATOL, FLOAT_ATOL, compare_token_traces

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("seed,step,batch,seq", [(0, 0, 4, 512), (3, 7, 2, 33)])
def test_make_batch_equals_reference(smoke, seed, step, batch, seq):
    get = "smoke" if smoke else "get"
    ref_cfg = getattr(ref_configs, get)("qwen3-8b").model
    cfg = getattr(port_configs, get)("qwen3-8b").model
    ref = ref_make_batch(ref_cfg, batch, seq, seed=seed, step=step)
    got = make_batch(cfg, batch, seq, seed=seed, step=step)
    assert set(got) == set(ref) == {"tokens", "loss_mask"}
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        assert np.array_equal(got[k], ref[k])
    ref_ds = RefDataset(ref_cfg, batch, seq, seed=seed).batch_at(step + 1)
    got_ds = SyntheticDataset(cfg, batch, seq, seed=seed).batch_at(step + 1)
    assert np.array_equal(got_ds["tokens"], ref_ds["tokens"])


def test_make_batch_float_stubs_follow_the_reference_stream():
    """A VLM batch draws its patch stub first: the tokens after it still
    equal the reference's, and the stub is the reference's in float32."""
    ref_cfg = ref_configs.get("qwen3-8b").model.replace(family="vlm", num_patch_tokens=8,
                                                        d_model=32, compute_dtype="float32")
    cfg = PortConfig(**dataclasses.asdict(ref_cfg))
    ref = ref_make_batch(ref_cfg, 2, 24, seed=5)
    got = make_batch(cfg, 2, 24, seed=5)
    assert np.array_equal(got["tokens"], ref["tokens"])
    assert got["patches"].dtype == np.float32
    assert np.array_equal(got["patches"], ref["patches"])


def _np_params(specs, seed):
    rng = np.random.default_rng(seed)

    def leaf(s):
        if s.init == "ones":
            return 1 + 0.1 * rng.standard_normal(s.shape, dtype=np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = s.init_scale if s.init == "normal" else s.init_scale / np.sqrt(fan_in)
        return rng.standard_normal(s.shape, dtype=np.float32) * np.float32(std)

    return jax.tree.map(leaf, specs, is_leaf=ref_is_spec)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_serve_loop_tokens_equal_reference_up_to_ties(cd):
    ref_cfg = ref_configs.get("qwen3-8b").model.replace(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, d_ff=128, vocab_size=512,
        head_dim=16, compute_dtype=cd)
    cfg = PortConfig(**dataclasses.asdict(ref_cfg))
    ref_model = RefModel(ref_cfg)
    p = _np_params(ref_model.param_specs(), 21)
    ref_p = jax.tree.map(jnp.asarray, p)
    prompt = make_batch(cfg, 2, 24, seed=4)["tokens"]
    new = 16

    # bfloat16: the reference runs eagerly, rounding where its code says
    # (see tests/test_torch_models.py).
    mode = jax.disable_jit() if cd == "bfloat16" else contextlib.nullcontext()
    with mode:
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

    model = Model(cfg, params=params_from_jax(p, cfg), device="cpu")
    out = serve.serve_loop(model, 2, 64).generate({"tokens": torch.from_numpy(prompt)}, new,
                                                  echo_metrics=True)
    assert out["tokens"].shape == (2, new) and out["metrics"]["decoded"] == new
    cmp = compare_token_traces(ref_tokens, out["tokens"], ref_logits,
                               atol=FLOAT_ATOL if cd == "float32" else BF16_ATOL)
    if cd == "float32":
        assert cmp.matched == 2, cmp.ties
    assert cmp.matched + len(cmp.ties) == 2


def test_token_trace_rule():
    logits = np.zeros((2, 3, 4), np.float32)
    logits[:, :, 1] = 1.0
    logits[1, 1, 2] = 1.0 - 1e-6  # a near-tie at row 1, step 1
    ref = np.ones((2, 3), np.int64)
    assert compare_token_traces(ref, ref, logits, atol=1e-5).matched == 2
    got = ref.copy()
    got[1, 1:] = 2
    cmp = compare_token_traces(ref, got, logits, atol=1e-5)
    assert cmp.matched == 1 and [t[:2] for t in cmp.ties] == [(1, 1)]
    got[0, 0] = 3
    with pytest.raises(AssertionError, match="not a tie"):
        compare_token_traces(ref, got, logits, atol=1e-5)


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen3-8b", "--smoke",
         "--device", "cpu", "--max-new-tokens", "8"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("[serve] device=cpu batch=4 prompt=16 new=8 ")
    assert lines[1].startswith("[tokens] [")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    cfg = port_configs.smoke("qwen3-8b").model
    for run in (
        lambda: Model(cfg),
        lambda: serve.build_model("qwen3-8b", smoke=True),
        lambda: serve.main(["--arch", "qwen3-8b", "--smoke"]),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
    model = serve.build_model("qwen3-8b", smoke=True, device="cpu")
    assert model.device == torch.device("cpu")
    assert model.layers[0]["mlp"]["wo"].dtype == torch.bfloat16  # cast once for serving
    assert model.final_norm["scale"].dtype == torch.float32
