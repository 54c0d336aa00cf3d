"""Shared helpers of the tests that hold the port's model zoo against the
JAX package's, family by family (`tests/test_torch_moe.py`,
`test_torch_hybrid.py`, `test_torch_encdec.py`, `test_torch_vlm.py` and the
dense configs in `test_torch_models.py`).

Both packages get the same parameters and inputs, drawn with numpy from a
seed; the reference's values (in each leaf's own dtype, bfloat16 for the
MoE configs) reach the port through
`repro_torch.models.convert.params_from_jax`.  Tolerances
(`repro_torch.testing`): float32 compute agrees with the jitted reference
to FLOAT_RTOL / FLOAT_ATOL, or end to end through a model to
`MODEL_F32_TOL` (below), bfloat16 compute with the eager reference to
BF16_RTOL / BF16_ATOL (under `jax.jit` XLA may skip bfloat16 roundings:
`tests/test_torch_models.py`).
"""

import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.models import Model as RefModel
from repro.models.spec import is_spec as ref_is_spec
from repro_torch.models.config import EncoderConfig, MoEConfig, SSMConfig
from repro_torch.models.config import ModelConfig as PortConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import Model
from repro_torch.testing import BF16_ATOL, BF16_RTOL, FLOAT_ATOL, FLOAT_RTOL, assert_close

TOL = {"float32": dict(rtol=FLOAT_RTOL, atol=FLOAT_ATOL),
       "bfloat16": dict(rtol=BF16_RTOL, atol=BF16_ATOL)}
# The smoke models of the new families and configs end to end in float32
# (forward, prefill, decode).  Here the reference disagrees with itself
# beyond FLOAT_ATOL: its jitted and eager forwards differ by up to 1.6e-5
# (kimi), 2.3e-5 (kimi with drops), 1.5e-5 (arctic), 1.1e-5 (the
# five-layer hybrid), 3.8e-5 (whisper), 1.1e-5 (llava) and 1.9e-5
# (granite-34b) in logits of size up to 4.1: a few float32 steps a layer,
# carried through the router's softmax and the gate products, through five
# layers, or through activations of size up to 39 (at the reference's
# initializers a 3-D projection's fan-in is its head count, and only qwen3
# normalizes q and k).  The port lies as far from each (4.2e-5 from the
# jitted reference at most, 4.4e-5 from the eager one), so these models are
# held to FLOAT_RTOL and an atol of 2^-14 (6.1e-5), 1.6-2.6x the reference's
# own spread.  Their layers alone (`moe_apply`, the SSD core, the encoder,
# cross-attention, chunked attention) agree to FLOAT_ATOL.
MODEL_F32_TOL = dict(rtol=FLOAT_RTOL, atol=2.0**-14)
MODEL_TOL = {"float32": MODEL_F32_TOL, "bfloat16": TOL["bfloat16"]}


def port_config(ref_cfg):
    """The reference's ModelConfig as the port's, its family configs too."""
    kw = dataclasses.asdict(ref_cfg)
    for key, sub in (("moe", MoEConfig), ("ssm", SSMConfig), ("encoder", EncoderConfig)):
        if kw[key] is not None:
            kw[key] = sub(**kw[key])
    return PortConfig(**kw)


def np_values(specs, seed):
    """Numpy float32 values for a reference spec tree, drawn as its
    initializers draw, with norm scales and biases perturbed off 1 and 0 so
    that they matter."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if s.init == "zeros":
            return 0.1 * rng.standard_normal(s.shape, dtype=np.float32)
        if s.init == "ones":
            return 1 + 0.1 * rng.standard_normal(s.shape, dtype=np.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = s.init_scale if s.init == "normal" else s.init_scale / np.sqrt(fan_in)
        return rng.standard_normal(s.shape, dtype=np.float32) * np.float32(std)

    return jax.tree.map(leaf, specs, is_leaf=ref_is_spec)


def ref_params(ref_model, seed):
    """The reference's parameters: `np_values` in each leaf's spec dtype."""
    specs = ref_model.param_specs()
    return jax.tree.map(lambda s, v: jnp.asarray(v, s.dtype), specs, np_values(specs, seed),
                        is_leaf=ref_is_spec)


def pair(ref_cfg, seed=0):
    """(reference model, its parameters, the port's model on the CPU with
    the same values)."""
    ref_model = RefModel(ref_cfg)
    p = ref_params(ref_model, seed)
    cfg = port_config(ref_cfg)
    return ref_model, p, Model(cfg, params=params_from_jax(p, cfg), device="cpu")


def reference_mode(cd):
    """Eager JAX for bfloat16 compute."""
    return jax.disable_jit() if cd == "bfloat16" else contextlib.nullcontext()


def np_f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def make_inputs(cfg, b, t, seed, *, patches=None, loss_mask=True):
    """A batch of ``t`` text tokens and the family's stubs (``frames`` at the
    encoder's source length, ``patches``: that many, the config's by
    default), float32 values of the size `make_batch` draws."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, t)).astype(np.int32)}
    if loss_mask:
        batch["loss_mask"] = (rng.random((b, t)) < 0.8).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = normal(rng, (b, cfg.encoder.source_len, cfg.d_model), 0.5)
    if cfg.family == "vlm":
        n = cfg.num_patch_tokens if patches is None else patches
        batch["patches"] = normal(rng, (b, n, cfg.d_model), 0.5)
    return batch


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def zero_cache(ref_model, b, max_len):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), ref_model.cache_specs(b, max_len),
                        is_leaf=ref_is_spec)


def hold_forward(ref_model, ref_p, model, batch, cd, tol=None):
    """Forward logits, aux loss and the loss's metrics, port against
    reference, within ``tol`` (`MODEL_TOL` by default).  Returns the port's
    (logits, aux)."""
    tol = tol or MODEL_TOL[cd]
    jb = jax_batch(batch)
    with reference_mode(cd):
        ref_logits, ref_aux = jax.jit(ref_model.forward)(ref_p, jb)
        _, ref_m = jax.jit(ref_model.loss_fn)(ref_p, jb)
    with torch.no_grad():
        logits, aux = model.forward(batch)
        _, metrics = model.loss_fn(batch)
    b, t = batch["tokens"].shape
    assert logits.shape == (b, t, model.cfg.vocab_size) and logits.dtype == torch.float32
    assert_close(np.asarray(ref_logits), logits.numpy(), **tol, what="logits")
    assert_close(float(ref_aux), float(aux), **tol, what="aux")
    for k in ("loss", "ce", "z_loss", "aux_loss"):
        assert_close(float(ref_m[k]), float(metrics[k]), **tol, what=k)
    assert float(metrics["tokens"]) == float(ref_m["tokens"])
    return logits, aux


def hold_prefill_and_decode(ref_model, ref_p, model, batch, cd, max_len, steps=3, tol=None):
    """Prefill logits and ``steps`` greedy decode steps (the reference's
    argmax fed to both), then every cache buffer, port against reference,
    within ``tol`` (`MODEL_TOL` by default).  Decoding starts after the
    patches and the text."""
    tol = tol or MODEL_TOL[cd]
    b, t = batch["tokens"].shape
    offset = t + (batch["patches"].shape[1] if "patches" in batch else 0)
    ref_cache = zero_cache(ref_model, b, max_len)
    cache = model.init_cache(b, max_len)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in cache.items()} == \
        {k: (v.shape, jnp.dtype(v.dtype).name) for k, v in ref_cache.items()}
    jb = jax_batch({k: v for k, v in batch.items() if k != "loss_mask"})
    with reference_mode(cd):
        ref_logits, ref_cache = jax.jit(ref_model.prefill)(ref_p, jb, ref_cache)
    with torch.no_grad():
        logits, cache = model.prefill({k: v for k, v in batch.items() if k != "loss_mask"},
                                      cache)
    assert logits.shape == (b, 1, model.cfg.vocab_size)
    assert_close(np.asarray(ref_logits), logits.numpy(), **tol, what="prefill logits")
    decode = jax.jit(ref_model.decode_step)
    for step in range(steps):
        tok = np.asarray(jnp.argmax(ref_logits[:, -1], -1)).astype(np.int32)[:, None]
        with reference_mode(cd):
            ref_logits, ref_cache = decode(ref_p, ref_cache, jnp.asarray(tok),
                                           jnp.int32(offset + step))
        with torch.no_grad():
            logits, cache = model.decode_step(cache, tok, offset + step)
        assert_close(np.asarray(ref_logits), logits.numpy(), **tol, what=f"decode {step}")
    for k in ref_cache:
        assert_close(np_f32(ref_cache[k]), np_f32(cache[k]), **tol, what=f"cache {k}")
    return cache


def hold_decode_against_forward(model, batch, split, max_len):
    """Prefill the first ``split`` text tokens, decode the rest one at a
    time (teacher-forced), and hold every step's logits to the forward's at
    the same positions, in float32, within `MODEL_F32_TOL`."""
    t = batch["tokens"].shape[1]
    offset = batch["patches"].shape[1] if "patches" in batch else 0
    with torch.no_grad():
        full, _ = model.forward(batch)
        cache = model.init_cache(batch["tokens"].shape[0], max_len)
        head = dict(batch, tokens=batch["tokens"][:, :split])
        head.pop("loss_mask", None)
        last, cache = model.prefill(head, cache)
        steps = [last]
        for i in range(split, t):
            step, cache = model.decode_step(cache, batch["tokens"][:, i:i + 1], offset + i)
            steps.append(step)
    assert_close(full[:, split - 1:t].numpy(), torch.cat(steps, 1)[:, :t - split + 1].numpy(),
                 **MODEL_F32_TOL, what="decode vs forward")


def train_cli_and_resume(arch, tmp_path, seq_len=24):
    """``python -m repro_torch.launch.train --arch <arch> --smoke --device
    cpu``: 2 steps in 2 microbatches with a checkpoint at step 2, then
    `train.main` resumes from it for 2 more."""
    from repro_torch.launch import train

    ck = tmp_path / "ck"
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--global-batch", "4",
            "--seq-len", str(seq_len), "--microbatches", "2", "--ckpt-dir", str(ck),
            "--ckpt-every", "2"]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args, "--steps", "2",
                          "--log-every", "1"], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[train] step 2 loss" in out.stdout
    assert "device=cpu exit=completed final_step=2" in out.stdout
    assert sorted(os.listdir(ck)) == ["step_00000002"]
    result = train.main(args + ["--steps", "2"])
    assert result["final_step"] == 4 and result["exit"] == "completed"  # resumed at 2
