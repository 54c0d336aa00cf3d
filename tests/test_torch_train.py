"""The port's training path against the JAX package's, on the CPU.

`make_train_step` on the smoke qwen3-8b and mamba2-370m, and on the smoke
configs of the other families (`ZOO_CASES`: kimi-k2 and arctic with
Adafactor over bfloat16 parameters, zamba2, whisper-tiny and llava), with
the reference's parameter values carried across (`models.convert.
params_from_jax`, each leaf in its spec's dtype), the same synthetic
batches (`data.make_batch`, with frames and patches), and the reference's
`make_train_step` on the other side, for three steps.  In
float32 compute the reference is jitted; in bfloat16 compute it runs
eagerly (`jax.disable_jit`: under `jit` XLA may skip bfloat16 roundings,
ROADMAP Queue 3).  Held each step:

  * loss, ce, z_loss, aux_loss, tokens, grad_norm: the comparator's float
    tolerance (`repro_torch.testing`: FLOAT_RTOL/FLOAT_ATOL in float32
    compute, BF16_RTOL/BF16_ATOL in bfloat16), lr to one float32 step (the
    two libraries' cosines differ in the last bit);
  * the clipped gradients, through AdamW's first moment after the first
    step (μ₁ = (1 − b1)·g, exactly as both compute it) and ν₁ = (1 − b2)·g²,
    at the float tolerance; where the gradients are cast to bfloat16 before
    accumulating (``bf16_grad_reduce``), a last-bit difference can carry a
    value across one bfloat16 rounding boundary: one bfloat16 step of the
    value (2^-7 relative).  In bfloat16 compute a gradient component moves
    further wherever a bfloat16 activation differs by a step, so the
    moments are held in norm there: ‖port − ref‖/‖ref‖ ≤ BF16_RTOL (0.5 %
    and 1.0 % for μ₁ and ν₁ of the smoke qwen3-8b);
  * the updated parameters, at ``PARAM_SLACK · Σ lr`` absolute.  Adam
    normalizes each component: a step moves it by
    lr·(m̂/(√v̂ + ε) + wd·p), and over the first three steps |m̂/√v̂| ≤ 1.0003
    (Cauchy–Schwarz on the bias-corrected moments), with wd·|p| ≤ 0.03 here.
    So a component whose gradient is near 0 moves by up to about lr on a
    last-bit difference, in either direction, and two implementations can
    end up 2·1.03·Σ lr apart: PARAM_SLACK = 2.1.  In float32 compute,
    moreover, all but PARAM_FRACTION (0.1 %) of the components agree to
    the float tolerance (`NOISE_LEAVES` apart).  Where a step starts from
    the reference's state (``carry``), the slack is that step's lr alone.
    Adafactor's update is not normalized per component, but its state is
    held to the float tolerance after the first step (row and column means
    of g², one bfloat16 step where the gradients were cast), and its
    parameters are bfloat16 here, so they part where a rounding flips: one
    bfloat16 step of a value below 0.5, 0.65·lr at most in these runs.

Also here: the checkpoint cases of `tests/test_checkpoint.py`, the loop
cases of `tests/test_runtime.py` (restart reproduces the uninterrupted
run, preemption, the non-finite-loss guard, stragglers) on the port, and
`python -m repro_torch.launch.train --smoke --device cpu` end to end, with
its refusals (no card, a mesh).
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

import repro.configs as ref_configs
from repro.models import Model as RefModel
from repro.models.spec import is_spec as ref_is_spec
from repro.runtime.steps import init_train_state as ref_init_train_state
from repro.runtime.steps import make_train_step as ref_make_train_step
from repro.runtime.steps import train_state_specs as ref_train_state_specs
import repro_torch.configs as port_configs
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.configs.base import ExecConfig
from repro_torch.data.pipeline import SyntheticDataset, make_batch, shard_batch
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.models.model import STACKS, Model
from repro_torch.models.spec import leaves
from repro_torch.optim import OptState
from repro_torch.runtime.loop import PreemptionGuard, StragglerMonitor, TrainLoop
from repro_torch.runtime.steps import init_train_state, make_train_step, train_state_specs
from repro_torch.testing import BF16_ATOL, BF16_RTOL, FLOAT_ATOL, FLOAT_RTOL, assert_close
from torch_zoo import port_config

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": dict(rtol=FLOAT_RTOL, atol=FLOAT_ATOL),
       "bfloat16": dict(rtol=BF16_RTOL, atol=BF16_ATOL)}
BF16_STEP = dict(rtol=2.0**-7, atol=FLOAT_ATOL)
PARAM_SLACK = 2.1
PARAM_FRACTION = 1e-3
# The key bias's gradient is 0 in exact arithmetic (it adds q·bk to every
# score of a query, and the softmax ignores a shift), so what both sides
# compute is rounding noise, which AdamW turns into ±lr steps: its leaves
# (whisper's) are held to PARAM_SLACK · Σ lr alone.
NOISE_LEAVES = ("bk",)
METRICS = ("loss", "ce", "z_loss", "aux_loss", "tokens", "grad_norm")


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


def stacked(tree, path=()):
    """The port's tree (each stack of `STACKS` a list of per-layer dicts) in
    the reference's layout (numpy, every leaf of a stack stacked along a
    leading axis)."""
    as_np = lambda t: t.detach().float().numpy()
    if path in STACKS and isinstance(tree, list):
        return jax.tree.map(lambda *xs: np.stack([as_np(x) for x in xs]), *tree)
    if isinstance(tree, dict):
        return {k: stacked(v, path + (k,)) for k, v in tree.items()}
    return as_np(tree)


def trees_close(ref, got, what, **tol):
    """Hold the port's (stacked) tree against the reference's; returns the
    largest |difference| and the fraction of components beyond ``tol``,
    the `NOISE_LEAVES` left out of the fraction."""
    ref_flat, _ = jax.tree_util.tree_flatten_with_path(ref)
    got_flat = jax.tree.leaves(got)
    assert len(ref_flat) == len(got_flat), what
    worst, beyond, total = 0.0, 0, 0
    for (path, r), g in zip(ref_flat, got_flat):
        r = np.asarray(r, np.float32)
        diff = np.abs(r - g)
        worst = max(worst, float(diff.max()))
        if path[-1].key in NOISE_LEAVES:
            continue
        beyond += int((diff > tol["atol"] + tol["rtol"] * np.abs(r)).sum())
        total += r.size
    return worst, beyond / total


def norm_distance(ref, got):
    """‖got − ref‖ / ‖ref‖ over the whole tree."""
    pairs = list(zip(jax.tree.leaves(ref), jax.tree.leaves(got)))
    num = sum(float(np.square(np.asarray(r, np.float32) - g).sum()) for r, g in pairs)
    den = sum(float(np.square(np.asarray(r, np.float32)).sum()) for r, _ in pairs)
    return (num / den) ** 0.5


@dataclasses.dataclass
class Pair:
    """The same training job in both packages."""

    arch: str
    cd: str = "float32"
    microbatches: int = 1
    bf16_grad_reduce: bool = False
    remat: str = "none"
    model_kw: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        spec = ref_configs.smoke(self.arch)
        self.ref_cfg = spec.model.replace(compute_dtype=self.cd, remat_policy=self.remat,
                                          **self.model_kw)
        self.ref_ex = spec.exec.replace(num_microbatches=self.microbatches, warmup_steps=2,
                                        total_steps=10, learning_rate=3e-3,
                                        bf16_grad_reduce=self.bf16_grad_reduce)
        self.cfg = port_config(self.ref_cfg)
        self.ex = ExecConfig(**dataclasses.asdict(self.ref_ex))
        ref_model = RefModel(self.ref_cfg)
        specs = ref_model.param_specs()
        p = jax.tree.map(lambda s, v: np.asarray(jnp.asarray(v, s.dtype)), specs,
                         np_params(specs, 0), is_leaf=ref_is_spec)  # each leaf in its dtype
        opt = ref_init_train_state(ref_model, self.ref_ex, jax.random.key(0))["opt"]
        self.ref_state = {"params": jax.tree.map(jnp.asarray, p), "opt": opt}
        self.ref_step = ref_make_train_step(ref_model, self.ref_ex)
        if self.cd == "float32":
            self.ref_step = jax.jit(self.ref_step)
        self.model = Model(self.cfg, params=params_from_jax(p, self.cfg), device="cpu")
        self.state = init_train_state(self.model, self.ex)
        self.step = make_train_step(self.model, self.ex)

    @torch.no_grad()
    def resync(self):
        """Carry the reference's state into the port's tensors, in place."""
        params = params_from_jax(self.ref_state["params"], self.cfg)
        opt = opt_state_from_jax(self.ref_state["opt"], self.cfg)
        for (_, t), (_, v) in zip(leaves((self.state["params"], self.state["opt"])),
                                  leaves((params, opt)), strict=True):
            t.copy_(v)

    def run(self, i):
        batch = make_batch(self.cfg, 4, 32, seed=0, step=i)
        mode = jax.disable_jit() if self.cd == "bfloat16" else contextlib.nullcontext()
        with mode:
            self.ref_state, ref_m = self.ref_step(self.ref_state, jax.tree.map(jnp.asarray, batch))
        self.state, m = self.step(self.state, shard_batch(batch, "cpu"))
        return ref_m, m




# The other families' smoke configs (their ExecConfig: kimi-k2 and arctic
# train with Adafactor over bfloat16 parameters, accumulating in bfloat16).
# "carry": each step after the first starts from the reference's state,
# carried into the port's tensors (`models.convert`), and not from the
# port's own.  Whisper and llava are chaotic at the reference's
# initializers (PERF.md §6): whisper's step-2 gradient norm moves by 0.3 %
# from the port's own state, llava's parameters leave the float tolerance
# at 1.8e-3 of components by step 3.  Under bfloat16 parameters a last-bit
# float32 difference in an update flips a bfloat16 rounding (2^-8
# relative) in about 1e-4 of the components, which moves kimi-k2's step-2
# gradient norm by 6e-4 and arctic's step-3 one by 1.4e-2; from the same
# state each step agrees to 1.2e-5.  The run without the carry is held to
# the reference's own response to such a difference in
# `test_adafactor_run_stays_within_the_reference_noise`.
ZOO_CASES = {  # arch: (microbatches, bf16_grad_reduce, remat), (config overrides, carry)
    "kimi-k2-1t-a32b": ((2, True, "full"), ({}, True)),
    "arctic-480b": ((2, False, "full"), ({"attention_chunk": 8}, True)),  # 4 key chunks
    "zamba2-1.2b": ((2, False, "full"), ({}, False)),
    "whisper-tiny": ((1, False, "none"), ({}, True)),
    "llava-next-mistral-7b": ((1, False, "full"), ({}, True)),
}


@pytest.mark.parametrize("arch,cd,mb,bf16_reduce,remat", [
    ("qwen3-8b", "float32", 1, False, "none"),
    ("qwen3-8b", "float32", 2, False, "full"),
    ("qwen3-8b", "float32", 2, True, "none"),  # gradients summed in bfloat16
    ("mamba2-370m", "float32", 2, False, "dots"),
    ("mamba2-370m", "float32", 1, True, "full"),
    ("qwen3-8b", "bfloat16", 2, True, "full"),  # the reference eagerly
    *((arch, "float32", *run) for arch, (run, _) in ZOO_CASES.items()),
])
def test_train_step_matches_reference(arch, cd, mb, bf16_reduce, remat):
    model_kw, carry = ZOO_CASES[arch][1] if arch in ZOO_CASES else ({}, False)
    job = Pair(arch, cd, mb, bf16_reduce, remat, model_kw)
    lrs = []
    for i in range(3 if cd == "float32" else 2):
        if carry and i:
            job.resync()
        ref_m, m = job.run(i)
        for k in METRICS:
            assert_close(float(ref_m[k]), float(m[k]), **TOL[cd], what=f"step {i + 1} {k}")
        r = np.float32(ref_m["lr"])
        assert abs(float(m["lr"]) - float(r)) <= np.spacing(r), f"step {i + 1} lr"
        lrs.append(float(r))
        assert int(job.state["opt"].step) == i + 1
        if i == 0 and job.ex.optimizer == "adafactor":  # the stacked state of g²
            tol = BF16_STEP if bf16_reduce else TOL["float32"]
            worst, beyond = trees_close(job.ref_state["opt"].inner,
                                        stacked(job.state["opt"].inner), "state", **tol)
            assert beyond == 0, f"state: {beyond:.2e} of components beyond {tol}, worst {worst}"
        elif i == 0:  # the clipped gradients, through the first step's moments
            for k in ("mu", "nu"):
                ref, port = job.ref_state["opt"].inner[k], stacked(job.state["opt"].inner[k])
                if cd == "bfloat16":
                    rel = norm_distance(ref, port)
                    assert rel <= BF16_RTOL, f"{k}: |port - ref| / |ref| = {rel}"
                    continue
                tol = BF16_STEP if bf16_reduce else TOL["float32"]
                worst, beyond = trees_close(ref, port, k, **tol)
                assert beyond == 0, f"{k}: {beyond:.2e} of components beyond {tol}, worst {worst}"
        worst, beyond = trees_close(job.ref_state["params"], stacked(job.state["params"]),
                                    "params", **TOL["float32"])
        slack = PARAM_SLACK * (lrs[-1] if carry else sum(lrs))
        assert worst <= slack + FLOAT_ATOL, f"step {i + 1}: params {worst}"
        if cd == "float32":
            assert beyond <= PARAM_FRACTION, f"step {i + 1}: {beyond:.2e} of params beyond"


WITNESSES = 4


def nudged(ref_tree, port_tree, rng):
    """The reference's parameters moved as far as the port's differ from
    them, leaf by leaf, at random places: in each leaf as many components as
    differ, a bfloat16 one by one ulp, a float32 one by noise of the port's
    RMS difference over the leaf."""

    def leaf(r, g):
        r = np.asarray(r)
        diff = np.asarray(r, np.float32) - g
        n = int(np.count_nonzero(diff))
        if n == 0:
            return jnp.asarray(r)
        flat = r.reshape(-1).copy()
        idx = rng.choice(flat.size, n, replace=False)
        if r.dtype == ml_dtypes.bfloat16:
            bits = flat.view(np.uint16)
            step = rng.choice(np.array([1, -1], np.int32), n)
            step[(bits[idx] & 0x7FFF) == 0] = 1  # away from zero, never below it
            bits[idx] = (bits[idx].astype(np.int32) + step).astype(np.uint16)
        else:
            rms = np.sqrt(np.mean(np.square(diff)))
            flat[idx] += (rms * np.sqrt(flat.size / n) * rng.standard_normal(n)).astype(r.dtype)
        return jnp.asarray(flat.reshape(r.shape))

    return jax.tree.map(leaf, ref_tree, port_tree)


def departures(ref_state, ref_m, state, m, port):
    """How far a run is from the reference's after the same step: relative
    loss and gradient norm, and the relative distance of the parameters and
    of the Adafactor state (the port's trees stacked first)."""
    if port:
        state = {"params": stacked(state["params"]), "opt": stacked(state["opt"].inner)}
    else:
        state = {"params": state["params"], "opt": state["opt"].inner}
    rel = lambda k: abs(float(m[k]) - float(ref_m[k])) / abs(float(ref_m[k]))
    return np.array([rel("loss"), rel("grad_norm"),
                     norm_distance(ref_state["params"], state["params"]),
                     norm_distance(ref_state["opt"].inner, state["opt"])])


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "arctic-480b"])
def test_adafactor_run_stays_within_the_reference_noise(arch):
    """Steps 2 and 3 from the port's own state, with no carry: the MoE
    configs' Adafactor over bfloat16 parameters.  After step 1 the port's
    parameters differ from the reference's by rounding (a bfloat16 rounding
    flipped in about 1e-4 of the components, float32 leaves in the last
    bits; held here to PARAM_FRACTION), and steps 2 and 3 amplify any such
    difference.  The witnesses
    are the reference run against itself: from its step-1 state moved by as
    much as the port's differs, leaf by leaf, at random places
    (`WITNESSES` seeds).  The port's loss, gradient norm, parameters and
    Adafactor state at steps 2 and 3 stay within the largest witness's
    departure on each."""
    (mb, bf16_reduce, remat), (model_kw, _) = ZOO_CASES[arch]
    job = Pair(arch, "float32", mb, bf16_reduce, remat, model_kw)
    job.run(0)
    start = job.ref_state
    _, beyond = trees_close(start["params"], stacked(job.state["params"]), "params",
                            **TOL["float32"])
    assert beyond <= PARAM_FRACTION, f"step 1: {beyond:.2e} of params beyond"  # rounding only
    witnesses = [{"params": nudged(start["params"], stacked(job.state["params"]),
                                   np.random.default_rng(seed)), "opt": start["opt"]}
                 for seed in range(WITNESSES)]
    for i in (1, 2):
        ref_m, m = job.run(i)
        batch = jax.tree.map(jnp.asarray, make_batch(job.cfg, 4, 32, seed=0, step=i))
        worst = np.zeros(4)
        for w, st in enumerate(witnesses):
            witnesses[w], wm = job.ref_step(st, batch)
            worst = np.maximum(worst, departures(job.ref_state, ref_m, witnesses[w], wm, False))
        port = departures(job.ref_state, ref_m, job.state, m, True)
        names = ("loss", "grad_norm", "params", "adafactor state")
        assert (port <= worst).all(), f"step {i + 1}: port {dict(zip(names, port))} " \
                                      f"beyond the witnesses' {dict(zip(names, worst))}"


def test_train_state_specs_match_reference():
    ref_spec, port_spec = ref_configs.smoke("qwen3-8b"), port_configs.smoke("qwen3-8b")
    ref = ref_train_state_specs(RefModel(ref_spec.model), ref_spec.exec)
    model = Model(port_spec.model, device="cpu")
    got = train_state_specs(model, port_spec.exec)
    assert isinstance(got["opt"], OptState)
    assert got["opt"].step.shape == () and got["opt"].step.dtype == torch.int32
    for part, r, g in (("params", ref["params"], got["params"]),
                       ("opt", ref["opt"].inner, got["opt"].inner)):
        flat, _ = jax.tree_util.tree_flatten_with_path(r, is_leaf=ref_is_spec)
        ref_by_name = {".".join(str(k.key) for k in path): s for path, s in flat}
        port_by_name = dict(leaves(g))
        assert set(port_by_name) == set(ref_by_name), part
        for name, s in ref_by_name.items():
            assert port_by_name[name].shape == s.shape, (part, name)
    # the state init_train_state allocates: the model's own parameters, set to
    # require gradients, and zero moments
    state = init_train_state(model, port_spec.exec)
    assert all(a is b for (_, a), (_, b) in zip(leaves(state["params"]),
                                                leaves(model.params_tree())))
    assert all(p.requires_grad for _, p in leaves(state["params"]))
    assert int(state["opt"].step) == 0
    assert all(float(t.abs().max()) == 0.0 for _, t in leaves(state["opt"].inner))


def spec_shapes(tree):
    """{dotted name: shape} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=ref_is_spec)
    return {".".join(str(k.key) for k in path): tuple(s.shape) for path, s in flat}


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "arctic-480b", "zamba2-1.2b",
                                  "whisper-tiny", "llava-next-mistral-7b"])
def test_train_state_specs_match_allocated_state(arch):
    """`train_state_specs` describes the state `init_train_state` allocates,
    name for name and shape for shape, and both are the reference's: the
    Adafactor state (kimi-k2, arctic) as allocated, stacked over layers;
    the parameters and AdamW's moments (the others) once their per-layer
    lists are stacked."""
    ref_spec, port_spec = ref_configs.smoke(arch), port_configs.smoke(arch)
    ref = ref_train_state_specs(RefModel(ref_spec.model), ref_spec.exec)
    model = Model(port_spec.model, device="cpu")
    specs = train_state_specs(model, port_spec.exec)
    state = init_train_state(model, port_spec.exec)
    want = {"params": spec_shapes(ref["params"]), "opt": spec_shapes(ref["opt"].inner)}
    assert {k: s.shape for k, s in leaves(specs["params"])} == want["params"]
    assert {k: s.shape for k, s in leaves(specs["opt"].inner)} == want["opt"]
    assert {k: v.shape for k, v in leaves(stacked(state["params"]))} == want["params"]
    if port_spec.exec.optimizer == "adafactor":
        allocated = {k: tuple(t.shape) for k, t in leaves(state["opt"].inner)}
        assert "layers.attn_norm.scale.vr" in allocated  # a per-layer scale, factored
    else:
        moments = {k: stacked(v) for k, v in state["opt"].inner.items()}  # mu, nu
        allocated = {k: v.shape for k, v in leaves(moments)}
    assert allocated == want["opt"]
    assert all(t.dtype == torch.float32 for _, t in leaves(state["opt"].inner))


# ---------------------------------------------------------------- checkpoints


def tree():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "scale": torch.ones(5, dtype=torch.bfloat16) * 1.5,
                   "layers": [{"a": torch.full((2,), 3.0)}, {"a": torch.full((2,), -1.0)}]},
        "opt": OptState(step=torch.tensor(7, dtype=torch.int32), inner={"mu": torch.ones(3)}),
    }


def zeros_like(t):
    return jax.tree.map(torch.zeros_like, t)


class TestCheckpoint:
    def test_save_load_identity_in_place(self, tmp_path):
        t, target = tree(), zeros_like(tree())
        save_pytree(str(tmp_path / "ck"), t, extra={"step": 7})
        restored, extra = load_pytree(str(tmp_path / "ck"), target)
        assert extra["step"] == 7
        assert isinstance(restored["opt"], OptState)
        for (name, a), (_, b), (_, c) in zip(leaves(t), leaves(restored), leaves(target)):
            assert b is c, name  # written into the target's tensors
            assert a.dtype == b.dtype and torch.equal(a, b), name

    def test_layout_is_the_references(self, tmp_path):
        """A tree the port writes reads back in the reference, and the other way."""
        from repro.checkpoint import load_pytree as ref_load
        from repro.checkpoint import save_pytree as ref_save
        from repro.optim import OptState as RefOptState

        def ref_tree(scale):
            return {"params": {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4) * scale,
                               "scale": jnp.ones((5,), jnp.bfloat16) * 1.5 * scale,
                               "layers": [{"a": jnp.full((2,), 3.0 * scale)},
                                          {"a": jnp.full((2,), -1.0 * scale)}]},
                    "opt": RefOptState(step=jnp.asarray(7, jnp.int32),
                                       inner={"mu": jnp.ones((3,)) * scale})}

        save_pytree(str(tmp_path / "port"), tree())
        restored, _ = ref_load(str(tmp_path / "port"), ref_tree(0))
        for a, (_, b) in zip(jax.tree.leaves(restored), leaves(tree())):
            assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())
        ref_save(str(tmp_path / "ref"), ref_tree(2))
        got, _ = load_pytree(str(tmp_path / "ref"), zeros_like(tree()))
        for a, (_, b) in zip(jax.tree.leaves(ref_tree(2)), leaves(got)):
            assert np.array_equal(np.asarray(a, np.float32), b.float().numpy())

    def test_bf16_dtype_preserved(self, tmp_path):
        t = {"x": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
        save_pytree(str(tmp_path / "ck"), t)
        manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
        assert manifest["entries"]["x"]["dtype"] == "bfloat16"
        r, _ = load_pytree(str(tmp_path / "ck"), zeros_like(t))
        assert r["x"].dtype == torch.bfloat16 and torch.equal(r["x"], t["x"])

    def test_mismatches_rejected(self, tmp_path):
        save_pytree(str(tmp_path / "ck"), {"x": torch.zeros(3)})
        with pytest.raises(ValueError, match="shape"):
            load_pytree(str(tmp_path / "ck"), {"x": torch.zeros(4)})
        with pytest.raises(ValueError, match="dtype"):
            load_pytree(str(tmp_path / "ck"), {"x": torch.zeros(3, dtype=torch.float64)})
        with pytest.raises(KeyError):
            load_pytree(str(tmp_path / "ck"), {"x": torch.zeros(3), "y": torch.zeros(1)})

    def test_no_tmp_dir_left_behind(self, tmp_path):
        save_pytree(str(tmp_path / "ck"), tree())
        assert not any(p.endswith(".tmp") for p in os.listdir(tmp_path))

    def test_latest_and_restore(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_n=10)
        t = tree()
        for step in (5, 10, 15):
            t["opt"].step.fill_(step)
            mgr.save(step, t, extra={"step": step})
        assert mgr.latest_step() == 15
        target = zeros_like(tree())
        restored, extra = mgr.restore(target)
        assert extra["step"] == 15 and int(restored["opt"].step) == 15
        restored5, _ = mgr.restore(target, step=5)
        assert int(restored5["opt"].step) == 5

    def test_keep_n_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_n=2)
        for step in range(1, 6):
            mgr.save(step, {"x": torch.tensor(step)})
        assert mgr.all_steps() == [4, 5]

    def test_async_save_snapshots_before_returning(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_n=3)
        t = tree()
        mgr.save_async(3, t, extra={"step": 3})
        t["params"]["w"].add_(100.0)  # an in-place update after the call
        mgr.wait()
        assert mgr.latest_step() == 3
        r, _ = mgr.restore(zeros_like(tree()))
        assert torch.equal(r["params"]["w"], tree()["params"]["w"])

    def test_async_overlapping_saves_serialize(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_n=5)
        for s in (1, 2, 3):
            mgr.save_async(s, {"x": torch.ones(64, 64) * s})
        mgr.wait()
        assert set(mgr.all_steps()) == {1, 2, 3}

    def test_restore_empty_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            CheckpointManager(str(tmp_path)).restore({"x": torch.zeros(())})


# ---------------------------------------------------------------- the loop


def make_loop(tmp_path, arch="qwen3-8b", **loop_kw):
    spec = port_configs.smoke(arch)
    model = Model(spec.model, device="cpu", seed=0)
    ex = spec.exec.replace(num_microbatches=1, warmup_steps=2, total_steps=50,
                           learning_rate=3e-3)
    ds = SyntheticDataset(spec.model, global_batch=4, seq_len=16)
    return TrainLoop(
        train_step=make_train_step(model, ex),
        batch_at=ds.batch_at,
        place_batch=lambda b: shard_batch(b, "cpu"),
        state=init_train_state(model, ex),
        checkpoints=CheckpointManager(str(tmp_path), keep_n=3),
        checkpoint_every=5,
        log_every=100,
        log_fn=lambda s: None,
        **loop_kw,
    )


def next_loss(loop, step):
    return float(loop.train_step(loop.state, loop.place_batch(loop.batch_at(step)))[1]["loss"])


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-370m", "kimi-k2-1t-a32b", "arctic-480b",
                                  "zamba2-1.2b", "whisper-tiny", "llava-next-mistral-7b"])
def test_restart_reproduces_uninterrupted_run(tmp_path, arch):
    """10 straight steps == 5 steps + restart (a new model, restored in
    place) + 5 steps: the same state, bit for bit, and the same next loss."""
    loop_a = make_loop(tmp_path / "a", arch)
    loop_a.run(10)
    loop_b1 = make_loop(tmp_path / "b", arch)
    loop_b1.run(5)
    loop_b2 = make_loop(tmp_path / "b", arch)
    assert loop_b2.maybe_restore() == 5
    loop_b2.run(5)
    for (name, a), (_, b) in zip(leaves(loop_a.state["params"]), leaves(loop_b2.state["params"])):
        assert torch.equal(a, b), name
    assert int(loop_b2.state["opt"].step) == 10
    assert next_loss(loop_a, 10) == next_loss(loop_b2, 10)


def test_data_pipeline_replays_identically():
    ds = SyntheticDataset(port_configs.smoke("qwen3-8b").model, 4, 16, seed=9)
    np.testing.assert_array_equal(ds.batch_at(123)["tokens"], ds.batch_at(123)["tokens"])
    placed = shard_batch(ds.batch_at(1), "cpu")
    assert placed["tokens"].dtype == torch.int32 and placed["loss_mask"].dtype == torch.float32


def test_preemption_checkpoints_and_exits(tmp_path):
    guard = PreemptionGuard(install=False)
    loop = make_loop(tmp_path, guard=guard)
    guard.trigger()
    res = loop.run(50)
    assert res["exit"] == "preempted"
    assert res["final_step"] == 1  # one in-flight step completes
    assert loop.checkpoints.latest_step() == 1


def test_straggler_monitor():
    mon = StragglerMonitor(window=20, threshold=1.5)
    assert mon.observe(0, 100.0) is False  # not enough history
    mon = StragglerMonitor(window=20, threshold=1.5)
    for i in range(10):
        mon.observe(i, 0.1)
    assert mon.observe(10, 0.5) is True and 10 in mon.flagged
    assert mon.observe(11, 0.11) is False


def test_nonfinite_loss_aborts_with_checkpoint(tmp_path):
    loop = make_loop(tmp_path)
    step = loop.train_step

    def poisoned_step(state, batch):
        state, metrics = step(state, batch)
        return state, dict(metrics, loss=torch.tensor(float("nan")))

    loop.train_step = poisoned_step
    with pytest.raises(FloatingPointError):
        loop.run(3)
    assert loop.checkpoints.latest_step() == 1


# ---------------------------------------------------------------- the entry point


def test_train_cli_end_to_end_and_resume(tmp_path):
    ck = tmp_path / "ck"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-8b", "--smoke",
           "--device", "cpu", "--steps", "3", "--global-batch", "4", "--seq-len", "16",
           "--microbatches", "2", "--ckpt-dir", str(ck), "--ckpt-every", "2", "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[train] step 3 loss" in out.stdout
    assert "device=cpu exit=completed final_step=3" in out.stdout
    assert sorted(os.listdir(ck)) == ["step_00000002", "step_00000003"]
    from repro_torch.launch import train

    result = train.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu", "--steps", "2",
                         "--global-batch", "4", "--seq-len", "16", "--microbatches", "2",
                         "--ckpt-dir", str(ck), "--ckpt-every", "2"])
    assert result["final_step"] == 5 and result["exit"] == "completed"  # resumed at 3


def test_train_cli_refusals(monkeypatch, tmp_path):
    from repro_torch.launch import train

    args = ["--arch", "mamba2-370m", "--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="needs a process group of 256 ranks"):
        train.main(args + ["--mesh", "single_pod", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(args)
    assert os.listdir(tmp_path) == []  # no step ran
