"""The port's optimizers, schedules, gradient accumulation and remat
policies against the JAX package's, on the CPU.

Both packages get the same numpy trees (parameters, and a gradient per
step) and the same learning rate.  The port updates in place; the
reference returns new trees.  Tolerances (`repro_torch.testing`): float32
results agree to FLOAT_RTOL / FLOAT_ATOL; both sides run the same float32
operations in the same order, and differ only where the two libraries'
elementwise functions (pow, sqrt, rsqrt, cos) or sum orders round
differently.  The schedules agree to one float32 step: the cosine of
XLA's CPU library and of torch's differ in the last bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as ref_configs
from repro.models import Model as RefModel
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import cosine_schedule as ref_cosine
from repro.optim import linear_warmup_cosine as ref_warmup_cosine
from repro.optim import make_optimizer as ref_make_optimizer
from repro.parallel.microbatch import accumulate_gradients as ref_accumulate
import repro_torch.configs as port_configs
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.model import Model, _unstacked_specs
from repro_torch.models.spec import leaves
from repro_torch.optim import (
    OptState,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    linear_warmup_cosine,
    make_optimizer,
)
from repro_torch.parallel.microbatch import accumulate_gradients
from repro_torch.parallel.remat import POLICIES, remat_wrap
from repro_torch.testing import FLOAT_ATOL, FLOAT_RTOL, assert_close

TOL = dict(rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
SHAPES = {"a": {"w": (8, 4), "k": (2, 3, 5)}, "b": (5,), "c": [(6, 7), (3,)]}


def np_tree(rng, shapes=SHAPES, scale=1.0):
    if isinstance(shapes, dict):
        return {k: np_tree(rng, v, scale) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [np_tree(rng, v, scale) for v in shapes]
    return (scale * rng.standard_normal(shapes)).astype(np.float32)


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_port(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def assert_trees_close(ref, got, **tol):
    ref_flat, _ = jax.tree_util.tree_flatten_with_path(ref)
    got_flat = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), got))
    assert len(ref_flat) == len(got_flat)
    for (path, r), g in zip(ref_flat, got_flat):
        assert_close(np.asarray(r), g, **(tol or TOL), what=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference_over_steps(name):
    rng = np.random.default_rng(0)
    params = np_tree(rng)
    ref_opt, opt = ref_make_optimizer(name), make_optimizer(name, stacks=())
    ref_p, ref_state = to_jax(params), ref_opt.init(to_jax(params))
    p = to_port(params)
    state = opt.init(p)
    for step in range(5):
        grads = np_tree(rng, scale=0.1 * (step + 1))
        lr = np.float32(1e-2 / (step + 1))
        ref_p, ref_state = ref_opt.update(ref_p, ref_state, to_jax(grads), jnp.asarray(lr))
        tensors = [t for _, t in leaves(p)]
        p, state = opt.update(p, state, to_port(grads), torch.tensor(lr))
        assert all(a is b for a, b in zip(tensors, (t for _, t in leaves(p))))  # in place
        assert int(state.step) == int(ref_state.step) == step + 1
        assert state.step.dtype == torch.int32
        assert_trees_close(ref_p, p)
        assert_trees_close(ref_state.inner, state.inner)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_state_specs_match_reference(name):
    ref_specs = RefModel(ref_configs.smoke("qwen3-8b").model).param_specs()
    port_specs = Model(port_configs.smoke("qwen3-8b").model, device="cpu").param_specs()
    ref_state = ref_make_optimizer(name).state_specs(ref_specs)
    port_state = make_optimizer(name, stacks=()).state_specs(port_specs)
    ref_flat, _ = jax.tree_util.tree_flatten_with_path(
        ref_state, is_leaf=lambda x: hasattr(x, "axes"))
    ref_by_name = {".".join(str(k.key) for k in path): s for path, s in ref_flat}
    port_by_name = dict(leaves(port_state))
    assert set(port_by_name) == set(ref_by_name)
    for key, s in ref_by_name.items():
        got = port_by_name[key]
        assert got.shape == s.shape and got.axes == s.axes, key
        assert got.dtype == torch.float32 and jnp.dtype(s.dtype) == jnp.float32, key
    # and the state the port allocates from its own (per-layer) tree has the
    # shapes its specs give
    model = Model(port_configs.smoke("qwen3-8b").model, device="cpu")
    inner = make_optimizer(name, stacks=()).init(model.params_tree()).inner
    specs = dict(leaves(make_optimizer(name, stacks=()).state_specs(_unstacked_specs(model.cfg))))
    allocated = dict(leaves(inner))
    assert set(allocated) == set(specs)
    for key, t in allocated.items():
        assert tuple(t.shape) == specs[key].shape and t.dtype == specs[key].dtype, key


# A model-like tree for Adafactor over stacks: one leaf outside the stack,
# and per-layer leaves of rank 0, 1, 2 and an expert-shaped 3.
STACK_LAYERS = 3
STACK_LAYER = {"g": (), "scale": (6,), "w": (5, 7), "experts": (4, 5, 3)}


def stacked_case(rng, step):
    """(reference tree, port tree) of gradients at ``step``: each layer's at
    its own scale, growing over the steps in even layers and shrinking in
    odd ones, so that the preconditioned update's RMS moves above 1 in some
    layers and below it in others, and the clip over the stack differs from
    one per layer."""
    embed = normal_np(rng, (9, 6))
    layers = [{k: normal_np(rng, s) * np.float32((1 + step) ** (1.5 if l % 2 == 0 else -1.5))
               for k, s in STACK_LAYER.items()} for l in range(STACK_LAYERS)]
    ref = {"embed": embed, "layers": jax.tree.map(lambda *xs: np.stack(xs), *layers)}
    return ref, {"embed": embed, "layers": layers}


def normal_np(rng, shape):
    return np.asarray(rng.standard_normal(shape), np.float32)


def test_adafactor_matches_reference_over_stacked_trees():
    """The port's Adafactor on per-layer lists named as stacks computes the
    reference's Adafactor on the stacked leaves: the stacked state (a
    per-layer 1-D leaf factored over the layers, (L,) and (d,)), the update
    clipped by one RMS over the stack, over five steps.  Float32 tolerance:
    the same operations, the stack's sums of squares in another order."""
    rng = np.random.default_rng(3)
    ref_params, params = stacked_case(rng, 0)
    ref_opt = ref_make_optimizer("adafactor", weight_decay=0.01)
    opt = make_optimizer("adafactor", weight_decay=0.01, stacks=[("layers",)])
    ref_p, ref_state = to_jax(ref_params), ref_opt.init(to_jax(ref_params))
    p = to_port(params)
    state = opt.init(p)
    assert {k: tuple(t.shape) for k, t in leaves(state.inner)} == {
        k: tuple(np.shape(t)) for k, t in ((".".join(str(x.key) for x in path), t) for path, t
                                          in jax.tree_util.tree_flatten_with_path(
                                              ref_state.inner)[0])}
    assert tuple(state.inner["layers"]["scale"]["vr"].shape) == (STACK_LAYERS,)
    clipped = set()
    for step in range(5):
        ref_grads, grads = stacked_case(rng, step)
        lr = np.float32(1e-2 / (step + 1))
        ref_p, ref_state = ref_opt.update(ref_p, ref_state, to_jax(ref_grads), jnp.asarray(lr))
        tensors = [t for _, t in leaves(p)]
        p, state = opt.update(p, state, to_port(grads), torch.tensor(lr))
        assert all(a is b for a, b in zip(tensors, (t for _, t in leaves(p))))  # in place
        assert int(state.step) == step + 1
        stacked_p = {"embed": p["embed"],
                     "layers": jax.tree.map(lambda *xs: torch.stack(xs), *p["layers"])}
        assert_trees_close(ref_p, stacked_p)
        assert_trees_close(ref_state.inner, state.inner)
        # which layers' own update RMS exceeds 1 (the clip a layer alone would take)
        pre = ref_layer_rms(ref_state.inner["layers"]["w"], ref_grads["layers"]["w"])
        clipped |= {bool(r > 1) for r in pre}
    assert clipped == {True, False}  # the stacked clip bit on some layers and not others


def ref_layer_rms(st, g):
    """Per layer, the RMS of the reference's preconditioned update of a 2-D
    per-layer leaf, from its updated state."""
    vr, vc = np.asarray(st["vr"]), np.asarray(st["vc"])
    rfac = 1 / np.sqrt(vr / np.maximum(vr.mean(-1, keepdims=True), 1e-30))
    pre = g * rfac[..., None] / np.sqrt(vc[..., None, :])
    return np.sqrt(np.square(pre).mean(axis=(1, 2)))


def test_adafactor_state_is_factored():
    state = make_optimizer("adafactor", stacks=()).init(
        {"w": torch.zeros(128, 64), "s": torch.zeros(7)})
    assert [tuple(t.shape) for _, t in leaves(state.inner)] == [(7,), (64,), (128,)]  # s.v, w.vc, w.vr


@pytest.mark.parametrize("scale,max_norm", [(10.0, 1.0), (0.01, 1.0), (3.0, 0.5)])
def test_clip_by_global_norm_matches_reference(scale, max_norm):
    grads = np_tree(np.random.default_rng(1), scale=scale)
    ref_g, ref_norm = ref_clip(to_jax(grads), max_norm)
    g = to_port(grads)
    got, norm = clip_by_global_norm(g, max_norm)
    assert got is g
    assert_close(float(ref_norm), float(norm), **TOL)
    assert_trees_close(ref_g, got)
    assert float(global_norm(got)) <= max_norm * (1 + 1e-6)


def test_schedules_match_reference():
    for step in [0, 1, 5, 99, 100, 101, 500, 999, 1000, 1500]:
        for ref_lr, lr in (
            (ref_warmup_cosine(jnp.asarray(step, jnp.int32), 3e-4, 100, 1000),
             linear_warmup_cosine(torch.tensor(step, dtype=torch.int32), 3e-4, 100, 1000)),
            (ref_cosine(jnp.asarray(step, jnp.int32), 1e-3, 1000, 0.2),
             cosine_schedule(step, 1e-3, 1000, 0.2)),
        ):
            assert lr.dtype == torch.float32
            r = np.float32(ref_lr)
            assert abs(float(lr) - float(r)) <= np.spacing(r), (step, float(lr), float(r))
    assert float(linear_warmup_cosine(0, 1e-3, 100, 1000)) == 0.0


def test_opt_state_is_the_reference_shape():
    state = make_optimizer("adamw", stacks=()).init({"w": torch.zeros(3)})
    assert isinstance(state, OptState) and state._fields == ("step", "inner")
    assert set(state.inner) == {"mu", "nu"}


# ---------------------------------------------------------------- microbatches


def lsq_grad_fns(cast_bf16):
    """The same least-squares gradient in both packages, optionally cast to
    bfloat16 per microbatch, as the training step does."""
    def ref_fn(w, mb):
        loss = lambda p: jnp.mean((mb["x"] @ p - mb["y"]) ** 2)
        g = jax.grad(loss)(w)
        return (g.astype(jnp.bfloat16) if cast_bf16 else g), {"loss": loss(w)}

    def port_fn(w, mb):
        w = w.detach().requires_grad_()
        loss = ((mb["x"] @ w - mb["y"]) ** 2).mean()
        (g,) = torch.autograd.grad(loss, [w])
        return (g.to(torch.bfloat16) if cast_bf16 else g), {"loss": loss.detach()}

    return ref_fn, port_fn


@pytest.mark.parametrize("n,cast_bf16,accum", [
    (1, False, None), (2, False, None), (4, False, None),
    (2, True, None),  # the sum runs in bfloat16, as the reference's does
    (3, True, None),  # 1/3 multiplies in bfloat16
    (4, True, "float32"),
    (4, False, "bfloat16"),
])
def test_accumulate_gradients_matches_reference(n, cast_bf16, accum):
    rng = np.random.default_rng(n)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    batch = {"x": rng.standard_normal((12, 8)).astype(np.float32),
             "y": rng.standard_normal((12, 4)).astype(np.float32)}
    ref_fn, port_fn = lsq_grad_fns(cast_bf16)
    rg, rm = ref_accumulate(ref_fn, jnp.asarray(w), to_jax(batch), n,
                            accum_dtype=None if accum is None else jnp.dtype(accum))
    g, m = accumulate_gradients(port_fn, torch.from_numpy(w), to_port(batch), n,
                                accum_dtype=None if accum is None else getattr(torch, accum))
    assert str(g.dtype).split(".")[-1] == str(rg.dtype)
    if g.dtype == torch.bfloat16:
        # the same bfloat16 additions of values that agree to float32
        # rounding: at most one bfloat16 step apart
        assert_close(np.asarray(rg, np.float32), g.float().numpy(), rtol=2.0**-7, atol=0.0)
    else:
        assert_close(np.asarray(rg), g.numpy(), **TOL)
    assert_close(float(rm["loss"]), float(m["loss"]), **TOL)


def test_accumulate_rejects_indivisible_batch():
    with pytest.raises(ValueError, match="not divisible"):
        accumulate_gradients(lambda p, mb: (p, {}), torch.zeros(()),
                             {"x": torch.zeros((10, 2))}, 3)
    with pytest.raises(ValueError):
        ref_accumulate(lambda p, mb: (p, {"loss": jnp.zeros(())}), jnp.zeros(()),
                       {"x": jnp.zeros((10, 2))}, 3)


# ---------------------------------------------------------------- remat


def test_remat_wrap_refuses_unknown_policy():
    assert POLICIES == ("none", "dots", "full")
    with pytest.raises(ValueError, match="unknown remat policy"):
        remat_wrap(lambda x: x, "everything")


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-370m"])
def test_remat_policies_give_the_same_gradients(arch, monkeypatch):
    """Each policy recomputes what it does not save and gets the gradients
    of "none" bit for bit; the layer bodies run twice under "dots" and
    "full" (forward and recompute), once under "none" and once without
    gradients (a plain forward saves nothing to recompute)."""
    cfg = port_configs.smoke(arch).model.replace(compute_dtype="float32")
    params = Model(cfg, device="cpu").params_tree()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 24)))
    module, name = (L, "attn_apply") if arch == "qwen3-8b" else (S, "ssm_apply")
    inner = getattr(module, name)
    calls = []
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or inner(*a, **k))
    grads = {}
    for policy in POLICIES:
        model = Model(cfg.replace(remat_policy=policy), params=params, device="cpu")
        flat = [p.requires_grad_() for _, p in leaves(model.params_tree())]
        calls.clear()
        loss, _ = model.loss_fn({"tokens": tokens})
        grads[policy] = torch.autograd.grad(loss, flat)
        assert len(calls) == cfg.num_layers * (1 if policy == "none" else 2), policy
        with torch.no_grad():
            calls.clear()
            model.forward({"tokens": tokens})
            assert len(calls) == cfg.num_layers
    for policy in ("dots", "full"):
        for a, b in zip(grads["none"], grads[policy]):
            assert torch.equal(a, b), policy
