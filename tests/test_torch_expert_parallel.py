"""The port's expert-parallel MoE (`repro_torch.parallel.expert_parallel`)
over four gloo processes on a (2, 2) ("data", "model") mesh, against the
single-process port and the JAX package's local dispatch on the same numpy
inputs (the reference's own `shard_map` lanes fail on JAX 0.9).

One spawn runs every rank's share of three jobs (`torch_dist.ep_worker`):

  * **uncapped** (arctic smoke, float32, capacity factor 16): the model's
    logits and every parameter's gradient of ce + z_loss equal the
    single-process port's and the reference's (the ranks under remat
    "full", their backward in another thread, as on the card).  The load-balancing ``aux``
    is each data shard's own (the reference's ``pmean``), so it and its
    gradient are held at the layer: ``aux`` equals the mean of the shards'
    local ``aux``, and the gradients of sum(y · c) + aux, and of aux alone
    (c = 0: its share of sum(y · c) + aux is too small to see), equal those
    of the same functions computed shard by shard in one process;
  * **capped** (kimi smoke, capacity factor 0.3): each data shard's output
    equals the reference's local `moe_apply` on that shard's tokens (the
    per-shard drop set, by `_expert_capacity(n_local)`), and ``aux`` the
    mean of the shards' local ``aux``.

Every rank holds the full output and gradients, the same on all four.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as RC
from repro.models import layers as RL

from repro_torch import configs as C
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch.build import rules_for
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as PL
from repro_torch.models.convert import params_from_jax
from repro_torch.models.spec import leaves, tree_map
from repro_torch.parallel import constraints
from repro_torch.parallel.expert_parallel import moe_shard_map_available
from repro_torch.parallel.sharding import default_rules
from repro_torch.testing import FLOAT_ATOL, FLOAT_RTOL, assert_close
from torch_dist import ep_worker, fake_world, spawn
from torch_zoo import MODEL_F32_TOL, normal, np_values, pair, port_config

MESH = (2, 2)  # ("data", "model"): two data shards of four rows, experts split in two
B, T = 8, 16
SHARDS = [slice(0, 4), slice(4, 8)]


def f32_moe_cfg(arch, capacity):
    ref_cfg = RC.smoke(arch).model.replace(param_dtype="float32", compute_dtype="float32")
    return ref_cfg.replace(moe=dataclasses.replace(ref_cfg.moe, capacity_factor=capacity))


def layer_case(arch, capacity, seed):
    """(reference config, reference MoE params, x, the cotangent weights c)."""
    ref_cfg = f32_moe_cfg(arch, capacity)
    ref_p = jax.tree.map(jnp.asarray, np_values(RL.moe_specs(ref_cfg), seed),
                         is_leaf=lambda v: isinstance(v, np.ndarray))
    rng = np.random.default_rng(seed + 1)
    return ref_cfg, ref_p, normal(rng, (B, T, ref_cfg.d_model)), normal(rng, (B, T, ref_cfg.d_model))


def grads_close(ref, got, tol, what):
    """Every leaf within ``tol``, its atol scaled by the leaf's largest
    |gradient| (a gradient's small entries are sums that cancel)."""
    for (path, r), (_, g) in zip(leaves(ref), leaves(got)):
        scale = max(float(np.abs(r).max()), 1e-30)
        assert_close(r, g, rtol=tol["rtol"], atol=tol["atol"] * scale, what=f"{what} {path}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference and single-process sides, and the four ranks' results."""
    ref_cfg = f32_moe_cfg("arctic-480b", 16.0)
    ref_model, ref_p, model = pair(ref_cfg, 0)
    cfg = model.cfg
    batch = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab_size, (B, T))
             .astype(np.int32)}
    layers = {name: layer_case(arch, cap, seed) for name, arch, cap, seed in
              (("uncapped", "arctic-480b", 16.0, 5), ("capped", "kimi-k2-1t-a32b", 0.3, 7))}
    # remat "full": the backward's recompute runs the expert-parallel MoE again
    jobs = [("model", "arctic-480b", cfg.replace(remat_policy="full"),
             tree_map(lambda t: t.detach().numpy(), model.params_tree()), batch)]
    for name, arch in (("uncapped", "arctic-480b"), ("capped", "kimi-k2-1t-a32b")):
        ref_cfg_l, ref_p_l, x, c = layers[name]
        for weights in (c, np.zeros_like(c)):
            jobs.append(("layer", arch, port_config(ref_cfg_l),
                         jax.tree.map(np.array, ref_p_l), x, weights))
    ranks = spawn(ep_worker, MESH[0] * MESH[1], tmp_path_factory.mktemp("ep"), jobs, MESH)
    return dict(ref_cfg=ref_cfg, ref_model=ref_model, ref_p=ref_p, model=model, batch=batch,
                layers=layers, ranks=ranks)


def test_uncapped_model_matches_single_process_and_reference(runs):
    model, batch = runs["model"], runs["batch"]
    tree = model.params_tree()
    for p in model.parameters():
        p.requires_grad_(True)
    with torch.no_grad():
        logits, aux = model.forward(batch)
    _, m = model.loss_fn(batch)
    (m["ce"] + m["z_loss"]).backward()
    grads = tree_map(lambda p: p.grad.numpy(), tree)

    ref_model, ref_p = runs["ref_model"], runs["ref_p"]
    jb = {"tokens": jnp.asarray(batch["tokens"])}
    ref_logits, _ = jax.jit(ref_model.forward)(ref_p, jb)

    def ref_loss(p):
        loss, metrics = ref_model.loss_fn(p, jb)
        return loss - metrics["aux_loss"]

    ref_grads = params_from_jax(jax.jit(jax.grad(ref_loss))(ref_p), model.cfg)
    ref_grads = tree_map(lambda t: t.float().numpy(), ref_grads)
    tol = dict(rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
    for rank, out in enumerate(runs["ranks"]):
        res = out[0]
        # the forward, the loss's forward and its recompute
        assert res["shard_map_calls"] == 3 * model.cfg.num_layers
        assert_close(logits.numpy(), res["logits"], **tol, what=f"rank {rank} logits")
        assert_close(np.asarray(ref_logits), res["logits"], **MODEL_F32_TOL,
                     what=f"rank {rank} logits vs reference")
        grads_close(grads, res["grads"], tol, f"rank {rank} gradient")
        grads_close(ref_grads, res["grads"], MODEL_F32_TOL, f"rank {rank} gradient vs reference")
        # each data shard's aux, averaged: not the aux of all eight rows at once
        assert res["aux"] != pytest.approx(float(aux), rel=1e-3)


def per_shard_layer(cfg, p, x, c):
    """`moe_apply` shard by shard in one process: the output, the mean aux,
    and the gradients of sum(y · c) + aux."""
    p = tree_map(lambda a: torch.from_numpy(a).requires_grad_(True), p)
    xt = torch.from_numpy(x).requires_grad_(True)
    ys, auxes = zip(*(PL.moe_apply(p, cfg, xt[rows]) for rows in SHARDS))
    y, aux = torch.cat(ys), torch.stack(auxes).mean()
    ((y.float() * torch.from_numpy(c)).sum() + aux).backward()
    return (y.detach().numpy(), float(aux.detach()), xt.grad.numpy(),
            tree_map(lambda a: a.grad.numpy(), p))


@pytest.mark.parametrize("aux_only", [False, True], ids=["y and aux", "aux alone"])
@pytest.mark.parametrize("name", ["uncapped", "capped"])
def test_layer_matches_per_shard_dispatch(runs, name, aux_only):
    ref_cfg, ref_p, x, c = runs["layers"][name]
    cfg = port_config(ref_cfg)
    p = jax.tree.map(np.array, ref_p)
    y, aux, gx, gp = per_shard_layer(cfg, p, x, np.zeros_like(c) if aux_only else c)
    shard_y = [jax.jit(RL.moe_apply, static_argnums=1)(ref_p, ref_cfg, jnp.asarray(x[rows]))
               for rows in SHARDS]
    ref_y = np.concatenate([np.asarray(s[0]) for s in shard_y])
    ref_aux = float(np.mean([float(s[1]) for s in shard_y]))
    if name == "capped":  # each shard drops pairs, and not those all eight rows would
        route = PL.moe_route(torch.from_numpy(p["router"]), cfg.moe,
                             torch.from_numpy(x[SHARDS[0]]).reshape(-1, cfg.d_model))
        assert 0 < int((~route["keep"]).sum()) < route["keep"].numel()
        with torch.no_grad():
            whole, _ = PL.moe_apply(tree_map(torch.from_numpy, p), cfg, torch.from_numpy(x))
        assert not np.allclose(whole.numpy(), y, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
    tol = dict(rtol=FLOAT_RTOL, atol=FLOAT_ATOL)
    for rank, out in enumerate(runs["ranks"]):
        res = out[(1 if name == "uncapped" else 3) + aux_only]
        assert res["shard_map_calls"] == 1
        assert_close(ref_y, res["y"], **tol, what=f"rank {rank} y vs reference per shard")
        assert_close(y, res["y"], **tol, what=f"rank {rank} y")
        assert_close(ref_aux, res["aux"], **tol, what=f"rank {rank} aux vs reference")
        assert_close(aux, res["aux"], **tol, what=f"rank {rank} aux")
        grads_close({"x": gx, **gp}, {"x": res["gx"], **res["gp"]}, tol, f"rank {rank}")


def test_every_rank_holds_the_same_result(runs):
    first = runs["ranks"][0]
    coords = set()
    for out in runs["ranks"]:
        coords.add(out[0]["coords"])
        for a, b in zip(first, out):
            for key in ("logits", "y", "gx"):
                if key in a:
                    assert np.array_equal(a[key], b[key]), key
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_available_only_with_a_dividing_model_axis():
    cfg = port_config(f32_moe_cfg("kimi-k2-1t-a32b", 1.25))
    dense = C.smoke("qwen3-8b").model
    shape = (B, T, cfg.d_model)
    assert not moe_shard_map_available(cfg, shape)  # no context
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        odd = make_mesh((1, 3), ("data", "model"), "cpu")
        pod = make_mesh((2, 4), ("pod", "data"), "cpu")
        rules = rules_for(C.smoke("kimi-k2-1t-a32b"), ShapeCell("t", T, B, "train"), mesh)
        cases = [
            (rules, mesh, cfg, True),
            (rules, mesh, dense, False),  # no MoE
            (rules.override(experts=None), mesh, cfg, False),
            (rules.override(experts=("model",)), mesh, cfg, False),  # a tuple entry
            (default_rules(data_axes=("pod",), model_axis="pod"), pod, cfg, True),
            (rules, pod, cfg, False),  # the mesh has no "model" axis
            (rules, odd, cfg, cfg.moe.num_experts % 3 == 0),
        ]
        for r, m, c, want in cases:
            with constraints.activation_sharding(r, m):
                assert moe_shard_map_available(c, shape) is want, (r.get("experts"), m, want)
    assert cfg.moe.num_experts % 3 != 0
