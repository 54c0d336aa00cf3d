"""The port's parallel layer (`repro_torch.parallel.sharding`,
`.constraints`, `repro_torch.launch.mesh`, `.build.rules_for`,
`repro_torch.configs.shapes`, `models.spec`'s `abstract_tree` and
`partition_tree`) against the JAX package's, whose resolution code runs
live on JAX 0.9.

The reference resolves over `jax.sharding.AbstractMesh` (no devices); the
port over `DeviceMesh`es of the same shapes built in this process on the
fake process group of `torch.testing._internal` (`torch_dist.fake_world`):
rank 0 of a 512-rank world holds the single-pod, multi-pod and (2, 4)
meshes.  Every resolved spec, for every registry architecture × shape cell
× mesh, over the parameters, the caches and the train state, equals the
reference's entry for entry.
"""

import types

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh

import repro.configs as RC
from repro.configs import shapes as ref_shapes
from repro.launch import build as ref_build
from repro.launch import mesh as ref_mesh
from repro.models import Model as RefModel
from repro.models import spec as ref_spec
from repro.parallel import sharding as ref_sharding
from repro.runtime.steps import train_state_specs as ref_train_state_specs

from repro_torch import configs as C
from repro_torch.configs import shapes
from repro_torch.launch import build, mesh as port_mesh
from repro_torch.models import Model, abstract_tree, partition_tree
from repro_torch.models.model import _param_specs, cache_specs
from repro_torch.models.spec import TensorSpec, leaves
from repro_torch.parallel import constraints, sharding
from repro_torch.runtime.steps import train_state_specs
from torch_dist import fake_world

MESHES = {  # name: (shape, axes)
    "single_pod": ((16, 16), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
    "small": ((2, 4), ("data", "model")),
}


@pytest.fixture(scope="module")
def meshes():
    """The port's meshes by name, and the reference's abstract twins."""
    with fake_world(512):
        port = {
            "single_pod": port_mesh.make_production_mesh(device="cpu"),
            "multi_pod": port_mesh.make_production_mesh(multi_pod=True, device="cpu"),
            "small": port_mesh.make_mesh(*MESHES["small"], device="cpu"),
        }
        ref = {name: AbstractMesh(shape, axes) for name, (shape, axes) in MESHES.items()}
        yield port, ref


def ref_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=ref_spec.is_spec)


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1] if isinstance(dtype, torch.dtype) else jnp.dtype(dtype).name


def port_state_specs(cfg, exec_cfg):
    """`train_state_specs` from the config alone (no parameters drawn)."""
    return train_state_specs(types.SimpleNamespace(param_specs=lambda: _param_specs(cfg)),
                             exec_cfg)


# ---------------------------------------------------------------- rules


class TestRules:
    def test_override_and_get(self):
        r = sharding.default_rules(data_axes=("data",), model_axis="model")
        assert r.get("heads") == "model"
        r2 = r.override(seq="model")
        assert r2.get("seq") == "model"
        assert r.get("seq") is None  # original untouched
        assert r.get(None) is None
        assert sharding.ShardingRules.from_dict(r2.to_dict()) == r2

    def test_multi_pod_batch_axes(self):
        r = sharding.default_rules(data_axes=("pod", "data"), model_axis="model")
        assert r.get("batch") == ("pod", "data")

    @pytest.mark.parametrize("data_axes", [("data",), ("pod", "data")])
    @pytest.mark.parametrize("fsdp", [True, False])
    def test_default_rules_equal_reference(self, data_axes, fsdp):
        kw = dict(data_axes=data_axes, model_axis="model", fsdp=fsdp)
        got = sharding.default_rules(**kw)
        want = ref_sharding.default_rules(**kw)
        assert got.rules == want.rules
        assert got.override(seq="model", cache_seq="data").to_dict() == \
            want.override(seq="model", cache_seq="data").to_dict()


def test_mesh_helpers_equal_reference(meshes):
    port, ref = meshes
    for name, (shape, axes) in MESHES.items():
        m = port[name]
        assert tuple(m.mesh_dim_names) == axes
        assert tuple(sharding.mesh_axis_size(m, a) for a in axes) == shape
        assert port_mesh.data_axes(m) == ref_mesh.data_axes(ref[name])
        assert port_mesh.model_axis(m) == ref_mesh.model_axis(ref[name])
        assert port_mesh.mesh_context(m) is m
    with pytest.raises(KeyError, match="pod"):
        sharding.mesh_axis_size(port["single_pod"], "pod")


@pytest.mark.parametrize("arch", C.ARCHS)
def test_rules_for_equal_reference(arch, meshes):
    port, ref = meshes
    for cell in shapes.CELLS.values():
        for name in MESHES:
            got = build.rules_for(C.get(arch), cell, port[name])
            want = ref_build.rules_for(RC.get(arch), ref_shapes.CELLS[cell.name], ref[name])
            assert got.to_dict() == want.to_dict(), (arch, cell.name, name)
            over = dict(vocab=None, layers="data")
            assert (build.rules_for(C.get(arch), cell, port[name], overrides=over).to_dict()
                    == ref_build.rules_for(RC.get(arch), ref_shapes.CELLS[cell.name], ref[name],
                                           overrides=over).to_dict())


def test_resolve_pspec_drops_and_never_reuses_axes(meshes):
    """The reference's `test_divisibility_drops_axis`, on the port's mesh."""
    port, ref = meshes
    mesh, rmesh = port["small"], ref["small"]
    rules = sharding.default_rules(data_axes=("data",), model_axis="model")
    rules2 = sharding.default_rules(data_axes=("data", "model"))
    cases = [
        (rules, TensorSpec((16, 8, 4), None, ("embed", "heads", "head_dim")), ("data", "model")),
        (rules, TensorSpec((16, 6, 4), None, ("embed", "heads", "head_dim")), ("data",)),
        (rules2, TensorSpec((2, 10), None, ("batch", None)), ("data",)),
        (rules, TensorSpec((8, 8), None, ("heads", "kv_heads")), ("model",)),
        (rules, TensorSpec((3,), None, ()), ()),
    ]
    for r, s, want in cases:
        got = sharding.resolve_pspec(s, r, mesh)
        assert isinstance(got, sharding.PartitionSpec) and tuple(got) == want, (s, got)
        ref_r = ref_sharding.default_rules(**{"data_axes": ("data", "model")} if r is rules2
                                           else {"data_axes": ("data",), "model_axis": "model"})
        ref_s = ref_spec.TensorSpec(s.shape, jnp.float32, s.axes)
        assert tuple(ref_sharding.resolve_pspec(ref_s, ref_r, rmesh)) == want


def resolution_cases(arch):
    """(cell, tree name, port spec tree, reference spec tree) of an arch:
    the parameters in every applicable cell, the caches of the prefill and
    decode cells, the train state of the train cell."""
    spec, ref_spec_ = C.get(arch), RC.get(arch)
    cfg, ref_cfg = spec.model, ref_spec_.model
    ref_model = RefModel(ref_cfg)
    params, ref_params = _param_specs(cfg), ref_model.param_specs()
    for cell in shapes.CELLS.values():
        if not shapes.cell_applicable(cfg, cell)[0]:
            continue
        yield cell, "params", params, ref_params
        if cell.kind == "train":
            yield (cell, "train_state", port_state_specs(cfg, spec.exec),
                   ref_train_state_specs(ref_model, ref_spec_.exec))
        else:
            b, t = cell.global_batch, shapes.cache_len(cell)
            yield cell, "cache", cache_specs(cfg, b, t), ref_model.cache_specs(b, t)


@pytest.mark.parametrize("arch", C.ARCHS)
def test_every_resolved_spec_equals_reference(arch, meshes):
    port, ref = meshes
    spec, ref_arch = C.get(arch), RC.get(arch)
    checked = 0
    for cell, what, tree, ref_tree in resolution_cases(arch):
        got_leaves, want_leaves = list(leaves(tree)), ref_leaves(ref_tree)
        assert [(s.shape, s.axes) for _, s in got_leaves] == \
            [(tuple(s.shape), tuple(s.axes)) for s in want_leaves], (arch, cell.name, what)
        for name in MESHES:
            rules = build.rules_for(spec, cell, port[name])
            ref_rules = ref_build.rules_for(ref_arch, ref_shapes.CELLS[cell.name], ref[name])
            resolved = dict(leaves(sharding.resolve_tree(tree, rules, port[name])))
            for (path, s), rs in zip(got_leaves, want_leaves):
                want = tuple(ref_sharding.resolve_pspec(rs, ref_rules, ref[name]))
                assert tuple(resolved[path]) == want, (arch, cell.name, what, name, path)
                checked += 1
    assert checked > 0


@pytest.mark.parametrize("arch", C.ARCHS)
def test_partition_and_abstract_trees_equal_reference(arch):
    cfg, ref_cfg = C.get(arch).model, RC.get(arch).model
    ref_specs = RefModel(ref_cfg).param_specs()
    for rules in (sharding.default_rules(), sharding.default_rules(data_axes=("pod", "data"),
                                                                    fsdp=False)):
        got = [tuple(p) for _, p in leaves(partition_tree(_param_specs(cfg), rules.to_dict()))]
        ref_tree = ref_spec.partition_tree(ref_specs, rules.to_dict())
        want = [tuple(p) for p in jax.tree.leaves(
            ref_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
        assert got == want
    got = [(tuple(t.shape), dtype_name(t.dtype), t.device.type)
           for _, t in leaves(abstract_tree(_param_specs(cfg)))]
    want = [(tuple(s.shape), dtype_name(s.dtype), "meta")
            for s in jax.tree.leaves(ref_spec.abstract_tree(ref_specs))]
    assert got == want


@pytest.mark.parametrize("arch", C.ARCHS)
def test_input_specs_and_applicability_equal_reference(arch):
    cfg, ref_cfg = C.get(arch).model, RC.get(arch).model
    assert list(shapes.CELLS) == list(ref_shapes.CELLS)
    for name, cell in shapes.CELLS.items():
        ref_cell = ref_shapes.CELLS[name]
        assert (cell.seq_len, cell.global_batch, cell.kind, cell.tokens) == \
            (ref_cell.seq_len, ref_cell.global_batch, ref_cell.kind, ref_cell.tokens)
        assert shapes.cache_len(cell) == ref_shapes.cache_len(ref_cell)
        assert shapes.cell_applicable(cfg, cell) == ref_shapes.cell_applicable(ref_cfg, ref_cell)
        got = [(path, tuple(t.shape), dtype_name(t.dtype), t.device.type)
               for path, t in leaves(shapes.input_specs(cfg, cell))]
        ref_tree = ref_shapes.input_specs(ref_cfg, ref_cell)
        flat, _ = jax.tree_util.tree_flatten_with_path(ref_tree)
        want = [(".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path),
                 tuple(s.shape), dtype_name(s.dtype), "meta") for path, s in flat]
        assert got == want, (arch, name)


# ---------------------------------------------------------------- placements


def test_named_sharding_tree_gives_dtensor_placements(meshes):
    port, _ = meshes
    mesh = port["single_pod"]
    cfg = C.get("qwen3-8b").model
    rules = build.rules_for(C.get("qwen3-8b"), shapes.CELLS["decode_32k"], mesh)
    tree = sharding.named_sharding_tree(cache_specs(cfg, 128, 32768), rules, mesh)
    # (layers, batch, cache_seq, kv_heads, head_dim): batch takes "data", so
    # cache_seq keeps "model"; 8 kv heads do not divide 16
    assert tree["k"] == (Shard(1), Shard(2))
    params = sharding.named_sharding_tree(_param_specs(cfg), rules, mesh)
    assert params["layers"]["attn"]["wq"] == (Shard(1), Shard(2))  # (L, embed, heads, hd)
    assert params["final_norm"]["scale"] == (Shard(0), Replicate())
    multi = port["multi_pod"]
    ps = sharding.PartitionSpec(("pod", "data"), None, "model")
    assert sharding.placements(ps, multi) == (Shard(0), Shard(0), Shard(2))


def test_cache_seq_against_the_mesh_order_raises(meshes):
    """The default ``cache_seq`` rule at batch 1 shards the cache length
    over ("model", "data"), model major; DTensor cannot lay that out."""
    port, _ = meshes
    mesh = port["single_pod"]
    cfg = C.get("qwen3-8b").model
    rules = sharding.default_rules()
    specs = cache_specs(cfg, 1, 32768)
    assert tuple(sharding.resolve_pspec(specs["k"], rules, mesh)) == (None, None,
                                                                      ("model", "data"))
    with pytest.raises(ValueError, match=r"^k \(36, 1, 32768, 8, 128\).*mesh's order"):
        sharding.named_sharding_tree(specs, rules, mesh)


# ---------------------------------------------------------------- constraints


def test_shard_activation_outside_and_inside_a_context(meshes):
    port, _ = meshes
    mesh = port["small"]
    x = torch.randn(4, 8, 12, 6)
    axes = ("batch", "seq", "heads", "head_dim")
    assert constraints.current_context() is None
    assert constraints.shard_activation(x, axes) is x
    assert constraints.shard_activation(x, ("only", "two")) is x  # no context: no checks
    rules = sharding.default_rules().override(seq="model")
    with constraints.activation_sharding(rules, mesh):
        assert constraints.current_context() == (rules, mesh)
        assert constraints.shard_activation(x, axes) is x  # a plain tensor keeps its values
        with pytest.raises(ValueError, match="rank"):
            constraints.shard_activation(x, ("batch", "seq"))
        inner = sharding.default_rules()
        with constraints.activation_sharding(inner, mesh):
            assert constraints.current_context()[0] is inner
        assert constraints.current_context()[0] is rules  # restored
        d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        got = constraints.shard_activation(d, axes)
        assert isinstance(got, DTensor)
        # batch 4 over data (2), seq 8 over model (4); heads then finds model taken
        assert got.placements == (Shard(0), Shard(1))
    assert constraints.current_context() is None


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "qwen3-8b", "mamba2-370m"])
def test_forward_under_a_one_rank_mesh_is_bit_equal(arch, meshes, monkeypatch):
    """Under a (1, 1) mesh every constraint site resolves and the MoE takes
    the expert-parallel route with no collective: the logits and aux are
    the same bits as without a context."""
    from repro_torch.parallel import expert_parallel

    port, _ = meshes
    calls = []
    shard_map = expert_parallel.moe_apply_shard_map
    monkeypatch.setattr(expert_parallel, "moe_apply_shard_map",
                        lambda *a: calls.append(1) or shard_map(*a))
    spec = C.smoke(arch)
    model = Model(spec.model, device="cpu", seed=0)
    batch = {"tokens": np.random.default_rng(0).integers(0, spec.model.vocab_size, (2, 16))}
    mesh = port_mesh.make_mesh((1, 1), ("data", "model"), "cpu")
    with torch.no_grad():
        want, want_aux = model.forward(batch)
        rules = build.rules_for(spec, shapes.ShapeCell("t", 16, 2, "train"), mesh)
        with constraints.activation_sharding(rules, mesh):
            got, aux = model.forward(batch)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    assert len(calls) == (spec.model.num_layers if spec.model.family == "moe" else 0)


def test_train_cli_mesh_still_refuses(tmp_path, monkeypatch):
    """``--mesh`` runs only on a process group with the mesh's ranks: with
    fewer (here 4 for the multi-pod mesh's 512) it raises, naming both
    counts, and never carries on at a smaller mesh."""
    from repro_torch.launch import train

    monkeypatch.setattr(port_mesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(port_mesh.dist, "get_world_size", lambda *a: 4)
    with pytest.raises(RuntimeError, match=r"needs 512 ranks; the process group has 4"):
        train.main(["--arch", "qwen3-8b", "--smoke", "--mesh", "multi_pod", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path)])


def test_expert_parallel_reads_replicated_dtensors(meshes):
    """`moe_apply_shard_map` takes the full inputs as plain tensors or as
    replicated DTensors (read with ``to_local()``); a batch-sharded DTensor
    (a step built by `launch.build`) takes the DTensor route over the
    local shards, with the same values."""
    from repro_torch.models import layers as L
    from repro_torch.models.spec import init_tree
    from repro_torch.parallel.expert_parallel import moe_apply_shard_map

    spec = C.smoke("kimi-k2-1t-a32b")
    cfg = spec.model.replace(param_dtype="float32", compute_dtype="float32")
    p = init_tree(torch.Generator().manual_seed(0), L.moe_specs(cfg), "cpu")
    x = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    mesh = port_mesh.make_mesh((1, 1), ("data", "model"), "cpu")
    rules = build.rules_for(spec, shapes.ShapeCell("t", 16, 2, "train"), mesh)
    rep = [Replicate(), Replicate()]
    with torch.no_grad(), constraints.activation_sharding(rules, mesh):
        want = moe_apply_shard_map(p, cfg, x)
        got = moe_apply_shard_map({k: distribute_tensor(v, mesh, rep) for k, v in p.items()
                                   if k != "shared"}, cfg, distribute_tensor(x, mesh, rep))
        sharded = moe_apply_shard_map(
            {k: distribute_tensor(v, mesh, rep) for k, v in p.items() if k != "shared"}, cfg,
            distribute_tensor(x, mesh, [Shard(0), Replicate()]))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(sharded[0].full_tensor(), want[0])
    assert torch.equal(sharded[1].full_tensor(), want[1])
