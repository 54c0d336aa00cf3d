"""The multi-pod dry-run with "pod" and "data" merged into one mesh
dimension (`repro_torch.launch.mesh.flat_view`, `launch.build.traced_mesh`).

  * The merge decision on resolved spec trees: a batch of 32 on the
    multi-pod mesh merges; a batch of 2 on a (2, 2, 2) mesh, which shards
    over "pod" alone, does not, nor does ("model", "pod", "data"), the
    default cache rule of a batch-1 cell, whose axes run against the
    mesh's order.  The merged mesh keeps the 3-D mesh's ranks, axes and
    resolved specs, one FSDP gather over it is one all-gather, and an
    attention whose two sequences are split runs on query blocks with the
    keys whole, nothing replicated (`spmd.query_blocks`).
  * On a (2, 2, 2) fake mesh, 3-D against merged, in float32: the pieces
    of a step that address the "model" dimension under the default rules
    (the loss over vocab shards, the flash attention on local shards, with
    gradients), and a smoke training step of granite-8b and kimi-k2 with
    its rules cut to the data axes and the experts: equal flops, equal
    local shards, peaks within 2 %.
  * One production multi-pod cell that took minutes before the merge, with
    a bound on its wall time.

The meshes live in a fake world of 512 ranks (`torch_dist.fake_world`), the
traces on the ``meta`` device.  No JAX: the merged trace is held to the
port's own 3-D trace, which `tests/test_torch_launch.py` holds to the
reference.
"""

import dataclasses
import functools
import time

import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from repro_torch import configs as C
from repro_torch.configs.shapes import ShapeCell
from repro_torch.launch import build
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.hlo_analysis import analyze_step
from repro_torch.models import layers as L
from repro_torch.models.spec import TensorSpec, flatten
from repro_torch.parallel.constraints import activation_sharding
from repro_torch.parallel import pipeline, spmd
from repro_torch.parallel.sharding import (POD_DATA, PartitionSpec, default_rules, merge_dim,
                                           mesh_axes, mesh_axis_size, placements,
                                           resolve_pspec)
from repro_torch.runtime import steps
from torch_dist import fake_world


@pytest.fixture(scope="module")
def meshes():
    with fake_world(512):
        yield {"small": port_mesh.make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu",
                                            abstract=True),
               "multi_pod": port_mesh.make_production_mesh(multi_pod=True, device="cpu",
                                                           abstract=True)}


# ------------------------------------------------------------ the decision


def batch_pspec(mesh, b):
    rules = default_rules(data_axes=port_mesh.data_axes(mesh))
    return build._batch_pspec_tree({"tokens": torch.empty((b, 16), device="meta")}, rules, mesh)


def test_batch_of_32_merges_on_the_multi_pod_mesh(meshes):
    mesh = meshes["multi_pod"]
    tree = batch_pspec(mesh, 32)
    assert tree["tokens"] == PartitionSpec(POD_DATA)
    flat, merged = build.traced_mesh(mesh, tree)
    assert merged and flat.mesh_dim_names == ("pod_data", "model")
    assert build.traced_mesh(mesh, tree, flatten=False) == (mesh, False)


def test_pod_apart_from_data_does_not_merge(meshes):
    mesh = meshes["small"]
    tree = batch_pspec(mesh, 2)  # 2 divides "pod" but not "pod" x "data"
    assert tree["tokens"] == PartitionSpec("pod")
    assert build.traced_mesh(mesh, tree) == (mesh, False)
    assert build.traced_mesh(mesh, {"t": tree, "x": PartitionSpec(None, ("data", "pod"))}) \
        == (mesh, False)


def test_cache_against_the_mesh_order_does_not_merge(meshes):
    """A batch-1 cell's cache under the default rules: ("model", "pod",
    "data") names "pod" and "data" together, but model-major, which no mesh
    lays out; the cell stays 3-D (and raises there, as before)."""
    mesh = meshes["multi_pod"]
    rules = default_rules(data_axes=POD_DATA)
    cache = TensorSpec((1, 524288, 8, 128), torch.bfloat16,
                       ("batch", "cache_seq", "kv_heads", "head_dim"))
    ps = resolve_pspec(cache, rules, mesh)
    assert ps == PartitionSpec(None, ("model", "pod", "data"))
    assert build.traced_mesh(mesh, {"k": ps}) == (mesh, False)
    with pytest.raises(ValueError):
        placements(ps, mesh)


def test_merged_mesh_keeps_ranks_axes_and_specs(meshes):
    mesh = meshes["multi_pod"]
    flat = port_mesh.flat_view(mesh)
    assert torch.equal(flat.mesh, mesh.mesh.reshape(32, 16))
    assert port_mesh.data_axes(flat) == POD_DATA and port_mesh.model_axis(flat) == "model"
    assert [mesh_axis_size(flat, a) for a in ("pod", "data", "model")] == [2, 16, 16]
    rules = default_rules(data_axes=POD_DATA)
    spec = TensorSpec((4096, 12288), torch.float32, ("embed", "ffn"))
    assert resolve_pspec(spec, rules, flat) == resolve_pspec(spec, rules, mesh) \
        == PartitionSpec(POD_DATA, "model")
    assert placements(PartitionSpec(POD_DATA, "model"), flat) == (Shard(0), Shard(1))
    assert placements(PartitionSpec(POD_DATA, "model"), mesh) == (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="part of"):
        placements(PartitionSpec("pod"), flat)
    with pytest.raises(ValueError):
        port_mesh.flat_view(flat)
    # the merge is the dimension's, not the object's: a mesh rebuilt from the
    # same ranks and names (as DTensor may) reads the same axes
    again = DeviceMesh(flat.device_type, flat.mesh, mesh_dim_names=flat.mesh_dim_names)
    assert mesh_axes(again) == mesh_axes(flat) == (("pod", 2, 0), ("data", 16, 0), ("model", 16, 1))
    with pytest.raises(ValueError, match="pipeline stages"):  # no stages over a merged "pod"
        pipeline._Pod(flat, "pod")
    with pytest.raises(ValueError, match="already"):  # one split per merged name and size
        merge_dim((("pod", 4), ("data", 8)))


def test_fsdp_gather_is_one_all_gather_on_the_merged_mesh(meshes):
    """An "embed"-sharded weight gathered at use: two chained all-gathers on
    the 3-D mesh (the first's result counted too), one on the merged mesh,
    as XLA's one replica group."""
    mesh = meshes["small"]
    counts = {}
    for name, m in (("3d", mesh), ("merged", port_mesh.flat_view(mesh))):
        pl = placements(PartitionSpec(POD_DATA, "model"), m)
        w = spmd.abstract_tree({"w": TensorSpec((64, 32), torch.float32, ())}, {"w": pl}, m)["w"]
        out, cost, _, _ = analyze_step(spmd._gather_data_axes, w)
        assert tuple(out.placements)[-1] == Shard(1)
        assert all(p == Replicate() for p in tuple(out.placements)[:-1])
        counts[name] = cost.collective_breakdown["all-gather"]
    full = 64 * 16 * 4  # the gathered weight's bytes on a rank (its "model" shard)
    assert counts == {"3d": full / 2 + full, "merged": full}


def test_attention_keys_whole_where_both_sequences_split(meshes):
    """A training step's attention with queries and keys split over the
    batch and the sequence (whisper-tiny's decoder on the CPU's route, B =
    256, T = 4096) on the merged multi-pod mesh: left to DTensor, the
    product also splits its merged batch over "model", 512 ways, and the
    view back to (B, KV, G, T, S) runs replicated; on each rank's block of
    queries with the keys whole along the sequence (`spmd.query_blocks`, as
    `layers.attn_apply` takes them without a cache) nothing does, and the
    output keeps the queries' layout."""
    flat = port_mesh.flat_view(meshes["multi_pod"])
    spec = TensorSpec((256, 4096, 6, 64), torch.float32, ())
    q, k, v = (spmd.abstract_tree({"x": spec}, {"x": (Shard(0), Shard(1))}, flat)["x"]
               for _ in range(3))
    attend = functools.partial(L._sdpa, causal=True)
    for whole in (False, True):
        spmd.REPLICATED.clear()
        with spmd.spmd_region():
            out = spmd.query_blocks(attend, q, k, v) if whole else attend(q, k, v)
        assert bool(spmd.REPLICATED) != whole, dict(spmd.REPLICATED)
    assert tuple(out.placements) == (Shard(0), Shard(1))


# ------------------------------------------------- 3-D against merged traces

ARCHS = ["granite-8b", "kimi-k2-1t-a32b"]


def axes_of(t):
    """{tensor dim: mesh axes sharding it, major first} of a DTensor: the
    same for one layout on the 3-D mesh and on its merged view."""
    out = {}
    for m, p in enumerate(t.placements):
        if isinstance(p, Shard):
            out.setdefault(p.dim, []).extend(a for a, _, d in mesh_axes(t.device_mesh) if d == m)
    return out


def trace_on_both(mesh, rules, specs, fn):
    """``fn`` on abstract DTensors laid out by ``specs``' resolved specs, run
    once on ``mesh`` and once on its merged view under the activation
    context: {"3d"/"merged": (flops, kernel calls, peak bytes, [(local
    shape, axes_of) of each output])}."""
    got = {}
    for name, m in (("3d", mesh), ("merged", port_mesh.flat_view(mesh))):
        shardings = {k: placements(resolve_pspec(s, rules, m), m) for k, s in specs.items()}
        args = spmd.abstract_tree(specs, shardings, m)
        for k, s in specs.items():
            args[k].requires_grad_(s.dtype.is_floating_point)

        def run(args):
            with activation_sharding(rules, m), spmd.spmd_region():
                return fn(args)

        out, cost, mem, calls = analyze_step(run, args)
        got[name] = (cost.flops, dict(calls), mem.peak_bytes,
                     [(tuple(t.to_local().shape), axes_of(t)) for t in out])
    return got["3d"], got["merged"]


@pytest.mark.parametrize("piece", ["loss", "attention"])
def test_model_sharded_pieces_equal_on_both_meshes(meshes, piece):
    """The pieces of a step that address the "model" dimension, which moves
    from mesh dim 2 to dim 1 when "pod" and "data" merge, under
    `rules_for`'s default rules with FSDP (granite-8b smoke widths, f32, on
    the (2, 2, 2) mesh): the unembedding and the loss over vocab shards
    (`spmd.logsumexp_last`, `spmd.pick_last`) with their gradients, and the
    flash attention on local batch and head shards (`spmd.sharded_call`,
    the kernel's shape function) with its gradients.  Each output has the
    same local shape and the same axes on both meshes; flops and kernel
    calls are equal, peaks within 2 %.  (A whole smoke step under these
    rules is no test: see `test_merged_trace_equals_the_3d_trace`.)"""
    spec = C.smoke("granite-8b").replace_model(compute_dtype="float32")
    spec = dataclasses.replace(spec, exec=spec.exec.replace(fsdp=True, seq_shard=False))
    mesh, cfg = meshes["small"], spec.model
    rules = build.rules_for(spec, ShapeCell("t", 128, 8, "train"), mesh)
    b, t, hd = 8, 128, cfg.d_model // cfg.num_heads
    f32 = torch.float32
    if piece == "loss":
        specs = {"x": TensorSpec((b, t, cfg.d_model), f32, ("batch", "seq", "act_embed")),
                 "w": TensorSpec((cfg.d_model, cfg.vocab_size), f32, ("embed", "vocab")),
                 "tokens": TensorSpec((b, t), torch.int64, ("batch", "seq"))}

        def fn(a):
            w = spmd.gathered({"w": a["w"]})["w"]
            logits = L.unembed_apply({"unembed": w}, cfg, a["x"])
            nll = spmd.logsumexp_last(logits) - spmd.pick_last(logits, a["tokens"])
            return (logits, nll, *torch.autograd.grad(nll.sum(), (a["x"], a["w"])))
    else:
        specs = {"q": TensorSpec((b, t, cfg.num_heads, hd), f32,
                                 ("batch", "seq", "heads", "head_dim")),
                 **{n: TensorSpec((b, t, cfg.num_kv_heads, hd), f32,
                                  ("batch", "seq", "kv_heads", "head_dim")) for n in "kv"}}

        def fn(a):
            out = L.flash_attention(a["q"], a["k"], a["v"], True)
            return (out, *torch.autograd.grad(out.sum(), (a["q"], a["k"], a["v"])))

    (f3, c3, p3, o3), (fm, cm, pm, om) = trace_on_both(mesh, rules, specs, fn)
    assert om == o3
    assert any("model" in sum(ax.values(), []) for _, ax in o3)  # "model" shards something
    assert fm == f3 > 0 and cm == c3
    assert abs(pm - p3) <= 0.02 * p3


@pytest.mark.parametrize("arch", ARCHS)
def test_merged_trace_equals_the_3d_trace(meshes, arch, monkeypatch):
    """One smoke training step (float32, batch 8 x 16 tokens, FSDP on) on
    the (2, 2, 2) mesh, traced 3-D and merged.  The cell is cut to the
    axes the merge touches: "batch", "embed" and the MoE's "capacity" over
    ("pod", "data"), the experts over "model", every other rule and the
    sequence sharding off; each case takes about 15 s.  Under the default
    rules the 3-D trace is no test: views that merge a dimension split over
    ("pod", "data") with one split over "model" give `_StridedShard`
    inputs, and DTensor costs each candidate strategy of their products by
    a graph search over three mesh dims, up to 140 s for one `bmm`.  One
    granite-8b smoke layer took 840 s 3-D against 10 s merged on one CPU
    core (flops, every state and gradient shard and the peak equal).  The "model"-sharded pieces of such a step are
    held 3-D against merged under the default rules in
    `test_model_sharded_pieces_equal_on_both_meshes`."""
    spec = C.smoke(arch).replace_model(compute_dtype="float32")
    ex = spec.exec.replace(fsdp=True, seq_shard=False)
    cell = ShapeCell("t", 16, 8, "train")
    mesh = meshes["small"]
    rules = build.rules_for(dataclasses.replace(spec, exec=ex), cell, mesh).override(
        heads=None, kv_heads=None, ffn=None, vocab=None, ssm_inner=None, seq=None)
    grads = []
    clip = steps.clip_by_global_norm

    def recording_clip(tree, limit):
        grads.append([t.to_local().numel() * t.element_size() for t in flatten(tree)])
        return clip(tree, limit)

    monkeypatch.setattr(steps, "clip_by_global_norm", recording_clip)
    got = {}
    for merge in (False, True):
        built = build.build_cell(spec, cell, mesh, rules=rules, exec_override=ex, flatten=merge)
        assert built.mesh_flattened == merge
        compiled = built.lower()
        state = [t.to_local().numel() * t.element_size() for t in flatten(built.abstract_args[0])]
        got[merge] = (compiled.cost.flops, state, grads[-1], compiled.memory.peak_bytes)
    (f3, s3, g3, p3), (fm, sm, gm, pm) = got[False], got[True]
    print(arch, "peak 3-D", p3, "merged", pm)
    assert fm == f3
    assert sm == s3 and gm == g3
    assert abs(pm - p3) <= 0.02 * p3


# --------------------------------------------------- a production cell


def test_multi_pod_cell_within_its_time(meshes):
    """mamba2-370m x decode_32k x multi_pod, describing the card: the
    cheapest multi-pod cell that took over 60 s before the merge (258 s in
    the dry-run sweep of `PERF.md` §6, 13 s single-pod); merged, about 8 s
    in-process, in the module's fake world of 512 ranks."""
    t0 = time.time()
    art = run_cell("mamba2-370m", "decode_32k", "multi_pod")
    wall = time.time() - t0
    assert art["status"] == "ok" and art["mesh_flattened"]
    assert art["replicated_at"] == {}
    assert 0 < art["memory"]["peak_bytes_per_device"] < 2**30
    assert wall < 60.0, wall
