"""The port's launch layer against the JAX package's: the step counter
(`repro_torch.launch.hlo_analysis`), `build_cell` and its `lower`, the
batch shardings, and sharded training (``train --mesh``).

  * The counter's hand tests are the twins of `tests/test_hlo_analysis.py`
    (matrix products, loops, a batched einsum, an all-reduce and its loop),
    with a matmul sharded over a (2, 4) mesh and a peak-bytes case.
  * The flops of one smoke step of five cells, traced by the port on one
    device, are held within 2 % of the reference's `analyze_hlo` on its
    single-device CPU compile of the same step (for prefill, less the
    unembedding of the T - 1 positions whose logits the reference computes
    and drops, and the port never computes).
  * Every step kind of the six families of `tests/test_sharding.py`'s
    tiny-mesh dry-run traces on a (2, 4) mesh, with a peak per device above
    0 and no larger than on one device.
  * `_batch_pspec_tree` equals the reference's over `AbstractMesh`.
  * A training step through ``train.main(["--mesh", ...])`` on four gloo
    ranks at (2, 2) equals the single-device step within the reference's
    own limits (`tests/test_sharding.py`: loss 1e-4, gradient norm 1e-3
    relative); the single-device step is held against the reference's by
    `tests/test_torch_train.py` (the reference's sharded test fails on
    JAX 0.9).

The meshes live in a fake world of 512 ranks (`torch_dist.fake_world`), the
traces on the ``meta`` device.
"""

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

import jax
from jax.sharding import AbstractMesh

import repro.configs as RC
from repro.configs.shapes import ShapeCell as RefCell
from repro.launch import build as ref_build
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import Model as RefModel
from repro.models.spec import abstract_tree as ref_abstract
from repro.runtime import steps as ref_steps

from repro_torch import configs as C
from repro_torch.configs.shapes import ShapeCell, input_specs
from repro_torch.launch import build
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.hlo_analysis import HloCost, analyze_step
from repro_torch.models.model import Model
from repro_torch.models.spec import abstract_tree
from repro_torch.runtime.steps import make_serve_steps, make_train_step, train_state_specs
from torch_dist import f32_smoke, fake_world, recorded_steps, spawn, train_mesh_worker

MESHES = {  # name: (shape, axes)
    "flat": ((8,), ("x",)),
    "one": ((1, 1), ("data", "model")),
    "small": ((2, 4), ("data", "model")),
    "single_pod": ((16, 16), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
}


@pytest.fixture(scope="module")
def meshes():
    with fake_world(512):
        yield {k: port_mesh.make_mesh(s, a, "cpu", abstract=True) for k, (s, a) in MESHES.items()}


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def cost(fn, *args) -> HloCost:
    return analyze_step(fn, *args)[1]


# ---------------------------------------------------------------- counter


def test_plain_matmul():
    m, k, n = 64, 128, 32
    assert cost(lambda a, b: a @ b, meta(m, k), meta(k, n)).flops == 2 * m * k * n


def test_loop_multiplies_by_trip_count():
    def f(x):
        for _ in range(17):
            x = torch.tanh(x @ x)
        return x

    assert cost(f, meta(64, 64)).flops == 17 * 2 * 64**3


def test_nested_loops():
    def f(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ x
        return x

    assert cost(f, meta(32, 32)).flops == 15 * 2 * 32**3


def test_batched_einsum():
    c = cost(lambda a, b: torch.einsum("bij,bjk->bik", a, b), meta(4, 16, 32), meta(4, 32, 8))
    assert c.flops == 2 * 4 * 16 * 32 * 8


def test_all_reduce_bytes_and_loop_scaling(meshes):
    """An all-reduce of a per-device (1, 1024) float32 counts 4096 B under
    all-reduce; ten in a loop count ten times."""
    mesh = meshes["flat"]

    def partial(local):
        return DTensor.from_local(local, mesh, [Partial()], run_check=False)

    def once(v):
        return v.redistribute(mesh, [Replicate()])

    def ten(v):
        for _ in range(10):
            v = partial(v.redistribute(mesh, [Replicate()]).to_local())
        return v

    c = cost(once, partial(meta(1, 1024)))
    assert c.collective_bytes == 4096 and c.collective_breakdown == {"all-reduce": 4096.0}
    c10 = cost(ten, partial(meta(1, 1024)))
    assert c10.collective_breakdown == {"all-reduce": 40960.0}
    both = (c + c10).scaled(2.0)
    assert both.collective_breakdown == {"all-reduce": 2 * 45056.0}


def test_sharded_matmul_counts_its_share(meshes):
    """A (16, 64) x (64, 128) product, rows over "data" (2) and columns over
    "model" (4): each device counts 1/8 of the flops and moves nothing."""
    mesh = meshes["small"]
    x = DTensor.from_local(meta(8, 64), mesh, [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(meta(64, 32), mesh, [Replicate(), Shard(1)], run_check=False)
    out, c, _, _ = analyze_step(lambda a, b: a @ b, x, w)
    assert c.flops == 2 * 16 * 64 * 128 / 8 and c.collective_bytes == 0
    assert tuple(out.to_local().shape) == (8, 32)


def test_peak_bytes_follow_the_live_tensors():
    """a (4 KiB) → t1 → t2 (t1 freed) → t3: at most three 4 KiB buffers
    live; an in-place update returns its argument (an alias)."""
    def chain(a):
        t1 = a * 2
        t2 = t1 * 3
        del t1
        return t2 + 1

    _, _, mem, _ = analyze_step(chain, meta(1024))
    assert (mem.argument_size_in_bytes, mem.output_size_in_bytes, mem.alias_size_in_bytes,
            mem.temp_size_in_bytes, mem.peak_bytes) == (4096, 4096, 0, 4096, 12288)

    def bump(a):
        return a.add_(1)

    _, _, mem, _ = analyze_step(bump, meta(1024))
    assert (mem.argument_size_in_bytes, mem.output_size_in_bytes, mem.alias_size_in_bytes,
            mem.temp_size_in_bytes, mem.peak_bytes) == (4096, 4096, 4096, 0, 4096)


FALLBACK_CASES = {  # op → (placements of a global (8, 8) f32, the op, bytes gathered)
    # no strategy at all: run on the whole tensor, replicated out
    "aten.renorm.default": ((Shard(0), Replicate()), lambda x: x.renorm(2, 0, 1.0), 128.0),
    # a view that cannot split the 4 "model" shards of dim 1 into (2, 4)
    "aten.view.default": ((Replicate(), Shard(1)), lambda x: x.view(8, 2, 4), 192.0),
}


@pytest.mark.parametrize("op", list(FALLBACK_CASES))
def test_replicate_at_op_fallback(meshes, op):
    """An op DTensor cannot shard runs on inputs gathered over more and more
    mesh dims; the site and its gathered bytes are recorded, and the
    gathers are collectives the counter sees."""
    from repro_torch.parallel import spmd

    mesh = meshes["small"]
    placements, fn, gathered = FALLBACK_CASES[op]
    local = meta(*spmd.local_shape((8, 8), placements, mesh))
    x = DTensor.from_local(local, mesh, placements, run_check=False)
    spmd.REPLICATED.clear()

    def step(x):
        with spmd.spmd_region():
            return fn(x)

    out, c, _, _ = analyze_step(step, x)
    assert dict(spmd.REPLICATED) == {op: gathered}
    assert c.collective_breakdown.get("all-gather", 0) >= gathered
    assert out.full_tensor().shape == fn(torch.empty(8, 8, device="meta")).shape


@pytest.mark.parametrize("with_mask", [False, True])
def test_loss_over_dtensors_matches_plain(meshes, with_mask):
    """Over DTensors the loss shifts the targets, not the logits, and picks
    and reduces over the vocabulary on local shards: the same loss and
    metrics as the plain path, with and without a loss mask."""
    from repro_torch.models.spec import tree_map
    from repro_torch.parallel import spmd

    mesh = meshes["one"]
    spec = C.smoke("granite-8b").replace_model(compute_dtype="float32")
    model = Model(spec.model, device="cpu", seed=0)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, spec.model.vocab_size, (4, 16)))}
    if with_mask:
        batch["loss_mask"] = torch.from_numpy((rng.random((4, 16)) > 0.3).astype(np.float32))
    want = model.loss_fn(batch)[1]
    rows = (Shard(0), Replicate())
    params = spmd.distribute_tree(model.params_tree(), tree_map(
        lambda _: (Replicate(), Replicate()), model.params_tree()), mesh)
    sharded = {k: spmd.distribute_tree(v, rows, mesh) for k, v in batch.items()}
    with spmd.spmd_region():
        got = model.loss_fn(sharded, params=params)[1]
    for k in want:
        assert float(spmd.replicated(got[k])) == pytest.approx(float(want[k]), rel=1e-6), k


# ---------------------------------------------------- flops vs reference

FLOP_CELLS = [  # (arch, step kind, float32 params and compute)
    ("granite-8b", "train", False),
    ("granite-8b", "prefill", False),
    ("granite-8b", "decode", False),
    ("mamba2-370m", "train", False),
    ("kimi-k2-1t-a32b", "train", True),
]
FLOP_RTOL = 0.02


def smoke_pair(arch, f32):
    ref, port = RC.smoke(arch), C.smoke(arch)
    if f32:
        kw = dict(param_dtype="float32", compute_dtype="float32")
        ref, port = ref.replace_model(**kw), port.replace_model(**kw)
    return ref, port


def plain_step(spec, cell):
    """(step fn, its meta arguments) for ``cell`` on one device: the port's
    step over plain meta tensors, no mesh."""
    model = Model(spec.model, device="meta")
    specs = input_specs(spec.model, cell)
    if cell.kind == "train":
        state = abstract_tree(train_state_specs(model, spec.exec, per_layer=True))
        return make_train_step(model, spec.exec), state, specs["batch"]
    prefill, decode = make_serve_steps(model)
    params = abstract_tree(model.param_specs(stacked=False))
    cache = abstract_tree(model.cache_specs(cell.global_batch, cell.seq_len))
    if cell.kind == "prefill":
        return prefill, params, specs["batch"], cache
    return decode, params, cache, specs["tokens"], cell.seq_len - 1


def ref_step(spec, cell):
    """The reference's step for ``cell``, compiled for one CPU device (no
    mesh: its activation constraints are the identity)."""
    model = RefModel(spec.model)
    specs = RC.input_specs(spec.model, cell)
    if cell.kind == "train":
        fn = ref_steps.make_train_step(model, spec.exec)
        args = (ref_abstract(ref_steps.train_state_specs(model, spec.exec)), specs["batch"])
    else:
        prefill, decode = ref_steps.make_serve_steps(model)
        params = ref_abstract(model.param_specs())
        fn, args = ((prefill, (params, specs["batch"], specs["cache"])) if cell.kind == "prefill"
                    else (decode, (params, specs["cache"], specs["tokens"], specs["index"])))
    return jax.jit(fn).lower(*args).compile()


@pytest.mark.parametrize("arch,kind,f32", FLOP_CELLS)
def test_flops_match_reference_analyze_hlo(meshes, arch, kind, f32):
    ref_spec, spec = smoke_pair(arch, f32)
    t, b = 32, 4
    ref_cost = analyze_hlo(ref_step(ref_spec, RefCell("c", t, b, kind)).as_text())
    want = ref_cost.flops
    if kind == "prefill":  # the port unembeds the last position only; the reference all T
        cfg = spec.model
        want -= 2.0 * b * (t - 1) * cfg.d_model * cfg.vocab_size
    port_cost = analyze_step(*plain_step(spec, ShapeCell("c", t, b, kind)))[1]
    got = port_cost.flops
    # HBM bytes are not held: eager PyTorch writes every result XLA fuses away
    print(f"{arch} {kind}: flops port {got:.6e} reference {want:.6e} ratio {got / want:.5f}; "
          f"HBM bytes port/reference {port_cost.hbm_bytes / ref_cost.hbm_bytes:.3f}")
    assert abs(got / want - 1) < FLOP_RTOL


# ------------------------------------------------------- tiny-mesh dry-run

TINY_ARCHS = ["granite-8b", "kimi-k2-1t-a32b", "mamba2-370m", "zamba2-1.2b", "whisper-tiny",
              "llava-next-mistral-7b"]


def tiny_cells(spec):
    if spec.model.family == "vlm":
        return [ShapeCell("t", 24, 8, "train"), ShapeCell("p", 24, 8, "prefill"),
                ShapeCell("d", 32, 8, "decode")]
    return [ShapeCell("t", 16, 8, "train"), ShapeCell("p", 32, 8, "prefill"),
            ShapeCell("d", 32, 8, "decode")]


@pytest.mark.parametrize("arch", TINY_ARCHS)
def test_tiny_mesh_dryrun_all_step_kinds(meshes, arch):
    spec = C.smoke(arch)
    for cell in tiny_cells(spec):
        sharded = build.build_cell(spec, cell, meshes["small"]).lower().memory_analysis()
        single = analyze_step(*plain_step(spec, cell))[2]
        print(arch, cell.kind, sharded.peak_bytes, single.peak_bytes)
        assert 0 < sharded.peak_bytes <= single.peak_bytes


# --------------------------------------------------------- batch shardings


def entries(pspec):
    """A spec's entries, trailing Nones trimmed (the port's never holds them)."""
    out = [tuple(e) if isinstance(e, (tuple, list)) else e for e in pspec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("mesh_name", ["single_pod", "multi_pod", "small"])
def test_batch_pspec_tree_matches_reference(meshes, mesh_name):
    shape, axes = MESHES[mesh_name]
    ref_m, mesh = AbstractMesh(shape, axes), meshes[mesh_name]
    for arch in C.ARCHS:
        for name, cell in C.CELLS.items():
            spec, ref_spec = C.get(arch), RC.get(arch)
            specs = input_specs(spec.model, cell)
            ref_specs = RC.input_specs(ref_spec.model, RC.CELLS[name])
            batch = specs["batch"] if "batch" in specs else {"tokens": specs["tokens"]}
            ref_batch = (ref_specs["batch"] if "batch" in ref_specs
                         else {"tokens": ref_specs["tokens"]})
            got = build._batch_pspec_tree(batch, build.rules_for(spec, cell, mesh), mesh)
            want = ref_build._batch_pspec_tree(
                ref_batch, ref_build.rules_for(ref_spec, RC.CELLS[name], ref_m), ref_m)
            assert {k: entries(v) for k, v in got.items()} == \
                {k: entries(v.spec) for k, v in want.items()}, (arch, name)


# ------------------------------------------------------------ train --mesh

TRAIN_ARGV = ["--arch", "granite-8b", "--smoke", "--device", "cpu", "--steps", "1",
              "--global-batch", "8", "--seq-len", "16", "--microbatches", "2"]


def test_sharded_train_step_matches_single_device(tmp_path, monkeypatch):
    """Four gloo ranks at (2, 2) through ``train.main(["--mesh", ...])``
    against the single-device step (float32 compute, 2 microbatches, as the
    reference's test); each rank first sees the real production mesh refuse
    its world of 4."""
    from repro_torch.launch import train

    ranks = spawn(train_mesh_worker, 4, tmp_path, TRAIN_ARGV, str(tmp_path / "ck"))
    monkeypatch.setattr(C, "smoke", C.smoke)
    f32_smoke(C)
    seen = []
    make = train.make_train_step
    monkeypatch.setattr(train, "make_train_step",
                        lambda *a, **kw: recorded_steps(make(*a, **kw), seen))
    train.main(TRAIN_ARGV + ["--ckpt-dir", str(tmp_path / "single")])
    (want,) = seen
    for r in ranks:
        assert "needs 256 ranks; the process group has 4" in r["refusal"]
        (got,) = r["metrics"]
        assert abs(got["loss"] - want["loss"]) < 1e-4, (got, want)
        assert abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"] < 1e-3, (got, want)
        assert np.isfinite(got["lr"]) and got["lr"] == pytest.approx(want["lr"])
