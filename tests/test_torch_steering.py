"""Steering DTensor in a sequence-split training step and in serving: the
projections on local shards (`repro_torch.parallel.spmd.project`), the
port's all-to-all for a shard moved between tensor dimensions on a CPU mesh
(`spmd.redistribute`), and the attention over a KV cache on each rank's
slice of the cache length (`spmd.cache_shards`).

  * (a) No DTensor view in a smoke training step of granite-8b and
    mamba2-370m, their sequence split over "model" (``seq_shard``, kept by
    the smoke configs), merges two dimensions that are split over mesh
    dims: such a view (the einsum's (B, T, D) → (B·T, D)) is sharded by
    some versions of DTensor and run replicated by others, so a step
    without one traces alike on every version.
  * (b) That step's flops a device times the ranks equal one device's
    within 2 %, and no op ran replicated.
  * (c) The same cell traced on a mesh of device "cpu" and of device "cuda"
    moves the same collective bytes by kind (the logits' move from the
    vocabulary to the sequence is an all-to-all on both, no all-gather),
    and its peaks agree within 2 %.
  * (d) On two gloo ranks, the port's Shard(2) → Shard(1) move equals
    DTensor's ``redistribute`` bit for bit, in values and in the gradient;
    and, with gradients, one device's results are those of the chunked
    attention on each rank's block of queries (`spmd.query_blocks`) and of
    `spmd.sharded_call` where two ranks share one KV head or B/C group, or
    split the batch of the SSM's scan (gradients that are partial sums).
  * (e) A smoke prefill and decode step of a GQA model and of an MHA model
    whose heads do not split over "model" runs nothing replicated, merges no
    two split dimensions in a view, and attends over a quarter of the cache
    length a rank; so do the SSM's, the hybrid's and the chunked
    attention's steps.
  * (f) On the two gloo ranks, the attention over a cache split along its
    length equals one device's and the reference's `_sdpa` (decode with
    ``kv_len`` ending inside a shard, prefill with ``q_offset`` > 0; GQA and
    MHA); `project` with the contraction split over a mesh dim that splits
    neither operand equals the einsum, its gradients too; and a batch-1
    prefill and decode steps of a hybrid and a decoder over a cache split
    along its length equal one device's (the new keys and values written
    into each rank's slice, `spmd.cache_write`).
  * The helpers' layouts on a (2, 4) mesh: `project` keeps an activation's
    batch and sequence splits, and declares the weight's gradient a partial
    sum there; a contracted dimension split alike on both operands stays
    split, the output a partial sum; a batch-1 product splits its
    contraction over the free "data" dim, a training-sized one does not.

The meshes live in a fake world of 8 ranks (`torch_dist.fake_world`), the
traces on the ``meta`` device; (d) and (f) share one world of two ranks.
Only (f)'s comparison with the reference imports JAX, in the test process
(a host without JAX skips it): the single-device step is held to the
reference by `tests/test_torch_launch.py`.
"""

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs as C
from repro_torch.configs.shapes import ShapeCell, input_specs
from repro_torch.launch import build
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.hlo_analysis import analyze_step
from repro_torch.models.model import Model
from repro_torch.models.spec import abstract_tree
from repro_torch.parallel import spmd
from repro_torch.runtime.steps import make_train_step, train_state_specs
from repro_torch.testing import FLOAT_ATOL, FLOAT_RTOL
from torch_dist import fake_world, spawn, steering_worker

ARCHS = ["granite-8b", "mamba2-370m"]
CELL = ShapeCell("t", 32, 8, "train")
FLOP_RTOL = 0.02
PEAK_RTOL = 0.02


@pytest.fixture(scope="module")
def meshes():
    with fake_world(8):
        yield {d: port_mesh.make_mesh((2, 4), ("data", "model"), d, abstract=True)
               for d in ("cpu", "cuda")}


# ------------------------------------------------------------------ (a)

_VIEWS = {torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
          torch.ops.aten.reshape.default}


def merged_groups(src, dst):
    """The groups of ``src``'s dimensions (indices) that a view to ``dst``
    merges into one dimension; dimensions of size 1 left out."""
    a = [(i, n) for i, n in enumerate(src) if n != 1]
    b = [n for n in dst if n != 1]
    i = j = 0
    out = []
    while i < len(a) and j < len(b):
        group, pa, pb = [a[i][0]], a[i][1], b[j]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb:
                group.append(a[i][0])
                pa *= a[i][1]
                i += 1
            else:
                pb *= b[j]
                j += 1
        if len(group) > 1:
            out.append(group)
    return out


class MergedSplitViews(TorchDispatchMode):
    """Records every view of a DTensor that merges two or more dimensions
    each split over a mesh dim of more than one rank."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        x = args[0] if args else None
        if func in _VIEWS and isinstance(x, DTensor):
            mesh = x.device_mesh
            split = {p.dim for m, p in enumerate(x.placements)
                     if isinstance(p, Shard) and mesh.size(m) > 1}
            dst = list(args[1])
            if -1 in dst:
                dst[dst.index(-1)] = x.numel() // -int(np.prod(dst))
            for group in merged_groups(tuple(x.shape), dst):
                if len(split & set(group)) > 1:
                    self.seen.append((str(func), tuple(x.shape), tuple(dst),
                                      tuple(x.placements)))
        return func(*args, **kwargs)


def test_merged_groups():
    assert merged_groups((8, 16, 64), (128, 64)) == [[0, 1]]
    assert merged_groups((128, 64), (8, 16, 64)) == []
    assert merged_groups((4, 1, 16, 4, 16), (4, 16, 64)) == [[3, 4]]
    assert merged_groups((2, 3, 4), (6, 4)) == [[0, 1]]


def traced(spec, mesh, watch=None, cell=CELL):
    """`build_cell`'s step for ``cell`` on ``mesh``, lowered (under
    ``watch``, a dispatch mode, when given)."""
    built = build.build_cell(spec, cell, mesh)
    if watch is not None:
        step = built.step_fn

        def watched(*args):
            with watch:
                return step(*args)

        built.step_fn = watched
    return built.lower()


def single_device_flops(spec):
    model = Model(spec.model, device="meta")
    state = abstract_tree(train_state_specs(model, spec.exec, per_layer=True))
    return analyze_step(make_train_step(model, spec.exec), state,
                        input_specs(spec.model, CELL)["batch"])[1].flops


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_split_step_merges_no_split_dimensions(meshes, arch):
    """(a) and (b)."""
    spec = C.smoke(arch)
    assert spec.exec.seq_shard
    mesh = meshes["cuda"]
    rules = build.rules_for(spec, CELL, mesh)
    assert rules.get("seq") == "model"
    watch = MergedSplitViews()
    compiled = traced(spec, mesh, watch)
    assert watch.seen == [], watch.seen[:5]
    assert compiled.replicated == {}
    want = single_device_flops(spec)
    got = compiled.cost.flops * mesh.size()
    print(f"{arch}: flops a device x {mesh.size()} ranks {got:.6e}, one device {want:.6e}, "
          f"ratio {got / want:.5f}")
    assert abs(got / want - 1) < FLOP_RTOL


# ------------------------------------------------------------------ (e)

SERVE_MODELS = {  # name -> (arch, the smoke model's changes)
    "gqa": ("qwen3-8b", {"num_kv_heads": 2}),
    "mha, 6 heads over 4": ("qwen1.5-32b", {"num_heads": 6, "num_kv_heads": 6}),
}
SERVE_CELLS = {"prefill": ShapeCell("p", 32, 4, "prefill"),
               "decode": ShapeCell("d", 32, 4, "decode")}


@pytest.fixture
def attention_calls(monkeypatch):
    """The calls of `layers`' attention functions in a step: (name, the
    keys' length, whether an input was a DTensor)."""
    from repro_torch.models import layers as L

    calls = []

    def recorder(name, fn):
        def recorded(q, k, v, **kw):
            calls.append((name, k.shape[1], any(isinstance(a, DTensor) for a in (q, k, v))))
            return fn(q, k, v, **kw)
        return recorded

    for name in ("_sdpa", "_chunked_sdpa", "_sdpa_parts"):
        monkeypatch.setattr(L, name, recorder(name, getattr(L, name)))
    return calls


@pytest.mark.parametrize("kind", list(SERVE_CELLS))
@pytest.mark.parametrize("model", list(SERVE_MODELS))
def test_serving_step_attends_on_cache_shards(meshes, attention_calls, model, kind):
    """(e): the cache (4, 32, KV, 16) splits its batch over "data" and its
    length over "model"; each rank attends over 32 / 4 keys, on local
    tensors."""
    arch, changes = SERVE_MODELS[model]
    spec = C.smoke(arch).replace_model(**changes)
    cell = SERVE_CELLS[kind]
    watch = MergedSplitViews()
    compiled = traced(spec, meshes["cuda"], watch, cell)
    assert watch.seen == [], watch.seen[:5]
    assert compiled.replicated == {}
    assert attention_calls == [("_sdpa_parts", cell.seq_len // 4, False)] * spec.model.num_layers
    assert compiled.cost.collective_breakdown.get("all-reduce", 0) > 0


SERVE_ROUTES = {  # name -> (arch, the smoke model's changes)
    "ssm": ("mamba2-370m", {}),  # the decode step on local shards
    "hybrid": ("zamba2-1.2b", {}),
    "chunked attention": ("arctic-480b", {"attention_chunk": 8}),  # prefill on query blocks
}


@pytest.mark.parametrize("kind", list(SERVE_CELLS))
@pytest.mark.parametrize("route", list(SERVE_ROUTES))
def test_serving_steps_of_the_other_routes_run_on_local_shards(meshes, attention_calls, route,
                                                              kind):
    """(e) for the SSM's decode step, the hybrid's and the chunked
    attention's prefill: nothing replicated, no view merging two split
    dimensions (the SSM's decode einsums merge its batch and heads), and
    every attention on local tensors (the chunked one over DTensors ran a
    view that torch 2.11 replicates)."""
    arch, changes = SERVE_ROUTES[route]
    watch = MergedSplitViews()
    compiled = traced(C.smoke(arch).replace_model(**changes), meshes["cuda"], watch,
                      SERVE_CELLS[kind])
    assert watch.seen == [], watch.seen[:5]
    assert compiled.replicated == {}
    assert not any(dtensor for _, _, dtensor in attention_calls), attention_calls
    if route == "chunked attention" and kind == "prefill":
        assert {name for name, _, _ in attention_calls} == {"_chunked_sdpa"}


def test_cache_shards_refuses_a_gradient(meshes):
    mesh = meshes["cpu"]
    q = dt(mesh, (4, 1, 4, 16), (Shard(0), Shard(2))).requires_grad_(True)
    k = dt(mesh, (4, 32, 4, 16), (Shard(0), Shard(1)))
    with pytest.raises(RuntimeError, match="no gradient"):
        spmd.cache_shards(None, None, q, k, k, 31)


# ------------------------------------------------------------------ (c)


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_mesh_moves_what_the_card_mesh_moves(meshes, arch):
    spec = C.smoke(arch)
    cpu, cuda = (traced(spec, meshes[d]) for d in ("cpu", "cuda"))
    print(arch, "cpu", cpu.cost.collective_breakdown, cpu.memory.peak_bytes)
    print(arch, "cuda", cuda.cost.collective_breakdown, cuda.memory.peak_bytes)
    assert cpu.cost.collective_breakdown == cuda.cost.collective_breakdown
    assert cpu.cost.collective_breakdown.get("all-to-all", 0) > 0
    assert abs(cpu.memory.peak_bytes / cuda.memory.peak_bytes - 1) < PEAK_RTOL
    assert cpu.cost.flops == cuda.cost.flops


def test_logits_move_is_one_all_to_all_on_a_cpu_mesh(meshes):
    """The unembedding's vocab-sharded logits, constrained to ("batch",
    "seq", "vocab"): on a CPU mesh the move counts as an all-to-all of one
    local block, where DTensor's own route gathered the whole vocabulary."""
    from repro_torch.parallel.constraints import activation_sharding, shard_activation

    spec = C.smoke("granite-8b")
    mesh = meshes["cpu"]
    rules = build.rules_for(spec, CELL, mesh)
    b, t, v = 8, 16, spec.model.vocab_size
    local = torch.empty(b // 2, t, v // 4, device="meta")
    logits = DTensor.from_local(local, mesh, (Shard(0), Shard(2)), run_check=False,
                                shape=torch.Size((b, t, v)), stride=(t * v, v, 1))

    def step(x):
        with activation_sharding(rules, mesh), spmd.spmd_region():
            return shard_activation(x, ("batch", "seq", "vocab"))

    out, cost, _, _ = analyze_step(step, logits)
    assert tuple(out.placements) == (Shard(0), Shard(1))
    assert tuple(out.to_local().shape) == (b // 2, t // 4, v)
    assert cost.collective_breakdown == {"all-to-all": float(local.numel() * 4)}


# ------------------------------------------------------------------ (d)


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """One world of two gloo ranks for (d) and the chunked attention."""
    rng = np.random.default_rng(0)
    move = [rng.standard_normal((2, 6, 8)).astype(np.float32) for _ in range(2)]
    qkv = [rng.standard_normal(s).astype(np.float32)
           for s in ((2, 16, 4, 8), (2, 16, 2, 8), (2, 16, 2, 8), (2, 16, 4, 8))]
    ranks = spawn(steering_worker, 2, tmp_path_factory.mktemp("gloo"), *move, qkv, 4,
                  {name: (axis, args) for name, (axis, args, _) in KERNEL_CASES.items()},
                  CACHE_CASES, PRODUCT, SERVING)
    return move, qkv, ranks


def _kernel_cases():
    """name → (mesh axis, the worker's arguments, the plain function)."""
    import functools

    from repro_torch.models.layers import _sdpa
    from repro_torch.models.ssm import ssd_chunked

    rng = np.random.default_rng(1)

    def arr(*shape, positive=False, negative=False):
        a = rng.standard_normal(shape).astype(np.float32)
        return np.abs(a) + 0.1 if positive else -np.abs(a) - 0.1 if negative else a

    def ssd(b, split):
        ins = [(arr(b, 8, 2, 4), split), (arr(b, 8, 2, positive=True), split),
               (arr(2, negative=True), None), (arr(b, 8, 1, 4), split), (arr(b, 8, 1, 4), split)]
        return ins + [[arr(b, 8, 2, 4), arr(b, 2, 4, 4)]]

    attention = [(arr(1, 8, 2, 4), 1), (arr(1, 8, 1, 4), 1), (arr(1, 8, 1, 4), 1),
                 [arr(1, 8, 2, 4)]]
    scan = functools.partial(ssd_chunked, chunk_size=4, use_kernel=False)
    return {"attention:one KV head for two ranks": (
                "model", attention, functools.partial(_sdpa, causal=True)),
            "ssd_chunked:one group for two ranks": ("model", ssd(1, 1), scan),
            "ssd_chunked:batch split": ("data", ssd(2, 0), scan)}


KERNEL_CASES = _kernel_cases()


def _cache_cases():
    """name → (q, k, v, q_offset, queries' heads split): a cache of 16
    slots, 8 a rank; ``kv_len`` = q_offset + T."""
    rng = np.random.default_rng(2)

    def case(t, h, kv, q_offset, heads_split):
        q, k, v = (rng.standard_normal(s).astype(np.float32)
                   for s in ((2, t, h, 8), (2, 16, kv, 8), (2, 16, kv, 8)))
        return q, k, v, q_offset, heads_split

    return {"decode, gqa, kv_len 5": case(1, 4, 2, 4, True),  # rank 1 holds no valid key
            "decode, mha, kv_len 11": case(1, 3, 3, 10, False),
            "prefill, gqa, 5 from 6": case(5, 4, 2, 6, True),  # the mask crosses the shards
            "prefill, mha, 5 from 6": case(5, 3, 3, 6, False)}


CACHE_CASES = _cache_cases()
PRODUCT = tuple(np.random.default_rng(3).standard_normal(s).astype(np.float32)
                for s in ((1, 1, 8), (8, 6), (1, 1, 6)))


def _serving():
    """name → (mesh shape, (arch, smoke changes, cache, steps)): a batch-1
    float32 smoke model on two ranks, its cache of 16 slots drawn at random
    and split along its length (over "data" for the hybrid, "model" for the
    decoder), a prefill then decode steps at 6 and 11 (``kv_len`` 7 and 12,
    inside the first and the second slice).  The hybrid's prefill of 6
    writes across the split; the decoder's of 16, its keys split as the
    cache is, writes each rank's slice whole."""
    from repro_torch.models.model import Model

    rng = np.random.default_rng(4)
    out = {}
    for name, shape, arch, changes, prompt in (
            ("hybrid, (2, 1)", (2, 1), "zamba2-1.2b", {}, 6),
            ("gqa decoder, (1, 2)", (1, 2), "qwen3-8b", {"num_kv_heads": 2}, 16)):
        cfg = C.smoke(arch).replace_model(compute_dtype="float32", **changes).model
        cache = {k: rng.standard_normal(s.shape).astype(np.float32)
                 for k, s in Model(cfg, device="meta").cache_specs(1, 16).items()}
        steps = [(rng.integers(0, cfg.vocab_size, (1, t)), i) for t, i in ((prompt, 0), (1, 6),
                                                                           (1, 11))]
        out[name] = (shape, (arch, changes, cache, steps))
    return out


SERVING = _serving()


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_kernels_on_local_shards_match_one_device(gloo_ranks, name):
    """`spmd.sharded_call` on two gloo ranks, with gradients: attention whose
    two ranks share one KV head, the SSM's chunked scan whose ranks share
    one B/C group, and the scan split over the batch (A's gradient then a
    sum over both ranks' tokens)."""
    _, args, fn = KERNEL_CASES[name]
    *inputs, cots = args
    ins = [torch.from_numpy(a).requires_grad_(True) for a, _ in inputs]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
    for got in (r["kernels"][name] for r in gloo_ranks[2]):
        for a, b in zip(got["outs"], outs):
            np.testing.assert_allclose(a, b.detach().numpy(), rtol=1e-5, atol=1e-6)
        for i, (a, b) in enumerate(zip(got["grads"], ins)):
            np.testing.assert_allclose(a, b.grad.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=f"input {i}")


def test_port_all_to_all_equals_dtensor_redistribute(gloo_ranks):
    (x, c), _, ranks = gloo_ranks
    for r, got in enumerate(ranks):
        assert got["move"] == (0, 2, 1)
        port, ref = got["port"], got["dtensor"]
        assert port["placements"] == ref["placements"] == (Shard(1),)
        assert port["grad_placements"] == ref["grad_placements"] == (Shard(2),)
        np.testing.assert_array_equal(port["y"], ref["y"])
        np.testing.assert_array_equal(port["grad"], ref["grad"])
        np.testing.assert_array_equal(port["y"], x[:, 3 * r:3 * r + 3])
        np.testing.assert_array_equal(port["grad"], c[:, :, 4 * r:4 * r + 4])


def test_chunked_attention_on_query_blocks_matches_one_device(gloo_ranks):
    """The chunked attention of a sequence split over two ranks, each on its
    block of queries with the keys whole: the output and the gradients of
    q, k and v equal one device's (float32 rounding: the keys' gradients
    are summed across ranks)."""
    from repro_torch.models.layers import _chunked_sdpa

    _, (q, k, v, g), ranks = gloo_ranks
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = _chunked_sdpa(q, k, v, causal=True, chunk=4)
    (out * torch.from_numpy(g)).sum().backward()
    for got in ranks:
        blocks = got["blocks"]
        assert blocks["placements"] == (Shard(1),)
        np.testing.assert_allclose(blocks["out"], out.detach().numpy(), rtol=1e-6, atol=1e-6)
        for n, a in zip("qkv", (q, k, v)):
            np.testing.assert_allclose(blocks[f"g{n}"], a.grad.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(CACHE_CASES))
def test_attention_over_cache_shards_matches_one_device(gloo_ranks, name):
    """(f): each rank attends over its 8 slots and the softmax is combined
    across both; the output, back in the queries' layout, equals the port's
    `_sdpa` on one device."""
    from repro_torch.models.layers import _sdpa

    q, k, v, q_offset, heads_split = CACHE_CASES[name]
    one = _sdpa(*(torch.from_numpy(a) for a in (q, k, v)), causal=True, q_offset=q_offset,
                kv_len=q_offset + q.shape[1]).numpy()
    for got in (r["cache"][name] for r in gloo_ranks[2]):
        assert got["placements"] == ((Shard(2),) if heads_split else (Replicate(),))
        assert got["lengths"] == [8]
        np.testing.assert_allclose(got["out"], one, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)


@pytest.mark.parametrize("name", list(CACHE_CASES))
def test_attention_over_cache_shards_matches_the_reference(gloo_ranks, name):
    """(f): the same numpy inputs through the reference's `_sdpa` (JAX, in
    this process; a host without JAX, the card's, skips it)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.models import layers as RL

    q, k, v, q_offset, _ = CACHE_CASES[name]
    ref = np.asarray(RL._sdpa(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                              q_offset=q_offset, kv_len=q_offset + q.shape[1]))
    for got in (r["cache"][name] for r in gloo_ranks[2]):
        np.testing.assert_allclose(got["out"], ref, rtol=FLOAT_RTOL, atol=FLOAT_ATOL)


def test_project_splits_a_free_contraction_like_the_einsum(gloo_ranks):
    """(f): (1, 1, 8) by (8, 6), both whole on two ranks: the contraction
    splits over them, and the partial sums are summed at once into a whole
    output; values and gradients equal the einsum's."""
    x, w, c = (torch.from_numpy(a).requires_grad_(True) for a in PRODUCT)
    out = torch.einsum("btd,df->btf", x, w)
    (out * c).sum().backward()
    for got in (r["project"] for r in gloo_ranks[2]):
        assert got["placements"] == (Replicate(),)
        assert got["local_x"] == (1, 1, 4)
        np.testing.assert_allclose(got["out"], out.detach().numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["gx"], x.grad.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["gw"], w.grad.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(SERVING))
def test_sharded_serving_matches_one_device(gloo_ranks, name):
    """(f): `build_cell`'s prefill and decode steps on two ranks, the cache
    written and read on each rank's slice of its length and the batch-1
    products split over the free mesh dim, give one device's logits."""
    from repro_torch.models.model import Model

    _, (arch, changes, cache, steps) = SERVING[name]
    model = Model(C.smoke(arch).replace_model(compute_dtype="float32", **changes).model,
                  device="cpu", seed=0)
    held = {k: torch.from_numpy(a.copy()) for k, a in cache.items()}
    want = []
    for tokens, index in steps:
        tokens = torch.from_numpy(tokens)
        logits, held = (model.prefill({"tokens": tokens}, held) if tokens.shape[1] > 1
                        else model.decode_step(held, tokens, index))
        want.append(logits.numpy())
    for got in (r["serving"][name] for r in gloo_ranks[2]):
        for step, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_allclose(a, b, rtol=FLOAT_RTOL, atol=FLOAT_ATOL,
                                       err_msg=f"step {step}")


# ----------------------------------------------------------- the layouts


def dt(mesh, shape, placements):
    local = torch.empty(spmd.local_shape(shape, placements, mesh), device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=spmd._contiguous_stride(shape))


def test_project_keeps_the_activation_splits(meshes):
    """A (B, T, D) activation split over batch and sequence by a (D, H, K)
    weight split over heads: the weight is gathered whole, the product runs
    on the (B/2, T/4) block, its gradient is a partial sum over both mesh
    dims."""
    mesh = meshes["cpu"]
    x = dt(mesh, (8, 16, 64), (Shard(0), Shard(1)))
    w = dt(mesh, (64, 4, 16), (Replicate(), Shard(1)))
    plan = spmd._project_plan("btd,dhk->bthk", x, w)
    assert plan == ((Shard(0), Shard(1)), (Replicate(), Replicate()), (Shard(0), Shard(1)),
                    (Shard(0), Shard(1)), (Partial(), Partial()))
    out, cost, _, _ = analyze_step(lambda a, b: spmd.project("btd,dhk->bthk", a, b), x, w)
    assert tuple(out.to_local().shape) == (4, 4, 4, 16) and out.shape == (8, 16, 4, 16)
    assert cost.flops == 2 * 8 * 16 * 64 * 4 * 16 / 8
    assert cost.collective_breakdown == {"all-gather": float(64 * 4 * 16 * 4)}


def test_project_contracts_alike_split_dimensions_locally(meshes):
    """Heads split over "model" on both operands of the output projection:
    no gather, the output a partial sum over "model"."""
    mesh = meshes["cpu"]
    x = dt(mesh, (8, 16, 4, 16), (Shard(0), Shard(2)))
    w = dt(mesh, (4, 16, 64), (Replicate(), Shard(0)))
    plan = spmd._project_plan("bthk,hkd->btd", x, w)
    assert plan == ((Shard(0), Shard(2)), (Replicate(), Shard(0)), (Shard(0), Partial()),
                    (Shard(0), Shard(2)), (Partial(), Shard(0)))
    out, cost, _, _ = analyze_step(lambda a, b: spmd.project("bthk,hkd->btd", a, b), x, w)
    assert tuple(out.placements) == (Shard(0), Partial())
    assert cost.collective_bytes == 0


PLANS = {  # name -> (eq, x (shape, placements), w (shape, placements), the plan)
    # a batch-1 decode: "data" splits neither operand, so the contraction
    # splits over it, the output a partial sum there
    "batch 1": ("btd,df->btf", ((1, 1, 64), (Replicate(), Replicate())),
                ((64, 32), (Replicate(), Shard(1))),
                ((Shard(2), Replicate()), (Shard(0), Shard(1)), (Partial(), Shard(2)),
                 (Shard(2), Partial()), (Shard(0), Shard(1)))),
    # a training shape with a free "model" dim (6 heads over 4): the output
    # outweighs the weight, so the plan is the plain one
    "training": ("btd,dhk->bthk", ((8, 32, 64), (Shard(0), Replicate())),
                 ((64, 6, 16), (Replicate(), Replicate())),
                 ((Shard(0), Replicate()), (Replicate(), Replicate()),
                  (Shard(0), Replicate()), (Shard(0), Replicate()), (Partial(), Replicate()))),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_project_plan_splits_a_free_mesh_dim_only_for_a_small_output(meshes, name):
    """(d)"""
    eq, (xs, xp), (ws, wp), want = PLANS[name]
    mesh = meshes["cpu"]
    assert spmd._project_plan(eq, dt(mesh, xs, xp), dt(mesh, ws, wp)) == want


def test_project_on_plain_tensors_is_the_einsum():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 5)).astype(np.float32))
    assert torch.equal(spmd.project("btd,dv->btv", x, w), torch.einsum("btd,dv->btv", x, w))
