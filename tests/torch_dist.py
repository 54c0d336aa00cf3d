"""Multi-process helpers of the port's parallel tests (a helper module, not
a test file): `spawn` runs a function on every rank of a gloo world in
fresh processes, and `fake_world` builds one process's fake world, in
which a mesh of 256 or 512 ranks exists without its peers.

`spawn` meets through a `FileStore` under the test's ``tmp_path`` (no TCP
port, so tests in parallel workers cannot collide), gives the group and
the join a timeout, and fails on a rank that fails or hangs.  The workers
import torch and the port, never JAX: the test compares their results
with the JAX reference in its own process.  `fake_world` leans on
`torch.testing._internal.distributed.fake_pg`, which is not a public API.
"""

import contextlib
import datetime
import multiprocessing
import os
import pickle
import sys
import threading
import traceback

import torch
import torch.distributed as dist

JOIN_TIMEOUT_S = 240.0
GROUP_TIMEOUT_S = 120.0


def _entry(fn, rank, world, store_path, out_dir, args):
    try:
        sys.path[:0] = [os.path.dirname(__file__)]
        torch.set_num_threads(1)
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        traceback.print_exc()
        sys.exit(1)


def spawn(fn, world, tmp_path, *args):
    """``fn(rank, world, *args)`` on each rank of a gloo world of ``world``
    processes; returns the ranks' results in rank order.  ``fn`` must be a
    module-level function of a module that does not import JAX."""
    ctx = multiprocessing.get_context("spawn")
    out_dir = str(tmp_path)
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, store, out_dir, args))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        failed = [r for r, p in enumerate(procs) if p.exitcode not in (0, None)]
        assert not hung, f"ranks {hung} still running after {JOIN_TIMEOUT_S} s"
        assert not failed, f"ranks {failed} failed (exit codes {[p.exitcode for p in procs]})"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def clear_dtensor_caches():
    """Drop DTensor's sharding-propagation caches: they key on meshes by
    shape and names, so a mesh of an earlier world would answer for an
    equal mesh of a new one, with its dead process groups
    (`torch.distributed.tensor.debug`, not a public API)."""
    from torch.distributed.tensor import debug

    clear = getattr(debug, "_clear_sharding_prop_cache", None)
    if clear is not None:
        clear()


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a fake world of ``size`` ranks (no peers;
    collectives return without moving data), DTensor's caches cleared on
    the way in and out."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    clear_dtensor_caches()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        clear_dtensor_caches()


def numpy_tree(tree):
    """A tree of tensors as float32 numpy arrays (results cross processes so)."""
    from repro_torch.models.spec import tree_map

    return tree_map(lambda t: None if t is None else t.detach().float().numpy(), tree)


# ----------------------------------------------------------------- workers


def ep_worker(rank, world, jobs, mesh_shape):
    """The expert-parallel MoE on this rank, under ``rules_for`` on a mesh
    of ``mesh_shape`` over ("data", "model").  Each job is

      * ``("model", arch, cfg, params, batch)``: the forward's logits and
        aux, and every parameter's gradient of ce + z_loss, its backward run
        in another thread, outside the context (autograd's device thread on
        the card runs a checkpoint's recompute so);
      * ``("layer", arch, cfg, p, x, c)``: `moe_apply` on ``x``: its
        output and aux, and the gradients of sum(y · c) + aux in ``x`` and
        every leaf of ``p``;

    with the number of `moe_apply_shard_map` calls each made."""
    from repro_torch import configs as C
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch.build import rules_for
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_map
    from repro_torch.parallel import expert_parallel
    from repro_torch.parallel.constraints import activation_sharding

    calls = []
    shard_map = expert_parallel.moe_apply_shard_map

    def counted(*a, **kw):
        calls.append(1)
        return shard_map(*a, **kw)

    expert_parallel.moe_apply_shard_map = counted
    mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
    results = []
    for kind, arch, cfg, *args in jobs:
        calls.clear()
        out = {"coords": (mesh.get_local_rank("data"), mesh.get_local_rank("model"))}
        if kind == "model":
            params, batch = args
            b, t = batch["tokens"].shape
            rules = rules_for(C.smoke(arch), ShapeCell("t", t, b, "train"), mesh)
            model = Model(cfg, params=tree_map(torch.from_numpy, params), device="cpu")
            tree = model.params_tree()
            for p in model.parameters():
                p.requires_grad_(True)
            with activation_sharding(rules, mesh):
                with torch.no_grad():
                    logits, aux = model.forward(batch)
                _, m = model.loss_fn(batch)
            errors = []

            def backward():
                try:
                    (m["ce"] + m["z_loss"]).backward()
                except BaseException as e:  # re-raised in this thread
                    errors.append(e)

            thread = threading.Thread(target=backward)
            thread.start()
            thread.join()
            if errors:
                raise errors[0]
            out.update(logits=logits.numpy(), aux=float(aux),
                       grads=numpy_tree(tree_map(lambda p: p.grad, tree)))
        else:
            p, x, c = args
            b, t, _ = x.shape
            rules = rules_for(C.smoke(arch), ShapeCell("t", t, b, "train"), mesh)
            p = tree_map(lambda a: torch.from_numpy(a).requires_grad_(True), p)
            x = torch.from_numpy(x).requires_grad_(True)
            with activation_sharding(rules, mesh):
                y, aux = L.moe_apply(p, cfg, x)
                ((y.float() * torch.from_numpy(c)).sum() + aux).backward()
            out.update(y=y.detach().numpy(), aux=float(aux.detach()), gx=x.grad.numpy(),
                       gp=numpy_tree(tree_map(lambda a: a.grad, p)))
        out["shard_map_calls"] = len(calls)
        results.append(out)
    return results


def pipeline_worker(rank, world, w, xs, mesh_shape, axes):
    """`pipeline_apply` over ``tanh(h @ w_i)`` stages on this rank: the
    outputs and the gradients of sum(out²) in ``w`` and ``xs``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipeline_apply

    mesh = make_mesh(mesh_shape, axes, "cpu")

    def stage_fn(w_local, h):
        for wi in w_local:
            h = torch.tanh(h @ wi)
        return h

    w = torch.from_numpy(w).requires_grad_(True)
    xs = torch.from_numpy(xs).requires_grad_(True)
    out = pipeline_apply(stage_fn, w, xs, mesh=mesh)
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(), "gw": w.grad.numpy(), "gx": xs.grad.numpy(),
            "stage": mesh.get_local_rank("pod")}


def f32_smoke(C):
    """Patch ``C.smoke`` (the port's registry) to compute in float32, as
    the reference's sharded-step test configures its smoke model."""
    smoke = C.smoke
    C.smoke = lambda arch: smoke(arch).replace_model(compute_dtype="float32")


def recorded_steps(step_fn, seen):
    """``step_fn`` that appends each step's metrics (as floats) to ``seen``."""

    def step(state, batch):
        state, metrics = step_fn(state, batch)
        seen.append({k: float(v) for k, v in metrics.items()})
        return state, metrics

    return step


def train_mesh_worker(rank, world, argv, ckpt_root):
    """``train.main(argv + ["--mesh", "single_pod"])`` on this rank, the
    production mesh patched to (2, 2) over ("data", "model") (after checking
    that the real one refuses a world of 4), and each step's metrics."""
    from repro_torch import configs as C
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train

    f32_smoke(C)
    try:
        M.make_production_mesh(device="cpu")
    except RuntimeError as e:
        refusal = str(e)
    else:
        raise AssertionError("a world of 4 built the 256-rank mesh")
    train.make_production_mesh = lambda multi_pod=False, device=None: M.make_mesh(
        (2, 2), ("data", "model"), device)
    seen = []
    build_cell = train.build_cell

    def recorded(*a, **kw):
        built = build_cell(*a, **kw)
        built.step_fn = recorded_steps(built.step_fn, seen)
        return built

    train.build_cell = recorded
    train.main(list(argv) + ["--mesh", "single_pod", "--ckpt-dir", f"{ckpt_root}/rank{rank}"])
    return {"metrics": seen, "refusal": refusal}


def steering_worker(rank, world, x, c, qkv, chunk, kernel_cases, cache_cases, product,
                    serving):
    """`parallel.spmd`'s routes on a mesh of ``world`` CPU ranks ("model"):

      * ``"move"``: a (B, T, V) tensor sharded over its last dimension, moved
        to its second dimension by the port's all-to-all
        (`spmd.redistribute`) and by DTensor's ``redistribute``: each
        route's local result and the local gradient of sum(y · c) in x;
      * ``"blocks"``: the chunked attention of ``qkv`` (causal, ``chunk``
        keys a step) on each rank's block of queries (`spmd.query_blocks`),
        the sequence split over "model": the whole output and the whole
        gradients of sum(out · c) in q, k and v;
      * ``"kernels"``: `sharded_kernel` for each of ``kernel_cases``, name →
        (the mesh's one axis, its arguments);
      * ``"cache"``: `cached_attention` for each of ``cache_cases``, name →
        its arguments;
      * ``"project"``: `free_dim_project` of ``product`` (x, w, c) on a mesh
        of one axis, "data";
      * ``"serving"``: `sharded_serving` for each of ``serving``, name →
        (mesh shape over ("data", "model"), its other arguments)."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import _chunked_sdpa
    from repro_torch.parallel import spmd

    mesh = make_mesh((world,), ("model",), "cpu")
    out = {"move": spmd._shard_move(distribute_tensor(torch.from_numpy(x), mesh, [Shard(2)]),
                                    (Shard(1),))}
    for name, move in (("port", lambda d: spmd.redistribute(d, [Shard(1)])),
                       ("dtensor", lambda d: d.redistribute(mesh, [Shard(1)]))):
        d = distribute_tensor(torch.from_numpy(x), mesh, [Shard(2)]).requires_grad_(True)
        y = move(d)
        local_c = torch.from_numpy(c).chunk(world, dim=1)[rank]
        (y.to_local() * local_c).sum().backward()
        out[name] = {"y": y.to_local().detach().numpy(), "placements": tuple(y.placements),
                     "grad": d.grad.to_local().numpy(),
                     "grad_placements": tuple(d.grad.placements)}
    q, k, v, g = (distribute_tensor(torch.from_numpy(a), mesh, [Shard(1)]).requires_grad_(True)
                  for a in qkv)

    def chunked(q_, k_, v_, q_offset=None):
        return _chunked_sdpa(q_, k_, v_, causal=True, chunk=chunk, q_offset=q_offset)

    o = spmd.query_blocks(chunked, q, k, v)
    (o.to_local() * g.to_local().detach()).sum().backward()
    out["blocks"] = {"out": o.full_tensor().detach().numpy(),
                     "placements": tuple(o.placements),
                     **{f"g{n}": a.grad.full_tensor().numpy() for n, a in zip("qkv", (q, k, v))}}
    out["kernels"] = {name: sharded_kernel(name, make_mesh((world,), (axis,), "cpu"), args)
                      for name, (axis, args) in kernel_cases.items()}
    out["cache"] = {name: cached_attention(mesh, *args) for name, args in cache_cases.items()}
    out["project"] = free_dim_project(make_mesh((world,), ("data",), "cpu"), *product)
    out["serving"] = {name: sharded_serving(make_mesh(shape, ("data", "model"), "cpu"), *args)
                      for name, (shape, args) in serving.items()}
    return out


def cached_attention(mesh, q, k, v, q_offset, heads_split):
    """`spmd.cache_shards` over `layers._sdpa` (causal, ``kv_len`` = q_offset
    + T) with the cache (B, S, KV, D) split along its length over ``mesh``'s
    one dim, the queries (B, T, H, D) split over their heads where
    ``heads_split``, else whole.  Returns the whole output, its placements,
    and the local cache length each rank attended over."""
    import functools

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import layers as L
    from repro_torch.parallel import spmd

    kv_len = q_offset + q.shape[1]
    lengths = []

    def parts(q_, k_, v_, **kw):
        lengths.append(k_.shape[1])
        return L._sdpa_parts(q_, k_, v_, causal=True, kv_len=kv_len, **kw)

    qd = distribute_tensor(torch.from_numpy(q), mesh, [Shard(2) if heads_split else Replicate()])
    kd, vd = (distribute_tensor(torch.from_numpy(a), mesh, [Shard(1)]) for a in (k, v))
    o = spmd.cache_shards(functools.partial(L._sdpa, causal=True, kv_len=kv_len), parts,
                          qd, kd, vd, q_offset)
    return {"out": o.full_tensor().numpy(), "placements": tuple(o.placements),
            "lengths": lengths}


def free_dim_project(mesh, x, w, c):
    """`spmd.project` of ``x`` (B, T, D) by ``w`` (D, F), both whole on
    ``mesh`` (a batch-1 decode's product): the output's placements, the
    shape of x in the local product, the whole output and the whole
    gradients of Σ out · c in x and w."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.parallel import spmd

    xd, wd = (distribute_tensor(torch.from_numpy(a), mesh, [Replicate()]).requires_grad_(True)
              for a in (x, w))
    einsum, local = torch.einsum, []

    def recorded(eq, a, b):
        local.append(tuple(a.shape))
        return einsum(eq, a, b)

    torch.einsum = recorded
    try:
        out = spmd.project("btd,df->btf", xd, wd)
    finally:
        torch.einsum = einsum
    (out * distribute_tensor(torch.from_numpy(c), mesh, [Replicate()])).sum().full_tensor() \
        .backward()
    return {"placements": tuple(out.placements), "local_x": local[0],
            "out": out.full_tensor().detach().numpy(),
            "gx": xd.grad.full_tensor().numpy(), "gw": wd.grad.full_tensor().numpy()}


def sharded_kernel(name, mesh, args):
    """`spmd.sharded_call` of a kernel's plain stand-in (``name`` before a
    colon: "attention", `layers._sdpa`, or "ssd_chunked",
    `ssm.ssd_chunked`) on ``mesh``.  ``args``: (array, the tensor dimension
    it is split on over the mesh, or None) for each input, then the list of
    cotangents c, one per output.  Returns the outputs and the gradients of
    Σ out · c in every input, whole."""
    import functools

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models.layers import _sdpa
    from repro_torch.models.ssm import ssd_chunked
    from repro_torch.parallel import spmd

    kind, fn = {"attention": ("attention", functools.partial(_sdpa, causal=True)),
                "ssd_chunked": ("ssd_chunked", functools.partial(
                    ssd_chunked, chunk_size=4, use_kernel=False))}[name.split(":")[0]]
    *inputs, cots = args
    ins = [distribute_tensor(torch.from_numpy(a), mesh, [Replicate() if d is None else Shard(d)])
           .requires_grad_(True) for a, d in inputs]
    outs = spmd.sharded_call(kind, fn, *ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * distribute_tensor(torch.from_numpy(c), mesh, o.placements)).sum()
               for o, c in zip(outs, cots))
    loss.full_tensor().backward()
    return {"outs": [o.full_tensor().detach().numpy() for o in outs],
            "grads": [a.grad.full_tensor().numpy() for a in ins]}



def sharded_serving(mesh, arch, changes, cache, steps):
    """`build_cell`'s serving steps of ``arch``'s float32 smoke model
    (``changes`` applied, parameters from seed 0) at batch 1 on ``mesh``,
    run in turn on the real ``cache`` (numpy, one array a name; written in
    place): for each (tokens (1, T), index) of ``steps`` a prefill of the
    T tokens from position 0 where T > 1, else a decode step at ``index``.
    Returns each step's whole logits."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import configs as C
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch.build import build_cell
    from repro_torch.models.model import Model
    from repro_torch.parallel.spmd import distribute_tree

    spec = C.smoke(arch).replace_model(compute_dtype="float32", **changes)
    model = Model(spec.model, device="cpu", seed=0)
    cache_len = next(iter(cache.values())).shape[2]
    built = {kind: build_cell(spec, ShapeCell(kind, cache_len, 1, kind), mesh)
             for kind in ("prefill", "decode")}
    params_sh, cache_sh, tokens_sh, _ = built["decode"].in_shardings
    params = distribute_tree(model.params_tree(), params_sh, mesh)
    held = distribute_tree({k: torch.from_numpy(a) for k, a in cache.items()}, cache_sh, mesh)
    out = []
    for tokens, index in steps:
        t = distribute_tensor(torch.from_numpy(tokens), mesh, tuple(tokens_sh))
        if tokens.shape[1] > 1:
            logits, held = built["prefill"].step_fn(params, {"tokens": t}, held)
        else:
            logits, held = built["decode"].step_fn(params, held, t, index)
        out.append(logits.full_tensor().numpy())
    return out
