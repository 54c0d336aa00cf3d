"""The port's hand-written CUDA kernels against their plain versions, on the card.

These tests need a CUDA card (and `nvcc` to build the kernels at first
use); without one they skip with the reason.  They import neither JAX nor
the JAX package, so they run on a machine that has only PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py

`chip_smoke.py` makes the same comparison at the main path's shapes and
times both.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import fast_bo
from repro_torch.core.gp import pairwise_sqdist
from repro_torch.kernels.ei_argmax import kernel
from repro_torch.kernels.ei_argmax.ops import ei_argmax, ei_argmax_plain
from repro_torch.kernels.ei_argmax.tile import ei_from_sqdist
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.kernels.ssd.ops import ssd_diag_chunk, ssd_diag_plain
from repro_torch.kernels.rmsnorm import kernel as rn_kernel
from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_plain
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.testing import EI_ATOL, EI_RTOL, assert_close, pick_agrees

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel is built by nvcc and runs only there")
    return torch.device("cuda")


def case(dev, seed, n, d, k, cap):
    """Tail inputs for a packed state, from the port's own head, on ``dev``."""
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sum(enc**2, -1) + 0.3 * rng.normal(size=n)).astype(np.float32)
    picks = rng.choice(n, size=k, replace=False)
    tried = np.full(cap, -1, np.int32)
    tried[:k] = picks
    py = np.zeros(cap, np.float32)
    py[:k] = y[picks]
    mask = np.ones(n, bool)
    mask[picks] = False
    enc_t = torch.from_numpy(enc).to(dev)[None]
    feats = enc_t[:, np.maximum(tried, 0)]
    d2_bb = pairwise_sqdist(feats, feats)
    pm, best, ls, chol, alpha, y_mean, y_std = fast_bo._packed_head(
        d2_bb, torch.from_numpy(py).to(dev)[None], torch.tensor([k], dtype=torch.int32, device=dev))
    return (enc_t, torch.from_numpy(mask).to(dev)[None], feats, pm, alpha, chol,
            ls, y_mean, y_std, best)


EI_CASES = [  # (seed, n, d, k, cap): the main paths' and edge shapes, each register
    (0, 69, 4, 40, 69), (1, 1500, 6, 24, 24), (2, 200, 1, 5, 12), (3, 2000, 4, 100, 128),
    (4, 130, 6, 2, 2), (11, 500, 4, 12, 16), (12, 800, 5, 30, 32), (13, 1200, 6, 50, 64),
    # bucket at its edge, then past the register route: B = 129, 256, 1000; d = 33, 64
    (6, 3000, 5, 100, 129), (7, 4000, 6, 160, 256), (8, 5000, 6, 250, 1000),
    (9, 2000, 33, 20, 24), (10, 3000, 64, 30, 40),
]


@pytest.mark.parametrize("seed,n,d,k,cap", EI_CASES)
def test_kernel_matches_plain_version(dev, seed, n, d, k, cap):
    args = case(dev, seed, n, d, k, cap)
    before = kernel.ei_argmax_cuda.launches
    k_idx, k_val = ei_argmax(*args)
    p_idx, p_val = ei_argmax_plain(*args)
    torch.cuda.synchronize()
    assert kernel.ei_argmax_cuda.launches == before + 1
    full = ei_from_sqdist(pairwise_sqdist(args[2], args[0]), *args[3:], args[1])
    assert pick_agrees(int(p_idx[0]), int(k_idx[0]), full[0].cpu().numpy())
    assert_close(float(p_val[0]), float(k_val[0]), rtol=EI_RTOL, atol=EI_ATOL)


@pytest.mark.parametrize("seed,n,d,k,cap", [EI_CASES[1], EI_CASES[5], EI_CASES[7]])
def test_kernel_routes_match_plain_version(dev, seed, n, d, k, cap):
    """The register and blocked routes, each forced, at shapes both take:
    one launch a call, each held to the plain version."""
    args = case(dev, seed, n, d, k, cap)
    scal = torch.stack([args[6], args[7], args[8], args[9]], -1)
    p_idx, p_val = ei_argmax_plain(*args)
    full = ei_from_sqdist(pairwise_sqdist(args[2], args[0]), *args[3:], args[1])[0].cpu().numpy()
    for route in (kernel._REGISTERS, kernel._BLOCKED):
        before = kernel.ei_argmax_cuda.launches
        k_idx, k_val = kernel._launch(*args[:6], scal, 0.0, route)
        torch.cuda.synchronize()
        assert kernel.ei_argmax_cuda.launches == before + 1
        assert pick_agrees(int(p_idx[0]), int(k_idx[0]), full), route
        assert_close(float(p_val[0]), float(k_val[0]), rtol=EI_RTOL, atol=EI_ATOL,
                     what=f"route {route}")


def test_kernel_rejects_what_it_cannot_take(dev):
    args = list(case(dev, 5, 300, 3, 5, 8))
    scal = torch.stack([args[6], args[7], args[8], args[9]], -1)
    with pytest.raises(TypeError):
        kernel.ei_argmax_cuda(args[0].double(), *args[1:6], scal)
    with pytest.raises(ValueError):
        kernel.ei_argmax_cuda(args[0].transpose(1, 2).contiguous().transpose(1, 2),
                              *args[1:6], scal)
    with pytest.raises(ValueError):  # CPU tensors never reach the kernel
        kernel.ei_argmax_cuda(*(a.cpu() for a in args[:6]), scal.cpu())
    big = list(case(dev, 6, 400, 3, 100, 129))
    big_scal = torch.stack([big[6], big[7], big[8], big[9]], -1)
    with pytest.raises(ValueError, match="register route"):
        kernel._launch(*big[:6], big_scal, 0.0, kernel._REGISTERS)


def test_fused_search_past_128_configurations_on_the_card(dev):
    """CherryPick over 200 configurations with no trial budget (B = 200) in
    the fused layout on the card, seeds 0 and 1: every BO step launches the
    kernel once, and each trace is held step by step to the CPU's (the plain
    version) under the tie-aware comparator, each pick equal or a certified
    tie under the CPU's EI at that step; at least one matches in full."""
    from repro_torch.core import bayesopt
    from repro_torch.core.search_space import Configuration, SearchSpace
    from repro_torch.testing import compare_traces, port_ei_at

    rng = np.random.default_rng(200)
    feats = rng.normal(size=(200, 5))
    space = SearchSpace([Configuration(name=f"s{i}", features=tuple(map(float, f)),
                                       total_memory=float(i) * 2.0**30)
                         for i, f in enumerate(feats)])
    z = feats @ rng.normal(size=5)
    table = 1.0 + ((z - z.mean()) / z.std() - 0.7) ** 2 + 0.05 * rng.random(200)
    n = len(space)
    assert bayesopt.trial_budget(n, 0, bayesopt.BOSettings()) == n == 200
    full = 0
    for seed in (0, 1):
        runs = {}
        for where in ("cuda", "cpu"):
            before = kernel.ei_argmax_cuda.launches
            runs[where] = bayesopt.cherrypick_search(space, lambda i: float(table[i]),
                                                     np.random.default_rng(seed),
                                                     layout="fused", device=where)
            runs[where + "_launches"] = kernel.ei_argmax_cuda.launches - before
        got, cpu = runs["cuda"], runs["cpu"]
        assert runs["cpu_launches"] == 0 and len(got.tried) > 3
        assert runs["cuda_launches"] >= len(got.tried) - 3
        cmp = compare_traces(cpu, got, port_ei_at(space.encoded(), [list(range(n))], n, cpu,
                                                  "cpu"), first_bo_step=3)
        full += cmp.full
    assert full >= 1, "no card trace matched the CPU's in full"


def job_axis_case(dev, n, d, cap, ks, seed=30):
    """Tail inputs for len(ks) packed states stacked on the job axis, row j
    with ks[j] observations (rows at different t, a full buffer, an
    all-masked pool in the last row)."""
    rows = [case(dev, seed + j, n, d, k, cap) for j, k in enumerate(ks)]
    out = [torch.cat([r[i] for r in rows]).contiguous() for i in range(10)]
    out[1][-1] = False  # the last row's candidate pool is empty
    return out


@pytest.mark.parametrize("n,d,cap,ks", [
    (69, 4, 69, [3, 10, 40, 69, 5, 68, 20, 7]),  # the paper grid, the blocked route
    (5000, 6, 24, [3, 4, 8, 12, 16, 20, 24, 6]),  # the register route, several tiles
    (700, 5, 10, [3, 9, 10, 5, 7]),  # J = 5
])
def test_kernel_job_axis(dev, n, d, cap, ks):
    """K1 at J > 1: every row against the plain version of that row alone,
    one launch for the whole batch, and a second call equal to the first
    (the per-device finished-block counts are left at 0 by each call)."""
    args = job_axis_case(dev, n, d, cap, ks)
    before = kernel.ei_argmax_cuda.launches
    k_idx, k_val = ei_argmax(*args)
    torch.cuda.synchronize()
    assert kernel.ei_argmax_cuda.launches == before + 1
    again = ei_argmax(*args)
    assert torch.equal(again[0], k_idx) and torch.equal(again[1], k_val)
    for j in range(len(ks)):
        row = [a[j:j + 1] for a in args]
        p_idx, p_val = ei_argmax_plain(*row)
        assert_close(float(p_val[0]), float(k_val[j]), rtol=EI_RTOL, atol=EI_ATOL,
                     what=f"row {j} max EI")
        full = ei_from_sqdist(pairwise_sqdist(row[2], row[0]), *row[3:], row[1])
        assert pick_agrees(int(p_idx[0]), int(k_idx[j]), full[0].cpu().numpy()), j
    assert int(k_idx[-1]) == 0 and float(k_val[-1]) == float("-inf")


def fleet_jobs(J, n=300, d=5):
    from repro_torch.core.search_space import Configuration, SearchSpace

    rng = np.random.default_rng(n)
    feats = rng.normal(size=(n, d))
    space = SearchSpace([Configuration(name=f"s{i}", features=tuple(map(float, f)),
                                       total_memory=float(i) * 2.0**30)
                         for i, f in enumerate(feats)])
    z = feats @ rng.normal(size=d)
    table = 1.0 + ((z - z.mean()) / z.std() - 0.7) ** 2 + 0.05 * rng.random(n)
    pools = [(list(range(n)), []), (list(range(40)), list(range(40, n)))]
    return space, table, [pools[j % 2] for j in range(J)]


@pytest.mark.parametrize("J", [5, 9])
def test_fused_fleet_on_the_card_matches_the_cpu(dev, J, monkeypatch):
    """A lockstep fleet of J jobs (CherryPick and two-phase Ruya pools over
    300 configurations, max_iters = 16, the stop criterion armed) in the
    fused layout through a `TuningSession` on the card: K1 launches once
    per chunk step (J = 9 is two chunks), and each trace is held to the same
    fleet on the CPU (K1's plain version) under the CPU's EI; at least J - 1
    match in full."""
    from repro_torch.core.bayesopt import BOSettings, trial_budget
    from repro_torch.fleet import FleetJob, TuningSession, batched_search
    from repro_torch.testing import compare_traces, port_ei_at

    from repro_torch.fleet import session as session_mod

    space, table, pools = fleet_jobs(J)
    st = BOSettings(max_iters=16)
    session = TuningSession(settings=st, layout="fused", device=dev)
    hs = [session.submit(FleetJob(name=f"j{j}", space=space, cost_table=table), seed=j,
                         priority=p, remaining=r) for j, (p, r) in enumerate(pools)]
    update, chunk_steps = session_mod._fleet_update, [0]

    def counted(*args, **kw):  # one call per chunk step
        chunk_steps[0] += 1
        return update(*args, **kw)

    monkeypatch.setattr(session_mod, "_fleet_update", counted)
    kernel.ei_argmax_cuda.launches = 0
    session.step()
    torch.cuda.synchronize()
    assert chunk_steps[0] == kernel.ei_argmax_cuda.launches == len(session._chunks) >= 1
    session.drain()
    assert kernel.ei_argmax_cuda.launches == chunk_steps[0] > 16
    cpu = batched_search(space, [table] * J, [np.random.default_rng(j) for j in range(J)],
                         priority=[p for p, _ in pools], remaining=[r for _, r in pools],
                         settings=st, layout="fused", device="cpu")
    full = 0
    for j, (h, (p, r)) in enumerate(zip(hs, pools)):
        ref = cpu.job_trace(j)
        plist = [p, r] if r else [p]
        cap = trial_budget(len(p), len(r), st)
        full += compare_traces(ref, h.outcome().trace(),
                               port_ei_at(space.encoded(), plist, cap, ref, "cpu"),
                               first_bo_step=3).full
    assert full >= J - 1, f"only {full} of {J} card traces matched the CPU's in full"


def counted_fleet_updates(monkeypatch):
    """Wrap the plain chunk's and the bundle's update: one count a chunk
    (or shard) step, the calls that launch K1 in the fused layout."""
    import threading

    from repro_torch.fleet import session as session_mod, sharding

    steps, lock = [0], threading.Lock()
    for mod in (session_mod, sharding):
        def counted(*args, _update=mod._fleet_update, **kw):
            with lock:
                steps[0] += 1
            return _update(*args, **kw)

        monkeypatch.setattr(mod, "_fleet_update", counted)
    return steps


def drain_fleet(dev, J, **kw):
    """`fleet_jobs(J)` through a fused session on the card: its outcomes."""
    from repro_torch.core.bayesopt import BOSettings
    from repro_torch.fleet import FleetJob, TuningSession

    space, table, pools = fleet_jobs(J)
    session = TuningSession(settings=BOSettings(max_iters=16), layout="fused", device=dev, **kw)
    hs = [session.submit(FleetJob(name=f"j{j}", space=space, cost_table=table), seed=j,
                         priority=p, remaining=r) for j, (p, r) in enumerate(pools)]
    session.drain()
    return [h.outcome().as_dict() for h in hs]


def test_sharded_fleet_on_the_card_matches_unsharded(dev, monkeypatch):
    """Sixteen fused searches bundled over ``["cuda:0"] * 2`` (two shards of
    eight rows, the unsharded chunks' extent): every outcome equals the
    unsharded session's, and K1 launches once per shard per bundle step."""
    want = drain_fleet(dev, 16)
    steps = counted_fleet_updates(monkeypatch)
    kernel.ei_argmax_cuda.launches = 0
    got = drain_fleet(dev, 16, devices=["cuda:0"] * 2)
    torch.cuda.synchronize()
    assert got == want
    assert kernel.ei_argmax_cuda.launches == steps[0] > 16


def test_service_fleet_on_the_card_matches_lockstep(dev, monkeypatch):
    """The same sixteen searches through a `TuningService` on the card,
    submitted while it is paused (so it forms the lockstep chunks), then
    drained by its worker threads: every outcome equals the lockstep
    session's, and K1's launches equal the chunk steps `metrics()` counts."""
    from repro_torch.core.bayesopt import BOSettings
    from repro_torch.fleet import FleetJob, TuningService

    want = drain_fleet(dev, 16)
    space, table, pools = fleet_jobs(16)
    steps = counted_fleet_updates(monkeypatch)
    kernel.ei_argmax_cuda.launches = 0
    with TuningService(settings=BOSettings(max_iters=16), layout="fused", device=dev) as svc:
        svc.pause()
        hs = [svc.submit(FleetJob(name=f"j{j}", space=space, cost_table=table), seed=j,
                         priority=p, remaining=r) for j, (p, r) in enumerate(pools)]
        svc.drain()
        metrics = svc.metrics()
    torch.cuda.synchronize()
    assert [h.outcome().as_dict() for h in hs] == want
    counted = sum(g["steps"] for g in metrics["groups"].values())
    assert kernel.ei_argmax_cuda.launches == steps[0] == counted > 16
    assert {g["device"] for g in metrics["groups"].values()} == {"cuda:0"}


def test_kernel_from_two_threads(dev):
    """K1 at J = 8 called 50 times from each of two threads at once, on the
    one default stream they share: every result equals the same call made
    in turn, and no launch goes uncounted."""
    import threading

    cases = [job_axis_case(dev, n, d, cap, ks) for n, d, cap, ks in (
        (69, 4, 69, [3, 10, 40, 69, 5, 68, 20, 7]),
        (5000, 6, 24, [3, 4, 8, 12, 16, 20, 24, 6]),
    )]
    want = [ei_argmax(*args) for args in cases]
    torch.cuda.synchronize()
    before = kernel.ei_argmax_cuda.launches
    got, errors = [[], []], []
    barrier = threading.Barrier(2)

    def run(k):
        try:
            barrier.wait(timeout=30.0)
            for _ in range(50):
                got[k].append(ei_argmax(*cases[k]))
            torch.cuda.synchronize()
        except BaseException as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60.0)
    assert not errors
    assert kernel.ei_argmax_cuda.launches == before + 100
    for k in range(2):
        assert all(torch.equal(i, want[k][0]) and torch.equal(v, want[k][1]) for i, v in got[k])


def test_device_split_on_the_card(dev):
    """`split_masks_device` on the card equals the host split's lists in
    every branch, at 131072 configurations and for the paper jobs."""
    from repro_torch.cluster.simulator import ClusterSimulator
    from repro_torch.cluster.workloads import JOBS
    from repro_torch.core.memory_model import MemoryCategory, MemoryModel
    from repro_torch.core.profiler import profile_job
    from repro_torch.core.search_space import (
        Configuration, SearchSpace, split_masks_device, split_search_space)

    def check(space, model, size, **kw):
        prio, rest = split_search_space(space, model, size, **kw)
        mask = split_masks_device(space, model, size, device=dev, **kw).cpu().numpy()
        assert np.flatnonzero(mask).tolist() == prio
        assert np.flatnonzero(~mask).tolist() == rest
        return len(prio)

    for key in sorted(JOBS):
        sim = ClusterSimulator.for_job(key)
        size = sim.job.input_gb * 2.0**30
        check(sim.space, profile_job(sim.profile_run_fn(), size).model, size,
              per_node_overhead=0.5 * 2.0**30)
    n = 131072
    rng = np.random.default_rng(5)
    mems = rng.choice(rng.uniform(1, 2048, size=4000), size=n) * 2.0**30  # many ties
    nodes = rng.integers(1, 65, size=n)
    space = SearchSpace([Configuration(name=f"c{i}", features=(float(i),),
                                       total_memory=float(m), num_nodes=int(k))
                         for i, (m, k) in enumerate(zip(mems, nodes))])

    def model(cat, slope=0.0, intercept=2.0**30):
        return MemoryModel(category=MemoryCategory(cat), slope=slope, intercept=intercept,
                           r2=1.0, sizes=(1.0,), readings=(4.0 * 2.0**30,))

    kw = dict(per_node_overhead=0.5 * 2.0**30)
    assert check(space, model("flat"), 1e12, **kw) == round(n / 7)
    assert 0 < check(space, model("linear", 3.0), 100 * 2.0**30, **kw) < n
    assert check(space, model("linear", 1e3), 100 * 2.0**30, **kw) == 2 * round(0.15 * n)
    assert check(space, model("linear", 1e-9, 0.0), 1.0) == n
    assert check(space, model("unclear"), 1.0, **kw) == n


# ---------------------------------------------------------------- flash attention (K2)

FA_SHAPES = [  # tests/test_kernels.py's sweep: (b, t, h, kv, d, causal)
    (1, 128, 4, 4, 64, True),
    (2, 128, 4, 2, 64, True),
    (1, 256, 8, 1, 32, True),
    (2, 128, 4, 2, 128, True),
    (1, 128, 4, 4, 64, False),
    (1, 100, 4, 2, 64, False),
    (1, 200, 6, 3, 48, True),
]
# Kernel against plain version and attention_ref: float32 sums in another
# order; in bfloat16 both round the same float32 result once, so they differ
# by at most one bfloat16 step of the output (2^-7 relative), with 1e-3
# absolute for outputs near zero.
FA_TOL = {torch.float32: dict(rtol=1e-4, atol=2e-5), torch.bfloat16: dict(rtol=2.0**-7, atol=1e-3)}


def qkv(dev, seed, b, t, h, kv, d, dtype, s=None):
    rng = np.random.default_rng(seed)
    s = t if s is None else s
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 .to(dev, dtype) for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d)))


def fa_counts():
    fa = fa_kernel.flash_attention_cuda
    return fa.launches, fa.tensor_core_launches, fa.cuda_core_launches


def fa_launched(before, route):
    """The launch counts after one call that took ``route``."""
    n, tc, cc = before
    return (n + 1, tc + (route == "tensor_core"), cc + (route == "cuda_core"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,h,kv,d,causal", FA_SHAPES)
def test_flash_kernel_matches_plain_version(dev, b, t, h, kv, d, causal, dtype):
    """float32 takes the CUDA-core kernel, bfloat16 (every D here is a
    multiple of 8) the tensor-core one."""
    q, k, v = qkv(dev, t * h + d, b, t, h, kv, d, dtype)
    before = fa_counts()
    out = flash_attention(q, k, v, causal)
    plain = flash_attention_plain(q, k, v, causal=causal)
    ref = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    route = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
    assert fa_counts() == fa_launched(before, route)
    assert out.dtype == dtype and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    assert_close(plain.float().cpu().numpy(), out.float().cpu().numpy(), **FA_TOL[dtype],
                 what="kernel vs plain")
    assert_close(ref.float().cpu().numpy(), out.float().cpu().numpy(), **FA_TOL[dtype],
                 what="kernel vs attention_ref")


def test_flash_kernel_long_ragged_and_large_logits(dev):
    q, k, v = qkv(dev, 3, 1, 1000, 8, 2, 128, torch.bfloat16)
    out = flash_attention(q, k, v, True)
    assert_close(flash_attention_plain(q, k, v).float().cpu().numpy(),
                 out.float().cpu().numpy(), **FA_TOL[torch.bfloat16])
    big = torch.full((1, 128, 1, 64), 10.0, device=dev)
    out = flash_attention(big, big, torch.randn(1, 128, 1, 64, device=dev), True)
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("t,s,d,causal", [
    (4096, 4096, 128, True),   # the Qwen3-8B forward's shape, with H=32 and KV=8
    (200, 333, 128, False),    # S > T, both ragged
    (333, 200, 64, True),      # S < T, causal: the late queries see every key
    (77, 77, 128, True),       # ragged T at D = 128, one partial tile
    (1000, 1000, 96, True),    # ragged T, D between the two tile widths
    (130, 130, 8, False),      # the smallest D the tensor-core kernel takes
])
def test_flash_tensor_core_kernel_matches_plain_version(dev, t, s, d, causal):
    h, kv = (32, 8) if t == 4096 else (4, 2)
    q, k, v = qkv(dev, t + s + d, 1, t, h, kv, d, torch.bfloat16, s=s)
    before = fa_counts()
    out = flash_attention(q, k, v, causal)
    plain = flash_attention_plain(q, k, v, causal=causal)
    ref = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_counts() == fa_launched(before, "tensor_core")
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    assert_close(plain.float().cpu().numpy(), out.float().cpu().numpy(),
                 **FA_TOL[torch.bfloat16], what="kernel vs plain")
    assert_close(ref.float().cpu().numpy(), out.float().cpu().numpy(),
                 **FA_TOL[torch.bfloat16], what="kernel vs attention_ref")


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 12, "cuda_core"),
    (torch.bfloat16, 4, "cuda_core"), (torch.float32, 64, "cuda_core"),
    (torch.float32, 12, "cuda_core"),
], ids=["bf16-d64", "bf16-d12", "bf16-d4", "f32-d64", "f32-d12"])
def test_flash_route_by_dtype_and_head_dim(dev, dtype, d, route):
    """float32, and bfloat16 with D % 8 != 0, stay on the CUDA-core kernel."""
    assert fa_kernel.route(dtype, d) == route
    q, k, v = qkv(dev, d, 2, 150, 4, 2, d, dtype)
    before = fa_counts()
    out = flash_attention(q, k, v, True)
    plain = flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert fa_counts() == fa_launched(before, route)
    assert_close(plain.float().cpu().numpy(), out.float().cpu().numpy(), **FA_TOL[dtype])


def test_flash_tensor_core_kernel_reads_unaligned_views(dev):
    """A contiguous view 16-byte misaligned for TMA is copied, not refused."""
    q, k, v = qkv(dev, 5, 1, 128, 4, 2, 64, torch.bfloat16)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    qv = buf[1:].view(q.shape)
    qv.copy_(q)
    assert qv.data_ptr() % 16 != 0 and qv.is_contiguous()
    out = fa_kernel.flash_attention_cuda(qv, k, v)
    assert torch.equal(out, fa_kernel.flash_attention_cuda(q, k, v))


def test_flash_kernel_rejects_what_it_cannot_take(dev):
    q, k, v = qkv(dev, 0, 1, 128, 4, 2, 64, torch.float32)
    with pytest.raises(TypeError):
        fa_kernel.flash_attention_cuda(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        fa_kernel.flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        fa_kernel.flash_attention_cuda(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    q2, k2, v2 = qkv(dev, 0, 1, 128, 4, 2, 136, torch.float32)
    with pytest.raises(ValueError):
        fa_kernel.flash_attention_cuda(q2, k2, v2)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half(), True)


def test_model_forward_launches_flash_once_per_layer(dev):
    """The teacher-forced forward runs the kernel in every layer and matches
    the dense route; prefill and decode never launch it."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import Model

    cfg = ModelConfig(name="tiny", family="dense", num_layers=3, d_model=128, num_heads=8,
                      num_kv_heads=2, d_ff=256, vocab_size=512, head_dim=32, qk_norm=True,
                      compute_dtype="float32", attention_impl="auto")
    model = Model(cfg, device=dev, seed=0)
    dense = Model(cfg.replace(attention_impl="dense"), params=model.params_tree(), device=dev)
    tokens = torch.randint(0, 512, (2, 256), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        before = fa_kernel.flash_attention_cuda.launches
        before_cc = fa_kernel.flash_attention_cuda.cuda_core_launches
        logits, _ = model.forward({"tokens": tokens})
        assert fa_kernel.flash_attention_cuda.launches == before + cfg.num_layers
        # float32 compute: the CUDA-core kernel
        assert fa_kernel.flash_attention_cuda.cuda_core_launches == before_cc + cfg.num_layers
        ref, _ = dense.forward({"tokens": tokens})
        cache = model.init_cache(2, 300)
        model.prefill({"tokens": tokens}, cache)
        model.decode_step(cache, tokens[:, :1], 256)
        assert fa_kernel.flash_attention_cuda.launches == before + cfg.num_layers
    assert_close(ref.cpu().numpy(), logits.cpu().numpy(), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- K2's backward

BWD_SHAPES = [  # (b, t, s, h, kv, d, causal): the zoo's training shapes that take the kernel
    (1, 4096, 4096, 32, 8, 128, True),   # granite-8b (and Qwen3-8B): a train-4k-b2 microbatch
    (2, 4096, 4096, 32, 32, 64, True),   # zamba2's shared block, 4 x 4096 in 2 microbatches
    (2, 3584, 3584, 32, 8, 128, True),   # llava: 2880 patches + 704 text tokens, batch 2
    (1, 4096, 4096, 64, 8, 112, True),   # kimi-k2: D = 112, between the tile widths
    (8, 512, 512, 6, 6, 64, True),       # whisper's decoder self-attention, batch 8
    (8, 512, 512, 6, 6, 64, False),      # whisper's shape bidirectional
    (1, 1000, 1000, 8, 2, 96, True),     # ragged T at a D between the widths
    (1, 200, 333, 4, 1, 48, False),      # T < S, both ragged, 4 query heads a KV head
    (1, 333, 200, 4, 2, 64, True),       # T > S, causal: the late queries see every key
]
# The kernel against its plain version, each on the kernel's own output and
# log-sum-exp: both round the same float32 gradients once to bfloat16 (they
# differ only in the order of float32 sums, the 16-bit two-term p and ds
# and the hardware exp2), so by at most one bfloat16 step (2^-7 relative),
# with 2^-10 of the tensor's largest entry for entries near zero.
BWD_PLAIN_TOL = dict(rtol=2.0**-7, atol_of_max=2.0**-10)
# Against the float32 oracle on the same bfloat16 values: one rounding of
# the output (2^-8 relative), and Di taken from the bfloat16 output o
# rather than the float32 sum of p * dp (about 2^-9 of |dO . o| a row,
# which moves each ds by p times that); 2^-7 of the largest entry covers
# both at every shape here, where a gradient 5 % off would not pass.
BWD_ORACLE_TOL = dict(rtol=2.0**-7, atol_of_max=2.0**-7)
# The forward's f32 row log-sum-exp against the plain forward's: the same
# f32 exponentials summed in another order (the kernel in base 2), some
# 1e-6 apart at |lse| near 10; a wrong mask or tile is off by 0.1 or more.
LSE_TOL = dict(rtol=0.0, atol=2.0**-14)


def bwd_inputs(dev, seed, b, t, s, h, kv, d, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                 for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d), (b, t, h, d)))


def hold(ref, got, tol, what):
    ref, got = ref.float(), got.float()
    return assert_close(ref.cpu().numpy(), got.cpu().numpy(), rtol=tol["rtol"],
                        atol=tol["atol_of_max"] * float(ref.abs().max()), what=what)


def oracle_grads(q, k, v, g, causal):
    """Autograd through `attention_ref` in float32 on the same values."""
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    return torch.autograd.grad(attention_ref(*leaves, causal=causal), leaves, g.float())


@pytest.mark.parametrize("b,t,s,h,kv,d,causal", BWD_SHAPES)
def test_flash_backward_kernel_holds_dq_dk_dv(dev, b, t, s, h, kv, d, causal):
    """Through the op: one forward launch on the tensor-core route, one
    backward launch; the forward's log-sum-exp held to the plain forward's;
    dq, dk and dv each held to the plain backward and to the float32
    oracle."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_backward_plain

    q, k, v, g = bwd_inputs(dev, t + s + h + d, b, t, s, h, kv, d)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before, bwd = fa_counts(), fa_kernel.flash_attention_bwd_cuda.launches
    out = flash_attention(*leaves, causal)
    out.backward(g)
    torch.cuda.synchronize()
    assert fa_counts() == fa_launched(before, "tensor_core")
    assert fa_kernel.flash_attention_bwd_cuda.launches == bwd + 1
    o, lse = fa_kernel.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    assert torch.equal(o, out.detach())
    _, plain_lse = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    assert_close(plain_lse.cpu().numpy(), lse.cpu().numpy(), **LSE_TOL, what="lse vs plain")
    plain = flash_attention_backward_plain(q, k, v, o, lse, g, causal=causal)
    ref = oracle_grads(q, k, v, g, causal)
    for name, x, p, r in zip("qkv", leaves, plain, ref):
        assert x.grad.dtype == torch.bfloat16 and bool(torch.isfinite(x.grad).all())
        hold(p, x.grad, BWD_PLAIN_TOL, f"d{name} vs plain")
        hold(r, x.grad, BWD_ORACLE_TOL, f"d{name} vs the float32 oracle")


def test_flash_backward_kernel_takes_strided_and_unaligned_inputs(dev):
    """A strided gradient (autograd may hand one in) is made contiguous, and
    views 16-byte misaligned for TMA are copied: the same gradients bit for
    bit."""
    q, k, v, g = bwd_inputs(dev, 11, 1, 300, 300, 8, 2, 64)
    o, lse = fa_kernel.flash_attention_cuda(q, k, v, return_lse=True)
    want = fa_kernel.flash_attention_bwd_cuda(q, k, v, o, lse, g)
    strided = g.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()

    def misaligned(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        assert view.data_ptr() % 16 != 0 and view.is_contiguous()
        return view

    for args in ((q, k, v, o, lse, strided), tuple(misaligned(x) for x in (q, k, v, o, lse, g))):
        got = fa_kernel.flash_attention_bwd_cuda(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.bfloat16, 12)],
                         ids=["f32-d64", "bf16-d12"])
def test_flash_backward_off_the_tensor_core_route_is_the_oracles(dev, dtype, d):
    """The CUDA-core route keeps autograd through the oracle: no backward
    launch, the oracle's gradients bit for bit."""
    q, k, v, g = bwd_inputs(dev, d, 2, 150, 150, 4, 2, d, dtype)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    bwd = fa_kernel.flash_attention_bwd_cuda.launches
    flash_attention(*leaves, True).backward(g)
    torch.cuda.synchronize()
    assert fa_kernel.flash_attention_bwd_cuda.launches == bwd
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = torch.autograd.grad(attention_ref(*ref_leaves, causal=True), ref_leaves, g)
    assert all(torch.equal(x.grad, r) for x, r in zip(leaves, ref))


def test_flash_backward_kernel_rejects_what_it_cannot_take(dev):
    q, k, v, g = bwd_inputs(dev, 0, 1, 128, 128, 4, 2, 64)
    o, lse = fa_kernel.flash_attention_cuda(q, k, v, return_lse=True)
    with pytest.raises(ValueError):  # the CUDA-core route has no backward kernel
        fa_kernel.flash_attention_bwd_cuda(q.float(), k.float(), v.float(), o.float(), lse,
                                           g.float())
    with pytest.raises(TypeError):
        fa_kernel.flash_attention_bwd_cuda(q, k, v, o, lse.bfloat16(), g)
    with pytest.raises(ValueError):
        fa_kernel.flash_attention_bwd_cuda(q, k, v, o[:, :64], lse, g)
    q3, k3, v3, g3 = bwd_inputs(dev, 0, 1, 128, 128, 6, 4, 64)  # H not a multiple of KV
    o3, lse3 = fa_kernel.flash_attention_cuda(q3, k3, v3, return_lse=True)
    with pytest.raises(ValueError):
        fa_kernel.flash_attention_bwd_cuda(q3, k3, v3, o3, lse3, g3)
    with pytest.raises(ValueError):
        fa_kernel.flash_attention_cuda(q.float(), k.float(), v.float(), return_lse=True)


# ---------------------------------------------------------------- SSD intra-chunk (K3)

SSD_SHAPES = [  # (b, nc, q, h, p, n): tests/test_kernels.py's four, ragged, smoke model
    (1, 2, 8, 2, 16, 16),
    (2, 2, 64, 4, 32, 32),
    (1, 1, 128, 2, 64, 64),
    (1, 1, 256, 1, 64, 128),
    (1, 2, 100, 3, 20, 24),
    (2, 3, 8, 8, 16, 16),
    (1, 1, 512, 2, 96, 192),  # past the CUDA-core kernel's caps (Q 256, P 64, N 128)
    (1, 2, 333, 3, 72, 136),  # ragged past all three
    (1, 2, 77, 2, 33, 17),  # odd P and N: the 4-byte copies and single stores
]
SSD_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_kernels.py's limits for the TPU kernel


def ssd_inputs(dev, seed, b, nc, q, h, p, n):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, nc, q, h, p), generator=g, device=dev)
    dt = torch.nn.functional.softplus(torch.randn((b, nc, q, h), generator=g, device=dev))
    lA = -torch.nn.functional.softplus(torch.randn((b, nc, q, h), generator=g, device=dev))
    B_ = torch.randn((b, nc, q, h, n), generator=g, device=dev)
    C_ = torch.randn((b, nc, q, h, n), generator=g, device=dev)
    return x, dt, lA, B_, C_


@pytest.mark.parametrize("b,nc,q,h,p,n", SSD_SHAPES)
def test_ssd_kernel_matches_plain_version(dev, b, nc, q, h, p, n):
    args = ssd_inputs(dev, q * h + n, b, nc, q, h, p, n)
    before = ssd_kernel.ssd_diag_cuda.launches
    out = ssd_diag_chunk(*args)
    plain = ssd_diag_plain(*args)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_diag_cuda.launches == before + 1
    assert out.shape == (b, nc, q, h, p) and bool(torch.isfinite(out).all())
    assert_close(plain.cpu().numpy(), out.cpu().numpy(), **SSD_TOL, what="kernel vs plain")


def test_ssd_kernel_reads_head_broadcast_views(dev):
    """B and C shared by every head, as a stride-0 view: the same result as
    their copies, nothing copied on the way."""
    x, dt, lA, B_, C_ = ssd_inputs(dev, 3, 1, 4, 256, 32, 64, 128)
    Bg, Cg = B_[:, :, :, :1], C_[:, :, :, :1]
    view = ssd_diag_chunk(x, dt, lA, Bg.expand_as(B_), Cg.expand_as(C_))
    copy = ssd_diag_chunk(x, dt, lA, Bg.expand_as(B_).contiguous(), Cg.expand_as(C_).contiguous())
    assert torch.equal(view, copy)
    assert_close(ssd_diag_plain(x, dt, lA, Bg.expand_as(B_), Cg.expand_as(C_)).cpu().numpy(),
                 view.cpu().numpy(), **SSD_TOL)


@pytest.mark.parametrize("b,nc,q,h,p,n,g,bf16", [
    (1, 2, 256, 8, 64, 128, 2, False),  # G > 1: head h reads group h // 4
    (2, 2, 256, 8, 64, 128, 1, True),  # x, B and C bf16 values, as the model gives them
    (1, 1, 300, 6, 40, 72, 3, True),
    (8, 8, 256, 64, 64, 64, 1, True),  # zamba2's prefill of 8 x 2048 tokens
])
def test_ssd_kernel_reads_grouped_b_and_c(dev, b, nc, q, h, p, n, g, bf16):
    """B and C per group, (b, nc, q, G, n), as `ssd_chunked` passes them:
    one launch, held to the plain version (and to the head copies' result)."""
    x, dt, lA, B_, C_ = ssd_inputs(dev, 11 * g + q, b, nc, q, h, p, n)
    Bg, Cg = B_[:, :, :, :g], C_[:, :, :, :g]
    if bf16:
        x, Bg, Cg = (a.to(torch.bfloat16).float() for a in (x, Bg, Cg))
    before = ssd_kernel.ssd_diag_cuda.launches
    out = ssd_diag_chunk(x, dt, lA, Bg, Cg)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_diag_cuda.launches == before + 1
    plain = ssd_diag_plain(x, dt, lA, Bg, Cg)
    assert_close(plain.cpu().numpy(), out.cpu().numpy(), **SSD_TOL, what="kernel vs plain")
    copies = ssd_diag_chunk(x, dt, lA, *(a.repeat_interleave(h // g, dim=3) for a in (Bg, Cg)))
    assert_close(copies.cpu().numpy(), out.cpu().numpy(), **SSD_TOL, what="grouped vs copies")


def test_ssd_kernel_rejects_what_it_cannot_take(dev):
    x, dt, lA, B_, C_ = (a[0] for a in ssd_inputs(dev, 0, 1, 1, 64, 2, 16, 16))
    with pytest.raises(TypeError):
        ssd_kernel.ssd_diag_cuda(x.double(), dt, lA, B_, C_)
    with pytest.raises(ValueError):
        ssd_kernel.ssd_diag_cuda(x, dt, lA, B_.transpose(2, 3).contiguous().transpose(2, 3), C_)
    with pytest.raises(ValueError):  # CPU tensors never reach the kernel
        ssd_kernel.ssd_diag_cuda(x.cpu(), dt.cpu(), lA.cpu(), B_.cpu(), C_.cpu())
    x3, dt3, lA3, B3, C3 = (a[0] for a in ssd_inputs(dev, 0, 1, 1, 64, 3, 16, 16))
    with pytest.raises(ValueError):  # 2 groups do not divide 3 heads
        ssd_kernel.ssd_diag_cuda(x3, dt3, lA3, B3[:, :, :2], C3[:, :, :2])


def test_ssm_model_launches_ssd_once_per_layer(dev):
    """The smoke SSM model's forward and prefill run the kernel in every
    layer, decode never; the forward matches the CPU's (plain version)."""
    from repro_torch import configs
    from repro_torch.models.model import Model

    cfg = configs.smoke("mamba2-370m").model.replace(compute_dtype="float32", num_layers=3)
    model = Model(cfg, device=dev, seed=0)
    cpu = Model(cfg, params=model.params_tree(), device="cpu")
    tokens = torch.randint(0, 256, (2, 37), generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        before = ssd_kernel.ssd_diag_cuda.launches
        logits, _ = model.forward({"tokens": tokens})
        assert ssd_kernel.ssd_diag_cuda.launches == before + cfg.num_layers
        cache = model.init_cache(2, 64)
        model.prefill({"tokens": tokens}, cache)
        assert ssd_kernel.ssd_diag_cuda.launches == before + 2 * cfg.num_layers
        model.decode_step(cache, tokens[:, :1], 37)
        assert ssd_kernel.ssd_diag_cuda.launches == before + 2 * cfg.num_layers
        ref, _ = cpu.forward({"tokens": tokens})
    assert_close(ref.numpy(), logits.cpu().numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- RMSNorm (K4)

RN_SHAPES = [  # (x shape, dtype): tests/test_kernels.py's, nd, each launch mode, unaligned D
    ((256, 64), torch.float32), ((300, 128), torch.float32), ((512, 384), torch.bfloat16),
    ((64, 1024), torch.float32), ((2, 7, 96), torch.float32),
    ((33, 4096), torch.float32),  # a block per row
    ((17, 4096), torch.bfloat16), ((16384, 4096), torch.bfloat16),  # bf16: a warp per row,
    ((16383, 4096), torch.bfloat16),  # 4 rows a block, the last block ragged
    ((9, 6144), torch.bfloat16), ((5, 8192), torch.bfloat16),  # 32 words a lane
    ((3, 12288), torch.bfloat16),  # bf16 above 8192: a block per row
    ((5, 12288), torch.float32),  # 1024 threads per row
    ((9, 100), torch.bfloat16), ((7, 1030), torch.float32),  # D off the 16-byte words
]


def rn_inputs(dev, seed, shape, dtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    s = torch.randn(shape[-1:], generator=g, device=dev).to(dtype)
    return x, s


def rn_assert_close(plain, out):
    """f32 within 1e-5; bf16 within one step of the output (2^-7 relative):
    both round the same float32 value once."""
    if out.dtype == torch.bfloat16:
        assert_close(plain.float().cpu().numpy(), out.float().cpu().numpy(), rtol=2.0**-7, atol=0.0)
    else:
        assert_close(plain.cpu().numpy(), out.cpu().numpy(), rtol=0.0, atol=1e-5)


@pytest.mark.parametrize("shape,dtype", RN_SHAPES)
def test_rmsnorm_kernel_matches_plain_version(dev, shape, dtype):
    x, s = rn_inputs(dev, sum(shape), shape, dtype)
    before = rn_kernel.rmsnorm_cuda.launches
    out = rmsnorm(x, s)
    plain = rmsnorm_plain(x, s)
    torch.cuda.synchronize()
    assert rn_kernel.rmsnorm_cuda.launches == before + 1
    assert out.shape == x.shape and out.dtype == x.dtype and bool(torch.isfinite(out).all())
    rn_assert_close(plain, out)


def test_rmsnorm_gradient_through_the_op(dev):
    x, s = rn_inputs(dev, 3, (32, 64), torch.float32)
    xk, sk = x.clone().requires_grad_(), s.clone().requires_grad_()
    xr, sr = x.clone().requires_grad_(), s.clone().requires_grad_()
    (rmsnorm(xk, sk) ** 2).sum().backward()
    (rmsnorm_ref(xr, sr) ** 2).sum().backward()
    assert_close(xr.grad.cpu().numpy(), xk.grad.cpu().numpy(), rtol=0.0, atol=1e-4)
    assert_close(sr.grad.cpu().numpy(), sk.grad.cpu().numpy(), rtol=0.0, atol=1e-4)


def test_rmsnorm_kernel_rejects_what_it_cannot_take(dev):
    x, s = rn_inputs(dev, 0, (8, 64), torch.float32)
    with pytest.raises(TypeError):
        rn_kernel.rmsnorm_cuda(x.double(), s)
    with pytest.raises(TypeError):
        rn_kernel.rmsnorm_cuda(x, s.bfloat16())
    with pytest.raises(ValueError):
        rn_kernel.rmsnorm_cuda(x.t(), s[:8])
    big, sb = rn_inputs(dev, 0, (2, rn_kernel.MAX_D + 4), torch.float32)
    with pytest.raises(ValueError):
        rn_kernel.rmsnorm_cuda(big, sb)


# ---------------------------------------------------------------- training (K2, K3)


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-370m"])
def test_train_step_launches_kernels_twice_per_layer(dev, arch):
    """Under remat "full" a training step runs each layer's kernel in the
    forward and again in the recompute: 2 x layers x microbatches launches;
    its loss and gradient norm match the same step on the CPU."""
    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch, shard_batch
    from repro_torch.models.model import Model
    from repro_torch.runtime.steps import init_train_state, make_train_step

    spec = configs.smoke(arch)
    cfg = spec.model.replace(compute_dtype="float32", remat_policy="full", num_layers=3)
    ex = spec.exec.replace(num_microbatches=2, warmup_steps=2, learning_rate=3e-3)
    model = Model(cfg, device=dev, seed=0)
    cpu = Model(cfg, params=model.params_tree(), device="cpu")
    batch = make_batch(cfg, 4, 128, seed=0)
    counter = (fa_kernel.flash_attention_cuda if arch == "qwen3-8b"
               else ssd_kernel.ssd_diag_cuda)
    state = init_train_state(model, ex)
    before = counter.launches
    state, m = make_train_step(model, ex)(state, shard_batch(batch, dev))
    torch.cuda.synchronize()
    assert counter.launches == before + 2 * cfg.num_layers * ex.num_microbatches
    _, ref = make_train_step(cpu, ex)(init_train_state(cpu, ex), shard_batch(batch, "cpu"))
    for k in ("loss", "grad_norm"):
        assert_close(float(ref[k]), float(m[k]), rtol=1e-4, atol=1e-5, what=k)


def test_granite_training_step_runs_the_backward_kernel(dev, monkeypatch):
    """One step of granite-8b at 12 of its 36 layers (the benchmark's
    `granite-8b.train-4k`: 2 x 4096 tokens in 2 microbatches, full remat,
    AdamW): 24 backward launches (one a layer and microbatch), 48 forward
    ones on the tensor-core route (the forward and remat's recompute), none
    on the CUDA-core route, and nothing through the oracle."""
    from repro_torch import configs
    from repro_torch.data.pipeline import make_batch, shard_batch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.model import Model
    from repro_torch.runtime.steps import init_train_state, make_train_step

    def no_oracle(*a, **k):
        raise AssertionError("the attention backward went through the oracle")

    monkeypatch.setattr(fa_ops, "attention_ref", no_oracle)
    spec = configs.get("granite-8b")
    cfg = spec.model.replace(num_layers=12)
    assert (cfg.remat_policy, cfg.compute_dtype) == ("full", "bfloat16")
    ex = spec.exec.replace(optimizer="adamw", num_microbatches=2)
    torch.cuda.empty_cache()
    model = Model(cfg, device=dev, seed=0)
    state = init_train_state(model, ex)
    batch = shard_batch(make_batch(cfg, 2, 4096, seed=0), dev)
    before, bwd = fa_counts(), fa_kernel.flash_attention_bwd_cuda.launches
    state, m = make_train_step(model, ex)(state, batch)
    torch.cuda.synchronize()
    n, tc, cc = before
    assert fa_counts() == (n + 48, tc + 48, cc)
    assert fa_kernel.flash_attention_bwd_cuda.launches == bwd + 24
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
    del state, model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- the other families


FAMILY_FA_SHAPES = [  # (b, t, h, kv, d): the causal forwards the other families give K2
    (1, 4096, 64, 8, 112),  # kimi-k2: D = 112, between the tile widths
    (1, 4096, 48, 1, 128),  # granite-34b: one KV head for all 48
    (1, 4096, 40, 40, 128),  # qwen1.5-32b: no grouping
    (1, 32768, 32, 32, 64),  # zamba2's shared block at T = 32768
    (4, 512, 6, 6, 64),  # whisper's decoder
]


@pytest.mark.parametrize("b,t,h,kv,d", FAMILY_FA_SHAPES)
def test_flash_kernel_at_the_families_shapes(dev, b, t, h, kv, d):
    """bfloat16, so the tensor-core kernel, against the plain version."""
    q, k, v = qkv(dev, t + h + d, b, t, h, kv, d, torch.bfloat16)
    before = fa_counts()
    out = flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    assert fa_counts() == fa_launched(before, "tensor_core")
    plain = flash_attention_plain(q, k, v)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    assert_close(plain.float().cpu().numpy(), out.float().cpu().numpy(),
                 **FA_TOL[torch.bfloat16], what="kernel vs plain")


def _family_batch(cfg, b, t):
    from repro_torch.data.pipeline import make_batch

    batch = make_batch(cfg, b, t, seed=0)
    return {k: v for k, v in batch.items() if k != "loss_mask"}


@pytest.mark.parametrize("arch", ["granite-8b", "granite-34b", "qwen1.5-32b", "kimi-k2-1t-a32b",
                                  "arctic-480b", "zamba2-1.2b", "whisper-tiny",
                                  "llava-next-mistral-7b"])
def test_family_smoke_model_on_the_card_matches_the_cpu(dev, arch):
    """Each family's smoke model in float32 on the card (T = 128 with the
    VLM's 8 patches, so the causal self-attention of the forward takes K2's
    CUDA-core kernel, once a layer or site, and the SSM layers K3) against
    the same parameters on the CPU (the plain versions); prefill and decode
    launch no K2, and decode no K3."""
    from repro_torch import configs
    from repro_torch.models.model import Model
    from repro_torch.models.spec import tree_map

    cfg = configs.smoke(arch).model.replace(param_dtype="float32", compute_dtype="float32")
    model = Model(cfg, device=dev, seed=0)
    cpu = Model(cfg, params=tree_map(lambda x: x.cpu(), model.params_tree()), device="cpu")
    batch = _family_batch(cfg, 2, 128)
    sites = {"hybrid": -(-cfg.num_layers // max(cfg.hybrid_attn_every, 1))}
    want_fa = 0 if cfg.attention_impl == "chunked" else sites.get(cfg.family, cfg.num_layers)
    want_ssd = cfg.num_layers if cfg.family == "hybrid" else 0
    fa, ssd = fa_kernel.flash_attention_cuda, ssd_kernel.ssd_diag_cuda
    with torch.inference_mode():
        before = (fa.launches, ssd.launches)
        logits, aux = model.forward(batch)
        torch.cuda.synchronize()
        assert (fa.launches - before[0], ssd.launches - before[1]) == (want_fa, want_ssd)
        ref, ref_aux = cpu.forward(batch)
        assert_close(ref.numpy(), logits.cpu().numpy(), rtol=1e-4, atol=1e-4, what="forward")
        assert_close(float(ref_aux), float(aux), rtol=1e-4, atol=1e-6, what="aux")
        t = batch["tokens"].shape[1] + (cfg.num_patch_tokens if cfg.family == "vlm" else 0)
        cache, cpu_cache = model.init_cache(2, t + 4), cpu.init_cache(2, t + 4)
        got, _ = model.prefill(batch, cache)
        want, _ = cpu.prefill(batch, cpu_cache)
        tok = want[:, -1].argmax(-1)[:, None]
        got_step, _ = model.decode_step(cache, tok.to(dev), t)
        want_step, _ = cpu.decode_step(cpu_cache, tok, t)
        torch.cuda.synchronize()
        assert (fa.launches - before[0], ssd.launches - before[1]) == (want_fa, 2 * want_ssd)
    assert_close(want.numpy(), got.cpu().numpy(), rtol=1e-4, atol=1e-4, what="prefill")
    assert_close(want_step.numpy(), got_step.cpu().numpy(), rtol=1e-4, atol=1e-4, what="decode")


# ---------------------------------------------------------------- training the other families


TRAIN_FA_SHAPES = [  # (b, t, h, kv, d): K2 at each new training path's microbatch
    (2, 4096, 32, 32, 64),  # zamba2's shared block, 4 x 4096 in 2 microbatches
    (1, 4096, 64, 8, 112),  # kimi-k2, 4 x 4096 in 4
    (2, 3584, 32, 8, 128),  # llava: 2880 patches + 704 text tokens, batch 2
    (8, 512, 6, 6, 64),  # whisper's decoder self-attention, batch 8
]


@pytest.mark.parametrize("b,t,h,kv,d", TRAIN_FA_SHAPES)
def test_flash_kernel_at_the_training_shapes(dev, b, t, h, kv, d):
    q, k, v = qkv(dev, b * t + h + d, b, t, h, kv, d, torch.bfloat16)
    before = fa_counts()
    out = flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    assert fa_counts() == fa_launched(before, "tensor_core")
    plain = flash_attention_plain(q, k, v)
    assert out.shape == q.shape and bool(torch.isfinite(out).all())
    assert_close(plain.float().cpu().numpy(), out.float().cpu().numpy(),
                 **FA_TOL[torch.bfloat16], what="kernel vs plain")


def test_ssd_kernel_at_the_hybrid_training_shape(dev):
    """zamba2's microbatch of 2 x 4096 tokens: 16 chunks of 256, 64 heads of
    64, one group of B and C, bfloat16 values."""
    b, nc, q, h, p, n = 2, 16, 256, 64, 64, 64
    x, dt, lA, B_, C_ = ssd_inputs(dev, 21, b, nc, q, h, p, n)
    x, Bg, Cg = (a.to(torch.bfloat16).float() for a in (x, B_[:, :, :, :1], C_[:, :, :, :1]))
    before = ssd_kernel.ssd_diag_cuda.launches
    out = ssd_diag_chunk(x, dt, lA, Bg, Cg)
    torch.cuda.synchronize()
    assert ssd_kernel.ssd_diag_cuda.launches == before + 1
    plain = ssd_diag_plain(x, dt, lA, Bg, Cg)
    assert_close(plain.cpu().numpy(), out.cpu().numpy(), **SSD_TOL, what="kernel vs plain")


def test_adafactor_stacked_on_the_card_matches_the_cpu(dev):
    """Adafactor over a stacked MoE-shaped tree (experts, a projection, a
    norm scale per layer, and an embedding outside the stack), three steps
    on the card against the same steps on the CPU: the same float32
    operations, summed in other orders."""
    from repro_torch.optim import make_optimizer
    from repro_torch.models.spec import leaves, tree_map

    rng = np.random.default_rng(5)
    layer = {"experts": (8, 64, 32), "wq": (64, 4, 16), "scale": (64,)}

    def tree(step):
        return {"embed": rng.standard_normal((128, 64)).astype(np.float32),
                "layers": [{k: (rng.standard_normal(s) * (1 + step) ** (l - 1.5)).astype(np.float32)
                            for k, s in layer.items()} for l in range(4)]}

    init = tree(0)
    opt = make_optimizer("adafactor", weight_decay=0.01, stacks=[("layers",)])
    sides = {}
    for where in (dev, "cpu"):
        p = tree_map(lambda a: torch.from_numpy(a).to(where), init)
        sides[str(where)] = [p, opt.init(p)]
    for step in range(3):
        g = tree(step + 1)
        lr = torch.tensor(1e-2, dtype=torch.float32)
        for where, side in sides.items():
            side[0], side[1] = opt.update(side[0], side[1],
                                          tree_map(lambda a: torch.from_numpy(a).to(where), g),
                                          lr.to(where))
    (p_dev, s_dev), (p_cpu, s_cpu) = sides[str(dev)], sides["cpu"]
    for part_dev, part_cpu in ((p_dev, p_cpu), (s_dev.inner, s_cpu.inner)):
        for (name, a), (_, b) in zip(leaves(part_dev), leaves(part_cpu)):
            assert_close(b.numpy(), a.cpu().numpy(), rtol=1e-4, atol=1e-5, what=name)
    assert tuple(s_dev.inner["layers"]["scale"]["vr"].shape) == (4,)


# ---------------------------------------------------------------- the parallel layer


@pytest.fixture
def one_rank(dev, tmp_path):
    """A gloo world of this process alone (the card's meshes at world size 1)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    yield dev
    dist.destroy_process_group()


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_expert_parallel_at_world_size_one_is_the_local_route(one_rank, cd):
    """Under a (1, 1) mesh the MoE takes `moe_apply_shard_map` with no
    collective: output, aux and gradients bit-equal to the local route."""
    from repro_torch import configs as C
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch.build import rules_for
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.models.spec import init_tree, tree_map
    from repro_torch.parallel import expert_parallel
    from repro_torch.parallel.constraints import activation_sharding

    spec = C.smoke("kimi-k2-1t-a32b")
    cfg = spec.model.replace(param_dtype=cd, compute_dtype=cd)
    p = init_tree(torch.Generator(device=one_rank).manual_seed(0), L.moe_specs(cfg), one_rank)
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator(device=one_rank).manual_seed(1),
                    device=one_rank).to(cfg.cdtype)
    mesh = make_mesh((1, 1), ("data", "model"), one_rank)
    rules = rules_for(spec, ShapeCell("t", 64, 2, "train"), mesh)
    outs = []
    for ctx in (None, (rules, mesh)):
        q = tree_map(lambda a: a.detach().clone().requires_grad_(True), p)
        xq = x.clone().requires_grad_(True)
        assert expert_parallel.moe_shard_map_available(cfg, x.shape) is False
        if ctx is None:
            y, aux = L.moe_apply(q, cfg, xq)
        else:
            with activation_sharding(*ctx):
                assert expert_parallel.moe_shard_map_available(cfg, x.shape)
                y, aux = L.moe_apply(q, cfg, xq)
        ((y.float() ** 2).sum() + aux).backward()
        outs.append((y, aux, xq.grad, {k: v.grad for k, v in q.items() if k != "shared"}))
    (y0, a0, gx0, gp0), (y1, a1, gx1, gp1) = outs
    assert torch.equal(y0, y1) and torch.equal(a0, a1) and torch.equal(gx0, gx1)
    for k in gp0:
        assert torch.equal(gp0[k], gp1[k]), k


def test_pipeline_at_one_stage_is_the_plain_stack(one_rank):
    """`pipeline_apply` at S = 1 over a smoke Qwen3's stacked decoder
    layers: the plain stack's outputs bit for bit, K2 once a layer and
    microbatch."""
    from repro_torch import configs as C
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    from repro_torch.models.spec import flatten, unflatten
    from repro_torch.parallel import pipeline_apply

    cfg = C.smoke("qwen3-8b").model.replace(attention_impl="auto")
    model = Model(cfg, device=one_rank, seed=0)
    layers = model.params_tree()["layers"]
    stacked = unflatten(layers[0], [torch.stack(leaf) for leaf in
                                    zip(*(flatten(layer) for layer in layers))])
    m, t = 3, 128
    positions = torch.arange(t, device=one_rank)[None, :]

    def stage_fn(params, h):
        flat = flatten(params)
        per_layer = [unflatten(params, [leaf[i] for leaf in flat]) for i in range(flat[0].shape[0])]
        return T.decoder_stack_apply(per_layer, cfg, h, positions=positions)[0]

    micro = torch.randn((m, 1, t, cfg.d_model), device=one_rank).to(cfg.cdtype)
    mesh = make_mesh((1,), ("pod",), one_rank)
    with torch.inference_mode():
        before = fa_kernel.flash_attention_cuda.launches
        got = pipeline_apply(stage_fn, stacked, micro, mesh=mesh)
        assert fa_kernel.flash_attention_cuda.launches == before + cfg.num_layers * m
        for i in range(m):
            want = T.decoder_stack_apply(layers, cfg, micro[i], positions=positions)[0]
            assert torch.equal(got[i], want)
