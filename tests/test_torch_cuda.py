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
