#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Phases, each reported on its own lines:

  0. set-up: the card's name and power limit, and the build of the CUDA
     EI/argmax kernel from `src/repro_torch/kernels/ei_argmax/csrc/`;
  1. the kernel against its plain PyTorch version on the card, over the
     shapes of the main path and the edge cases, with both timed by CUDA
     events and by `torch.profiler` at the shape of each of the paths below;
  2. the paper's pipeline on the card (profiling → memory model → split →
     two-phase GP+EI search) for the 16 Table II jobs: fused-layout Ruya
     and CherryPick held against the feature layout and `run_ruya`, and
     the Table II quotients;
  3. the catalog scale: CherryPick over a 131072-configuration space, with
     a profiled breakdown of one BO step;
  4. the `n512-budgeted` golden fixture, replayed on the card.

Phases 2-4 are the three paths that run the kernel.  Each sets the
kernel's launch count to 0 just before its run, reads it just after, and
fails unless the kernel ran exactly once per fused BO step.

A failed check fails the run: the script exits non-zero and prints no
result.  It needs a CUDA card and the rest of the checkout; without either
it exits non-zero.  The last line of standard output is the result object;
the line before it lists every kernel once per path, each entry with that
path's launches and the kernel's deviation from the plain version, times
and bound at that path's shape.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

GiB = 1024.0**3
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and FP32 outside
# the tensor cores, both at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

JOB_ORDER = [  # Table II row order (benchmarks/common.py)
    "naivebayes/spark/bigdata", "naivebayes/spark/huge",
    "kmeans/spark/bigdata", "kmeans/spark/huge",
    "pagerank/spark/bigdata", "pagerank/spark/huge",
    "linregr/spark/bigdata", "linregr/spark/huge",
    "logregr/spark/bigdata", "logregr/spark/huge",
    "join/spark/bigdata", "join/spark/huge",
    "pagerank/hadoop/bigdata", "pagerank/hadoop/huge",
    "terasort/hadoop/bigdata", "terasort/hadoop/huge",
]
THRESHOLDS = (1.2, 1.1, 1.0)
SEEDS = range(8)  # Table II repetitions on the card (the paper averages 200)
PAPER_QUOTIENT = {1.2: 0.379, 1.1: 0.402, 1.0: 0.492}  # table2_iterations.py
CATALOG_N, CATALOG_D, CATALOG_B = 131072, 6, 24
KERNEL_CASES = [  # (name, n, d, capacity B, observed k)
    ("paper grid at exhaustion", 69, 4, 69, 40),
    ("n512", 512, 5, 10, 7),
    ("ragged, several tiles", 1500, 6, 24, 24),
    ("catalog", CATALOG_N, CATALOG_D, CATALOG_B, CATALOG_B),
    ("d=1", 200, 1, 12, 5),
    ("d=2", 300, 2, 8, 4),
    ("B=2", 130, 6, 2, 2),
    ("B=128 cap", 2000, 4, 128, 100),
]
# The kernel's shape on each path that runs it: (n, d, capacity B,
# observed k) of the timing case.
PATH_SHAPES = {
    "pipeline": (69, 4, 69, 40),
    "catalog": (CATALOG_N, CATALOG_D, CATALOG_B, CATALOG_B),
    "fixture": (512, 5, 10, 7),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _device_events(prof):
    """(name, device µs) of each kernel in a `torch.profiler` run.  Only the
    device-side events count: the CPU op that launched a kernel carries its
    time too, and summing both would count it twice."""
    from torch.autograd import DeviceType

    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            t = getattr(evt, "self_device_time_total", None)
            yield evt.key, (t if t is not None else evt.self_cuda_time_total)


def device_ms(fn, kernel_names=None, reps: int = 20):
    """Device time per call of ``fn`` from `torch.profiler`: the kernels whose
    names contain one of ``kernel_names`` (None: every kernel).  None when
    the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(t for name, t in _device_events(prof)
                if kernel_names is None or any(k in name for k in kernel_names))
    return total / reps / 1e3 if total > 0 else None


def ei_argmax_bound(n_live: int, n: int, d: int, b: int) -> dict:
    """Least time for one EI/argmax call: bytes moved (each input read once,
    each output written once) over HBM bandwidth, and FP32 operations on
    the ``n_live`` unmasked candidates over the FP32 peak.  Per candidate
    and training slot: the d-term dot (2d), the distance and Matérn
    rescale (21, counting exp, sqrt and division as one each), and the
    forward-substitution row (2 per earlier slot, B(B-1) in all); per
    candidate, its norm (2d) and the EI tail (20)."""
    nbytes = 4 * n * d + n + 4 * (b * d + 2 * b + b * b + 4) + 8
    flops = n_live * (b * (2 * d + 21) + b * (b - 1) + 2 * d + 20)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_PER_S * 1e3
    return {
        "bytes": nbytes, "flops": flops,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


# ---------------------------------------------------------------- phase 1


def kernel_case(dev, seed, n, d, cap, k, *, garbage=False):
    """A packed BO-step instance on ``dev``: the head's outputs and the
    tail's inputs, each with a job axis of 1."""
    import torch

    from repro_torch.core import fast_bo
    from repro_torch.core.gp import pairwise_sqdist

    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sum(enc**2, -1) + 0.3 * rng.normal(size=n)).astype(np.float32)
    picks = rng.choice(n, size=k, replace=False)
    tried = np.full(cap, -1, np.int32)
    tried[:k] = picks
    py = np.zeros(cap, np.float32)
    py[:k] = y[picks]
    feats = enc[np.maximum(tried, 0)]
    if garbage:  # finite garbage in the padded packed slots
        g = np.random.default_rng(99)
        tried[k:] = g.integers(0, n, size=cap - k)
        py[k:] = 1e6 * g.standard_normal(cap - k)
        feats[k:] = 1e6 * g.standard_normal((cap - k, d))
    mask = np.ones(n, bool)
    mask[picks] = False

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)[None]

    enc_t, feats_t, tried_t, py_t = T(enc), T(feats), T(tried), T(py)
    idx = tried_t.clamp_min(0).long()[..., None].expand(-1, -1, d)
    d2_bb = pairwise_sqdist(feats_t, torch.gather(enc_t, 1, idx))
    t = torch.tensor([k], dtype=torch.int32, device=dev)
    pm, best, ls, chol, alpha, y_mean, y_std = fast_bo._packed_head(d2_bb, py_t, t)
    return types.SimpleNamespace(
        enc=enc_t, mask=T(mask), feats=feats_t, pm=pm, alpha=alpha, chol=chol,
        ls=ls, y_mean=y_mean, y_std=y_std, best=best,
    )


def tail_args(c):
    return (c.enc, c.mask, c.feats, c.pm, c.alpha, c.chol, c.ls, c.y_mean,
            c.y_std, c.best)


def full_ei(c):
    from repro_torch.core.gp import pairwise_sqdist
    from repro_torch.kernels.ei_argmax.tile import ei_from_sqdist

    return ei_from_sqdist(
        pairwise_sqdist(c.feats, c.enc), c.pm, c.alpha, c.chol, c.ls,
        c.y_mean, c.y_std, c.best, c.mask,
    )[0].cpu().numpy()


def phase_kernel(dev, report) -> dict:
    import torch

    from repro_torch.kernels.ei_argmax.ops import ei_argmax, ei_argmax_plain
    from repro_torch.testing import EI_ATOL, EI_RTOL, assert_close, pick_agrees

    print(f"phase 1: kernel vs plain version on the card "
          f"(max EI: rtol={EI_RTOL} atol={EI_ATOL}; pick: equal or an EI tie "
          f"within that tolerance)")
    errs = {}

    def check(name, c, *, plain_tile=None, expect_idx=None):
        k_idx, k_val = ei_argmax(*tail_args(c))
        p_idx, p_val = ei_argmax_plain(*tail_args(c), tile=plain_tile)
        torch.cuda.synchronize()
        ki, pi = int(k_idx[0]), int(p_idx[0])
        kv, pv = float(k_val[0]), float(p_val[0])
        err = assert_close(pv, kv, rtol=EI_RTOL, atol=EI_ATOL, what=f"{name} max EI")
        errs[name] = err
        if not pick_agrees(pi, ki, full_ei(c)):
            raise AssertionError(f"{name}: kernel pick {ki} vs plain {pi}, not a tie")
        if expect_idx is not None and ki != expect_idx:
            raise AssertionError(f"{name}: kernel pick {ki}, expected {expect_idx}")
        print(f"  {name:26s} kernel ({ki}, {kv!r})  plain ({pi}, {pv!r})  |dEI| {err:.3e}")
        return ki, kv

    for i, (name, n, d, cap, k) in enumerate(KERNEL_CASES):
        check(f"{name} n={n} d={d} B={cap}", kernel_case(dev, i, n, d, cap, k))

    # A cross-tile tie: a clone of the winning column three kernel blocks
    # away computes the same bits; the lower index must win.
    c = kernel_case(dev, 40, 2048, 3, 12, 6)
    j1 = int(ei_argmax(*tail_args(c))[0][0])
    j2 = j1 - 768 if j1 >= 768 else j1 + 768
    c.enc[0, j2] = c.enc[0, j1]
    c.mask[0, j2] = True
    check("cross-tile tie", c, plain_tile=256, expect_idx=min(j1, j2))

    c = kernel_case(dev, 41, 1024, 3, 8, 8)
    c.mask.zero_()
    ki, kv = check("all masked", c, expect_idx=0)
    if kv != float("-inf"):
        raise AssertionError(f"all-masked pool gave max EI {kv!r}, expected -inf")

    clean = kernel_case(dev, 42, 400, 4, 20, 7)
    dirty = kernel_case(dev, 42, 400, 4, 20, 7, garbage=True)
    kc = check("clean padded slots", clean)
    kd = check("garbage in padded slots", dirty)
    if kc != kd:
        raise AssertionError(f"garbage in padded slots moved the kernel: {kc} vs {kd}")

    times = {}
    for path, (n, d, cap, k) in PATH_SHAPES.items():
        c = kernel_case(dev, 7, n, d, cap, k)
        check(f"{path} timing case", c)
        ms = cuda_time_ms(lambda: ei_argmax(*tail_args(c)))
        plain_ms = cuda_time_ms(lambda: ei_argmax_plain(*tail_args(c)))
        k_dev = device_ms(lambda: ei_argmax(*tail_args(c)),
                          ("ei_tile_kernel", "ei_reduce_kernel"))
        p_dev = device_ms(lambda: ei_argmax_plain(*tail_args(c)))
        bound = ei_argmax_bound(int(c.mask.sum()), n, d, cap)
        times[path] = dict(shape=f"n={n} d={d} B={cap}", ms=ms, plain_ms=plain_ms,
                           device_ms=k_dev, plain_device_ms=p_dev,
                           max_abs_err=errs[f"{path} timing case"], **bound)
        print(f"  time, {path} shape n={n} d={d} B={cap}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (CUDA events around one call, median of 30); "
              f"profiler device time per call: kernel {k_dev} ms, plain {p_dev} ms; "
              f"bound {bound['bound_ms']:.6f} ms ({bound['bound_by']}; "
              f"{bound['bytes']} B, {bound['flops']} flop)")
    report["kernel_max_abs_err"] = max(errs.values())
    report["kernel_times"] = times
    return times


# ---------------------------------------------------------------- phase 2


def bo_steps(trace, n_prio: int) -> int:
    """BO steps a to-exhaustion search ran: every trial after the init picks."""
    return len(trace.tried) - min(3, n_prio)


def phase_pipeline(dev, seeds, report) -> int:
    from repro_torch.cluster.simulator import ClusterSimulator
    from repro_torch.core.bayesopt import cherrypick_search, ruya_search, trial_budget, BOSettings
    from repro_torch.core.profiler import profile_job
    from repro_torch.core.search_space import split_search_space
    from repro_torch.core.tuner import run_ruya
    from repro_torch.kernels.ei_argmax.kernel import ei_argmax_cuda
    from repro_torch.testing import compare_traces, port_ei_at

    print(f"phase 2: paper pipeline on the card, {len(JOB_ORDER)} Table II jobs "
          f"x seeds {list(seeds)}, fused vs feature layout")
    fused_steps = 0
    full = ties = 0
    tie_notes = []
    rows = []
    t0 = time.perf_counter()
    ei_argmax_cuda.launches = 0
    for key in JOB_ORDER:
        sim = ClusterSimulator.for_job(key)
        size = sim.job.input_gb * GiB
        prof = profile_job(sim.profile_run_fn(), size)
        prio, rest = split_search_space(sim.space, prof.model, size,
                                        per_node_overhead=0.5 * GiB)
        enc = sim.space.encoded()
        n = len(sim.space)
        cap_ruya = trial_budget(len(prio), len(rest), BOSettings())
        ruya, cp = [], []
        for s in seeds:
            rf = ruya_search(sim.space, sim.cost_fn(), np.random.default_rng(s),
                             prio, rest, to_exhaustion=True, layout="fused", device=dev)
            cf = cherrypick_search(sim.space, sim.cost_fn(), np.random.default_rng(s),
                                   to_exhaustion=True, layout="fused", device=dev)
            rep = run_ruya(profile_run=sim.profile_run_fn(), full_input_size=size,
                           space=sim.space, cost_fn=sim.cost_fn(),
                           rng=np.random.default_rng(s), per_node_overhead=0.5 * GiB,
                           to_exhaustion=True, device=dev)
            cx = cherrypick_search(sim.space, sim.cost_fn(), np.random.default_rng(s),
                                   to_exhaustion=True, layout="feature", device=dev)
            if (list(rep.priority), list(rep.remaining)) != (prio, rest):
                raise AssertionError(f"{key}: run_ruya split differs from the fused run's")
            fused_steps += bo_steps(rf, len(prio)) + bo_steps(cf, n)
            for ref, got, pools, cap, n_init in (
                (rep.trace, rf, [prio, rest] if rest else [prio], cap_ruya, min(3, len(prio))),
                (cx, cf, [list(range(n))], n, min(3, n)),
            ):
                if not np.all(np.isfinite(got.costs)) or len(got.tried) != n:
                    raise AssertionError(f"{key} seed {s}: bad fused trace")
                cmp = compare_traces(ref, got, port_ei_at(enc, pools, cap, ref, dev),
                                     first_bo_step=n_init)
                if cmp.full:
                    full += 1
                else:
                    ties += 1
                    tie_notes.append(f"{key} seed {s}: {cmp.detail}")
            ruya.append(rf)
            cp.append(cf)
        row = {"job": key, "category": prof.model.category.value}
        for th in THRESHOLDS:
            row[f"ruya_{th}"] = mean_iterations_until(ruya, th)
            row[f"cp_{th}"] = mean_iterations_until(cp, th)
        rows.append(row)
        print(f"  {key:26s} ({row['category']:7s}) "
              + " ".join(f"c<={th}: {row[f'ruya_{th}']:5.2f}/{row[f'cp_{th}']:5.2f}"
                         for th in THRESHOLDS))
    seconds = time.perf_counter() - t0
    launches = ei_argmax_cuda.launches
    print(f"  traces held fused vs feature: {full} match in full, {ties} end at a "
          f"certified float32 tie (reported, not counted as matches)")
    for note in tie_notes[:8]:
        print(f"    tie: {note}")
    quot = {}
    for th in THRESHOLDS:
        ru = float(np.mean([r[f"ruya_{th}"] for r in rows]))
        cpm = float(np.mean([r[f"cp_{th}"] for r in rows]))
        quot[th] = ru / cpm
        print(f"  Table II c<={th}: Ruya {ru:.3f} / CherryPick {cpm:.3f} iterations = "
              f"{quot[th]:.3f} (paper {PAPER_QUOTIENT[th]})")
    print(f"  kernel launches {launches} over {fused_steps} fused BO steps; "
          f"pipeline wall time {seconds:.1f} s")
    if launches != fused_steps:
        raise AssertionError(f"kernel launched {launches} times for {fused_steps} fused BO steps")
    if full == 0:
        raise AssertionError("no fused trace matched its feature trace in full")
    if not all(q < 1.0 for q in quot.values()):
        raise AssertionError(f"Ruya does not beat CherryPick on the mean row: {quot}")
    report["pipeline"] = {
        "seeds": list(seeds), "full_matches": full, "tie_ends": ties,
        "quotients": {str(k): v for k, v in quot.items()}, "rows": rows,
        "fused_bo_steps": fused_steps, "launches": launches, "seconds": seconds,
    }
    return launches


def mean_iterations_until(traces, threshold: float) -> float:
    vals = []
    for t in traces:
        it = t.iterations_until(threshold)
        vals.append(it if it is not None else len(t.tried) + 1)
    return float(np.mean(vals))


# ---------------------------------------------------------------- phase 3


def synth_space(n: int, d: int, seed: int, mem_unit: float):
    """The repo's synthetic space and cost table, on the same RNG stream as
    `benchmarks/fleet_bench.py::synthetic_space` (seed 7, memory unit 1)
    and `tests/golden/scenarios.py::synth_space_table` (seed 0, unit GiB)."""
    from repro_torch.core.search_space import Configuration, SearchSpace

    rng = np.random.default_rng(seed + n)
    feats = rng.normal(size=(n, d))
    space = SearchSpace([
        Configuration(name=f"s{i}", features=tuple(float(v) for v in feats[i]),
                      total_memory=float(i) * mem_unit)
        for i in range(n)
    ])
    w = rng.normal(size=d)
    z = feats @ w
    z = (z - z.mean()) / max(float(z.std()), 1e-9)
    return space, 1.0 + (z - 0.7) ** 2 + 0.05 * rng.random(n)


def phase_catalog(dev, report) -> int:
    import torch

    from repro_torch.core.bayesopt import BOSettings, cherrypick_search
    from repro_torch.kernels.ei_argmax.kernel import ei_argmax_cuda

    n, d, b = CATALOG_N, CATALOG_D, CATALOG_B
    print(f"phase 3: catalog scale, CherryPick over n={n} d={d}, "
          f"BOSettings(max_iters={b}), run to the budget")
    space, table = synth_space(n, d, seed=7, mem_unit=1.0)
    stamps = []

    def cost_fn(i):
        stamps.append(time.perf_counter())
        return float(table[i])

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ei_argmax_cuda.launches = 0
    trace = cherrypick_search(space, cost_fn, np.random.default_rng(0),
                              settings=BOSettings(max_iters=b), to_exhaustion=True,
                              layout="fused", device=dev)
    torch.cuda.synchronize()
    launches = ei_argmax_cuda.launches
    steps = bo_steps(trace, n)
    peak = torch.cuda.max_memory_allocated() - before
    # The probe's resident state: encoding, zero cost table, the pool, the
    # remaining-pool and observation masks, and the (B,·) packed buffers.
    resident = n * d * 4 + n * 4 + 3 * n + b * (4 + 4 + 4 * d)
    transient = peak - resident
    steps_ms = np.diff(stamps[3:]) * 1e3  # one BO step between observations
    block = 4 * b * n
    print(f"  {len(trace.tried)} trials, best {min(trace.costs):.4f}; BO step median "
          f"{np.median(steps_ms):.3f} ms (min {steps_ms.min():.3f}, max {steps_ms.max():.3f}, "
          f"{len(steps_ms)} steps)")
    print(f"  peak allocated {peak} B over the start; resident state {resident} B; "
          f"transient {transient} B vs a (B,n) f32 block of {block} B")
    print(f"  kernel launches {launches} over {steps} fused BO steps")
    if len(trace.tried) != b or not np.all(np.isfinite(trace.costs)):
        raise AssertionError("catalog search did not run its 24 finite trials")
    if launches != steps:
        raise AssertionError(f"kernel launched {launches} times for {steps} fused BO steps")
    if transient > block / 4:
        raise AssertionError(f"catalog transient {transient} B is not far below {block} B")
    report["catalog"] = {
        "step_ms_median": float(np.median(steps_ms)), "steps": len(steps_ms),
        "peak_bytes": int(peak), "resident_bytes": resident,
        "transient_bytes": int(transient), "block_bytes": block,
        "fused_bo_steps": steps, "launches": launches,
    }
    report["catalog"]["step_breakdown"] = step_breakdown(dev, space, trace)
    return launches


def step_breakdown(dev, space, trace, steps: int = 10) -> dict:
    """Replays BO steps of ``trace`` under `torch.profiler`: wall time per
    step, device busy time per step, the EI/argmax kernel's share, and the
    device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.fast_bo import SequentialProbe

    probe = SequentialProbe(space.encoded(), len(trace.tried), layout="fused", device=dev)
    probe.set_pool(np.ones(len(space), bool))
    obs = np.zeros(len(space), bool)
    obs[trace.tried[:3]] = True
    probe.start(obs, trace.tried[:3], trace.costs[:3])
    probe.step(trace.costs[2])  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            probe.step(1.0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    busy = kern = 0.0
    by_name = {}
    for name, t in _device_events(prof):
        busy += t
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + t / steps / 1e3
        if "ei_tile_kernel" in name or "ei_reduce_kernel" in name:
            kern += t
    host = sorted(((evt.self_cpu_time_total / steps / 1e3, evt.key) for evt in
                   prof.key_averages() if evt.key.startswith("aten::")), reverse=True)[:6]
    busy_ms, kern_ms = busy / steps / 1e3, kern / steps / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    print(f"  profiled step: wall {wall:.3f} ms, device busy {busy_ms:.4f} ms "
          f"(idle share {1 - busy_ms / wall:.3f}), EI/argmax kernel {kern_ms:.4f} ms")
    for name, ms in top.items():
        print(f"    device {ms:.4f} ms  {name}")
    for ms, name in host:
        print(f"    host   {ms:.4f} ms  {name}")
    return {"wall_ms": wall, "device_busy_ms": busy_ms, "kernel_ms": kern_ms,
            "idle_share": 1 - busy_ms / wall, "top_kernels_ms": top,
            "top_host_ops_ms": {name: ms for ms, name in host}}


# ---------------------------------------------------------------- phase 4


def fixture_traces(path: Path):
    data = json.loads(path.read_text())
    return [
        types.SimpleNamespace(
            tried=[r["index"] for r in o["records"]],
            costs=[r["cost"] for r in o["records"]],
            stop_iteration=o["stop_iteration"],
            phase_boundary=o["phase_boundary"],
        )
        for o in data["outcomes"]
    ]


def phase_fixture(dev, report) -> int:
    from repro_torch.core.bayesopt import BOSettings, ruya_search, trial_budget
    from repro_torch.kernels.ei_argmax.kernel import ei_argmax_cuda
    from repro_torch.testing import compare_traces, port_ei_at

    path = ROOT / "tests" / "golden" / "n512-budgeted.json"
    print(f"phase 4: {path.relative_to(ROOT)} replayed on the card (fused layout)")
    space, table = synth_space(512, 5, seed=0, mem_unit=GiB)
    st = BOSettings(max_iters=10)
    prio, rest = list(range(50)), list(range(50, 512))
    cap = trial_budget(len(prio), len(rest), st)
    full = ties = steps = 0
    ei_argmax_cuda.launches = 0
    for s, ref in enumerate(fixture_traces(path)):
        got = ruya_search(space, lambda i: float(table[i]), np.random.default_rng(s),
                          prio, rest, settings=st, to_exhaustion=True,
                          layout="fused", device=dev)
        steps += bo_steps(got, len(prio))
        cmp = compare_traces(ref, got, port_ei_at(space.encoded(), [prio, rest], cap, ref, dev),
                             first_bo_step=3)
        full += cmp.full
        ties += not cmp.full
        print(f"  seed {s}: {'matches' if cmp.full else cmp.detail} ({cmp.steps} trials)")
    launches = ei_argmax_cuda.launches
    print(f"  kernel launches {launches} over {steps} fused BO steps")
    if launches != steps:
        raise AssertionError(f"kernel launched {launches} times for {steps} fused BO steps")
    if full == 0:
        raise AssertionError("no n512-budgeted trace matched the fixture in full")
    report["fixture"] = {"full_matches": full, "tie_ends": ties,
                         "fused_bo_steps": steps, "launches": launches}
    return launches


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None, help="also write the report JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from repro_torch.device import resolve_device
        from repro_torch.kernels import build
        from repro_torch.kernels.ei_argmax import kernel as ei_kernel
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script ({e})", file=sys.stderr)
        return 2

    dev = resolve_device("cuda")  # also pins float32 matmuls (no TF32)
    card = card_line()
    print(f"phase 0: card {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    t0 = time.perf_counter()
    ei_kernel.load()
    print(f"  ei_argmax kernel built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in build.build_log("ei_argmax").splitlines():
        if "registers" in line or "spill" in line or "built in" in line:
            print(f"    {line.strip()}")

    report = {"card": card}
    failed = []
    times, launches = None, {}
    for name, phase in (
        ("kernel", lambda: phase_kernel(dev, report)),
        ("pipeline", lambda: phase_pipeline(dev, SEEDS, report)),
        ("catalog", lambda: phase_catalog(dev, report)),
        ("fixture", lambda: phase_fixture(dev, report)),
    ):
        try:
            out = phase()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            print(f"  FAILED: phase {name}")
            failed.append(name)
            continue
        if name == "kernel":
            times = out
        else:
            launches[name] = out
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1

    # One entry per path that runs the kernel: that path's launches beside
    # the kernel's numbers at that path's shape.
    kernels = [{
        "name": "ei_argmax",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ei_argmax/csrc/ei_argmax.cu",
        "replaces": "src/repro/kernels/ei_argmax/kernel.py:110",
        "path": path,
        "shape": t["shape"],
        "launches": launches[path],
        "max_abs_err": t["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "device_ms": t["device_ms"],
        "plain_device_ms": t["plain_device_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
    } for path, t in times.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
