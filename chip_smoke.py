#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Phases, each reported on its own lines:

  0. set-up: the card's name and power limit, and the builds of the CUDA
     kernels (EI/argmax from `src/repro_torch/kernels/ei_argmax/csrc/`,
     flash attention's CUDA-core and tensor-core kernels from
     `src/repro_torch/kernels/flash_attention/csrc/`,
     the SSD intra-chunk term from `src/repro_torch/kernels/ssd/csrc/`,
     RMSNorm from `src/repro_torch/kernels/rmsnorm/csrc/`), one `nvcc`
     each, started together, with the registers, spills and `cuobjdump`
     instruction counts (HGMMA, UTMALDG, LDL, STL) of the EI/argmax, flash
     and SSD kernels;
  1. the EI/argmax kernel against its plain PyTorch version on the card,
     over the shapes of the main path, each register bucket at its edge,
     B = 129, 256 and 1000 and d = 33 and 64 (the blocked route), two
     crowded pools and the edge cases, some also through the blocked route
     forced, with both timed at the shape of each of the paths below and
     at the catalog with B = 256 (`cuda_time_ms` and `graph_ms`), and the
     blocked route forced timed beside the register route where that ran;
  2. the paper's pipeline on the card (profiling → memory model → split →
     two-phase GP+EI search) for the 16 Table II jobs: fused-layout Ruya
     and CherryPick held against the feature layout and `run_ruya`, and
     the Table II quotients;
  3. the catalog scale: CherryPick over a 131072-configuration space, with
     a profiled breakdown of one BO step;
  4. the `n512-budgeted` golden fixture, replayed on the card;
  5. the flash-attention kernels against their plain PyTorch version on
     the card, at the shapes of `tests/test_kernels.py` and at the Qwen3-8B
     forward's shape, each in float32 (the CUDA-core kernel) and bfloat16
     (the tensor-core kernel), each call held to the route it must take;
     at the forward shape each kernel, the plain version and
     `scaled_dot_product_attention` (the library yardstick, which the port
     never calls) are timed, and the float32 op is driven once as the
     CUDA-core kernel's path;
  6. the Qwen3-8B teacher-forced forward at full width and depth (36
     layers, float32 parameters drawn on the card from a seed, bfloat16
     compute, B=1, T=4096), held against the same parameters run through
     the dense attention route, with layer 0's kernel output held against
     the plain version on that layer's own q, k and v;
  7. serving Qwen3-8B at full width through `repro_torch.launch.serve`:
     batch 4, Zipf prompts of 512 tokens, 64 greedy new tokens, cache
     length 1024, the tokens held against the teacher-forced forward's
     argmax under the tie rule of `repro_torch.testing`;
  8. the SSD intra-chunk kernel against its plain PyTorch version on the
     card, at the shapes of `tests/test_kernels.py`, the smoke model's
     chunk, ragged shapes, Q = 512 with N = 192 and P = 96, B and C per
     group (G = 1, 2 and 3, as the model passes them), bfloat16-valued
     inputs, and the shapes of phases 9, 10 and 13, timed there with
     bfloat16-valued x, B and C (as the model gives them) and with float32
     values;
  9. the mamba2-370m teacher-forced forward at full width and depth (48
     layers, float32 parameters drawn on the card from a seed, bfloat16
     compute, B=1, T=32768), held against the same parameters run through
     `ssm_apply`'s einsum route, with layer 0's kernel output held against
     the plain version on that layer's own inputs;
 10. serving mamba2-370m through `repro_torch.launch.serve`: batch 8, Zipf
     prompts of 2048 tokens, 64 greedy new tokens, the tokens held against
     the teacher-forced forward's argmax (T = 2111, so the padding to a
     chunk multiple runs) under the tie rule;
 11. the RMSNorm kernel against its plain PyTorch version on the card, at
     the shapes of `tests/test_kernels.py` and at (4096, 1024) and
     (16384, 4096) in float32 and bfloat16, and its gradient through the op
     against the oracle's; the op (its path) is driven once at each of the
     last three shapes, and timed there beside its plain version and
     `torch.nn.functional.rms_norm` (the library yardstick, which the port
     never calls), also with the L2 cache flushed before each call;
 12. Qwen3-8B training at full width with 8 of its 36 layers (float32
     parameters drawn on the card from a seed, bfloat16 compute, AdamW,
     remat "full", global batch 2 x 4096 tokens in 2 microbatches) through
     `make_train_step` and `TrainLoop` for 3 steps, checkpointing at step 2
     into a temporary directory: the first step held against the dense
     attention route's, the restore of the step-2 checkpoint held bit for
     bit and its step 3 against the uninterrupted one, and one more step
     under the profiler;
 13. mamba2-370m training at full width and depth (global batch 4 x 4096
     tokens in 2 microbatches), the same checks with the einsum route of
     the SSD term as the other side;
 14. the fleet on the card (`repro_torch.fleet`), run right after phase 4
     because it holds its traces against phases 2 and 4: (a) the device split
     (`split_masks_device`) equal to the host split's lists for the 16
     paper jobs and for five memory models over the 131072-configuration
     catalog, both timed; (b) Table II through `tune_fleet`, 16 jobs x
     seeds 0-7, both modes, to exhaustion, in the fused layout (and seeds
     0-1 in the feature and gather layouts), each trace held against phase
     2's sequential one and the quotients against phase 2's; (c) 64
     CherryPick jobs over the catalog (eight chunks of eight) through a
     `TuningSession`, one job of each chunk held against a sequential
     search, ms per chunk step and per job-step, a profiled window, peak
     memory; (d) `n512-budgeted` through a session, feature then fused
     layout, held to the fixture; (e) `benchmarks/fleet_bench.py`'s
     warm-start stream (64 paper jobs in 8 waves, a `ProfileCache`), run
     twice and required identical; (f) `run_ruya` and `run_cherrypick` with
     ``cost_table=``; and the EI/argmax kernel at J = 8 rows, at the shapes
     of (b) and (c), against its plain version and timed.

Phases 2-4 and 14 are the paths that run the EI/argmax kernel, phases 6 and
12 the paths that run the tensor-core flash-attention kernel (the bfloat16
models; the CUDA-core one must not run there), phase 5's float32 op the
path of the CUDA-core one, phases 9, 10 and 13 the paths that run the SSD
kernel, phase 11 the RMSNorm op.  Each sets the launch counts to 0 just
before its run, reads them just after, and fails unless its kernel ran
exactly once per fused BO step (phases 2-4), once per lockstep chunk step
of a fused fleet (phase 14: one launch for all the chunk's rows), once
per layer of each forward (phases 6 and 9), once per layer of the prefill
and never in a decode step (phase 10), once per call of the op (phases 5
and 11), or
twice per layer and microbatch of a training step, in the forward and in
the remat recompute (phases 12 and 13).  Qwen3 serving runs no kernel,
as in the reference (prefill and decode attend through the cache); phase 7
checks that too.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

GiB = 1024.0**3
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and FP32 outside
# the tensor cores, both at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12  # tensor cores, dense
PEAK_TF32_PER_S = 495e12  # tensor cores, dense

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
    ("B=16, bucket edge", 500, 4, 16, 12),
    ("B=32, bucket edge", 800, 5, 32, 30),
    ("B=64, bucket edge", 1200, 6, 64, 50),
    # Past the register buckets, k < B so that the padded slots are live.
    ("B=65, blocked", 1200, 6, 65, 50),
    ("B=128, the old cap", 2000, 4, 128, 100),
    ("B=129, blocked", 3000, 5, 129, 100),
    ("B=256, blocked", 4000, 6, 256, 160),
    ("B=1000, blocked", 5000, 6, 1000, 150),
    ("d=33, blocked", 2000, 33, 24, 20),
    ("d=64, blocked", 3000, 64, 40, 30),
]
# Crowded pools: so many observations among the candidates that 1 - |v|^2
# cancels, and a float32 evaluation of the posterior strays from a float64
# one by more than EI_RTOL through the float32 triangular solve, whatever
# its order (the kernel's row-by-row substitution, torch's blocked solve),
# so two such evaluations part by more than EI_RTOL by themselves.  The
# kernel and the plain version sum mean and |v|^2 in float64
# (`tile.ei_from_sqdist`), which leaves only the solve's error.  So each is
# held to the float64 evaluation: its pick a tie of that argmax under the
# EI tolerance, and its max EI within CROWDED_RTOL = 10 EI_RTOL, twice the
# float32 solve's error of about 1e-3 at these pools (this phase prints
# both distances).
# (seed, name, n, d, capacity B, observed k)
CROWDED_CASES = [(12, "B=256, 200 observed", 4000, 6, 256, 200),
                 (13, "B=1000, 900 observed", 5000, 6, 1000, 900),
                 (17, "B=256, 200 observed", 4000, 6, 256, 200),
                 (18, "B=1000, 900 observed", 5000, 6, 1000, 900)]
CROWDED_RTOL = 2e-3
# Cases run once more through the blocked route, which every register-route
# shape can also take: the two routes compute the same substitution.
BLOCKED_TOO = ("catalog", "B=16, bucket edge", "B=64, bucket edge")
EI_KERNEL_NAMES = ("ei_reg_kernel", "ei_blocked_kernel")  # the EI/argmax kernels' device names
# The kernel's shape on each path that runs it: (n, d, capacity B,
# observed k) of the timing case.
PATH_SHAPES = {
    "pipeline": (69, 4, 69, 40),
    "catalog": (CATALOG_N, CATALOG_D, CATALOG_B, CATALOG_B),
    "fixture": (512, 5, 10, 7),
}
# Timed beside the paths, on no path of its own: the catalog at a budget of
# 256 trials, which the blocked route takes.
EXTRA_SHAPES = {"catalog_b256": (CATALOG_N, CATALOG_D, 256, 256)}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name: the
    last of the nested names, and what follows it up to its parameters."""
    i, name = 3 if mangled.startswith("_ZN") else 2, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    rest = mangled[i:]
    if rest.startswith("I") and "Ev" in rest:
        name += f"<{rest[1:rest.index('Ev')].rstrip('E')}>"
    return name


def sass_counts(so: str) -> dict:
    """Per kernel of a built library, its count of tensor-core products
    (HGMMA), TMA loads (UTMALDG) and local-memory loads and stores (LDL,
    STL: spills), from `cuobjdump -sass`."""
    from repro_torch.kernels.build import find_nvcc

    tool = Path(find_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", so], capture_output=True, text=True, timeout=120,
                         check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = kernel_name(line.split("Function :")[1].strip())
            counts[fn] = {"HGMMA": 0, "UTMALDG": 0, "LDL": 0, "STL": 0}
        elif fn is not None and "*/" in line:
            words = [w for w in line.split("*/", 1)[1].split() if not w.startswith("@")]
            op = words[0].split(".")[0] if words else ""
            if op in counts[fn]:
                counts[fn][op] += 1
    return counts


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


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, the graph replayed ``reps`` times, each replay timed by CUDA
    events (median).  With the host out of the way this is the card's time
    for the work, plus the graph's gap between kernels (a microsecond or
    so each).  It replaces per-call `torch.profiler` sessions, which on the
    card come back with no device time once a process has run a few."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture: builds, workspaces
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return float(np.median(times))


def cold_graph_ms(fn, flush_bytes: int = 256 << 20) -> float:
    """Device time per call of ``fn`` with the card's 50 MB L2 cache flushed
    before each call, as a caller that finds its inputs cold sees it:
    `graph_ms` of (flush, call) less `graph_ms` of the flush alone, the
    flush a write of ``flush_bytes``."""
    import torch

    buf = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
    flush = buf.fill_

    def both():
        flush(1.0)
        fn()

    cold = graph_ms(both) - graph_ms(lambda: flush(1.0))
    del buf
    return cold


def _device_events(events):
    """(name, device µs) of each kernel in a `torch.profiler` run's
    ``key_averages()`` (taken once: on a long trace it takes seconds).  Only
    the device-side events count: the CPU op that launched a kernel carries
    its time too, and summing both would count it twice."""
    from torch.autograd import DeviceType

    for evt in events:
        if evt.device_type == DeviceType.CUDA:
            t = getattr(evt, "self_device_time_total", None)
            yield evt.key, (t if t is not None else evt.self_cuda_time_total)


def ei_argmax_bound(n_live: int, n: int, d: int, b: int, jobs: int = 1) -> dict:
    """Least time for one EI/argmax call over ``jobs`` rows of the job axis:
    bytes moved (each input read once, each output written once) over HBM
    bandwidth, and FP32 operations on the ``n_live`` unmasked candidates of
    all rows over the FP32 peak.  Per candidate and training slot: the
    d-term dot (2d), the distance and Matérn rescale (21, counting exp,
    sqrt and division as one each), and the forward-substitution row (2
    per earlier slot, B(B-1) in all); per candidate, its norm (2d) and the
    EI tail (20)."""
    nbytes = jobs * (4 * n * d + n + 4 * (b * d + 2 * b + b * b + 4) + 8)
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


def full_ei(c, dtype=None):
    """The EI of every candidate through the plain tail (in ``dtype`` if given)."""
    from repro_torch.core.gp import pairwise_sqdist
    from repro_torch.kernels.ei_argmax.tile import ei_from_sqdist

    a = [t.to(dtype) if dtype is not None and t.is_floating_point() else t for t in tail_args(c)]
    return ei_from_sqdist(pairwise_sqdist(a[2], a[0]), *a[3:], a[1])[0].cpu().numpy()


def phase_kernel(dev, report) -> dict:
    import torch

    from repro_torch.kernels.ei_argmax import kernel as ei_kernel
    from repro_torch.kernels.ei_argmax.kernel import ei_argmax_cuda
    from repro_torch.kernels.ei_argmax.ops import ei_argmax, ei_argmax_plain
    from repro_torch.testing import EI_ATOL, EI_RTOL, assert_close, pick_agrees

    print(f"phase 1: kernel vs plain version on the card "
          f"(max EI: rtol={EI_RTOL} atol={EI_ATOL}; pick: equal or an EI tie "
          f"within that tolerance)")
    errs = {}

    def blocked(c):  # the kernel's blocked route forced, as `ei_argmax` calls the kernel
        scal = torch.stack([c.ls, c.y_mean, c.y_std, c.best], -1)
        return ei_kernel._launch(c.enc, c.mask, c.feats, c.pm, c.alpha, c.chol, scal, 0.0,
                                 ei_kernel._BLOCKED)

    def check(name, c, *, plain_tile=None, expect_idx=None, route=None):
        before = ei_argmax_cuda.launches
        k_idx, k_val = ei_argmax(*tail_args(c)) if route is None else route(c)
        p_idx, p_val = ei_argmax_plain(*tail_args(c), tile=plain_tile)
        torch.cuda.synchronize()
        if ei_argmax_cuda.launches != before + 1:
            raise AssertionError(f"{name}: {ei_argmax_cuda.launches - before} launches counted")
        ki, pi = int(k_idx[0]), int(p_idx[0])
        kv, pv = float(k_val[0]), float(p_val[0])
        err = assert_close(pv, kv, rtol=EI_RTOL, atol=EI_ATOL, what=f"{name} max EI")
        errs[name] = err
        if not pick_agrees(pi, ki, full_ei(c)):
            raise AssertionError(f"{name}: kernel pick {ki} vs plain {pi}, not a tie")
        if expect_idx is not None and ki != expect_idx:
            raise AssertionError(f"{name}: kernel pick {ki}, expected {expect_idx}")
        print(f"  {name:46s} kernel ({ki}, {kv!r})  plain ({pi}, {pv!r})  |dEI| {err:.3e}")
        return ki, kv

    for i, (name, n, d, cap, k) in enumerate(KERNEL_CASES):
        c = kernel_case(dev, i, n, d, cap, k)
        check(f"{name} n={n} d={d} B={cap}", c)
        if name in BLOCKED_TOO:
            check(f"{name}, blocked route", c, route=blocked)

    for seed, name, n, d, cap, k in CROWDED_CASES:
        c = kernel_case(dev, seed, n, d, cap, k)
        before = ei_argmax_cuda.launches
        k_idx, k_val = ei_argmax(*tail_args(c))
        p_idx, p_val = ei_argmax_plain(*tail_args(c))
        torch.cuda.synchronize()
        if ei_argmax_cuda.launches != before + 1:
            raise AssertionError(f"{name}: {ei_argmax_cuda.launches - before} launches counted")
        e64 = full_ei(c, torch.float64)
        j, exact = int(np.argmax(e64)), float(np.max(e64))
        ki, kv, pi, pv = int(k_idx[0]), float(k_val[0]), int(p_idx[0]), float(p_val[0])
        for who, pick, val in (("kernel", ki, kv), ("plain", pi, pv)):
            if not pick_agrees(j, pick, e64):
                raise AssertionError(f"{name} seed {seed}: {who} pick {pick} vs float64 {j}, "
                                     f"not a tie")
            assert_close(exact, val, rtol=CROWDED_RTOL, atol=EI_ATOL,
                         what=f"{name} seed {seed} {who} max EI vs float64")
        errs[f"{name} seed {seed}"] = abs(kv - exact)
        print(f"  {name + f' seed {seed} n={n} d={d}':46s} kernel ({ki}, {kv!r})  plain ({pi}, "
              f"{pv!r})  float64 ({j}, {exact!r}): |kernel - float64| "
              f"{abs(kv - exact) / exact:.2e}, |plain - float64| {abs(pv - exact) / exact:.2e}, "
              f"|kernel - plain| {abs(kv - pv) / exact:.2e} (relative)")

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
    for path, (n, d, cap, k) in {**PATH_SHAPES, **EXTRA_SHAPES}.items():
        c = kernel_case(dev, 7, n, d, cap, k)
        check(f"{path} timing case", c)
        ms = cuda_time_ms(lambda: ei_argmax(*tail_args(c)))
        plain_ms = cuda_time_ms(lambda: ei_argmax_plain(*tail_args(c)))
        k_dev = graph_ms(lambda: ei_argmax(*tail_args(c)))
        p_dev = graph_ms(lambda: ei_argmax_plain(*tail_args(c)), calls=2)
        bound = ei_argmax_bound(int(c.mask.sum()), n, d, cap)
        times[path] = dict(shape=f"n={n} d={d} B={cap}", ms=ms, plain_ms=plain_ms,
                           device_ms=k_dev, plain_device_ms=p_dev,
                           max_abs_err=errs[f"{path} timing case"], **bound)
        print(f"  time, {path} shape n={n} d={d} B={cap}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (CUDA events around one call, median of 30); "
              f"device time per call (CUDA graph replay): kernel {k_dev:.4f} ms, plain "
              f"{p_dev:.4f} ms; "
              f"bound {bound['bound_ms']:.6f} ms ({bound['bound_by']}; "
              f"{bound['bytes']} B, {bound['flops']} flop)")
        if ei_kernel.load().ei_argmax_tile(n, d, cap, ei_kernel._REGISTERS) > 0:
            # The register route ran: the blocked route, which also takes
            # this shape, timed beside it.
            b_dev = graph_ms(lambda: blocked(c))
            times[path]["blocked_device_ms"] = b_dev
            print(f"    the blocked route forced at this shape: {b_dev:.4f} ms device "
                  f"({b_dev / k_dev:.2f}x the register route's)")
    report["kernel_max_abs_err"] = max(errs.values())
    report["kernel_times"] = times
    return {path: t for path, t in times.items() if path in PATH_SHAPES}


# ---------------------------------------------------------------- phase 2


def bo_steps(trace, n_prio: int) -> int:
    """BO steps a to-exhaustion search ran: every trial after the init picks."""
    return len(trace.tried) - min(3, n_prio)


def phase_pipeline(dev, seeds, report, traces) -> int:
    """Phase 2.  ``traces`` receives each search's trace under (job, seed,
    mode, layout) and each job's split under (job, "split"): phase 14 holds
    the fleet's traces against them."""
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
            traces.update({(key, s, "ruya", "fused"): rf, (key, s, "cherrypick", "fused"): cf,
                           (key, s, "ruya", "feature"): rep.trace,
                           (key, s, "cherrypick", "feature"): cx, (key, "split"): (prio, rest)})
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


def profiled_window(run, units: int):
    """``run()`` under `torch.profiler`, its times shared over ``units``
    steps: (wall ms, device busy ms, EI/argmax kernel ms, device ms by
    kernel name, the profiler's events), each per unit."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / units
    busy = kern = 0.0
    by_name = {}
    events = prof.key_averages()
    for name, t in _device_events(events):
        busy += t
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + t / units / 1e3
        if any(k in name for k in EI_KERNEL_NAMES):
            kern += t
    return wall, busy / units / 1e3, kern / units / 1e3, by_name, events


def step_breakdown(dev, space, trace, steps: int = 10) -> dict:
    """Replays BO steps of ``trace`` under `torch.profiler`: wall time per
    step, device busy time per step, the EI/argmax kernel's share, and the
    device's idle share."""
    from repro_torch.core.fast_bo import SequentialProbe

    probe = SequentialProbe(space.encoded(), len(trace.tried), layout="fused", device=dev)
    probe.set_pool(np.ones(len(space), bool))
    obs = np.zeros(len(space), bool)
    obs[trace.tried[:3]] = True
    probe.start(obs, trace.tried[:3], trace.costs[:3])
    probe.step(trace.costs[2])  # warm-up

    def run():
        for _ in range(steps):
            probe.step(1.0)

    wall, busy_ms, kern_ms, by_name, events = profiled_window(run, steps)
    host = sorted(((evt.self_cpu_time_total / steps / 1e3, evt.key) for evt in
                   events if evt.key.startswith("aten::")), reverse=True)[:6]
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


# ---------------------------------------------------------------- phase 14
#
# Runs right after phase 4 (its traces are held against phases 2 and 4);
# numbered after the model phases, which came first in the port.

FLEET_JOBS = 64  # benchmarks/fleet_bench.py's default --jobs
FLEET_WAVES = 8  # its streaming scenario's waves
FLEET_SHAPES = {  # K1 on the fleet's paths: (n, d, B, observed k) of a chunk's row
    "fleet_table2": (69, 4, 69, 40),
    "fleet_catalog": (CATALOG_N, CATALOG_D, CATALOG_B, CATALOG_B),
}
FLEET_ROWS = 8  # a full lockstep chunk (`repro_torch.fleet.batched_engine._CHUNK`)


class ChunkSteps:
    """Counts the lockstep chunk updates fleet sessions dispatch (each runs
    one BO step of every row of its chunk) by wrapping the session's update."""

    def __enter__(self):
        from repro_torch.fleet import session as mod

        self.mod, self.update, self.n = mod, mod._fleet_update, 0

        def counted(*args, **kw):
            self.n += 1
            return self.update(*args, **kw)

        mod._fleet_update = counted
        return self

    def __exit__(self, *exc):
        self.mod._fleet_update = self.update


def fleet_kernel_case(dev, shape, seed0):
    """K1's inputs for one full chunk: FLEET_ROWS packed states on the job
    axis, each from the port's own head."""
    import torch

    n, d, cap, k = shape
    rows = [kernel_case(dev, seed0 + j, n, d, cap, k) for j in range(FLEET_ROWS)]
    return types.SimpleNamespace(**{
        f: torch.cat([getattr(r, f) for r in rows]).contiguous()
        for f in ("enc", "mask", "feats", "pm", "alpha", "chol", "ls", "y_mean", "y_std", "best")
    })


def hold_fleet(ref, got, enc, pools, cap, dev, n_init):
    """(full match, detail) of a fleet trace against a sequential one."""
    from repro_torch.testing import compare_traces, port_ei_at

    cmp = compare_traces(ref, got, port_ei_at(enc, pools, cap, ref, dev), first_bo_step=n_init)
    return cmp.full, cmp.detail


def phase_fleet(dev, report, seq) -> dict:
    import torch

    from repro_torch.cluster.simulator import ClusterSimulator
    from repro_torch.core.bayesopt import BOSettings, cherrypick_search, trial_budget
    from repro_torch.core.memory_model import MemoryCategory, MemoryModel
    from repro_torch.core.profiler import profile_job
    from repro_torch.core.search_space import split_masks_device, split_search_space
    from repro_torch.core.tuner import run_cherrypick, run_ruya
    from repro_torch.fleet import FleetJob, ProfileCache, TuningSession, cluster_fleet, tune_fleet
    from repro_torch.kernels.ei_argmax.kernel import ei_argmax_cuda
    from repro_torch.kernels.ei_argmax.ops import ei_argmax, ei_argmax_plain
    from repro_torch.testing import EI_ATOL, EI_RTOL, assert_close, pick_agrees

    print(f"phase 14: the fleet on the card (TuningSession, tune_fleet; lockstep chunks of up "
          f"to {FLEET_ROWS} jobs, K1 at J = chunk rows)")
    out = {}
    t_phase = time.perf_counter()

    # (a) The device split, exactly equal to the host split's lists.
    def split_both(space, model, size, **kw):
        t0 = time.perf_counter()
        prio, rest = split_search_space(space, model, size, **kw)
        host_ms = (time.perf_counter() - t0) * 1e3
        times = []
        for _ in range(2):  # the first call pays the sort's set-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mask = split_masks_device(space, model, size, device=dev, **kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        mask = mask.cpu().numpy()
        if np.flatnonzero(mask).tolist() != prio or np.flatnonzero(~mask).tolist() != rest:
            raise AssertionError(f"device split differs from the host split ({model.category})")
        return len(prio), host_ms, times[-1]

    print("  (a) device split vs host split (mask == lists, exactly)")
    paper = [0.0, 0.0]
    for key in JOB_ORDER:
        sim = ClusterSimulator.for_job(key)
        size = sim.job.input_gb * GiB
        k, h_ms, d_ms = split_both(sim.space, profile_job(sim.profile_run_fn(), size).model,
                                   size, per_node_overhead=0.5 * GiB)
        paper[0] += h_ms
        paper[1] += d_ms
    print(f"    paper grid, 16 jobs: equal; host {paper[0]:.3f} ms, device {paper[1]:.3f} ms "
          f"in all")
    cat_space, cat_table = synth_space(CATALOG_N, CATALOG_D, seed=7, mem_unit=1.0)

    def mm(cat, slope=0.0, intercept=0.0):
        return MemoryModel(category=MemoryCategory(cat), slope=slope, intercept=intercept,
                           r2=1.0, sizes=(1.0,), readings=(5e4,))

    split_rows = {}
    for name, model, size, want in (
        ("FLAT", mm("flat"), 1.0, round(CATALOG_N / 7)),
        ("LINEAR, some qualify", mm("linear", 1.0), 5e4, None),
        ("LINEAR, none qualify (extremes)", mm("linear", 10.0), 1e5, 2 * round(0.15 * CATALOG_N)),
        ("LINEAR, all qualify", mm("linear", 1.0, -1.0), 0.0, CATALOG_N),
        ("UNCLEAR", mm("unclear"), 1.0, CATALOG_N),
    ):
        k, h_ms, d_ms = split_both(cat_space, model, size, per_node_overhead=0.5)
        if (want is not None and k != want) or not 0 < k <= CATALOG_N:
            raise AssertionError(f"catalog split {name}: {k} in the priority group, want {want}")
        split_rows[name] = {"priority": k, "host_ms": h_ms, "device_ms": d_ms}
        print(f"    catalog n={CATALOG_N}, {name}: {k} in the priority group, equal; host "
              f"{h_ms:.2f} ms, device {d_ms:.3f} ms")
    out["split"] = {"paper_host_ms": paper[0], "paper_device_ms": paper[1], "catalog": split_rows}

    # (b) Table II through tune_fleet, held against phase 2's sequential traces.
    jobs = cluster_fleet(JOB_ORDER)
    fleet = [j for j in jobs for _ in SEEDS]
    seeds = [s for _ in jobs for s in SEEDS]
    print(f"  (b) Table II through tune_fleet: {len(jobs)} jobs x seeds {list(SEEDS)}, to "
          f"exhaustion, both modes")
    table2 = {}
    rows = {key: {} for key in JOB_ORDER}
    launches_b = steps_b = 0
    for layout, run_seeds in (("fused", SEEDS), ("feature", (0, 1)), ("gather", (0, 1))):
        full = ties = 0
        notes = []
        table2[layout] = {}
        for mode in ("ruya", "cherrypick"):
            sel = [(j, s) for j, s in zip(fleet, seeds) if s in run_seeds]
            ei_argmax_cuda.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ChunkSteps() as cs:
                reps = tune_fleet([j for j, _ in sel], [np.random.default_rng(s) for _, s in sel],
                                  mode=mode, to_exhaustion=True, layout=layout, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ei_argmax_cuda.launches
            want = cs.n if layout == "fused" else 0
            if launches != want:
                raise AssertionError(f"{layout} {mode}: K1 launched {launches} times over "
                                     f"{cs.n} chunk steps")
            if layout == "fused":
                launches_b += launches
                steps_b += cs.n
                table2["fused"][mode] = {"chunk_steps": cs.n, "launches": launches,
                                         "seconds": wall, "ms_per_chunk_step": wall * 1e3 / cs.n}
            print(f"    {layout:7s} {mode:10s}: {len(sel)} searches in {cs.n} chunk steps, "
                  f"{wall:.2f} s ({wall * 1e3 / cs.n:.3f} ms a chunk step, wall); K1 launches "
                  f"{launches}")
            for (job, s), rep in zip(sel, reps):
                prio, rest = seq[(job.name, "split")]
                if mode == "cherrypick":
                    prio, rest = list(range(len(job.space))), []
                if (list(rep.priority), list(rep.remaining)) != (prio, rest):
                    raise AssertionError(f"{job.name}: the fleet's split differs from phase 2's")
                got = rep.trace
                if len(got.tried) != len(job.space) or not np.all(np.isfinite(got.costs)):
                    raise AssertionError(f"{job.name} seed {s} {mode}: bad fleet trace")
                ref = seq[(job.name, s, mode, "feature" if layout == "feature" else "fused")]
                pools = [prio, rest] if rest else [prio]
                ok, detail = hold_fleet(ref, got, job.space.encoded(), pools,
                                        trial_budget(len(prio), len(rest), BOSettings()),
                                        dev, min(3, len(prio)))
                full += ok
                ties += not ok
                if not ok:
                    notes.append(f"{job.name} seed {s} {mode}: {detail}")
                if layout == "fused":
                    rows[job.name].setdefault(mode, []).append(got)
        print(f"    {layout}: {full} traces match phase 2's in full, {ties} end at a certified "
              f"tie")
        for note in notes[:4]:
            print(f"      tie: {note}")
        if full == 0:
            raise AssertionError(f"no {layout} fleet trace matched phase 2's in full")
        table2[layout].update(full_matches=full, tie_ends=ties)
    quot = {}
    for th in THRESHOLDS:
        ru = float(np.mean([mean_iterations_until(rows[k]["ruya"], th) for k in JOB_ORDER]))
        cp = float(np.mean([mean_iterations_until(rows[k]["cherrypick"], th) for k in JOB_ORDER]))
        quot[th] = ru / cp
    seq_quot = report.get("pipeline", {}).get("quotients", {})
    print("    Table II through the fleet: " + ", ".join(
        f"c<={th}: {quot[th]:.3f} (phase 2: {seq_quot.get(str(th), float('nan')):.3f})"
        for th in THRESHOLDS))
    moved = any(abs(quot[th] - seq_quot.get(str(th), quot[th])) > 0 for th in THRESHOLDS)
    if moved and table2["fused"]["tie_ends"] == 0:
        raise AssertionError(f"the fleet's quotients {quot} differ from phase 2's {seq_quot} "
                             f"with every trace a full match")
    table2["quotients"] = {str(k): v for k, v in quot.items()}
    out["table2"] = table2

    # (c) The catalog fleet: 64 CherryPick jobs, eight chunks of eight.
    st = BOSettings(max_iters=CATALOG_B)
    print(f"  (c) catalog fleet: {FLEET_JOBS} CherryPick jobs over n={CATALOG_N} d={CATALOG_D}, "
          f"max_iters={CATALOG_B}, seeds 0-{FLEET_JOBS - 1}, fused, to the budget")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    session = TuningSession(settings=st, mode="cherrypick", warm_start=False,
                            to_exhaustion=True, layout="fused", device=dev)
    job = FleetJob(name="catalog", space=cat_space, cost_table=cat_table)
    handles = [session.submit(job, seed=s) for s in range(FLEET_JOBS)]
    ei_argmax_cuda.launches = 0
    step_ms, step_wall = [], []
    profiled = None
    with ChunkSteps() as cs:
        t0 = time.perf_counter()
        left = session.step()  # admission (8 chunks moved to the card) and the first step
        torch.cuda.synchronize()
        admit_s = time.perf_counter() - t0
        k = 1
        while left:
            chunks = -(-left // FLEET_ROWS)  # every chunk is full and retires last
            if k == 8:  # a profiled window of four session steps (32 chunk steps)
                profiled = fleet_breakdown(session, 4, chunks)
                k += 4
                continue
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            left = session.step()
            b.record()
            b.synchronize()
            step_wall.append((time.perf_counter() - t0) * 1e3 / chunks)
            step_ms.append(a.elapsed_time(b) / chunks)
            k += 1
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    launches_c = ei_argmax_cuda.launches
    outs = [h.outcome() for h in handles]
    # A cold chunk takes its budget of steps (the scripted init ones included:
    # `fleet_step` runs the BO step on every row each call) and one more.
    if launches_c != cs.n or cs.n != (FLEET_JOBS // FLEET_ROWS) * (CATALOG_B + 1):
        raise AssertionError(f"catalog fleet: K1 launched {launches_c} times over {cs.n} chunk "
                             f"steps")
    if any(len(o.records) != CATALOG_B or not np.all(np.isfinite([r.cost for r in o.records]))
           for o in outs):
        raise AssertionError("a catalog fleet job did not run its 24 finite trials")
    med_ms, med_wall = float(np.median(step_ms)), float(np.median(step_wall))
    print(f"    {cs.n} chunk steps, K1 launches {launches_c}; admission and first step "
          f"{admit_s * 1e3:.1f} ms; ms per chunk step {med_ms:.3f} (CUDA events), "
          f"{med_wall:.3f} (wall), medians over {len(step_ms)} session steps; per job-step "
          f"{med_wall / FLEET_ROWS:.3f} ms (phase 3's sequential step "
          f"{report.get('catalog', {}).get('step_ms_median', float('nan')):.3f} ms); peak "
          f"allocated {peak} B over the start")
    idle = profiled["idle_share"]
    print(f"    profiled chunk step: wall {profiled['wall_ms']:.3f} ms, device busy "
          f"{profiled['device_busy_ms']:.4f} ms (idle share "
          f"{'not measured: no device time traced' if idle is None else f'{idle:.3f}'}), "
          f"K1 {profiled['kernel_ms']:.4f} ms")
    full_c = 0
    for s in range(0, FLEET_JOBS, FLEET_ROWS):  # one job of each chunk, sequentially
        ref = cherrypick_search(cat_space, lambda i: float(cat_table[i]), np.random.default_rng(s),
                                settings=st, to_exhaustion=True, layout="fused", device=dev)
        ok, detail = hold_fleet(ref, outs[s].trace(), cat_space.encoded(),
                                [list(range(CATALOG_N))], CATALOG_B, dev, 3)
        full_c += ok
        print(f"    seed {s} vs SequentialProbe: {'matches' if ok else detail}")
    if full_c == 0:
        raise AssertionError("no catalog fleet job matched its sequential search in full")
    out["catalog"] = {"chunk_steps": cs.n, "launches": launches_c, "admit_ms": admit_s * 1e3,
                      "ms_per_chunk_step_events": med_ms, "ms_per_chunk_step_wall": med_wall,
                      "ms_per_job_step": med_wall / FLEET_ROWS, "peak_bytes": int(peak),
                      "full_matches": full_c, "profiled": profiled}
    del session, handles, outs
    torch.cuda.empty_cache()

    # (d) n512-budgeted through a TuningSession, feature then fused.
    path = ROOT / "tests" / "golden" / "n512-budgeted.json"
    space, table = synth_space(512, 5, seed=0, mem_unit=GiB)
    st = BOSettings(max_iters=10)
    prio, rest = list(range(50)), list(range(50, 512))
    want = report.get("fixture", {}).get("full_matches", 1)
    out["fixture"] = {}
    for layout in ("feature", "fused"):
        session = TuningSession(settings=st, to_exhaustion=True, layout=layout, device=dev)
        refs = fixture_traces(path)
        hs = [session.submit(FleetJob(name=f"j{s}", space=space, cost_table=table), seed=s,
                             priority=prio, remaining=rest) for s in range(len(refs))]
        ei_argmax_cuda.launches = 0
        with ChunkSteps() as cs:
            session.drain()
        if ei_argmax_cuda.launches != (cs.n if layout == "fused" else 0):
            raise AssertionError(f"n512 {layout}: K1 launched {ei_argmax_cuda.launches} times "
                                 f"over {cs.n} chunk steps")
        full = 0
        for ref, h in zip(refs, hs):
            ok, detail = hold_fleet(ref, h.outcome().trace(), space.encoded(), [prio, rest],
                                    trial_budget(len(prio), len(rest), st), dev, 3)
            full += ok
        print(f"  (d) n512-budgeted through a session, {layout}: {full} of {len(refs)} match "
              f"the fixture in full (phase 4, sequential: {want}); {cs.n} chunk steps, K1 "
              f"launches {ei_argmax_cuda.launches}")
        if full < want:
            raise AssertionError(f"n512 {layout}: {full} full matches, fewer than phase 4's {want}")
        out["fixture"][layout] = {"full_matches": full, "chunk_steps": cs.n}

    # (e) Warm-start streaming: fleet_bench's scenario, twice.
    def stream():
        per = FLEET_JOBS // FLEET_WAVES
        keys = [JOB_ORDER[i % len(JOB_ORDER)] for i in range(per)]
        waves = [cluster_fleet(keys) for _ in range(FLEET_WAVES)]
        session = TuningSession(cache=ProfileCache(), warm_start=True, to_exhaustion=False,
                                device=dev)
        t0 = time.perf_counter()
        submitted = 0
        for wave in waves:
            for i, job in enumerate(wave):
                session.submit(job, seed=1000 + submitted + i)
            submitted += len(wave)
            while session.step():
                pass
        return session, time.perf_counter() - t0

    runs = [stream() for _ in range(2)]
    dicts = [[o.as_dict() for o in s.results()] for s, _ in runs]
    if dicts[0] != dicts[1]:
        raise AssertionError("the warm-start stream did not repeat identically")
    session, secs = runs[0]
    outs = session.results()
    warm = [o for o in outs if o.seeded]
    cold = [o for o in outs if not o.seeded]
    cold_iters = float(np.mean([len(o.records) for o in cold]))
    warm_iters = float(np.mean([len(o.records) for o in warm])) if warm else float("nan")
    print(f"  (e) warm-start stream: {len(outs)} jobs in {FLEET_WAVES} waves; warm hits "
          f"{session.warm_hits}, seeded trials {session.warm_trials}, cache hits "
          f"{session.cache.hits} / misses {session.cache.misses}; mean fresh trials cold "
          f"{cold_iters:.3f} ({len(cold)} jobs), warm {warm_iters:.3f} ({len(warm)} jobs); "
          f"{secs:.2f} s and {runs[1][1]:.2f} s; the two runs' outcomes identical")
    if not warm or not cold or not warm_iters < cold_iters:
        raise AssertionError(f"warm-started searches should take fewer fresh trials: warm "
                             f"{warm_iters} vs cold {cold_iters}")
    out["stream"] = {"jobs": len(outs), "warm_hits": session.warm_hits,
                     "seeded_trials": session.warm_trials, "cold_mean_fresh": cold_iters,
                     "warm_mean_fresh": warm_iters, "seconds": [secs, runs[1][1]]}
    del runs, session

    # (f) The cost_table paths, one job each, held against phase 2's.
    key = JOB_ORDER[2]
    sim = ClusterSimulator.for_job(key)
    size = sim.job.input_gb * GiB
    prio, rest = seq[(key, "split")]
    rep = run_ruya(profile_run=sim.profile_run_fn(), full_input_size=size, space=sim.space,
                   cost_table=sim.normalized, rng=np.random.default_rng(0),
                   per_node_overhead=0.5 * GiB, to_exhaustion=True, device=dev)
    cp = run_cherrypick(space=sim.space, cost_table=sim.normalized, rng=np.random.default_rng(0),
                        to_exhaustion=True, device=dev)
    if (list(rep.priority), list(rep.remaining)) != (prio, rest):
        raise AssertionError("run_ruya(cost_table=...) split differs from phase 2's")
    n = len(sim.space)
    ok_r, det_r = hold_fleet(seq[(key, 0, "ruya", "feature")], rep.trace, sim.space.encoded(),
                             [prio, rest] if rest else [prio], n, dev, min(3, len(prio)))
    ok_c, det_c = hold_fleet(seq[(key, 0, "cherrypick", "feature")], cp, sim.space.encoded(),
                             [list(range(n))], n, dev, 3)
    print(f"  (f) cost_table paths, {key} seed 0: run_ruya {'matches' if ok_r else det_r}, "
          f"run_cherrypick {'matches' if ok_c else det_c} (phase 2's feature traces)")

    # K1 at J = 8, the shapes of the fleet's two paths.
    times = {}
    for path, shape in FLEET_SHAPES.items():
        n, d, cap, k = shape
        c = fleet_kernel_case(dev, shape, 70)
        before = ei_argmax_cuda.launches
        k_idx, k_val = ei_argmax(*tail_args(c))
        p_idx, p_val = ei_argmax_plain(*tail_args(c))
        torch.cuda.synchronize()
        if ei_argmax_cuda.launches != before + 1:
            raise AssertionError(f"{path}: {ei_argmax_cuda.launches - before} launches for one call")
        err = assert_close(p_val.cpu().numpy(), k_val.cpu().numpy(), rtol=EI_RTOL, atol=EI_ATOL,
                           what=f"{path} max EI at J={FLEET_ROWS}")
        for j in range(FLEET_ROWS):
            row = types.SimpleNamespace(**{f: getattr(c, f)[j:j + 1] for f in vars(c)})
            if not pick_agrees(int(p_idx[j]), int(k_idx[j]), full_ei(row)):
                raise AssertionError(f"{path} row {j}: kernel {int(k_idx[j])} vs plain "
                                     f"{int(p_idx[j])}, not a tie")
        ms = cuda_time_ms(lambda: ei_argmax(*tail_args(c)))
        plain_ms = cuda_time_ms(lambda: ei_argmax_plain(*tail_args(c)))
        k_dev = graph_ms(lambda: ei_argmax(*tail_args(c)))
        p_dev = graph_ms(lambda: ei_argmax_plain(*tail_args(c)), calls=2)
        bound = ei_argmax_bound(int(c.mask.sum()), n, d, cap, FLEET_ROWS)
        times[path] = dict(shape=f"J={FLEET_ROWS} n={n} d={d} B={cap}", ms=ms, plain_ms=plain_ms,
                           device_ms=k_dev, plain_device_ms=p_dev, max_abs_err=err, **bound)
        print(f"  K1 at J={FLEET_ROWS} n={n} d={d} B={cap}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (events); device {k_dev:.4f} ms, plain {p_dev:.4f} ms "
              f"(graph replay; {k_dev / FLEET_ROWS:.4f} ms a row); bound "
              f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}); |dEI| {err:.3e}")
    out["kernel_times"] = times
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 14 wall time {out['seconds']:.1f} s")
    report["fleet"] = out
    return {"launches": {"fleet_table2": launches_b, "fleet_catalog": launches_c},
            "times": times}


def fleet_breakdown(session, steps: int, chunks: int) -> dict:
    """``steps`` session steps of ``chunks`` live chunks each under
    `torch.profiler`: wall and device busy time per chunk step, K1's share,
    and the device's idle share (None where the trace holds no device
    time)."""
    def run():
        for _ in range(steps):
            session.step()

    wall, busy_ms, kern_ms, _, _ = profiled_window(run, steps * chunks)
    return {"wall_ms": wall, "device_busy_ms": busy_ms, "kernel_ms": kern_ms,
            "idle_share": 1 - busy_ms / wall if busy_ms > 0 else None}


# ---------------------------------------------------------------- phase 5

FA_CASES = [  # tests/test_kernels.py's sweep: (b, t, h, kv, d, causal)
    (1, 128, 4, 4, 64, True),
    (2, 128, 4, 2, 64, True),   # GQA
    (1, 256, 8, 1, 32, True),   # MQA
    (2, 128, 4, 2, 128, True),  # head_dim 128
    (1, 128, 4, 4, 64, False),  # bidirectional
    (1, 100, 4, 2, 64, False),  # ragged T
    (1, 200, 6, 3, 48, True),   # ragged T, causal
]
# Kernel against plain version, as tests/test_kernels.py holds the TPU
# kernel against its oracle: float32 sums in another order (its limits);
# in bfloat16 both round the same float32 result once, so they differ by at
# most one bfloat16 step of the output (2^-7 relative), with 1e-3 absolute
# for outputs near zero.
FA_TOL = {"float32": dict(rtol=1e-4, atol=2e-5), "bfloat16": dict(rtol=2.0**-7, atol=1e-3)}
# The library yardstick rounds the probabilities to bfloat16 before P.V, so
# it is held to the reference test's bfloat16 limit instead: it is only
# there to show that the timed call computes the same function.
SDPA_TOL = dict(rtol=2.0**-7, atol=2e-2)
FWD_SHAPE = (1, 4096, 32, 8, 128)  # Qwen3-8B forward: (B, T, H, KV, D)
ARCH = "qwen3-8b"
# Device names of K2's two kernels: the CUDA-core one (float32, and bfloat16
# with D % 8 != 0) and the tensor-core one (bfloat16 with D % 8 == 0).
FLASH_KERNEL_NAMES = ("flash_fwd_kernel", "flash_fwd_wgmma_kernel")
FLASH_ROUTES = ("tensor_core", "cuda_core")  # kernel.route's names


def flash_counts(fa) -> dict:
    """K2's launch counts: all, and each route's."""
    return {"all": fa.launches, **{r: getattr(fa, f"{r}_launches") for r in FLASH_ROUTES}}


def reset_flash_counts(fa) -> None:
    fa.launches = 0
    for r in FLASH_ROUTES:
        setattr(fa, f"{r}_launches", 0)


def fa_inputs(dev, seed, b, t, h, kv, d, dtype):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).to(getattr(torch, dtype))
                 for shape in ((b, t, h, d), (b, t, kv, d), (b, t, kv, d)))


def flash_bound(b, t, h, kv, d, causal, itemsize) -> dict:
    """Least time for one attention forward: q, k, v read and o written once
    over HBM bandwidth, and the products over the peak for the input type
    (bfloat16: the tensor cores; float32: the CUDA cores).  The causal run
    needs the query-key pairs at or before each query, T(T+1)/2 per head,
    and each pair costs 2D for q.k and 2D for p.v."""
    pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
    flops = 4 * d * pairs
    nbytes = itemsize * (2 * b * t * h * d + 2 * b * t * kv * d)
    peak = PEAK_BF16_PER_S if itemsize == 2 else PEAK_FP32_PER_S
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def sdpa(q, k, v):
    """The library yardstick: one PyTorch call for the same function."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), is_causal=True,
                                          enable_gqa=True).transpose(1, 2)


def phase_flash(dev, report) -> dict:
    import torch

    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
    from repro_torch.testing import assert_close

    fa = fa_kernel.flash_attention_cuda
    print(f"phase 5: flash-attention kernels vs plain version on the card "
          f"(float32 {FA_TOL['float32']}; bfloat16 {FA_TOL['bfloat16']})")
    b, t, h, kv, d = FWD_SHAPE
    errs = {}

    def check(name, q, k, v, causal):
        route = fa_kernel.route(q.dtype, q.shape[-1])
        before = flash_counts(fa)
        out = flash_attention(q, k, v, causal)
        after = flash_counts(fa)
        plain = flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if after[route] != before[route] + 1 or after["all"] != before["all"] + 1:
            raise AssertionError(f"{name}: the {route} kernel was not the one launched")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"non-finite kernel output at {name}")
        errs[name] = assert_close(plain.float().cpu().numpy(), out.float().cpu().numpy(),
                                  **FA_TOL[str(q.dtype).split(".")[1]], what=name)
        print(f"  {name:52s} {route:11s} max |kernel - plain| {errs[name]:.3e}")
        return out

    with torch.inference_mode():
        for i, (cb, ct, ch, ckv, cd, causal) in enumerate(FA_CASES):
            for dt in ("float32", "bfloat16"):
                check(f"b={cb} t={ct} h={ch} kv={ckv} d={cd} causal={causal} {dt}",
                      *fa_inputs(dev, 100 + i, cb, ct, ch, ckv, cd, dt), causal)
        shape = f"B={b} T={t} H={h} KV={kv} D={d}"
        routes = {}
        for dt in ("bfloat16", "float32"):
            q, k, v = fa_inputs(dev, 7, b, t, h, kv, d, dt)
            name = f"forward shape {shape} causal {dt}"
            out = check(name, q, k, v, True)
            err_lib = assert_close(sdpa(q, k, v).float().cpu().numpy(),
                                   out.float().cpu().numpy(), **SDPA_TOL, what=f"{name} vs SDPA")
            print(f"  {name}: max |kernel - SDPA| {err_lib:.3e} (SDPA held to {SDPA_TOL})")
            if dt == "float32":
                # The float32 route's path is the op itself (the models compute
                # in bfloat16): driven once, counted from 0.
                torch.cuda.synchronize()
                reset_flash_counts(fa)
                flash_attention(q, k, v, True)
                torch.cuda.synchronize()
                op_counts = flash_counts(fa)
                if op_counts != {"all": 1, "tensor_core": 0, "cuda_core": 1}:
                    raise AssertionError(f"the float32 op launched {op_counts}")
            ms = cuda_time_ms(lambda: flash_attention(q, k, v, True), reps=20)
            plain_ms = cuda_time_ms(lambda: flash_attention_plain(q, k, v), reps=3, warmup=0)
            lib_ms = cuda_time_ms(lambda: sdpa(q, k, v), reps=20)
            k_dev = graph_ms(lambda: flash_attention(q, k, v, True))
            p_dev = graph_ms(lambda: flash_attention_plain(q, k, v), calls=1, reps=3)
            l_dev = graph_ms(lambda: sdpa(q, k, v))
            bound = flash_bound(b, t, h, kv, d, True, q.element_size())
            route = fa_kernel.route(q.dtype, d)
            print(f"  time at the forward shape, {dt} ({route} kernel): kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms (CUDA events around one "
                  f"call, median of 20, 3 and 20); device time per call (CUDA graph replay): "
                  f"kernel {k_dev:.4f} ms, plain {p_dev:.4f} ms, SDPA {l_dev:.4f} ms; bound "
                  f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}, "
                  f"{'bf16 tensor-core' if dt == 'bfloat16' else 'FP32'} peak; "
                  f"{bound['bytes']} B, {bound['flops']} flop); kernel at "
                  f"{bound['flops'] / k_dev / 1e9:.1f} TFLOP/s, "
                  f"{bound['bound_ms'] / k_dev:.3f} of its bound, {k_dev / l_dev:.2f}x SDPA")
            routes[route] = dict(shape=f"{shape} {dt} causal", max_abs_err=errs[name], ms=ms,
                                 plain_ms=plain_ms, device_ms=k_dev, plain_device_ms=p_dev,
                                 library_ms=lib_ms, library_device_ms=l_dev, sdpa_err=err_lib,
                                 **bound)
            del q, k, v, out
    routes["cuda_core"]["op_launches"] = op_counts["cuda_core"]
    report["flash"] = {"case_errs": errs, **routes}
    return routes


# ---------------------------------------------------------------- phase 6

FWD_CALLS = 2  # teacher-forced forwards in the counted run
# Flash route against dense route, bfloat16 compute, 36 layers.  The dense
# route rounds the scores and the probabilities to bfloat16, the kernel keeps
# them in float32; the difference propagates through every later layer.  On
# the CPU, at 36 layers of head_dim 128 (d_model 512, T 512), the logits of
# the two routes differ by 0.9 % RMS and at most 0.047 (logits of RMS 1):
# allow 2^-5 RMS and 2^-2 at any logit, over 3x and 5x those.
FORWARD_RMS_REL = 2.0**-5
FORWARD_MAX_ABS = 2.0**-2


def phase_forward(dev, report) -> int:
    import torch

    from repro_torch import configs as C
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.testing import assert_close

    cfg = C.get(ARCH).model
    b, t = 1, FWD_SHAPE[1]
    print(f"phase 6: {ARCH} teacher-forced forward, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype} params, {cfg.compute_dtype} compute, B={b} T={t}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {n_params} parameters drawn on the card in {init_s:.2f} s "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    if n_params != model.total_params():
        raise AssertionError(f"{n_params} parameters, the spec says {model.total_params()}")
    batch = {"tokens": torch.as_tensor(make_batch(cfg, b, t, seed=0)["tokens"], device=dev)}

    captured = []  # layer 0's (q, k, v, out), taken on its way through the kernel

    def capture(q, k, v, causal=True, *rest):
        out = flash_attention(q, k, v, causal, *rest)
        if not captured:
            captured.append((q, k, v, out))
        return out

    walls = []
    with torch.inference_mode():
        L.flash_attention = capture
        try:
            reset_flash_counts(flash_attention_cuda)
            for _ in range(FWD_CALLS):
                t0 = time.perf_counter()
                logits, _ = model.forward(batch)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            counts = flash_counts(flash_attention_cuda)
        finally:
            L.flash_attention = flash_attention
        launches = counts["tensor_core"]
        peak = torch.cuda.max_memory_allocated()
        print(f"  flash kernel launches {counts} over {FWD_CALLS} forwards of "
              f"{cfg.num_layers} layers; forward wall {walls[0]:.1f} ms (first), "
              f"{walls[1]:.1f} ms (second); peak allocated {peak / 1e9:.2f} GB")
        want = FWD_CALLS * cfg.num_layers
        if counts != {"all": want, "tensor_core": want, "cuda_core": 0}:
            raise AssertionError(f"flash kernels launched {counts} times in {FWD_CALLS} bfloat16 "
                                 f"forwards of {cfg.num_layers} layers: want the tensor-core "
                                 f"kernel once a layer")
        if tuple(logits.shape) != (b, t, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"forward logits of shape {tuple(logits.shape)} not finite")

        q, k, v, out = captured[0]
        plain = flash_attention_plain(q, k, v)
        err0 = assert_close(plain.float().cpu().numpy(), out.float().cpu().numpy(),
                            **FA_TOL["bfloat16"], what="layer 0 kernel vs plain")
        print(f"  layer 0: q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}; max |kernel - "
              f"plain| {err0:.3e} on that layer's own q, k, v")

        fwd_ms = cuda_time_ms(lambda: model.forward(batch), reps=3, warmup=0)
        with_prof = forward_breakdown(lambda: model.forward(batch))

        dense = Model(cfg.replace(attention_impl="dense"), params=model.params_tree(), device=dev)
        dense_logits, _ = dense.forward(batch)
        dense_ms = cuda_time_ms(lambda: dense.forward(batch), reps=2, warmup=0)
        diff = logits - dense_logits
        rms_rel = float(diff.square().mean().sqrt() / dense_logits.square().mean().sqrt())
        max_abs = float(diff.abs().max())
        agree = float((logits.argmax(-1) == dense_logits.argmax(-1)).float().mean())
        del diff
    print(f"  forward {fwd_ms:.1f} ms by CUDA events (median of 3), dense route {dense_ms:.1f} "
          f"ms (median of 2); flash vs dense logits: RMS {rms_rel:.3e} of the dense logits' "
          f"RMS (limit {FORWARD_RMS_REL}), max |diff| {max_abs:.4f} (limit {FORWARD_MAX_ABS}), "
          f"argmax agrees at {agree:.4f} of positions")
    print(f"  profiled forward: wall {with_prof['wall_ms']:.1f} ms, device busy "
          f"{with_prof['device_busy_ms']:.1f} ms, flash kernel {with_prof['kernel_ms']:.1f} ms "
          f"({with_prof['kernel_share']:.3f} of device time; "
          f"{with_prof['kernel_ms'] / cfg.num_layers:.4f} ms per launch), idle share "
          f"{with_prof['idle_share']:.3f}")
    for name, ms in with_prof["top_kernels_ms"].items():
        print(f"    device {ms:.3f} ms  {name}")
    if rms_rel > FORWARD_RMS_REL or max_abs > FORWARD_MAX_ABS:
        raise AssertionError("flash route and dense route disagree beyond the stated tolerance")
    report["forward"] = {
        "params": n_params, "init_s": init_s, "launches": counts, "forward_calls": FWD_CALLS,
        "wall_ms": walls, "events_ms": fwd_ms, "dense_events_ms": dense_ms,
        "peak_bytes": int(peak), "layer0_err": err0, "rms_rel": rms_rel, "max_abs": max_abs,
        "argmax_agree": agree, "breakdown": with_prof,
    }
    return launches


def profile_summary(prof, calls: int, wall_ms: float, kernel_names=(), ranges=()) -> dict:
    """Per call of a `torch.profiler` run of ``calls`` calls: device busy
    time, the named kernels' time and share of it, the device's idle share
    against ``wall_ms`` (per call), launches, and the largest device kernels
    and host ops.  ``ranges``: names of `record_function` ranges, whose
    device-side annotations span kernels and are not kernels themselves:
    ``ranges_ms`` gives, per call, the device time of the kernels launched
    inside each, where the profiler reports it (else None)."""
    from torch.autograd import DeviceType

    busy = kern = 0.0
    by_name = {}
    events = prof.key_averages()
    for name, us in _device_events(events):
        if name in ranges:
            continue
        busy += us
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + us / calls / 1e3
        if any(k in name for k in kernel_names):
            kern += us
    launches = sum(e.count for e in events
                   if e.device_type == DeviceType.CUDA and e.key not in ranges)
    ranges_ms = {}
    for r in ranges:
        us = [getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
              for e in events if e.key == r]
        ranges_ms[r] = max(us) / calls / 1e3 if us and max(us) > 0 else None
    host = sorted(((e.self_cpu_time_total / calls / 1e3, e.key) for e in events
                   if e.key.startswith("aten::")), reverse=True)[:6]
    busy_ms, kern_ms = busy / calls / 1e3, kern / calls / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "kernel_ms": kern_ms,
            "kernel_share": kern_ms / busy_ms if busy_ms else None,
            "idle_share": 1 - busy_ms / wall_ms, "device_kernels": launches / calls,
            "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6]),
            "top_host_ops_ms": {name: ms for ms, name in host}, "ranges_ms": ranges_ms}


def forward_breakdown(fn, kernel_names=FLASH_KERNEL_NAMES) -> dict:
    """One call of ``fn`` under `torch.profiler` (`profile_summary`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return profile_summary(prof, 1, wall, kernel_names)


# ---------------------------------------------------------------- phase 7

SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_LEN = 4, 512, 64, 1024
# The served tokens against the argmax of a teacher-forced forward over the
# prompt and those tokens: both run the dense route in bfloat16, at other
# shapes (a 1024-slot cache against 575 keys), so their logits differ by a
# few bfloat16 steps; a differing token is a certified tie when its logit
# lies within 2^-3 of the forward's largest.  Ties are reported, not
# counted; at least 3 of the 4 rows must match in full (every run on the
# card so far: 3, the fourth ending at a tie after 31 matching steps).
SERVE_TIE_ATOL = 2.0**-3
SERVE_MIN_FULL = 3


def phase_serve(dev, report) -> None:
    import torch

    from repro_torch.kernels.ei_argmax.kernel import ei_argmax_cuda
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.launch import serve
    from repro_torch.testing import compare_token_traces

    print(f"phase 7: serving {ARCH} through repro_torch.launch.serve: batch {SERVE_BATCH}, "
          f"Zipf prompts of {SERVE_PROMPT} tokens, {SERVE_NEW} greedy new tokens, cache "
          f"{SERVE_MAX_LEN}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = serve.build_model(ARCH, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"  model built and its matrices cast to {model.cfg.compute_dtype} in "
          f"{time.perf_counter() - t0:.2f} s ({torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"resident)")
    loop = serve.serve_loop(model, SERVE_BATCH, SERVE_MAX_LEN)
    batch = serve.requests(model, SERVE_BATCH, SERVE_PROMPT, seed=0)
    loop.generate(batch, 4)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = ei_argmax_cuda.launches = 0
    out = loop.generate(batch, SERVE_NEW, echo_metrics=True)
    launches = (flash_attention_cuda.launches, ei_argmax_cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    m = out["metrics"]
    tokens = out["tokens"]
    step_ms = m["decode_s"] * 1e3 / max(m["decoded"] - 1, 1)
    print(f"  prefill {m['prefill_s'] * 1e3:.1f} ms, decode {step_ms:.2f} ms per step "
          f"({m['decoded'] - 1} steps), {m['tokens_per_s']:.1f} tokens/s; peak allocated "
          f"{peak / 1e9:.2f} GB")
    print(f"  kernel launches while serving: flash {launches[0]}, ei_argmax {launches[1]} "
          f"(prefill and decode attend through the cache; no kernel runs, as in the reference)")
    if launches != (0, 0):
        raise AssertionError(f"serving launched kernels {launches}")
    if tokens.shape != (SERVE_BATCH, SERVE_NEW):
        raise AssertionError(f"served tokens of shape {tokens.shape}")

    with torch.inference_mode():
        seq = torch.cat([batch["tokens"].long(), torch.as_tensor(tokens[:, :-1], device=dev).long()], 1)
        logits, _ = model.forward({"tokens": seq})
        logits = logits[:, SERVE_PROMPT - 1:]
        ref_tokens = logits.argmax(-1).cpu().numpy()
        ref_logits = logits.cpu().numpy()
    cmp = compare_token_traces(ref_tokens, tokens, ref_logits, atol=SERVE_TIE_ATOL)
    print(f"  served tokens vs the teacher-forced forward's argmax: {cmp.matched} of "
          f"{SERVE_BATCH} rows match in full, {len(cmp.ties)} end at a certified tie "
          f"(within {SERVE_TIE_ATOL}; reported, not counted as matches)")
    for b, n, detail in cmp.ties:
        print(f"    tie: row {b} step {n}: {detail}")
    if cmp.matched < min(SERVE_MIN_FULL, SERVE_BATCH):
        raise AssertionError(f"{cmp.matched} of {SERVE_BATCH} served rows match the forward "
                             f"in full; at least {SERVE_MIN_FULL} must")
    prof = decode_breakdown(model, batch)
    print(f"  profiled decode step: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['device_busy_ms']:.2f} ms (idle share {prof['idle_share']:.3f}), "
          f"{prof['device_kernels']} kernels per step")
    for name, ms in prof["top_kernels_ms"].items():
        print(f"    device {ms:.3f} ms  {name}")
    for name, ms in prof["top_host_ops_ms"].items():
        print(f"    host   {ms:.3f} ms  {name}")
    report["serve"] = {
        "decode_breakdown": prof,
        "prefill_ms": m["prefill_s"] * 1e3, "decode_ms_per_step": step_ms,
        "tokens_per_s": m["tokens_per_s"], "decoded": m["decoded"], "peak_bytes": int(peak),
        "full_matches": cmp.matched, "ties": [list(t) for t in cmp.ties],
        "launches": {"flash_attention": launches[0], "ei_argmax": launches[1]},
    }


def decode_breakdown(model, batch, steps: int = 8, max_len: int = SERVE_MAX_LEN) -> dict:
    """Decode steps after a prefill, under `torch.profiler` (`profile_summary`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    b, t = batch["tokens"].shape
    with torch.inference_mode():
        cache = model.init_cache(b, max_len)
        logits, cache = model.prefill(batch, cache)
        tok = logits[:, -1].argmax(-1)[:, None]
        model.decode_step(cache, tok, t)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                logits, cache = model.decode_step(cache, tok, t + 1 + i)
                tok = logits[:, -1].argmax(-1)[:, None]
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
    return profile_summary(prof, steps, wall)


# ---------------------------------------------------------------- phase 8

SSM_ARCH = "mamba2-370m"
SSD_CASES = [  # (b, nc, q, h, p, n)
    (1, 2, 8, 2, 16, 16),  # tests/test_kernels.py's four
    (2, 2, 64, 4, 32, 32),
    (1, 1, 128, 2, 64, 64),
    (1, 1, 256, 1, 64, 128),
    (2, 3, 8, 8, 16, 16),  # the smoke model's chunk: Q = 8, 8 heads of 16, state 16
    (1, 2, 100, 3, 20, 24),  # ragged: Q, P and N off the kernel's tile multiples
    (1, 1, 512, 2, 96, 192),  # past the CUDA-core kernel's caps (Q 256, P 64, N 128)
    (1, 2, 333, 3, 72, 136),  # ragged past all three
    (1, 2, 77, 2, 33, 17),  # odd P and N: the 4-byte copies and single stores
]
SSD_GROUPED = [  # (b, nc, q, h, p, n, groups, bf16): B and C per group, as the model
    (1, 2, 256, 8, 64, 128, 2, False),  # passes them: G > 1 (each head reads h // 4)
    (2, 2, 256, 8, 64, 128, 1, True),  # x, B and C bf16 values, as the model gives them
    (1, 1, 300, 6, 40, 72, 3, True),
]
# Kernel against plain version, as tests/test_kernels.py holds the TPU kernel
# against its oracle: float32 products summed in another order.
SSD_TOL = dict(rtol=1e-4, atol=1e-4)
SSM_FWD_T = 32768  # the reference's prefill_32k sequence length, at batch 1
SERVE_SSM_BATCH, SERVE_SSM_PROMPT, SERVE_SSM_NEW = 8, 2048, 64
SSD_PATHS = {  # the kernel's (batch, sequence length) on each path that runs it
    "ssm_forward": (1, SSM_FWD_T),
    "ssm_serve": (SERVE_SSM_BATCH, SERVE_SSM_PROMPT),  # the prefill
    "ssm_train": (2, 4096),  # a microbatch of phase 13's training step
}
SSD_KERNEL_NAMES = ("ssd_diag_wgmma_kernel", "ssd_cumsum_kernel")


def ssd_path_shape(cfg, b: int, t: int) -> tuple:
    """(b, nc, q, h, p, n) of the kernel's input for a (b, t) sequence batch."""
    s = cfg.ssm
    q = min(s.chunk_size, t)
    return b, -(-t // q), q, s.num_heads(cfg.d_model), s.head_dim, s.d_state


def ssd_inputs(dev, seed, b, nc, q, h, p, n, groups=None, bf16=False):
    """x, dt, lA, B, C drawn on ``dev`` as tests/test_kernels.py draws them.
    With ``groups``, B and C hold that many groups, (b, nc, q, G, n), as
    `ssd_chunked` passes them (head h reads group h // (h / G)); otherwise
    they are head-expanded.  With ``bf16``, x, B and C are rounded to
    bfloat16 values, as the model's bfloat16 compute gives them."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        a = torch.randn(shape, generator=g, device=dev)
        return a.to(torch.bfloat16).float() if bf16 else a

    x, dt, lA = randn(b, nc, q, h, p), F.softplus(randn(b, nc, q, h)), -F.softplus(randn(b, nc, q, h))
    g_ = h if groups is None else groups
    return x, dt, lA, randn(b, nc, q, g_, n), randn(b, nc, q, g_, n)


def ssd_bound(b, nc, q, h, p, n, groups) -> dict:
    """Least time for one call of the intra-chunk term: x, dt, lA read and y
    written once, B and C once per group, over HBM bandwidth; and the
    operations the lower triangle needs, Q(Q+1)/2 pairs per (chunk, head),
    each 2N for C.B, 2P for the weighted sum of x and 4 for the weight
    (difference, exp, two products), over the TF32 tensor-core peak, where
    the kernel takes its products.  The FP32 figure (the CUDA-core kernel's
    bound) is printed beside it."""
    cells = b * nc * h
    flops = cells * (q * (q + 1) // 2) * (2 * n + 2 * p + 4)
    nbytes = 4 * (2 * cells * q * p + 2 * cells * q + 2 * b * nc * q * groups * n)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_TF32_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops,
            "flops_full": cells * q * q * (2 * n + 2 * p + 4),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes_ms": t_bytes,
            "bound_fp32_ms": max(t_bytes, flops / PEAK_FP32_PER_S * 1e3)}


def phase_ssd(dev, report) -> dict:
    import torch

    from repro_torch import configs as C
    from repro_torch.kernels.ssd.kernel import ssd_diag_cuda
    from repro_torch.kernels.ssd.ops import ssd_diag_chunk, ssd_diag_plain
    from repro_torch.testing import assert_close

    print(f"phase 8: SSD intra-chunk kernel vs plain version on the card ({SSD_TOL})")
    cfg = C.get(SSM_ARCH).model
    errs = {}

    def check(name, args):
        before = ssd_diag_cuda.launches
        out = ssd_diag_chunk(*args)
        plain = ssd_diag_plain(*args)
        torch.cuda.synchronize()
        if ssd_diag_cuda.launches != before + 1:
            raise AssertionError(f"{name}: {ssd_diag_cuda.launches - before} launches counted")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"non-finite kernel output at {name}")
        errs[name] = assert_close(plain.cpu().numpy(), out.cpu().numpy(), **SSD_TOL, what=name)
        print(f"  {name:66s} max |kernel - plain| {errs[name]:.3e}")

    times = {}
    with torch.inference_mode():
        for i, shape in enumerate(SSD_CASES):
            check("b={} nc={} q={} h={} p={} n={}".format(*shape), ssd_inputs(dev, 200 + i, *shape))
        for i, (*shape, g, bf16) in enumerate(SSD_GROUPED):
            check("b={} nc={} q={} h={} p={} n={}".format(*shape) + f", G={g}"
                  + (", bf16 values" if bf16 else ""),
                  ssd_inputs(dev, 220 + i, *shape, groups=g, bf16=bf16))
        for path, (b, t) in SSD_PATHS.items():
            shape = ssd_path_shape(cfg, b, t)
            g = cfg.ssm.n_groups
            label = "{} (BC,Q,H,P,N) = ({},{},{},{},{}), G={}".format(
                path, shape[0] * shape[1], *shape[2:], g)
            bound = ssd_bound(*shape, g)
            got = {}
            # x, B and C as the model gives them (bfloat16 values: their
            # low TF32 terms are 0), then any float32 values.
            for kind, bf16 in (("bf16 values", True), ("f32 values", False)):
                args = ssd_inputs(dev, 9, *shape, groups=g, bf16=bf16)
                name = f"{label}, {kind}"
                check(name, args)
                ms = cuda_time_ms(lambda: ssd_diag_chunk(*args), reps=20)
                plain_ms = cuda_time_ms(lambda: ssd_diag_plain(*args), reps=3)
                k_dev = graph_ms(lambda: ssd_diag_chunk(*args))
                p_dev = graph_ms(lambda: ssd_diag_plain(*args), calls=1, reps=3)
                got[kind] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                                 device_ms=k_dev, plain_device_ms=p_dev)
                print(f"  time at the {path} shape, {kind}: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms (CUDA events around one call, median of 20 and 3); "
                      f"device time per call (CUDA graph replay): kernel {k_dev:.4f} ms, plain "
                      f"{p_dev:.4f} ms")
                del args
            print(f"    bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}; TF32 tensor peak; "
                  f"bytes alone {bound['bound_bytes_ms']:.4f} ms; {bound['bound_fp32_ms']:.4f} ms "
                  f"at the FP32 peak; {bound['bytes']} B, {bound['flops']} flop, "
                  f"{bound['flops_full']} flop for full Q x Q)")
            main = got["bf16 values"]
            times[path] = dict(shape=label.split(" ", 1)[1], **main,
                               f32_values_device_ms=got["f32 values"]["device_ms"],
                               f32_values_ms=got["f32 values"]["ms"], **bound)
    report["ssd"] = {"case_errs": errs, "paths": times}
    return times


# ---------------------------------------------------------------- phase 9

SSM_FWD_CALLS = 2  # teacher-forced forwards in the counted run
# Kernel route against the einsum route (`ssm_apply`'s default), bfloat16
# compute, 48 layers.  Both compute the intra-chunk term in float32, in
# another order; where that moves a value across a bfloat16 rounding
# boundary the step propagates through every later layer.  On the CPU, at
# 48 layers of d_model 1024 (vocab cut to 4096, T 1024 and 2048), the
# logits of the two routes differ by 2.7-2.8 % RMS and at most 0.104
# (logits of RMS 0.64); in float32 compute by 4e-6 RMS.  Allow 2^-4 RMS and
# 2^-1 at any logit, over 2x and 4x those, for the 1.6e9 logits here.
SSM_FORWARD_RMS_REL = 2.0**-4
SSM_FORWARD_MAX_ABS = 2.0**-1


def einsum_route(model, tokens):
    """The model's parameters through `ssm_apply` at its default
    (``use_kernel=False``: the einsum oracle for the intra-chunk term), layer
    by layer: the route the reference's `Model` takes."""
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S

    cfg, params = model.cfg, model.params_tree()
    x = L.embed_apply(params["embed"], cfg, tokens)
    for p in params["layers"]:
        out, _ = S.ssm_apply(p["ssm"], cfg, L.norm_apply(p["norm"], cfg, x))
        x = x + out
    return model._final_logits(params, x)


def phase_ssm_forward(dev, report) -> int:
    import torch

    from repro_torch import configs as C
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels.ssd.kernel import ssd_diag_cuda
    from repro_torch.kernels.ssd.ops import ssd_diag_chunk, ssd_diag_plain
    from repro_torch.models import ssm as S
    from repro_torch.models.model import Model
    from repro_torch.testing import assert_close

    cfg = C.get(SSM_ARCH).model
    s = cfg.ssm
    b, t = 1, SSM_FWD_T
    print(f"phase 9: {SSM_ARCH} teacher-forced forward, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {s.num_heads(cfg.d_model)} SSD heads of {s.head_dim}, state "
          f"{s.d_state}, chunk {s.chunk_size}, vocab {cfg.vocab_size}, {cfg.param_dtype} params, "
          f"{cfg.compute_dtype} compute, B={b} T={t}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {n_params} parameters drawn on the card in {init_s:.2f} s "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB)")
    if n_params != model.total_params():
        raise AssertionError(f"{n_params} parameters, the spec says {model.total_params()}")
    batch = {"tokens": torch.as_tensor(make_batch(cfg, b, t, seed=0)["tokens"], device=dev)}

    captured = []  # layer 0's kernel inputs and output, taken on their way through

    def capture(*args):
        out = ssd_diag_chunk(*args)
        if not captured:
            captured.append((args, out))
        return out

    walls = []
    with torch.inference_mode():
        S.ssd_diag_chunk = capture
        try:
            ssd_diag_cuda.launches = 0
            for _ in range(SSM_FWD_CALLS):
                t0 = time.perf_counter()
                logits, _ = model.forward(batch)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            launches = ssd_diag_cuda.launches
        finally:
            S.ssd_diag_chunk = ssd_diag_chunk
        peak = torch.cuda.max_memory_allocated()
        print(f"  SSD kernel launches {launches} over {SSM_FWD_CALLS} forwards of "
              f"{cfg.num_layers} layers; forward wall {walls[0]:.1f} ms (first), "
              f"{walls[1]:.1f} ms (second); peak allocated {peak / 1e9:.2f} GB")
        if launches != SSM_FWD_CALLS * cfg.num_layers:
            raise AssertionError(f"SSD kernel launched {launches} times in {SSM_FWD_CALLS} "
                                 f"forwards of {cfg.num_layers} layers")
        if tuple(logits.shape) != (b, t, cfg.vocab_size) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"forward logits of shape {tuple(logits.shape)} not finite")

        args, out = captured[0]
        captured.clear()
        plain = ssd_diag_plain(*args)
        err0 = assert_close(plain.cpu().numpy(), out.cpu().numpy(), **SSD_TOL,
                            what="layer 0 kernel vs plain")
        print(f"  layer 0: x {tuple(args[0].shape)}, B {tuple(args[3].shape)} with strides "
              f"{args[3].stride()}; max |kernel - plain| {err0:.3e} on that layer's own inputs "
              f"(outputs up to {float(out.abs().max()):.3f})")
        del args, out, plain

        fwd_ms = cuda_time_ms(lambda: model.forward(batch), reps=3, warmup=0)
        with_prof = forward_breakdown(lambda: model.forward(batch), SSD_KERNEL_NAMES)

        ref_logits = einsum_route(model, batch["tokens"])
        ref_ms = cuda_time_ms(lambda: einsum_route(model, batch["tokens"]), reps=2, warmup=0)
        diff = logits - ref_logits
        rms_rel = float(diff.square().mean().sqrt() / ref_logits.square().mean().sqrt())
        max_abs = float(diff.abs().max())
        agree = float((logits.argmax(-1) == ref_logits.argmax(-1)).float().mean())
        del diff, ref_logits
    print(f"  forward {fwd_ms:.1f} ms by CUDA events (median of 3), einsum route {ref_ms:.1f} ms "
          f"(median of 2); kernel vs einsum route logits: RMS {rms_rel:.3e} of the einsum "
          f"logits' RMS (limit {SSM_FORWARD_RMS_REL}), max |diff| {max_abs:.4f} (limit "
          f"{SSM_FORWARD_MAX_ABS}), argmax agrees at {agree:.4f} of positions")
    print(f"  profiled forward: wall {with_prof['wall_ms']:.1f} ms, device busy "
          f"{with_prof['device_busy_ms']:.1f} ms, SSD kernel {with_prof['kernel_ms']:.2f} ms "
          f"({with_prof['kernel_share']:.3f} of device time; "
          f"{with_prof['kernel_ms'] / cfg.num_layers:.4f} ms per launch), idle share "
          f"{with_prof['idle_share']:.3f}, {with_prof['device_kernels']:.0f} device kernels")
    for name, ms in with_prof["top_kernels_ms"].items():
        print(f"    device {ms:.3f} ms  {name}")
    for name, ms in with_prof["top_host_ops_ms"].items():
        print(f"    host   {ms:.3f} ms  {name}")
    if rms_rel > SSM_FORWARD_RMS_REL or max_abs > SSM_FORWARD_MAX_ABS:
        raise AssertionError("kernel route and einsum route disagree beyond the stated tolerance")
    report["ssm_forward"] = {
        "params": n_params, "init_s": init_s, "launches": launches,
        "forward_calls": SSM_FWD_CALLS, "wall_ms": walls, "events_ms": fwd_ms,
        "einsum_events_ms": ref_ms, "peak_bytes": int(peak), "layer0_err": err0,
        "rms_rel": rms_rel, "max_abs": max_abs, "argmax_agree": agree, "breakdown": with_prof,
    }
    return launches


# ---------------------------------------------------------------- phase 10

# The served tokens against the argmax of a teacher-forced forward over the
# prompt and those tokens: the served path carries the state through the
# recurrent decode step, the forward recomputes it chunk by chunk, both in
# bfloat16, and a float32 difference that moves a value across a bfloat16
# rounding boundary propagates through the later layers.  On the CPU, at
# full width (vocab cut to 4096, batch 2, 512-token prompts, 16 steps), the
# served logits differ from the forward's by 0.017 RMS and at most 0.103
# (logits of RMS 0.64), and the argmax differs at 3 % of the steps, so most
# rows of 64 steps are expected to end at a tie.  A differing token must be
# a certified tie: its logit within 2^-3 of the forward's largest (any other
# difference raises); ties are reported, with the steps compared before them.
# Since a tie ends a row's comparison, every step is also held by its
# logits: the served path re-run over the served tokens (prefill, then the
# decode steps) against the forward's logits at the same positions, within
# phase 9's limits (2^-4 RMS, 2^-1 at any logit; the CPU case above is
# 2.7 % RMS, 0.103 at most).


def phase_ssm_serve(dev, report) -> int:
    import torch

    from repro_torch.kernels.ei_argmax.kernel import ei_argmax_cuda
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.ssd.kernel import ssd_diag_cuda
    from repro_torch.launch import serve
    from repro_torch.testing import compare_token_traces

    max_len = SERVE_SSM_PROMPT + SERVE_SSM_NEW  # sizes no SSM state: O(1) in length
    print(f"phase 10: serving {SSM_ARCH} through repro_torch.launch.serve: batch "
          f"{SERVE_SSM_BATCH}, Zipf prompts of {SERVE_SSM_PROMPT} tokens, {SERVE_SSM_NEW} greedy "
          f"new tokens")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = serve.build_model(SSM_ARCH, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"  model built and its projections cast to {model.cfg.compute_dtype} in "
          f"{time.perf_counter() - t0:.2f} s ({torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"resident)")
    loop = serve.serve_loop(model, SERVE_SSM_BATCH, max_len)
    batch = serve.requests(model, SERVE_SSM_BATCH, SERVE_SSM_PROMPT, seed=0)
    loop.generate(batch, 4)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ssd_diag_cuda.launches = flash_attention_cuda.launches = ei_argmax_cuda.launches = 0
    out = loop.generate(batch, SERVE_SSM_NEW, echo_metrics=True)
    launches = ssd_diag_cuda.launches
    others = (flash_attention_cuda.launches, ei_argmax_cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    m = out["metrics"]
    tokens = out["tokens"]
    steps = m["decoded"] - 1
    step_ms = m["decode_s"] * 1e3 / max(steps, 1)
    print(f"  prefill {m['prefill_s'] * 1e3:.1f} ms, decode {step_ms:.2f} ms per step "
          f"({steps} steps), {m['tokens_per_s']:.1f} tokens/s; peak allocated "
          f"{peak / 1e9:.2f} GB")
    print(f"  kernel launches while serving: SSD {launches} (one prefill of "
          f"{model.cfg.num_layers} layers, {steps} decode steps), flash {others[0]}, ei_argmax "
          f"{others[1]}")
    if launches != model.cfg.num_layers or others != (0, 0):
        raise AssertionError(f"serving launched SSD {launches} times (want one per layer of "
                             f"the prefill, none per decode step) and {others} others")
    if tokens.shape != (SERVE_SSM_BATCH, SERVE_SSM_NEW):
        raise AssertionError(f"served tokens of shape {tokens.shape}")

    with torch.inference_mode():
        seq = torch.cat([batch["tokens"].long(),
                         torch.as_tensor(tokens[:, :-1], device=dev).long()], 1)
        logits, _ = model.forward({"tokens": seq})
        logits = logits[:, SERVE_SSM_PROMPT - 1:].clone()
        ref_tokens = logits.argmax(-1).cpu().numpy()
        ref_logits = logits.cpu().numpy()
        cache = model.init_cache(SERVE_SSM_BATCH, max_len)
        served = [model.prefill(batch, cache)[0]]
        for i in range(SERVE_SSM_NEW - 1):
            pos = SERVE_SSM_PROMPT + i
            served.append(model.decode_step(cache, seq[:, pos:pos + 1], pos)[0])
        diff = torch.cat(served, 1) - logits
        rms_rel = float(diff.square().mean().sqrt() / logits.square().mean().sqrt())
        max_abs = float(diff.abs().max())
        del logits, served, diff
    print(f"  served path's logits over the served tokens vs the forward's: RMS {rms_rel:.3e} of "
          f"the forward logits' RMS (limit {SSM_FORWARD_RMS_REL}), max |diff| {max_abs:.4f} "
          f"(limit {SSM_FORWARD_MAX_ABS})")
    if rms_rel > SSM_FORWARD_RMS_REL or max_abs > SSM_FORWARD_MAX_ABS:
        raise AssertionError("served logits and forward logits disagree beyond the stated "
                             "tolerance")
    cmp = compare_token_traces(ref_tokens, tokens, ref_logits, atol=SERVE_TIE_ATOL)
    compared = cmp.matched * SERVE_SSM_NEW + sum(n for _, n, _ in cmp.ties)
    print(f"  served tokens vs the teacher-forced forward's argmax (T = {seq.shape[1]}, padded to "
          f"a chunk multiple): {cmp.matched} of {SERVE_SSM_BATCH} rows match in full, "
          f"{len(cmp.ties)} end at a certified tie (within {SERVE_TIE_ATOL}; reported, not "
          f"counted as matches); {compared} of {tokens.size} steps equal before any tie")
    for b, n, detail in cmp.ties:
        print(f"    tie: row {b} step {n}: {detail}")
    prof = decode_breakdown(model, batch, max_len=max_len)
    print(f"  profiled decode step: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['device_busy_ms']:.2f} ms (idle share {prof['idle_share']:.3f}), "
          f"{prof['device_kernels']} kernels per step")
    for name, ms in prof["top_kernels_ms"].items():
        print(f"    device {ms:.3f} ms  {name}")
    for name, ms in prof["top_host_ops_ms"].items():
        print(f"    host   {ms:.3f} ms  {name}")
    report["ssm_serve"] = {
        "decode_breakdown": prof,
        "prefill_ms": m["prefill_s"] * 1e3, "decode_ms_per_step": step_ms,
        "tokens_per_s": m["tokens_per_s"], "decoded": m["decoded"], "peak_bytes": int(peak),
        "full_matches": cmp.matched, "ties": [list(t) for t in cmp.ties],
        "steps_equal": compared, "logits_rms_rel": rms_rel, "logits_max_abs": max_abs,
        "launches": {"ssd_diag": launches, "flash_attention": others[0], "ei_argmax": others[1]},
    }
    return launches


# ---------------------------------------------------------------- phase 11

RN_CASES = [  # (x shape, dtype): tests/test_kernels.py's, its nd input, then the timed shapes
    ((256, 64), "float32"), ((300, 128), "float32"), ((64, 1024), "float32"),
    ((512, 384), "bfloat16"), ((2, 7, 96), "float32"),
    ((4096, 1024), "float32"), ((16384, 4096), "float32"), ((16384, 4096), "bfloat16"),
]
RN_TIMED = RN_CASES[-3:]  # the op's path: driven once at each, then timed
# Kernel against plain version: float32 within 1e-5 (sums of squares in
# another order; tests/test_kernels.py's limit for the TPU kernel);
# bfloat16 within one step of the output (2^-7 relative): both round the
# same float32 value once.  The gradient goes through the op's backward,
# autograd through the oracle, against the oracle's own: 1e-4, the
# reference's limit for its custom VJP.
RN_TOL = {"float32": dict(rtol=0.0, atol=1e-5), "bfloat16": dict(rtol=2.0**-7, atol=0.0)}
RN_GRAD_ATOL = 1e-4
# `F.rms_norm` only has to show that the timed call computes the same
# function: in bfloat16 it rounds once more (after the normalization, before
# the scale), so it is held to two output steps.
RN_LIB_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2.0**-6, atol=1e-3)}
RN_EPS = 1e-6


def rmsnorm_bound(rows: int, d: int, itemsize: int) -> dict:
    """Least time for one RMSNorm call: x read and y written once, the f32
    scale read once, over HBM bandwidth; and 4 operations an element (the
    square and its sum, the two products) over the FP32 peak."""
    nbytes = 2 * rows * d * itemsize + 4 * d
    flops = 4 * rows * d
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def rn_inputs(dev, seed, shape, dtype):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev).to(getattr(torch, dtype))
    s = (1 + 0.1 * torch.randn(shape[-1:], generator=g, device=dev)).to(getattr(torch, dtype))
    return x, s


def phase_rmsnorm(dev, report) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_plain
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.testing import assert_close

    print(f"phase 11: RMSNorm kernel vs plain version on the card (float32 "
          f"{RN_TOL['float32']}; bfloat16 {RN_TOL['bfloat16']}; gradient atol {RN_GRAD_ATOL})")
    errs = {}

    def name_of(shape, dt):
        return f"{'x'.join(map(str, shape))} {dt}"

    with torch.inference_mode():
        for i, (shape, dt) in enumerate(RN_CASES):
            x, s = rn_inputs(dev, 300 + i, shape, dt)
            out, plain = rmsnorm(x, s, RN_EPS), rmsnorm_plain(x, s, RN_EPS)
            torch.cuda.synchronize()
            name = name_of(shape, dt)
            if out.shape != x.shape or out.dtype != x.dtype or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name}: output {tuple(out.shape)} {out.dtype} not finite")
            errs[name] = assert_close(plain.float().cpu().numpy(), out.float().cpu().numpy(),
                                      **RN_TOL[dt], what=name)
            print(f"  {name:22s} max |kernel - plain| {errs[name]:.3e}")
    for shape in ((300, 128), (4096, 1024)):
        x, s = rn_inputs(dev, 7, shape, "float32")
        cot = torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(8), device=dev)
        grads = []
        for fn in (rmsnorm, rmsnorm_ref):
            a, b = x.clone().requires_grad_(), s.clone().requires_grad_()
            (fn(a, b, RN_EPS) * cot).sum().backward()
            grads.append((a.grad, b.grad))
        for what, k, r in zip(("x", "scale"), grads[0], grads[1]):
            err = assert_close(r.cpu().numpy(), k.cpu().numpy(), rtol=0.0, atol=RN_GRAD_ATOL,
                               what=f"gradient in {what} at {shape}")
            print(f"  gradient in {what} at {shape}: max |op - oracle| {err:.3e}")

    cases = []
    for i, (shape, dt) in enumerate(RN_TIMED):
        x, s = rn_inputs(dev, 400 + i, shape, dt)
        cases.append((shape, dt, x.reshape(4, -1, shape[-1]), s))  # (B, T, D), as a model holds it
    torch.cuda.synchronize()
    rmsnorm_cuda.launches = 0  # the op's path: one call at each timed shape
    with torch.inference_mode():
        outs = [rmsnorm(x, s, RN_EPS) for _, _, x, s in cases]
    torch.cuda.synchronize()
    launches = rmsnorm_cuda.launches
    print(f"  kernel launches {launches} over {len(cases)} calls of the op")
    if launches != len(cases):
        raise AssertionError(f"rmsnorm kernel launched {launches} times in {len(cases)} calls")

    times = {}
    with torch.inference_mode():
        for (shape, dt, x, s), out in zip(cases, outs):
            name = name_of(shape, dt)
            d = shape[-1]
            lib = lambda: F.rms_norm(x, (d,), s, RN_EPS)
            err_lib = assert_close(lib().float().cpu().numpy(), out.float().cpu().numpy(),
                                   **RN_LIB_TOL[dt], what=f"{name} vs F.rms_norm")
            ms = cuda_time_ms(lambda: rmsnorm(x, s, RN_EPS))
            plain_ms = cuda_time_ms(lambda: rmsnorm_plain(x, s, RN_EPS))
            lib_ms = cuda_time_ms(lib)
            k_dev = graph_ms(lambda: rmsnorm(x, s, RN_EPS))
            p_dev = graph_ms(lambda: rmsnorm_plain(x, s, RN_EPS))
            l_dev = graph_ms(lib)
            # A working set under 50 MB stays in L2 across graph replays,
            # where no HBM bound binds it: also timed with L2 flushed.
            k_cold = cold_graph_ms(lambda: rmsnorm(x, s, RN_EPS))
            l_cold = cold_graph_ms(lib)
            bound = rmsnorm_bound(x.numel() // d, d, x.element_size())
            print(f"  time at {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, F.rms_norm "
                  f"{lib_ms:.4f} ms (CUDA events around one call, median of 30); device time per "
                  f"call (CUDA graph replay): kernel {k_dev:.4f} ms, plain {p_dev:.4f} ms, "
                  f"F.rms_norm {l_dev:.4f} ms; bound {bound['bound_ms']:.4f} ms "
                  f"({bound['bound_by']}; {bound['bytes']} B, {bound['flops']} flop); "
                  f"max |kernel - F.rms_norm| {err_lib:.3e}; device time kernel / F.rms_norm "
                  f"{k_dev / l_dev:.3f}, kernel at {bound['bound_ms'] / k_dev:.3f} of its bound")
            print(f"    with L2 flushed before each call: kernel {k_cold:.4f} ms, F.rms_norm "
                  f"{l_cold:.4f} ms of device time; kernel at {bound['bound_ms'] / k_cold:.3f} "
                  f"of its bound")
            times[name] = dict(shape=name, max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                               device_ms=k_dev, plain_device_ms=p_dev, library_ms=lib_ms,
                               library_device_ms=l_dev, device_cold_ms=k_cold,
                               library_device_cold_ms=l_cold, library_err=err_lib, **bound)
    report["rmsnorm"] = {"case_errs": errs, "launches": launches, "shapes": times}
    return {"launches_per_call": launches // len(cases), "times": times}


# ---------------------------------------------------------------- phases 12 and 13

TRAIN_STEPS = 3
TRAIN_PATHS = {  # the training cells: (arch, layers kept or None for all, global batch, T, microbatches)
    "train": ("qwen3-8b", 8, 2, 4096, 2),
    "ssm_train": ("mamba2-370m", None, 4, 4096, 2),
}
TRAIN_KERNELS = {  # the kernel each runs, its device names, its backward's profiler range
    # and the route counter that must carry every launch (None: one route)
    "train": ("flash_attention", FLASH_KERNEL_NAMES, "flash_attention.backward",
              "tensor_core_launches"),
    "ssm_train": ("ssd_diag", SSD_KERNEL_NAMES, "ssd_diag.backward", None),
}
# Step 1's cross-entropy at random initialization: about ln(V) + σ²/2 for
# logits of spread σ about 1 (the unembedding's fan-in scaling of a
# normalized state); it must lie within 1 of ln(V).
TRAIN_CE_SLACK = 1.0
# The first step against the same step through the route without the
# kernel (qwen3: the dense attention route; mamba2: the einsum route of the
# SSD term), on the same parameters and batch.  Both compute in bfloat16;
# they differ where a float32 difference carries a value across a bfloat16
# rounding boundary, which propagates through the later layers.  On the
# CPU, at full width (vocab cut to 4096, 2 x 256 tokens in 2 microbatches),
# qwen3's two routes give losses 2.7e-5 and 2.3e-5 apart (relative) at 2
# and 4 layers, gradient norms 2.4e-5 and 6.1e-6; mamba2's at 48 layers (2 x
# 512 tokens) 8.0e-5 and 7.3e-5.  Longer sequences and more layers carry a
# difference further: allow 2^-9 relative for the loss (24x the largest)
# and 2^-6 for the gradient norm (200x).
TRAIN_LOSS_REL = 2.0**-9
TRAIN_GRAD_NORM_REL = 2.0**-6


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by name (each counts its launches)."""
    from repro_torch.kernels.ei_argmax.kernel import ei_argmax_cuda
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_cuda
    from repro_torch.kernels.ssd.kernel import ssd_diag_cuda

    return {"ei_argmax": ei_argmax_cuda, "flash_attention": flash_attention_cuda,
            "ssd_diag": ssd_diag_cuda, "rmsnorm": rmsnorm_cuda}


def fingerprint(tree) -> list:
    """Per tensor of ``tree``, two int64 sums of its raw bits (plain, and
    weighted by position): a restore that returns every bit gives the same
    pairs, and one that changes a bit changes them."""
    import torch

    from repro_torch.models.spec import leaves

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = []
    for _, t in leaves(tree):
        bits = t.detach().reshape(-1).view(ints[t.element_size()])
        s1 = s2 = 0
        for chunk in bits.split(1 << 26):
            c = chunk.long()
            w = torch.arange(c.numel(), device=c.device) % 65521 + 1
            s1 = s1 + c.sum()
            s2 = s2 + (c * w).sum()
        out.append((int(s1), int(s2)))
    return out


class reference_route:
    """The training cell's model on the route without its kernel: for qwen3
    a second `Model` over the same parameter tensors with the dense
    attention route; for mamba2 the same model with `ssm_apply` held at its
    einsum default (the route the reference's `Model` takes)."""

    def __init__(self, path, model):
        self.path, self.model = path, model

    def __enter__(self):
        from repro_torch.models import ssm as S
        from repro_torch.models.model import Model

        if self.path == "train":
            return Model(self.model.cfg.replace(attention_impl="dense"),
                         params=self.model.params_tree(), device=self.model.device)
        self.apply = S.ssm_apply
        S.ssm_apply = lambda p, cfg, x, use_kernel=False, **kw: self.apply(
            p, cfg, x, use_kernel=False, **kw)
        return self.model

    def __exit__(self, *exc):
        from repro_torch.models import ssm as S

        if self.path != "train":
            S.ssm_apply = self.apply


def phase_training(dev, report, path) -> int:
    import math
    import shutil
    import tempfile

    import torch

    from repro_torch import configs as C
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import SyntheticDataset, shard_batch
    from repro_torch.models.model import Model
    from repro_torch.runtime.loop import TrainLoop
    from repro_torch.runtime.steps import init_train_state, make_grad_fn, make_train_step

    arch, layers, gbatch, t, mb = TRAIN_PATHS[path]
    kname, device_names, backward_range, route_attr = TRAIN_KERNELS[path]
    counters = kernel_counters()
    counter = counters[kname]
    spec = C.get(arch)
    cfg = spec.model if layers is None else spec.model.replace(num_layers=layers)
    ex = spec.exec.replace(num_microbatches=mb, total_steps=TRAIN_STEPS)
    per_step = 2 * cfg.num_layers * mb
    tokens = gbatch * t
    phase = {"train": 12, "ssm_train": 13}[path]
    marks = [time.perf_counter()]  # the phase's parts, for the time it takes
    print(f"phase {phase}: {arch} training, {cfg.num_layers} of {spec.model.num_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.param_dtype} params, "
          f"{cfg.compute_dtype} compute, {ex.optimizer}, remat {cfg.remat_policy}, global batch "
          f"{gbatch} x {t} in {mb} microbatches, {TRAIN_STEPS} steps")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  {n_params} parameters drawn on the card in {time.perf_counter() - t0:.2f} s")
    if n_params != model.total_params():
        raise AssertionError(f"{n_params} parameters, the spec says {model.total_params()}")
    ds = SyntheticDataset(cfg, gbatch, t, seed=0)

    def place(batch):
        return shard_batch(batch, dev)

    # The route without the kernel: the first step's loss and gradient norm,
    # before any update, on the same parameters and batch.
    before = {k: c.launches for k, c in counters.items()}
    with reference_route(path, model) as other:
        t0 = time.perf_counter()
        grads, om = make_grad_fn(other, ex)(other.params_tree(), place(ds.batch_at(0)))
        other_loss, other_norm = float(om["loss"]), float(om["grad_norm"])
        other_s = time.perf_counter() - t0
        del grads, other
    if any(c.launches != before[k] for k, c in counters.items()):
        raise AssertionError("the route without the kernel launched a kernel")
    torch.cuda.empty_cache()

    marks.append(time.perf_counter())
    state = init_train_state(model, ex)
    step_fn = make_train_step(model, ex)
    steps = []  # per step: start and end events, launches of the path's kernel, wall seconds

    def route_count():
        return getattr(counter, route_attr) if route_attr else counter.launches

    def timed_step(state, batch):
        launched, routed = counter.launches, route_count()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        state, m = step_fn(state, batch)
        b.record()
        loss = float(m["loss"])  # waits for the step, as the loop does
        steps.append(dict(events=(a, b), launches=counter.launches - launched,
                          routed=route_count() - routed, wall_s=time.perf_counter() - t0,
                          loss=loss))
        return state, m

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        loop = TrainLoop(train_step=timed_step, batch_at=ds.batch_at, place_batch=place,
                         state=state, checkpoints=CheckpointManager(ckdir, keep_n=1),
                         checkpoint_every=2, log_every=1, log_fn=lambda s: print(f"  {s}"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        metrics = []

        def keep(state, batch):
            state, m = timed_step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            return state, m

        loop.train_step = keep
        t0 = time.perf_counter()
        loop.run(2)  # steps 1 and 2; the step-2 checkpoint written
        run_s = time.perf_counter() - t0
        fp2 = fingerprint(loop.state)
        state, _ = keep(loop.state, place(ds.batch_at(2)))  # step 3, uninterrupted
        torch.cuda.synchronize()
        launched = {k: c.launches for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        ck_bytes = sum(f.stat().st_size for f in Path(ckdir).rglob("*") if f.is_file())
        save_s = run_s - sum(s["wall_s"] for s in steps[:2])

        marks.append(time.perf_counter())
        resumed = TrainLoop(train_step=keep, batch_at=ds.batch_at, place_batch=place,
                            state=state, checkpoints=CheckpointManager(ckdir, keep_n=1),
                            checkpoint_every=2, log_fn=lambda s: print(f"  {s}"))
        t0 = time.perf_counter()
        start = resumed.maybe_restore()  # in place, into the same tensors
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored_equal = fingerprint(resumed.state) == fp2
        resumed.state, _ = keep(resumed.state, place(ds.batch_at(2)))  # step 3 again
        marks.append(time.perf_counter())
        prof = train_breakdown(lambda: step_fn(resumed.state, place(ds.batch_at(3))),
                               device_names, backward_range)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    marks.append(time.perf_counter())
    parts = np.diff(marks)

    ev_ms = [s["events"][0].elapsed_time(s["events"][1]) for s in steps]
    walls = [s["wall_s"] * 1e3 for s in steps]
    tok_s = tokens / (float(np.median(walls[1:])) / 1e3)
    first = metrics[0]
    loss_rel = abs(first["loss"] - other_loss) / abs(other_loss)
    norm_rel = abs(first["grad_norm"] - other_norm) / abs(other_norm)
    ln_v = math.log(cfg.vocab_size)
    for i, (s, m) in enumerate(zip(steps, metrics)):
        label = f"step {i + 1}" if i < 3 else "step 3 after the restore"
        print(f"  {label}: loss {m['loss']:.6f} (ce {m['ce']:.6f}), grad norm "
              f"{m['grad_norm']:.6f}, lr {m['lr']:.3e}; {s['launches']} {kname} launches "
              f"({s['routed']} {route_attr or 'of its kernel'}); "
              f"{ev_ms[i]:.1f} ms by CUDA events, {walls[i]:.1f} ms wall")
    print(f"  peak allocated {peak / 1e9:.2f} GB over steps 1-3; {tokens} tokens a step, "
          f"{tok_s:.1f} tokens/s (median wall of the steps after the first); checkpoint "
          f"{ck_bytes} B, host snapshot and write {save_s:.1f} s, restore {restore_s:.1f} s")
    print(f"  step 1 vs the route without the kernel ({other_s:.1f} s): loss {other_loss:.6f}, "
          f"relative difference {loss_rel:.3e} (limit {TRAIN_LOSS_REL}); grad norm "
          f"{other_norm:.6f}, relative difference {norm_rel:.3e} (limit {TRAIN_GRAD_NORM_REL}); "
          f"step 1 ce {first['ce']:.4f} vs ln(V) {ln_v:.4f} (limit {TRAIN_CE_SLACK})")
    print(f"  restore of step {start}: every tensor bit-equal {restored_equal}; step 3 loss "
          f"{metrics[3]['loss']!r} vs uninterrupted {metrics[2]['loss']!r}")
    print(f"  profiled step 4: wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms (idle share {prof['idle_share']:.3f}), {kname} "
          f"{prof['kernel_ms']:.1f} ms ({prof['kernel_share']:.3f} of device time), its "
          f"backward through the oracle {prof['range_ms']} ms ({prof['range_share']} of device "
          f"time), {prof['device_kernels']:.0f} device kernels")
    for name, ms in prof["top_kernels_ms"].items():
        print(f"    device {ms:.3f} ms  {name}")
    for name, ms in prof["top_host_ops_ms"].items():
        print(f"    host   {ms:.3f} ms  {name}")
    print(f"  phase time: set-up and the route without the kernel {parts[0]:.1f} s, steps 1-3 "
          f"with the checkpoint {parts[1]:.1f} s, restore and step 3 again {parts[2]:.1f} s, "
          f"profiled step {parts[3]:.1f} s (its trace summary {prof['summary_s']:.1f} s)")

    if any(s["launches"] != per_step or s["routed"] != per_step for s in steps):
        raise AssertionError(f"{kname} launched {[s['launches'] for s in steps]} times a step, "
                             f"{[s['routed'] for s in steps]} through {route_attr or 'its kernel'}; "
                             f"want {per_step} (2 x {cfg.num_layers} layers x {mb} microbatches)")
    if any(v for k, v in launched.items() if k != kname):
        raise AssertionError(f"the training path launched other kernels: {launched}")
    if not all(math.isfinite(m[k]) for m in metrics for k in ("loss", "grad_norm")):
        raise AssertionError("non-finite loss or gradient norm")
    if abs(first["ce"] - ln_v) > TRAIN_CE_SLACK:
        raise AssertionError(f"step 1 ce {first['ce']} is not near ln(V) = {ln_v}")
    if loss_rel > TRAIN_LOSS_REL or norm_rel > TRAIN_GRAD_NORM_REL:
        raise AssertionError("the kernel's route and the route without it disagree beyond the "
                             "stated tolerance")
    if start != 2 or not restored_equal:
        raise AssertionError(f"restore from step {start}: tensors bit-equal {restored_equal}")
    if metrics[3]["loss"] != metrics[2]["loss"]:
        raise AssertionError("step 3 after the restore differs from the uninterrupted step 3")
    report[path] = {
        "params": n_params, "tokens_per_step": tokens, "launches_per_step": per_step,
        "steps": [dict(m, launches=s["launches"], events_ms=e, wall_ms=w)
                  for m, s, e, w in zip(metrics, steps, ev_ms, walls)],
        "peak_bytes": int(peak), "tokens_per_s": tok_s, "checkpoint_bytes": ck_bytes,
        "save_s": save_s, "restore_s": restore_s, "other_route": {
            "loss": other_loss, "grad_norm": other_norm, "loss_rel": loss_rel,
            "grad_norm_rel": norm_rel, "seconds": other_s},
        "breakdown": prof, "phase_parts_s": parts.tolist(),
    }
    return per_step


def train_breakdown(fn, kernel_names, backward_range) -> dict:
    """One training step under `torch.profiler` (`profile_summary`), and the
    device time of the kernels launched inside the backward's profiler
    range (autograd through the oracle), where the profiler reports it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out = profile_summary(prof, 1, wall, kernel_names, ranges=(backward_range,))
    out["summary_s"] = time.perf_counter() - t0
    range_ms = out["ranges_ms"][backward_range]
    out["range_ms"] = range_ms if range_ms is not None else "not measured"
    out["range_share"] = (range_ms / out["device_busy_ms"] if range_ms is not None
                          else "not measured")
    return out


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
        from repro_torch.kernels.flash_attention import kernel as fa_kernel
        from repro_torch.kernels.rmsnorm import kernel as rn_kernel
        from repro_torch.kernels.ssd import kernel as ssd_kernel
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script ({e})", file=sys.stderr)
        return 2

    dev = resolve_device("cuda")  # also pins float32 matmuls (no TF32)
    card = card_line()
    print(f"phase 0: card {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    report = {"card": card}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:  # one nvcc per library, started together
        for f in [pool.submit(m.load) for m in (ei_kernel, fa_kernel, ssd_kernel, rn_kernel)]:
            f.result()
    print(f"  ei_argmax, flash_attention, ssd and rmsnorm kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in ("ei_argmax", "flash_attention", "ssd", "rmsnorm"):
        for line in build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                print(f"    {name}: {kernel_name(line.split(chr(39))[1])}:")
            elif "registers" in line or "spill" in line or "built in" in line:
                print(f"    {name}:   {line.strip()}")
    sass = {}
    for name, mod in (("ei_argmax", ei_kernel), ("flash_attention", fa_kernel),
                      ("ssd", ssd_kernel)):
        sass[name] = sass_counts(mod.load()._name)
        for fn, counts in sass[name].items():
            print(f"    {name} SASS {fn}: {counts}")
    tc = [c for fn, c in sass["flash_attention"].items() if fn.startswith("flash_fwd_wgmma_kernel")]
    if not tc or not all(c["HGMMA"] and c["UTMALDG"] for c in tc):
        raise AssertionError(f"the tensor-core flash kernel lacks HGMMA or UTMALDG: {sass}")
    if not sass["ssd"].get("ssd_diag_wgmma_kernel", {}).get("HGMMA"):
        raise AssertionError(f"the SSD kernel lacks HGMMA: {sass['ssd']}")
    report["sass"] = sass
    fa_lib = fa_kernel.load()
    print(f"    flash_attention: {fa_lib.flash_attention_smem_bytes(FWD_SHAPE[4])} (CUDA cores) "
          f"and {fa_lib.flash_attention_wgmma_smem_bytes(FWD_SHAPE[4])} (tensor cores) bytes "
          f"of dynamic shared memory per block at D={FWD_SHAPE[4]}")
    print(f"    ssd: {ssd_kernel.load().ssd_diag_smem_bytes()} bytes of dynamic shared memory "
          f"per block (any shape)")

    failed = []
    times, fa_times, ssd_times, rn, fleet, launches = None, None, None, None, None, {}
    seq = {}  # phase 2's traces, which phase 14 holds the fleet against
    for name, phase in (
        ("kernel", lambda: phase_kernel(dev, report)),
        ("pipeline", lambda: phase_pipeline(dev, SEEDS, report, seq)),
        ("catalog", lambda: phase_catalog(dev, report)),
        ("fixture", lambda: phase_fixture(dev, report)),
        ("fleet", lambda: phase_fleet(dev, report, seq)),
        ("flash", lambda: phase_flash(dev, report)),
        ("forward", lambda: phase_forward(dev, report)),
        ("serve", lambda: phase_serve(dev, report)),
        ("ssd", lambda: phase_ssd(dev, report)),
        ("ssm_forward", lambda: phase_ssm_forward(dev, report)),
        ("ssm_serve", lambda: phase_ssm_serve(dev, report)),
        ("rmsnorm", lambda: phase_rmsnorm(dev, report)),
        ("train", lambda: phase_training(dev, report, "train")),
        ("ssm_train", lambda: phase_training(dev, report, "ssm_train")),
    ):
        try:
            out = phase()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            print(f"  FAILED: phase {name}")
            failed.append(name)
            continue
        finally:
            torch.cuda.empty_cache()
        if name == "kernel":
            times = out
        elif name == "flash":
            fa_times = out
        elif name == "ssd":
            ssd_times = out
        elif name == "rmsnorm":
            rn = out
        elif name == "fleet":
            fleet = out
        elif name != "serve":
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
    # K1 on the fleet's paths (phase 14): one launch a chunk step, J = 8 rows.
    kernels.extend({
        "name": "ei_argmax",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ei_argmax/csrc/ei_argmax.cu",
        "replaces": "src/repro/kernels/ei_argmax/kernel.py:110",
        "path": path,
        "shape": t["shape"],
        "launches": fleet["launches"][path],
        "max_abs_err": t["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "device_ms": t["device_ms"],
        "plain_device_ms": t["plain_device_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    } for path, t in fleet["times"].items())
    # K2: the tensor-core kernel runs the bfloat16 paths (a training
    # microbatch runs the forward's shape); the CUDA-core kernel's path is
    # the float32 op, driven once in phase 5.
    kernels.extend({
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/flash_attention/csrc/{src}",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:113",
        "path": path,
        "shape": t["shape"],
        "launches": n,
        "max_abs_err": t["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "device_ms": t["device_ms"],
        "plain_device_ms": t["plain_device_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],  # scaled_dot_product_attention
        "library_device_ms": t["library_device_ms"],
    } for name, src, path, t, n in (
        ("flash_attention_wgmma", "flash_attention_wgmma.cu", "forward",
         fa_times["tensor_core"], launches["forward"]),
        ("flash_attention_wgmma", "flash_attention_wgmma.cu", "train",
         fa_times["tensor_core"], launches["train"]),
        ("flash_attention", "flash_attention.cu", "op_float32",
         fa_times["cuda_core"], fa_times["cuda_core"]["op_launches"]),
    ))
    kernels.extend({
        "name": "ssd_diag",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_wgmma.cu",
        "replaces": "src/repro/kernels/ssd/ssd.py:59",
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
    } for path, t in ssd_times.items())
    kernels.extend({
        "name": "rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/rmsnorm.py:29",
        "path": "op",
        "shape": t["shape"],
        "launches": rn["launches_per_call"],
        "max_abs_err": t["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "device_ms": t["device_ms"],
        "plain_device_ms": t["plain_device_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],  # torch.nn.functional.rms_norm
        "library_device_ms": t["library_device_ms"],
    } for t in rn["times"].values())
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
