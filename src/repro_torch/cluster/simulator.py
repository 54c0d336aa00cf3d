"""Deterministic cost-surface and profiling emulation (paper §IV).

`job_cost_table` produces, for one job, the execution cost (USD) of every
cluster configuration — the quantity CherryPick/Ruya observe one trial at a
time.  The model follows the paper's Background section:

  runtime_h = [ serial
              + cpu_hours   · ref_cores / total_cores        (data-parallel)
              + io_hours    · ref_nodes / nodes ]             (disk/shuffle)
              · (1 + coord·(nodes-1))                         (coordination)
              · spill(config)                                 (memory cliff)
              · exp(σ · z_{job,config})                       (cloud variance)
  cost$     = runtime_h · price_per_hour(config)

`spill` is 1.0 when the job's (full-dataset) memory requirement fits into the
usable cluster memory and jumps to `spill_base + spill_slope·missing_frac`
when it does not — the drastic, discontinuous slowdown of Fig. 1.

The per-(job, config) variance term is *deterministic* (hashed seed): the
paper evaluates against one fixed dataset of recorded runs, and repeats only
randomize the BO initialization, not the costs.

`make_profile_run_fn` emulates the single-laptop profiling runs of §III-B:
runtime proportional to the sample size (calibrated to land Table III), and
peak-memory readings whose noise level drives the job into its ground-truth
linear/flat/unclear category.

The port's own numpy copy of the reference module `repro/cluster/simulator.py`:
the port never imports the JAX package, and the two stay bit-equal.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.cluster.faults import FaultPlan
from repro_torch.cluster.nodes import (
    ClusterConfig,
    enumerate_cluster_configs,
    make_cluster_search_space,
)
from repro_torch.cluster.pricing import PriceCatalog
from repro_torch.cluster.workloads import JOBS, JobSpec, _scenario_catalog
from repro_torch.core.search_space import SearchSpace

__all__ = [
    "REF_CORES",
    "REF_NODES",
    "USABLE_MEM_FRACTION",
    "PER_NODE_OVERHEAD_GB",
    "ClusterSimulator",
    "job_cost_table",
    "job_runtime_table",
    "make_profile_run_fn",
]

REF_CORES = 32  # reference parallelism for cpu_hours
REF_NODES = 8  # reference node count for io_hours
# Table I requirements are JOB memory; the framework/OS resident set is
# modeled separately as a flat per-node overhead, so the memory a job can
# actually use is  total · USABLE_MEM_FRACTION − overhead · nodes  (clamped
# at 0: a grid of nodes smaller than the overhead has NO usable memory —
# it must not wrap around into a saturated spill via the missing-fraction
# clamp).
USABLE_MEM_FRACTION = 1.0  # job-usable fraction of instance memory
PER_NODE_OVERHEAD_GB = 0.5  # framework+OS resident memory per node


def _hash_unit_normal(*parts: str) -> float:
    """Deterministic ~N(0,1) from a string key (Box–Muller over a hash)."""
    h = hashlib.sha256("/".join(parts).encode()).digest()
    u1 = (int.from_bytes(h[:8], "big") + 1) / (2**64 + 2)
    u2 = (int.from_bytes(h[8:16], "big") + 1) / (2**64 + 2)
    return float(np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2))


def _spill_factor(job: JobSpec, cfg: ClusterConfig) -> float:
    if job.spill_slope == 0.0 and job.spill_base <= 1.0:
        return 1.0
    # Usable = job-visible memory after the per-node framework/OS slice,
    # clamped at 0: on the committed c4/m4/r4 grid the smallest node
    # (3.75 GB) comfortably clears the 0.5 GB overhead, but the clamp is
    # the model's guarantee — a hypothetical grid of overhead-dominated
    # nodes spills at the full missing fraction instead of feeding a
    # negative "usable" into the ratio below.
    usable = max(
        cfg.total_memory_gb * USABLE_MEM_FRACTION
        - PER_NODE_OVERHEAD_GB * cfg.scale_out,
        0.0,
    )
    required = job.mem_requirement_gb
    if usable >= required:
        return 1.0
    missing = min(1.0, (required - usable) / required)
    return job.spill_base + job.spill_slope * missing


def runtime_hours(job: JobSpec, cfg: ClusterConfig) -> float:
    base = (
        job.serial_hours
        + job.cpu_hours * REF_CORES / cfg.total_cores
        + job.io_hours * REF_NODES / cfg.scale_out
    )
    coord = 1.0 + job.coord_per_node * (cfg.scale_out - 1)
    rug = np.exp(job.rugged_sigma * _hash_unit_normal(job.key, cfg.name))
    return base * coord * _spill_factor(job, cfg) * rug


def job_runtime_table(
    job: JobSpec, catalog: Optional[PriceCatalog] = None
) -> np.ndarray:
    """(69,) hours per configuration.  ``catalog`` applies its arch's
    runtime offset (`PriceCatalog.perf_factor`); None is the x86 baseline."""
    configs = enumerate_cluster_configs()
    rt = np.asarray([runtime_hours(job, c) for c in configs], np.float64)
    if catalog is not None and catalog.perf_factor != 1.0:
        rt = rt * catalog.perf_factor
    return rt


def job_cost_table(
    job: JobSpec, catalog: Optional[PriceCatalog] = None, epoch: int = 0
) -> np.ndarray:
    """(69,) USD execution cost per configuration, deterministic.

    With ``catalog=None`` (default) this is the legacy book — the
    committed x86 on-demand prices, bit-identical to every pinned trace.
    A catalog reprices the same configurations (runtime×price under its
    book at ``epoch``); the identity catalog (`pricing.on_demand()`)
    reproduces the legacy values bit-for-bit.
    """
    configs = enumerate_cluster_configs()
    if catalog is None:
        return np.asarray(
            [runtime_hours(job, c) * c.price_per_hour for c in configs],
            np.float64,
        )
    return job_runtime_table(job, catalog) * catalog.price_table(
        configs, epoch=epoch
    )


def make_profile_run_fn(job: JobSpec) -> Callable[[float], Tuple[float, float]]:
    """Single-machine profiling emulator: sample_gb -> (runtime_s, peak_gb).

    Runtime is linear in the sample size, scaled so the full §III-B procedure
    (one calibration run + five sweep runs on {0.2..1.0}·sample) lands near
    the job's Table III profiling time.  Memory readings follow the job's
    ground-truth slope with category-appropriate noise: near-exact for linear
    jobs, input-independent for flat jobs, and GC-sawtooth-corrupted for the
    regression jobs the paper found unclear.
    """
    # total ≈ 4 × r_cal (see profiler.py); r_cal is the 1 %-sample runtime.
    # Clamp the calibration runtime into the paper's [30 s, 300 s] corridor so
    # the profiler neither grows the sample nor cancels runs.
    first_sample_gb = 0.01 * job.input_gb
    r_cal = min(max(job.profile_time_s / 4.0, 31.0), 280.0)
    runtime_per_gb = r_cal / first_sample_gb

    def run(sample_gb: float) -> Tuple[float, float]:
        runtime_s = sample_gb * runtime_per_gb
        if job.category == "flat":
            # One-pass / disk-based jobs allocate fixed-size buffer pools;
            # the observed peak is the framework floor, quantized to JVM
            # heap-region granularity (128 MiB) — near-identical across
            # sample sizes, which is exactly why the paper's R² lands < 0.1.
            noise = 1.0 + job.profile_noise * 0.1 * _hash_unit_normal(
                job.key, "prof", f"{sample_gb:.6e}"
            )
            quantum = 0.125
            peak = round(job.base_mem_gb * noise / quantum) * quantum
        else:
            z = _hash_unit_normal(job.key, "prof", f"{sample_gb:.6e}")
            # GC sawtooth: multiplicative noise on the in-memory footprint.
            peak = job.mem_slope * sample_gb * (1.0 + job.profile_noise * z)
        return runtime_s, max(peak, 0.05)

    return run


@dataclasses.dataclass
class ClusterSimulator:
    """Bundles everything a searcher needs for one job.

    ``faults`` optionally attaches a `repro_torch.cluster.faults.FaultPlan`:
    `profile_run_fn` then injects the plan's transient/permanent failures
    into the profiling/probe runs (successful readings are untouched — a
    retried run replays identical values, which is what lets the golden
    harness pin disturbed fleets bit-identical to undisturbed ones), and
    the plan's per-trial straggler schedule is surfaced by the fleet layer
    as reported latency, never fed back into the cost surface.
    """

    job: JobSpec
    space: SearchSpace
    costs: np.ndarray  # (69,) USD
    normalized: np.ndarray  # costs / min(costs) — the paper's metric
    faults: Optional[FaultPlan] = None
    # Cost-aware extras, populated only when a catalog is requested: the
    # raw runtime/price axes the fleet layer threads into priced
    # `FleetJob`s (Pareto fronts, USD reporting).
    catalog: Optional[PriceCatalog] = None
    runtime_h: Optional[np.ndarray] = None  # (69,) hours under the catalog
    price_hour: Optional[np.ndarray] = None  # (69,) USD/hour under the catalog

    @classmethod
    def for_job(
        cls,
        key: str,
        faults: Optional[FaultPlan] = None,
        catalog: Optional[PriceCatalog] = None,
        epoch: int = 0,
    ) -> "ClusterSimulator":
        # Table I catalog first, then the MEMOIZED adversarial/drift
        # scenario specs (same key space).  Routed on `is None`, not on
        # `JOBS.get(key) or ...`: the falsy-`or` shape silently re-routes
        # falsy container values, and an unknown key must raise naming
        # both key spaces.
        job = JOBS.get(key)
        if job is None:
            job = _scenario_catalog().get(key)
        if job is None:
            raise KeyError(
                f"unknown job key {key!r}: valid keys are the Table I "
                f"catalog {sorted(JOBS)} or the failure scenarios "
                f"{sorted(_scenario_catalog())}"
            )
        space = make_cluster_search_space()
        if catalog is None:
            costs = job_cost_table(job)
            return cls(
                job=job, space=space, costs=costs,
                normalized=costs / costs.min(), faults=faults,
            )
        rt = job_runtime_table(job, catalog)
        price = catalog.price_table(epoch=epoch)
        costs = rt * price
        return cls(
            job=job, space=space, costs=costs,
            normalized=costs / costs.min(), faults=faults,
            catalog=catalog, runtime_h=rt, price_hour=price,
        )

    def cost_fn(self) -> Callable[[int], float]:
        table = self.normalized

        def fn(index: int) -> float:
            return float(table[index])

        return fn

    def profile_run_fn(self) -> Callable[[float], Tuple[float, float]]:
        """Byte-denominated wrapper around the GB-denominated emulator.

        The core profiler traffics in bytes (like a real /proc reading); the
        emulator's ground truth is specified in GB — convert on both ends.
        """
        base = make_profile_run_fn(self.job)

        def run(sample_bytes: float) -> Tuple[float, float]:
            rt, peak_gb = base(sample_bytes / 1024.0**3)
            return rt, peak_gb * 1024.0**3  # bytes, like a real reading

        if self.faults is not None:
            return self.faults.wrap_run(run, self.job.key)
        return run

    def optimal_cost(self) -> float:
        return 1.0

    def optimal_index(self) -> int:
        return int(np.argmin(self.costs))
