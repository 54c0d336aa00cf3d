"""The 16 evaluation jobs (paper Table I) as parameterized emulator specs.

Each spec fixes the job's *ground-truth* behaviour:
  * memory category + requirement at the full dataset size (Table I),
  * how the cost surface over the 69 configs is shaped (CPU/IO split, serial
    fraction, coordination overhead, spill severity at the memory cliff),
  * how noisy the single-machine memory readings are (which is what drives
    the linear/flat/unclear categorization, §IV-B),
  * the profiling-time scale (Table III).

HiBench input sizes are not printed in the paper; `input_gb` is chosen per
job so the implied bytes-in-memory-per-byte-of-input slopes are the 2–4×
JVM-object blowup typical for Spark caching.

The port's own numpy copy of the reference module `repro/cluster/workloads.py`:
the port never imports the JAX package, and the two stay bit-equal.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

if TYPE_CHECKING:  # pricing is a peer module; keep import-time deps flat
    from repro_torch.cluster.pricing import PriceCatalog

__all__ = [
    "JobSpec",
    "JOBS",
    "PricingScenario",
    "drift_spec",
    "failure_scenario_jobs",
    "family_constrained_scenarios",
    "pricing_scenarios",
    "spot_volatility_scenarios",
]


@dataclasses.dataclass(frozen=True)
class JobSpec:
    name: str  # e.g. "kmeans"
    framework: str  # "spark" | "hadoop"
    dataset: str  # "bigdata" | "huge"
    input_gb: float  # full input dataset size
    category: str  # ground truth: "linear" | "flat" | "unclear"
    mem_requirement_gb: float  # at full input (Table I for linear jobs)
    base_mem_gb: float  # framework-resident floor seen when profiling
    # --- cost-surface shape -------------------------------------------------
    serial_hours: float  # Amdahl serial part
    cpu_hours: float  # core-parallel work at the 8-core reference
    io_hours: float  # node-parallel (disk/shuffle) work at 4-node ref
    coord_per_node: float  # coordination overhead fraction per extra node
    spill_base: float  # instant runtime multiplier when the dataset
    spill_slope: float  # stops fitting + growth per missing fraction
    # --- profiling emulation -------------------------------------------------
    profile_noise: float  # relative noise of memory readings (GC churn)
    profile_time_s: float  # Table III target
    # --- objective ----------------------------------------------------------
    rugged_sigma: float = 0.10  # deterministic config-to-config variance

    @property
    def key(self) -> str:
        return f"{self.name}/{self.framework}/{self.dataset}"

    @property
    def mem_slope(self) -> float:
        """GB of job memory per GB of input (linear jobs)."""
        if self.category == "flat":
            return 0.0
        return self.mem_requirement_gb / self.input_gb


def _spark_ml(name, dataset, input_gb, req_gb, profile_time_s, *, unclear=False,
              cpu_hours=10.0, serial_hours=0.06, io_hours=1.0) -> JobSpec:
    return JobSpec(
        name=name,
        framework="spark",
        dataset=dataset,
        input_gb=input_gb,
        category="unclear" if unclear else "linear",
        mem_requirement_gb=req_gb,
        base_mem_gb=1.0,
        serial_hours=serial_hours,
        cpu_hours=cpu_hours,
        io_hours=io_hours,
        coord_per_node=0.006,
        spill_base=2.2,
        spill_slope=4.0,
        profile_noise=0.30 if unclear else 0.004,
        profile_time_s=profile_time_s,
    )


def _flat_job(name, framework, dataset, input_gb, profile_time_s, *,
              cpu_hours=6.0, io_hours=6.0, serial_hours=0.05) -> JobSpec:
    return JobSpec(
        name=name,
        framework=framework,
        dataset=dataset,
        input_gb=input_gb,
        category="flat",
        mem_requirement_gb=6.0,  # framework working set, input-independent
        base_mem_gb=4.0,
        serial_hours=serial_hours,
        cpu_hours=cpu_hours,
        io_hours=io_hours,
        coord_per_node=0.010,
        spill_base=1.0,  # no memory cliff: one-pass / disk-based
        spill_slope=0.0,
        profile_noise=0.04,
        profile_time_s=profile_time_s,
    )


def drift_spec(
    job: JobSpec,
    *,
    scale: float = 2.0,
    overhead_growth_gb: float = 0.0,
    slope_decay: float = 0.15,
    tag: str = "drift",
) -> JobSpec:
    """A recurring job whose memory behaviour has DRIFTED with its dataset.

    The streaming-system memory model (SNIPPETS.md snippet 1) is

        Memory = Overhead + Rows × Memory_Per_Row

    with the per-row slope *decreasing* as the dataset scales (dictionary
    encodings, shared buffers, and column compression amortize), while the
    fixed overhead creeps up with accumulated framework state.  This
    generator applies exactly that shift to a Table I spec: the input grows
    by ``scale``, the per-row slope decays as ``scale**-slope_decay``, and
    ``overhead_growth_gb`` is added to the resident floor.  The result is
    the drift-detection scenario's ground truth — a job whose fresh probe
    no longer matches the memory-signature class its old profile was filed
    under, so a Flora-style cache must re-profile instead of warm-seeding
    from the stale class.
    """
    if scale <= 0.0:
        raise ValueError(f"scale={scale}: want > 0")
    input_gb = job.input_gb * scale
    base_mem_gb = job.base_mem_gb + overhead_growth_gb
    if job.category == "flat":
        # Flat jobs have no per-row slope; drift is pure overhead creep.
        mem_requirement_gb = job.mem_requirement_gb + overhead_growth_gb
    else:
        slope = job.mem_slope * scale ** (-slope_decay)
        mem_requirement_gb = slope * input_gb + overhead_growth_gb
    return dataclasses.replace(
        job,
        name=f"{job.name}-{tag}",
        input_gb=input_gb,
        base_mem_gb=base_mem_gb,
        mem_requirement_gb=mem_requirement_gb,
    )


@functools.lru_cache(maxsize=1)
def _scenario_catalog() -> Dict[str, JobSpec]:
    """The memoized adversarial-scenario catalog (shared, do not mutate).

    `ClusterSimulator.for_job` consults this on every non-Table-I lookup;
    the specs are frozen dataclasses, so sharing one dict across lookups
    is safe — `failure_scenario_jobs()` hands callers their own copy.
    """
    kmeans = JOBS["kmeans/spark/bigdata"]
    terasort = JOBS["terasort/hadoop/bigdata"]
    out = {
        "flaky-kmeans": dataclasses.replace(kmeans, name="flaky-kmeans"),
        "broken-kmeans": dataclasses.replace(kmeans, name="broken-kmeans"),
        "drifted-kmeans": drift_spec(kmeans),
        "drifted-terasort": drift_spec(terasort, overhead_growth_gb=2.0),
    }
    return {spec.key: spec for spec in out.values()}


def failure_scenario_jobs() -> Dict[str, JobSpec]:
    """Named adversarial-scenario specs derived from the Table I catalog.

    These are the workloads the chaos lane (`pytest -m chaos`) and the
    adversarial fleet bench disturb: renamed clones whose profiling runs
    get a `repro_torch.cluster.faults.FaultPlan` attached (flaky / broken), plus
    drifted recurrences of a linear and a flat job (see `drift_spec`).
    The specs themselves are ordinary `JobSpec`s — the faults live in the
    plan, not the workload, so the same spec serves both the disturbed and
    the undisturbed (reference) run.  Built once per process (the specs
    are immutable); each call returns a fresh dict over the shared specs.
    """
    return dict(_scenario_catalog())


@dataclasses.dataclass(frozen=True)
class PricingScenario:
    """One cost-aware search setup: a Table I job priced under a catalog.

    ``families`` optionally restricts the search to the named node
    families (the priority pool is `pricing.family_indices(families)`);
    ``epoch`` selects the point of the catalog's spot-volatility schedule.
    The interesting scenarios are exactly the ones where the same job's
    cost-optimal configuration (argmin runtime×price under the catalog)
    differs from its runtime-optimal one (argmin of the legacy book) —
    fleet_bench workload H asserts that movement.
    """

    name: str
    job_key: str
    catalog: "PriceCatalog"
    families: Optional[Tuple[str, ...]] = None
    epoch: int = 0


# Jobs whose cost surfaces probe the three pricing-sensitive regimes:
# a memory-cliff job (spill dominates — family choice is load-bearing),
# an IO-heavy flat job (scale-out dominates), and a CPU-heavy job
# (core price dominates).
_PRICING_JOB_KEYS = (
    "kmeans/spark/bigdata",
    "terasort/hadoop/bigdata",
    "pagerank/spark/huge",
)


def spot_volatility_scenarios(
    seed: int = 0, epochs: Tuple[int, ...] = (0, 1, 2)
) -> List[PricingScenario]:
    """Spot-billed searches across several schedule epochs: the same job
    re-priced as the deterministic discount schedule moves, so the
    cost-optimal configuration can migrate while the runtime-optimal one
    stays put."""
    from repro_torch.cluster.pricing import spot

    cat = spot(seed)
    return [
        PricingScenario(
            name=f"spot/{key.split('/')[0]}-e{epoch}",
            job_key=key,
            catalog=cat,
            epoch=epoch,
        )
        for key in _PRICING_JOB_KEYS
        for epoch in epochs
    ]


def family_constrained_scenarios() -> List[PricingScenario]:
    """Family-constrained arm-book searches: the same job restricted to
    each node family under the graviton catalog, whose non-uniform
    per-family discounts move the cost optimum across family boundaries
    that the runtime objective never crosses."""
    from repro_torch.cluster.pricing import graviton

    cat = graviton()
    return [
        PricingScenario(
            name=f"graviton/{key.split('/')[0]}-{fam}",
            job_key=key,
            catalog=cat,
            families=(fam,),
        )
        for key in _PRICING_JOB_KEYS
        for fam in ("c", "m", "r")
    ]


def pricing_scenarios(seed: int = 0) -> List[PricingScenario]:
    """The combined scenario set fleet_bench workload H sweeps."""
    return spot_volatility_scenarios(seed) + family_constrained_scenarios()


# Table I ground truth.  bigdata ≈ 2× huge for the same job.
JOBS: Dict[str, JobSpec] = {
    j.key: j
    for j in [
        _spark_ml("naivebayes", "bigdata", 220.0, 754.0, 373, cpu_hours=9.0),
        _spark_ml("naivebayes", "huge", 115.0, 395.0, 369, cpu_hours=4.8),
        _spark_ml("kmeans", "bigdata", 170.0, 503.0, 470, cpu_hours=14.0),
        _spark_ml("kmeans", "huge", 85.0, 252.0, 470, cpu_hours=7.5),
        _spark_ml("pagerank", "bigdata", 30.0, 86.0, 1292, cpu_hours=16.0),
        _spark_ml("pagerank", "huge", 15.0, 42.0, 1292, cpu_hours=8.5),
        _spark_ml("logregr", "bigdata", 130.0, 360.0, 675, unclear=True, cpu_hours=11.0),
        _spark_ml("logregr", "huge", 65.0, 180.0, 562, unclear=True, cpu_hours=6.0),
        _spark_ml("linregr", "bigdata", 120.0, 330.0, 372, unclear=True, cpu_hours=10.0),
        _spark_ml("linregr", "huge", 60.0, 165.0, 198, unclear=True, cpu_hours=5.5),
        _flat_job("join", "spark", "bigdata", 250.0, 136, cpu_hours=5.0, io_hours=7.0),
        _flat_job("join", "spark", "huge", 125.0, 110, cpu_hours=2.6, io_hours=3.6),
        _flat_job("pagerank", "hadoop", "bigdata", 30.0, 812, cpu_hours=9.0, io_hours=11.0),
        _flat_job("pagerank", "hadoop", "huge", 15.0, 812, cpu_hours=4.6, io_hours=5.8),
        _flat_job("terasort", "hadoop", "bigdata", 320.0, 547, cpu_hours=7.0, io_hours=13.0),
        _flat_job("terasort", "hadoop", "huge", 160.0, 547, cpu_hours=3.6, io_hours=6.8),
    ]
}
