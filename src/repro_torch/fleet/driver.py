"""End-to-end fleet tuning: profile (with cache) → split → batched search.

Port of `repro/fleet/driver.py`.  One call tunes J jobs: each job is
profiled (or served from the Flora-style `ProfileCache`), its search space
is split into priority and remaining groups by the paper's §III-D rule, and
the J two-phase searches run in lockstep chunks on one device.  Every job
comes back as the `RuyaReport` the single-job pipeline
(`repro_torch.core.tuner.run_ruya`) produces: J = 1 is a fleet of one.

`tune_fleet` is a one-shot shim: it submits every job to a fresh
`repro_torch.fleet.session.TuningSession` and drains it.  Hold a session
directly for streaming submission, profile-cache ownership and cross-job
warm starting.

`cluster_fleet` replays paper workloads through
`repro_torch.cluster.simulator`; `replay_seeds` expands one job into a fleet
of seed replicas (the paper's "repeat every search 200×" protocol as one
batched call; the replicas share one `SearchSpace` object, so one device
geometry serves them all).
"""

from __future__ import annotations

import dataclasses
from typing import (
    Callable, Dict, List, Optional, Sequence, Tuple, TYPE_CHECKING,
)

import numpy as np

if TYPE_CHECKING:  # cluster is an optional peer package of fleet
    from repro_torch.cluster.faults import FaultPlan

from repro_torch.core.bayesopt import BOSettings, SearchTrace, ruya_search
from repro_torch.core.profiler import ProfileResult, profile_job
from repro_torch.core.search_space import SearchSpace, split_search_space
from repro_torch.core.tuner import RuyaReport
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fleet.profile_cache import ProfileCache

__all__ = ["FleetJob", "cluster_fleet", "replay_seeds", "tune_fleet"]

RunFn = Callable[[float], Tuple[float, float]]


@dataclasses.dataclass
class FleetJob:
    """Everything the fleet driver needs about one job.

    The cost table is the full per-configuration cost vector — fleet mode
    replays recorded/emulated workloads, so observations are table lookups
    and the whole search can stay on device.

    ``faults`` optionally attaches the job's `FaultPlan`: the session uses
    it to surface per-trial straggler latency (reported as
    `TrialRecord.attempts`, never fed into the cost surface).  The plan's
    run failures are already baked into ``profile_run`` by whoever wrapped
    it (`FaultPlan.wrap_run` / `ClusterSimulator(faults=...)`).

    ``runtime_table``/``price_table`` are the job's raw pricing axes
    (hours and USD/hour per config under a `repro_torch.cluster.pricing`
    catalog) — set for jobs built via ``cluster_fleet(..., catalog=...)``.
    They enable non-runtime objectives (`TuningSession(objective=...)`)
    and per-trial runtime/USD annotation (Pareto fronts); without them the
    job behaves exactly as before.
    """

    name: str
    space: SearchSpace
    cost_table: np.ndarray  # (len(space),) observed cost per config
    full_input_size: float = 0.0  # bytes
    profile_run: Optional[RunFn] = None
    profile_result: Optional[ProfileResult] = None
    per_node_overhead: float = 0.0
    leeway: float = 0.10
    flat_fraction: float = 1.0 / 7.0
    faults: Optional["FaultPlan"] = None
    runtime_table: Optional[np.ndarray] = None  # (len(space),) hours
    price_table: Optional[np.ndarray] = None  # (len(space),) USD/hour
    currency: str = "USD"


def cluster_fleet(
    keys: Sequence[str],
    *,
    per_node_overhead_gb: float = 0.5,
    sims=None,
    faults: Optional[Dict[str, "FaultPlan"]] = None,
    catalog=None,
    epoch: int = 0,
) -> List[FleetJob]:
    """Build fleet jobs from the paper's emulated Spark/Hadoop workloads.

    ``sims`` optionally supplies pre-built `ClusterSimulator`s by key
    (callers with their own memo — e.g. `benchmarks.common` — avoid
    re-instantiating the workload emulation).  ``faults`` optionally maps
    job keys to `FaultPlan`s: a planned job's profiling runs raise per the
    plan (memoized ``sims`` are bypassed for it — the fault wrapper is
    stateful and must be fresh per fleet) and the plan rides on
    `FleetJob.faults` for trial-level straggler reporting.

    ``catalog`` (a `repro_torch.cluster.pricing.PriceCatalog`, with ``epoch``
    selecting the spot-schedule point) builds PRICED jobs: the cost table
    comes from the catalog's book and the raw runtime/price axes ride on
    the job (`runtime_table`/`price_table`) for objective routing and
    Pareto fronts.  Priced builds bypass memoized ``sims`` — those were
    built under the legacy book.  Without a catalog nothing changes:
    tables, profiling, every committed trace.
    """
    from repro_torch.cluster.simulator import ClusterSimulator

    GiB = 1024.0**3
    sims = {} if sims is None else sims
    jobs = []
    for key in keys:
        plan = None if faults is None else faults.get(key)
        if plan is not None or catalog is not None:
            sim = ClusterSimulator.for_job(
                key, faults=plan, catalog=catalog, epoch=epoch
            )
        else:
            # NOT `sims.get(key) or ...`: same falsy-`or` shape as the
            # PR-9 session bug — route on None, not truthiness.
            sim = sims.get(key)
            if sim is None:
                sim = ClusterSimulator.for_job(key)
        # A priced job's base table is its normalized RUNTIME axis, so
        # objective="runtime" means fastest and objective="cost" means
        # cheapest under the same catalog — the two-objective contrast
        # workload H measures.  Unpriced jobs keep the legacy normalized
        # table byte-for-byte (the paper's metric, and every pinned trace).
        table = (
            sim.normalized if sim.runtime_h is None
            else sim.runtime_h / sim.runtime_h.min()
        )
        jobs.append(
            FleetJob(
                name=key,
                space=sim.space,
                cost_table=table,
                full_input_size=sim.job.input_gb * GiB,
                profile_run=sim.profile_run_fn(),
                per_node_overhead=per_node_overhead_gb * GiB,
                faults=plan,
                runtime_table=sim.runtime_h,
                price_table=sim.price_hour,
            )
        )
    return jobs


def replay_seeds(job: FleetJob, seeds: Sequence[int]) -> Tuple[
    List[FleetJob], List[np.random.Generator]
]:
    """One job × many seeds → a fleet (the paper's repetition protocol)."""
    return [job] * len(seeds), [np.random.default_rng(s) for s in seeds]


def _resolve_profile(job: FleetJob, cache: Optional[ProfileCache]) -> ProfileResult:
    if job.profile_result is not None:
        return job.profile_result
    if job.profile_run is None:
        raise ValueError(
            f"job {job.name!r} has neither profile_result nor profile_run"
        )
    if cache is not None:
        return cache.get_or_profile(job.profile_run, job.full_input_size)
    return profile_job(job.profile_run, job.full_input_size)


def tune_fleet(
    jobs: Sequence[FleetJob],
    rngs: Sequence[np.random.Generator],
    *,
    mode: str = "ruya",
    settings: BOSettings = BOSettings(),
    to_exhaustion: bool = False,
    cache: Optional[ProfileCache] = None,
    engine: str = "batched",
    shard=None,
    objective="runtime",
    layout: str = "feature",
    device: DeviceLike = None,
) -> List[RuyaReport]:
    """Tune J jobs on ``device`` (the card unless the caller passes
    ``device="cpu"``); returns one `RuyaReport` per job.

    ``mode="ruya"`` profiles each job (through ``cache`` when given) and runs
    the two-phase search; ``mode="cherrypick"`` runs the plain-BO baseline
    (no profiling, the report's ``profile`` is None).  ``engine="batched"``
    runs the lockstep session; ``engine="sequential"`` drives the per-job
    engine in a Python loop with the host split, for verification.
    ``layout`` selects the packed step ("feature", "fused" or "gather",
    `repro_torch.core.fast_bo`) in both engines.  ``objective`` routes the
    scoring ("runtime" | "cost" | weight mapping, see
    `repro_torch.fleet.session.objective_table`); both engines observe the
    same derived table.  ``shard`` shards the job axis of the batched
    engine over that many CUDA devices ("auto": every visible one;
    `repro_torch.fleet.sharding`).
    """
    if mode not in ("ruya", "cherrypick"):
        raise ValueError(f"unknown mode {mode!r}")
    if engine not in ("batched", "sequential"):
        raise ValueError(f"unknown engine {engine!r}")
    if shard is not None and engine == "sequential":
        raise ValueError("shard= requires the batched engine")
    if len(jobs) != len(rngs):
        raise ValueError(f"{len(jobs)} jobs but {len(rngs)} rngs")

    if engine == "batched":
        from repro_torch.fleet.session import TuningSession

        session = TuningSession(
            settings=settings, mode=mode, cache=cache, warm_start=False,
            to_exhaustion=to_exhaustion, shard=shard, objective=objective,
            layout=layout, device=device,
        )
        for job, rng in zip(jobs, rngs):
            session.submit(job, rng)
        return [out.report() for out in session.drain()]

    # Sequential verification path: the per-job engine with the host-side
    # §III-D split (the session's device split is held equal to it).  The
    # objective routes through the same derived table the session observes.
    from repro_torch.fleet.session import objective_table

    device = resolve_device(device)  # refuse before profiling without a card
    tables = [objective_table(job, objective) for job in jobs]
    profiles: List[Optional[ProfileResult]] = []
    priority: List[List[int]] = []
    remaining: List[List[int]] = []
    resolved: dict = {}  # id(job) -> profile; seed-replica fleets alias jobs
    for job in jobs:
        if mode == "cherrypick":
            profiles.append(None)
            priority.append(list(range(len(job.space))))
            remaining.append([])
            continue
        if id(job) not in resolved:
            resolved[id(job)] = _resolve_profile(job, cache)
        prof = resolved[id(job)]
        prio, rest = split_search_space(
            job.space,
            prof.model,
            job.full_input_size,
            per_node_overhead=job.per_node_overhead,
            leeway=job.leeway,
            flat_fraction=job.flat_fraction,
        )
        profiles.append(prof)
        priority.append(list(prio))
        remaining.append(list(rest))

    traces: List[SearchTrace] = [
        ruya_search(
            job.space,
            lambda i, _t=table: float(_t[i]),
            rng,
            prio,
            rest,
            settings=settings,
            to_exhaustion=to_exhaustion,
            layout=layout,
            device=device,
        )
        for job, table, rng, prio, rest in zip(
            jobs, tables, rngs, priority, remaining
        )
    ]
    return [
        RuyaReport(
            profile=prof,
            priority=tuple(prio),
            remaining=tuple(rest),
            trace=trace,
        )
        for prof, prio, rest, trace in zip(profiles, priority, remaining, traces)
    ]
