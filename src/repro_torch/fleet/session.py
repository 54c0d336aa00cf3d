"""`TuningSession`: one streaming session API over every tuning path.

Port of `repro/fleet/session.py`, on one device:

    session = TuningSession(cache=ProfileCache(), warm_start=True)
    handle  = session.submit(job, seed=0)     # profile → split → enqueue
    session.step()                            # ONE batched BO iteration for
                                              # every live search; newly
                                              # submitted jobs are admitted
                                              # into lockstep chunks between
                                              # steps
    outcomes = session.drain()                # step until everything is done
    handle.outcome().records                  # first-class TrialRecords

Execution model.  Submitted jobs wait in a pending queue; at the next
`step()` they are grouped by (space shape, packed capacity B), the grouping
rule of `repro_torch.fleet.batched_engine`, and formed into lockstep chunks
of at most `_CHUNK` jobs.  Each `step()` applies `fast_bo.fleet_step` once to
every live chunk, updating the chunk's state on the device in place, so the
session advances one BO iteration per call with no data-dependent host
decisions; chunks retire when their step budget is exhausted (or, with
early stopping, when a poll of the on-device done flags every
`_POLL_PERIOD` steps comes back all-True).  A chunk holds exactly its
members' rows: the reference's singleton dummy row exists for XLA:CPU's
numerics and is dropped here (see `batched_engine`).

Cross-job warm starting (Flora's signature classes, Blink's recurring-job
amortization).  The session owns the tuning state: give it a
`ProfileCache` to share probe-classified profiles across jobs (without
one, each distinct job profiles exactly once, like the one-shot drivers);
either way every profiled job gets a `MemorySignature`, and completed
trials are logged per (signature, space shape) class.  A job submitted
into a class with history is *seeded*: its packed (B,) trial and target
buffers and (B,d) feature buffer start pre-filled with up to B − reserve
class trials (capacity-aware: the seeds consume packed slots and trial
budget, so a seeded search runs at the same extents as a cold one), its
observation mask marks the seeded configs, and the scripted random
initialization is skipped.  Seeded slots are ordinary observations
(slots < t), written with the canonical float32 encoding rows an
observation on the device would have produced.  A warm-started search is
a deterministic function of (class history, seed): the history is
ordered by completion, deduplicated by config index, truncated
capacity-aware, and no RNG is consumed when seeding happens.

Memory-aware narrowing runs on the device: the §III-D priority split comes
from `repro_torch.core.search_space.split_masks_device` (float64, equal to
the host rule's lists), so admission cost scales with the catalog.

The reference's multi-device parts wait for ROADMAP Queue 1 item 15 (the
sharded session, the async service): ``shard=``/``devices=`` other than
None and `reshard` raise `NotImplementedError` naming it.  The lock and the
outcome listeners that the service needs are here already.

`run_ruya` / `run_cherrypick` (``cost_table=``), `tune_fleet` and
`batched_search` are thin shims over this engine.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import weakref
from typing import (
    Callable, Dict, List, Optional, Sequence, Set, Tuple, TYPE_CHECKING,
    Union,
)

import numpy as np
import torch

from repro_torch.core.bayesopt import BOSettings, SearchTrace, trial_budget
from repro_torch.core.fast_bo import (
    FleetState,
    _check_layout,
    encode_features,
    precompute_d2,
)
from repro_torch.core.profiler import (
    ProfileResult,
    ProfilingRunError,
    profile_job,
)
from repro_torch.core.search_space import split_masks_device
from repro_torch.core.tuner import RuyaReport
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fleet.batched_engine import _CHUNK, _POLL_PERIOD, _fleet_update
from repro_torch.fleet.profile_cache import MemorySignature, ProfileCache
from repro_torch.fleet.retry import RetryPolicy, RetryStats, call_with_retry

if TYPE_CHECKING:  # import cycle: driver imports session for tune_fleet
    from repro_torch.fleet.driver import FleetJob

__all__ = [
    "FleetFailedError",
    "JobHandle",
    "SearchOutcome",
    "TrialRecord",
    "TuningSession",
    "canonical_objective",
    "objective_table",
]

_SHARDING_ITEM = (
    "job-axis sharding over several devices waits for ROADMAP Queue 1 "
    "item 15 (multi-GPU sharding, async service and daemon)"
)

_TRIAL_SOURCES = ("init", "search", "warm")

# A tuning objective is "runtime" (the legacy table — every committed
# golden trace), "cost" (runtime×price under the job's catalog), or a
# weight mapping over both.  The canonical form is the string, or a
# sorted tuple of (axis, weight) pairs — hashable, so it can extend the
# warm-start class key (histories from different objectives score trials
# on different scales and must never cross-seed).
Objective = Union[str, Tuple[Tuple[str, float], ...]]
_OBJECTIVE_AXES = ("runtime", "cost")


def canonical_objective(objective) -> Objective:
    """Validate and canonicalize an objective spec (see `Objective`)."""
    if isinstance(objective, str):
        if objective not in _OBJECTIVE_AXES:
            raise ValueError(
                f"unknown objective {objective!r}; want one of "
                f"{_OBJECTIVE_AXES} or a weight mapping over them"
            )
        return objective
    if isinstance(objective, tuple):
        objective = dict(objective)
    if isinstance(objective, dict):
        extra = set(objective) - set(_OBJECTIVE_AXES)
        if extra or not objective:
            raise ValueError(
                f"objective weights must be over {_OBJECTIVE_AXES}, got "
                f"{sorted(objective) if objective else 'no axes'}"
            )
        weights = {k: float(v) for k, v in objective.items()}
        if min(weights.values()) < 0.0 or sum(weights.values()) <= 0.0:
            raise ValueError(
                f"objective weights must be >= 0 with a positive sum, "
                f"got {weights}"
            )
        return tuple(sorted(weights.items()))
    raise TypeError(
        f"objective must be a string or a weight mapping, got "
        f"{type(objective).__name__}"
    )


def objective_table(job: "FleetJob", objective: Objective) -> np.ndarray:
    """The (n,) float64 score table a search over ``job`` observes.

    ``"runtime"`` is the job's own ``cost_table``, byte-for-byte — the
    pinned legacy path.  ``"cost"`` scores by runtime×price from the
    job's pricing axes, normalized by its minimum (the same conditioning
    the legacy tables have); a weight mapping blends the two normalized
    axes.  Non-runtime objectives need a priced job (build one via
    `cluster_fleet(..., catalog=...)`).
    """
    obj = canonical_objective(objective)
    table = np.asarray(job.cost_table, np.float64)
    if obj == "runtime":
        return table
    rt = getattr(job, "runtime_table", None)
    price = getattr(job, "price_table", None)
    if rt is None or price is None:
        raise ValueError(
            f"job {job.name!r}: objective {objective!r} needs the job's "
            "runtime_table and price_table pricing axes — build priced "
            "jobs via cluster_fleet(..., catalog=...) or set both fields"
        )
    usd = np.asarray(rt, np.float64) * np.asarray(price, np.float64)
    usd_norm = usd / usd.min()
    if obj == "cost":
        return usd_norm
    weights = dict(obj)
    rt_norm = table / table.min()
    total = sum(weights.values())
    return (
        weights.get("runtime", 0.0) * rt_norm
        + weights.get("cost", 0.0) * usd_norm
    ) / total

# Terminal status of a search.  "converged" is the normal retirement (EI
# threshold fired or trial budget exhausted); the other three are
# first-class partial results: "cancelled" (caller revoked the job),
# "failed" (profiling failed permanently / retry budget exhausted, or an
# external executor died mid-flight), "preempted" (evicted for a
# higher-priority job — resubmit to continue from the class history).
_STATUSES = ("converged", "cancelled", "failed", "preempted")


class FleetFailedError(RuntimeError):
    """`drain()` was waiting exclusively on jobs that permanently failed.

    Partial fleets keep going — one broken job must not sink its
    chunk-mates — so failures surface as first-class "failed" outcomes.
    But when EVERY job live at the drain call ends "failed", returning
    normally would read as success; the session raises this instead (the
    outcomes stay available via `results()`)."""


@dataclasses.dataclass(frozen=True)
class TrialRecord:
    """One observation: which config, what it cost, when, and why.

    ``slot`` is the packed-buffer slot (= engine trial counter value when the
    observation was made, warm seeds included).  ``source`` is "init"
    (scripted random initialization), "search" (BO pick), or "warm" (seeded
    from the signature class's history — the cost is the donor's).
    ``attempts`` is the number of cluster runs the trial took (> 1 when a
    straggler run was re-dispatched — reported latency only, the observed
    cost is always the deterministic table value).

    ``runtime_h``/``usd`` are the trial's RAW axes — hours and dollars
    under the job's price catalog — populated only for priced jobs
    (`FleetJob.runtime_table`/`price_table` set); ``cost`` stays the
    objective's score.  Unpriced records serialize without the two keys,
    so every committed golden fixture round-trips unchanged.
    """

    index: int
    cost: float
    slot: int
    source: str = "search"
    attempts: int = 1
    runtime_h: Optional[float] = None
    usd: Optional[float] = None

    def as_dict(self) -> dict:
        d = {
            "index": int(self.index),
            "cost": float(self.cost),
            "slot": int(self.slot),
            "source": str(self.source),
            "attempts": int(self.attempts),
        }
        if self.runtime_h is not None:
            d["runtime_h"] = float(self.runtime_h)
        if self.usd is not None:
            d["usd"] = float(self.usd)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TrialRecord":
        src = str(d["source"])
        if src not in _TRIAL_SOURCES:
            raise ValueError(f"unknown trial source {src!r}")
        rt = d.get("runtime_h")
        usd = d.get("usd")
        return cls(
            index=int(d["index"]), cost=float(d["cost"]),
            slot=int(d["slot"]), source=src,
            attempts=int(d.get("attempts", 1)),
            runtime_h=None if rt is None else float(rt),
            usd=None if usd is None else float(usd),
        )


@dataclasses.dataclass
class SearchOutcome:
    """Everything one finished search produced — subsumes
    `SearchTrace`/`RuyaReport` (both are views: `trace()` / `report()`).

    ``records`` are the trials THIS search executed (sources "init" and
    "search"), in trial order; ``seeded`` are the warm-start seeds that
    pre-filled the packed buffers (source "warm", donor costs).
    ``stop_iteration`` / ``phase_boundary`` are the engine's registers and
    count packed slots — i.e. seeds included; `trace()` re-bases them onto
    the executed trials so cold searches round-trip exactly.

    ``status`` (see `_STATUSES`) makes partial results first-class: a
    cancelled/failed/preempted search still carries every trial it
    completed.  ``profile_attempts`` / ``retry_backoff_s`` surface what
    the profiling phase cost under faults (1 / 0.0 = clean first try; the
    backoff is charged, not slept — see `repro_torch.fleet.retry`), and
    ``failure`` carries the terminal error text for "failed" outcomes.

    ``objective`` is the canonical objective the search scored trials
    under (see `canonical_objective`); ``currency`` is set ("USD") for
    priced jobs, whose records carry raw runtime/dollar axes — the inputs
    to `pareto()`, `best_usd` and `best_runtime_h`.  Both serialize only
    when non-default, so unpriced runtime-objective outcomes (every
    committed golden fixture) keep their exact legacy `as_dict` form.
    """

    name: str
    records: List[TrialRecord]
    seeded: List[TrialRecord]
    stop_iteration: Optional[int]
    phase_boundary: Optional[int]
    priority: Tuple[int, ...]
    remaining: Tuple[int, ...]
    profile: Optional[ProfileResult] = None
    signature: Optional[MemorySignature] = None
    status: str = "converged"
    profile_attempts: int = 1
    retry_backoff_s: float = 0.0
    failure: Optional[str] = None
    objective: Objective = "runtime"
    currency: Optional[str] = None

    @property
    def memory_model(self):
        return None if self.profile is None else self.profile.model

    @property
    def observations(self) -> List[TrialRecord]:
        """Seeds + executed trials, in packed-slot order."""
        return list(self.seeded) + list(self.records)

    def _require_observations(self) -> List[TrialRecord]:
        obs = self.observations
        if not obs:
            raise RuntimeError(
                f"job {self.name!r} has no observations (status "
                f"{self.status!r}) — a search that failed or was revoked "
                "before its first trial has no best configuration"
            )
        return obs

    @property
    def best_cost(self) -> float:
        """Lowest recorded cost over seeds + executed trials (seeds carry
        donor costs — for recurring same-class jobs these are the point)."""
        return min(r.cost for r in self._require_observations())

    @property
    def best_index(self) -> int:
        return min(self._require_observations(), key=lambda r: r.cost).index

    def iterations_until(self, threshold_cost: float) -> Optional[int]:
        """1-based EXECUTED trial at which cost ≤ threshold was first seen
        (seeds excluded — this measures what the search itself had to do)."""
        for i, r in enumerate(self.records):
            if r.cost <= threshold_cost:
                return i + 1
        return None

    def _priced_observations(self) -> List[TrialRecord]:
        obs = [
            r for r in self._require_observations()
            if r.runtime_h is not None and r.usd is not None
        ]
        if not obs:
            raise RuntimeError(
                f"job {self.name!r} has no priced observations — runtime/"
                "cost axes exist only for jobs built with a price catalog "
                "(cluster_fleet(..., catalog=...))"
            )
        return obs

    def pareto(self) -> List[TrialRecord]:
        """The cost/runtime Pareto front: observed trials not dominated on
        the two RAW axes (hours, dollars), in trial order.

        A trial dominates another when it is no worse on both axes and
        strictly better on at least one.  Ties on both axes keep only the
        earliest trial (deterministic tie-break by trial order), so the
        front is a pure function of the observation sequence.
        """
        obs = self._priced_observations()
        front: List[TrialRecord] = []
        for i, r in enumerate(obs):
            dominated = False
            for j, o in enumerate(obs):
                if o.runtime_h <= r.runtime_h and o.usd <= r.usd and (
                    o.runtime_h < r.runtime_h or o.usd < r.usd
                ):
                    dominated = True
                    break
                # Exact tie on both axes: the earliest trial represents it.
                if (
                    j < i
                    and o.runtime_h == r.runtime_h
                    and o.usd == r.usd
                ):
                    dominated = True
                    break
            if not dominated:
                front.append(r)
        return front

    @property
    def best_usd(self) -> float:
        """Cheapest observed trial in dollars (priced jobs only)."""
        return min(r.usd for r in self._priced_observations())

    @property
    def best_runtime_h(self) -> float:
        """Fastest observed trial in hours (priced jobs only)."""
        return min(r.runtime_h for r in self._priced_observations())

    def trace(self) -> SearchTrace:
        """The executed trials as the legacy `SearchTrace` (bit-exact for
        cold searches; warm searches re-base the registers past the seeds)."""
        w = len(self.seeded)
        stop = self.stop_iteration
        pb = self.phase_boundary
        return SearchTrace(
            tried=[r.index for r in self.records],
            costs=[r.cost for r in self.records],
            stop_iteration=None if stop is None else max(stop - w, 0),
            phase_boundary=None if pb is None else max(pb - w, 0),
        )

    def report(self) -> RuyaReport:
        """The legacy `RuyaReport` view (single-job / fleet driver output)."""
        return RuyaReport(
            profile=self.profile,
            priority=self.priority,
            remaining=self.remaining,
            trace=self.trace(),
        )

    def as_dict(self) -> dict:
        """JSON-able view; drops `profile`/`signature` (not serializable).
        The cost-aware fields ("objective", "currency") are emitted only
        when non-default, so legacy fixtures compare byte-for-byte."""
        d = {
            "name": self.name,
            "records": [r.as_dict() for r in self.records],
            "seeded": [r.as_dict() for r in self.seeded],
            "stop_iteration": self.stop_iteration,
            "phase_boundary": self.phase_boundary,
            "priority": [int(i) for i in self.priority],
            "remaining": [int(i) for i in self.remaining],
            "status": str(self.status),
            "profile_attempts": int(self.profile_attempts),
            "retry_backoff_s": float(self.retry_backoff_s),
            "failure": self.failure,
        }
        if self.objective != "runtime":
            d["objective"] = (
                self.objective if isinstance(self.objective, str)
                else dict(self.objective)
            )
        if self.currency is not None:
            d["currency"] = str(self.currency)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SearchOutcome":
        stop = d["stop_iteration"]
        pb = d["phase_boundary"]
        status = str(d.get("status", "converged"))
        if status not in _STATUSES:
            raise ValueError(f"unknown outcome status {status!r}")
        failure = d.get("failure")
        currency = d.get("currency")
        return cls(
            name=str(d["name"]),
            records=[TrialRecord.from_dict(r) for r in d["records"]],
            seeded=[TrialRecord.from_dict(r) for r in d["seeded"]],
            stop_iteration=None if stop is None else int(stop),
            phase_boundary=None if pb is None else int(pb),
            priority=tuple(int(i) for i in d["priority"]),
            remaining=tuple(int(i) for i in d["remaining"]),
            status=status,
            profile_attempts=int(d.get("profile_attempts", 1)),
            retry_backoff_s=float(d.get("retry_backoff_s", 0.0)),
            failure=None if failure is None else str(failure),
            objective=canonical_objective(d.get("objective", "runtime")),
            currency=None if currency is None else str(currency),
        )


@dataclasses.dataclass
class JobHandle:
    """Ticket for one submitted job; query it any time.

    The session is held through a weakref and the outcome is attached to
    the handle at retirement, so handles never keep a drained session (and
    its cached device geometry) alive — one-shot shims create a session per
    call, and it must be reclaimed by refcount the moment the call returns.
    """

    uid: int
    name: str
    _session: "weakref.ref[TuningSession]" = dataclasses.field(repr=False)
    _outcome: Optional[SearchOutcome] = dataclasses.field(
        default=None, repr=False
    )

    @property
    def done(self) -> bool:
        return self._outcome is not None

    @property
    def status(self) -> str:
        if self.done:
            st = self._outcome.status
            return "done" if st == "converged" else st
        session = self._session()
        if session is None:
            return "detached"  # session dropped before the job finished
        with session._lock:
            if any(r.handle.uid == self.uid for r in session._pending):
                return "pending"
        return "running"

    def cancel(self) -> bool:
        """Cancel this job — pending or mid-flight (see
        `TuningSession.cancel`).  Returns False when the job already
        finished or the session is gone; cancelling twice is a no-op."""
        session = self._session()
        if session is None:
            return False
        return session.cancel(self)

    def outcome(self) -> SearchOutcome:
        if self._outcome is None:
            raise RuntimeError(
                f"job {self.name!r} (uid {self.uid}) has not finished — "
                "call session.step()/drain() first"
            )
        return self._outcome


@dataclasses.dataclass
class _JobRec:
    """Internal per-job state between submit and retire."""

    handle: JobHandle
    job: "FleetJob"
    table64: np.ndarray  # (n,) float64 — authoritative cost table
    enc: np.ndarray  # (n,d) canonical float32 encoding (encode_features)
    prio_mask: np.ndarray  # (n,) bool
    rem_mask: np.ndarray  # (n,) bool
    init_list: List[int]
    seed_trials: List[TrialRecord]
    budget: int  # trial budget == packed capacity B (trial_budget)
    profile: Optional[ProfileResult]
    signature: Optional[MemorySignature]
    class_key: Optional[Tuple[MemorySignature, int, int]]
    prio_idx: np.ndarray  # (p,) int64, pool order
    rem_idx: np.ndarray  # (r,) int64, pool order
    profile_attempts: int = 1  # profiling attempts incl. retries
    retry_backoff_s: float = 0.0  # charged profiling backoff
    status: str = "converged"  # terminal status, set before publication
    job_priority: int = 0  # preemption rank (see preempt_below)
    objective: Objective = "runtime"  # canonical scoring objective
    # (runtime_h, usd) raw-axis tables for priced jobs; None otherwise.
    axes64: Optional[Tuple[np.ndarray, np.ndarray]] = None



class _LiveChunk:
    """One lockstep chunk mid-flight: its state and arguments on the device,
    member i at row i.

    A member slot holds None after a mid-flight cancel, fail or preempt: the
    outcome was published already, the row's `done` flag is latched on the
    device (the update leaves done rows untouched), and retirement skips
    the tombstone.
    """

    __slots__ = ("state", "args", "members", "steps_done", "steps_needed")

    def __init__(self, state, args, members, steps_needed):
        self.state = state
        self.args = args
        self.members = members
        self.steps_done = 0
        self.steps_needed = steps_needed


class _SpaceEntry:
    """Refcounted per-space cache: the strong reference to the space keeps
    its id() stable for the entry's lifetime; the entry (the encoding and
    the geometry on the device, a gather layout's (n,n) tensor included)
    is evicted when the last active submission over the space retires."""

    __slots__ = ("space", "count", "enc", "geom")

    def __init__(self, space):
        self.space = space
        self.count = 0
        self.enc: Optional[np.ndarray] = None
        self.geom: Optional[torch.Tensor] = None


class TuningSession:
    """Streaming multi-job tuning session (see module docstring).

    ``settings``/``to_exhaustion``/``layout`` are session-wide (jobs group
    by packed capacity, which `BOSettings` helps determine).  ``mode`` is
    the default per-submit mode ("ruya" profiles and splits; "cherrypick"
    searches the whole space).  ``cache`` is the session-owned
    `ProfileCache`: give one to share probe-classified profiles across
    jobs; with ``cache=None`` each distinct job is profiled exactly once,
    like the one-shot drivers.  ``warm_start`` enables signature-class
    seeding; ``warm_reserve`` packed slots are always left for fresh trials
    (default: max(n_init, 1)).  ``device`` is where every chunk runs: the
    card unless the caller passes ``device="cpu"``.

    Failure semantics.  ``retry`` governs profiling-run faults:
    `TransientRunError`s are retried with the deterministic seeded backoff
    of `repro_torch.fleet.retry` (per-job retry seed derived from ``seed``,
    no live RNG), `PermanentRunError`s fast-fail, and a job whose profiling
    cannot complete becomes a first-class "failed" outcome at submit.
    `cancel`/`fail`/`preempt`/`preempt_below` retire a live search
    mid-flight: its completed trials publish immediately and its chunk row
    is frozen through the engine's `done` flag, so its chunk-mates' traces
    are those of an undisturbed run (no op reduces across the job axis).
    ``drift_tolerance`` (needs a ``cache``) turns on drift detection: a
    recurring job whose fresh probe no longer matches its cached class
    model is re-profiled and re-classed (`ProfileCache.model_drifted`), and
    the session does not warm-seed it from the stale class's history
    (``drift_events`` logs the job names).

    Finished jobs release their per-job state: cost tables, masks, cached
    encodings and device geometry (refcounted per space) are dropped at
    retirement, so a long-lived session holds only the outcomes and the
    per-class trial history.
    """

    def __init__(
        self,
        *,
        settings: BOSettings = BOSettings(),
        mode: str = "ruya",
        cache: Optional[ProfileCache] = None,
        warm_start: bool = True,
        warm_reserve: Optional[int] = None,
        to_exhaustion: bool = False,
        layout: str = "feature",
        shard: Union[None, int, str] = None,
        devices: Optional[Sequence] = None,
        seed: int = 0,
        retry: RetryPolicy = RetryPolicy(),
        drift_tolerance: Optional[float] = None,
        objective="runtime",
        device: DeviceLike = None,
    ) -> None:
        if mode not in ("ruya", "cherrypick"):
            raise ValueError(f"unknown mode {mode!r}")
        _check_layout(layout)
        if shard is not None or devices is not None:
            raise NotImplementedError(_SHARDING_ITEM)
        self.device = resolve_device(device)
        self.objective: Objective = canonical_objective(objective)
        self.settings = settings
        self.mode = mode
        self.cache = cache
        self.warm_start = bool(warm_start)
        self.warm_reserve = (
            max(int(warm_reserve), 0) if warm_reserve is not None
            else max(settings.n_init, 1)
        )
        self.to_exhaustion = bool(to_exhaustion)
        self.layout = layout
        self.seed = int(seed)
        self.retry = retry
        self.drift_tolerance = (
            None if drift_tolerance is None else float(drift_tolerance)
        )

        # Every access to the shared mutable session state (pending queue,
        # chunk list, outcome, history and cache tables) and every chunk
        # state transition happens under this re-entrant lock; waits for
        # the device happen outside it (`_step_chunk`).  The async service
        # of ROADMAP item 15 steps chunks from per-group host threads.
        self._lock = threading.RLock()
        # Called (under the lock) with each published SearchOutcome.
        self._outcome_listeners: List[Callable[[SearchOutcome], None]] = []

        self.warm_hits = 0  # jobs that were seeded
        self.warm_trials = 0  # total seeded observations
        self.drift_events: List[str] = []  # job names flagged as drifted
        # uids that turned "failed" since the last drain (the drain guard,
        # FleetFailedError, considers these alongside live jobs).
        self._failed_since_drain: List[int] = []

        self._pending: List[_JobRec] = []
        self._chunks: List[_LiveChunk] = []
        self._order: List[JobHandle] = []  # submission order
        self._outcomes: Dict[int, SearchOutcome] = {}
        # id(space) → refcounted encoding/geometry (strong space ref inside)
        self._spaces: Dict[int, _SpaceEntry] = {}
        # id(job) → [job, active submissions, profile, profiling attempts,
        # charged backoff seconds, drift flag]; evicted at zero refcount
        self._jobs: Dict[int, list] = {}
        # (signature, n, d[, objective]) → (ordered [(index, cost)], seen set)
        self._history: Dict[tuple, Tuple[List[Tuple[int, float]], Set[int]]] = {}

    # ------------------------------------------------------------- submit

    def submit(
        self,
        job: "FleetJob",
        rng: Optional[np.random.Generator] = None,
        *,
        seed: Optional[int] = None,
        mode: Optional[str] = None,
        priority: Optional[Sequence[int]] = None,
        remaining: Optional[Sequence[int]] = None,
        warm_start: Optional[bool] = None,
        job_priority: int = 0,
        objective=None,
    ) -> JobHandle:
        """Register one job; it joins a lockstep chunk at the next `step()`.

        ``rng`` (or ``seed``) scripts the random initialization exactly like
        the sequential engine.  ``mode`` defaults to the session mode.
        Passing ``priority``/``remaining`` explicitly skips profiling and
        uses the given split verbatim (the `batched_search` shim's path);
        otherwise "ruya" resolves a profile (``job.profile_result``, else
        the session `ProfileCache`) and computes the §III-D split on the
        device, while "cherrypick" searches the whole space.
        ``warm_start`` overrides the session default for this job; seeding
        only happens for profiled jobs (the signature is the class key) and
        consumes no RNG.

        Profiling faults: transient run failures are retried per the
        session `RetryPolicy`; a permanent failure (or retry exhaustion)
        returns a handle whose outcome is already published with status
        "failed".  ``job_priority`` ranks the job for `preempt_below`.
        ``objective`` overrides the session objective for this job (see
        `objective_table`).  Thread-safe: submitters serialize on the
        session lock.
        """
        with self._lock:
            return self._submit_locked(
                job, rng, seed=seed, mode=mode, priority=priority,
                remaining=remaining, warm_start=warm_start,
                job_priority=job_priority, objective=objective,
            )

    def _submit_locked(
        self,
        job: "FleetJob",
        rng: Optional[np.random.Generator] = None,
        *,
        seed: Optional[int] = None,
        mode: Optional[str] = None,
        priority: Optional[Sequence[int]] = None,
        remaining: Optional[Sequence[int]] = None,
        warm_start: Optional[bool] = None,
        job_priority: int = 0,
        objective=None,
    ) -> JobHandle:
        if (rng is None) == (seed is None):
            raise ValueError("provide exactly one of rng / seed")
        if rng is None:
            rng = np.random.default_rng(seed)
        mode = self.mode if mode is None else mode
        if mode not in ("ruya", "cherrypick"):
            raise ValueError(f"unknown mode {mode!r}")
        warm = self.warm_start if warm_start is None else bool(warm_start)
        obj = (
            self.objective if objective is None
            else canonical_objective(objective)
        )

        space = job.space
        n = len(space)
        d = space.encoded().shape[1]
        # The score table the engine observes: exactly `job.cost_table` for
        # objective="runtime"; derived from the pricing axes otherwise.
        table64 = objective_table(job, obj)
        if table64.shape != (n,):
            raise ValueError(
                f"job {job.name!r}: cost table has shape {table64.shape}, "
                f"want ({n},)"
            )
        axes64: Optional[Tuple[np.ndarray, np.ndarray]] = None
        rt_tab = getattr(job, "runtime_table", None)
        price_tab = getattr(job, "price_table", None)
        if rt_tab is not None and price_tab is not None:
            rt64 = np.asarray(rt_tab, np.float64)
            price64 = np.asarray(price_tab, np.float64)
            if rt64.shape != (n,) or price64.shape != (n,):
                raise ValueError(
                    f"job {job.name!r}: pricing axes have shapes "
                    f"{rt64.shape}/{price64.shape}, want ({n},)"
                )
            axes64 = (rt64, rt64 * price64)

        profile: Optional[ProfileResult] = None
        signature: Optional[MemorySignature] = None
        if priority is not None:
            prio_idx = np.asarray(priority, np.int64).reshape(-1)
            rem_idx = (
                np.zeros(0, np.int64) if remaining is None
                else np.asarray(remaining, np.int64).reshape(-1)
            )
            if len(np.intersect1d(prio_idx, rem_idx)):
                raise ValueError(
                    f"job {job.name!r}: priority and remaining pools overlap"
                )
            prio_mask = np.zeros(n, bool)
            prio_mask[prio_idx] = True
            rem_mask = np.zeros(n, bool)
            if rem_idx.size:
                rem_mask[rem_idx] = True
        elif mode == "cherrypick":
            prio_idx = np.arange(n, dtype=np.int64)
            rem_idx = np.zeros(0, np.int64)
            prio_mask = np.ones(n, bool)
            rem_mask = np.zeros(n, bool)
        else:
            try:
                profile = self._resolve_profile(job)
            except ProfilingRunError as e:
                # Permanent failure or retry budget exhausted: a first-class
                # "failed" outcome, published now; the fleet keeps going.
                return self._register_failed(job, e)
            je = self._jobs.get(id(job))
            if je is not None and je[5]:
                # The job's class drifted: the old class's trial history
                # predates the shift, so this job starts cold.
                warm = False
            signature = (
                self.cache.signature(profile.model)
                if self.cache is not None
                else MemorySignature.of(profile.model)
            )
            # §III-D narrowing on the device; remaining is the complement.
            prio_mask = split_masks_device(
                space,
                profile.model,
                job.full_input_size,
                per_node_overhead=job.per_node_overhead,
                leeway=job.leeway,
                flat_fraction=job.flat_fraction,
                device=self.device,
            ).cpu().numpy()
            rem_mask = ~prio_mask
            prio_idx = np.flatnonzero(prio_mask)
            rem_idx = np.flatnonzero(rem_mask)

        budget = trial_budget(len(prio_idx), len(rem_idx), self.settings)

        # Warm-start seeding, decided (and the history snapshot taken) at
        # submit time: a search is a deterministic function of (class
        # history, seed) however the session is stepped afterwards.
        # Non-runtime objectives score trials on another scale, so their
        # class histories are keyed apart.
        seed_trials: List[TrialRecord] = []
        class_key = None
        if signature is not None:
            class_key = (
                (signature, n, d) if obj == "runtime"
                else (signature, n, d, obj)
            )
        if warm and class_key is not None and class_key in self._history:
            room = max(budget - self.warm_reserve, 0)
            hist = self._history[class_key][0][:room]
            seed_trials = [
                TrialRecord(
                    index=i, cost=c, slot=s, source="warm",
                    runtime_h=(
                        None if axes64 is None else float(axes64[0][i])
                    ),
                    usd=None if axes64 is None else float(axes64[1][i]),
                )
                for s, (i, c) in enumerate(hist)
            ]
            if seed_trials:
                self.warm_hits += 1
                self.warm_trials += len(seed_trials)

        # Scripted random initialization: the sequential engine's phase-0
        # draw, in submission order.  A seeded search skips it and consumes
        # no RNG.
        init_list: List[int] = []
        if len(prio_idx) and not seed_trials:
            n_init = min(self.settings.n_init, len(prio_idx))
            picked = rng.choice(len(prio_idx), size=n_init, replace=False)
            init_list = [int(prio_idx[int(i)]) for i in picked]

        # Past the last possible raise: retain the refcounted per-space and
        # per-job entries and register the submission.
        handle = JobHandle(
            uid=len(self._order), name=job.name, _session=weakref.ref(self)
        )
        self._retain(job)
        je = self._jobs[id(job)]
        rec = _JobRec(
            handle=handle,
            job=job,
            table64=table64,
            enc=self._encoding(space),
            prio_mask=prio_mask,
            rem_mask=rem_mask,
            init_list=init_list,
            seed_trials=seed_trials,
            budget=budget,
            profile=profile,
            signature=signature,
            class_key=class_key,
            prio_idx=prio_idx,
            rem_idx=rem_idx,
            profile_attempts=je[3],
            retry_backoff_s=je[4],
            job_priority=int(job_priority),
            objective=obj,
            axes64=axes64,
        )
        self._order.append(handle)
        self._pending.append(rec)
        return handle

    # -------------------------------------------------------------- step

    def step(self) -> int:
        """Admit pending jobs into lockstep chunks, then advance every live
        chunk by ONE batched BO iteration.  Returns the number of jobs still
        unfinished (0: everything has retired)."""
        with self._lock:
            self._admit()
            chunks = list(self._chunks)
        for ch in chunks:
            self._step_chunk(ch)
        with self._lock:
            return self._unfinished()

    def _unfinished(self) -> int:
        """Jobs not yet published (pending + live chunk members); caller
        holds the lock."""
        return sum(
            sum(1 for m in c.members if m is not None) for c in self._chunks
        ) + len(self._pending)

    def _step_chunk(self, ch: _LiveChunk) -> None:
        """Advance one chunk by one BO iteration; retire it if finished, or
        drop it if every member was terminated mid-flight.  State
        transitions happen under the session lock; the poll of the done
        flags waits for the device outside it, on a captured reference
        (only this chunk's owner advances it)."""
        with self._lock:
            if ch not in self._chunks:
                return
            if all(m is None for m in ch.members):
                self._chunks.remove(ch)
                return
            _fleet_update(ch.state, *ch.args, xi=self.settings.xi,
                          layout=self.layout)
            ch.steps_done += 1
            retire = ch.steps_done >= ch.steps_needed
            poll = (
                not retire
                and not self.to_exhaustion
                and ch.steps_done % _POLL_PERIOD == 0
            )
            done_flags = ch.state.done if poll else None
        if poll:
            retire = bool(done_flags.all())  # waits for this chunk's work
        if not retire:
            return
        with self._lock:
            if ch in self._chunks:
                self._retire(ch)
                self._chunks.remove(ch)

    def drain(self) -> List[SearchOutcome]:
        """Step until every submitted job has finished; returns all outcomes
        (cumulative over the session's lifetime) in submission order.

        Raises `FleetFailedError` when every job this drain was waiting on
        (jobs live at the call, plus jobs that turned "failed" since the
        previous drain) ends with status "failed".  All outcomes stay
        available via `results()`."""
        with self._lock:
            waiting = {rec.handle.uid for rec in self._live_recs()}
            waiting.update(self._failed_since_drain)
            self._failed_since_drain = []
        while self._pending or self._chunks:
            self.step()
        self._check_all_failed(waiting)
        return self.results()

    def _check_all_failed(self, waiting: Set[int]) -> None:
        """The drain guard (see `drain`)."""
        if not waiting:
            return
        with self._lock:
            outs = [self._outcomes.get(uid) for uid in sorted(waiting)]
        if all(o is not None and o.status == "failed" for o in outs):
            names = [o.name for o in outs]
            raise FleetFailedError(
                f"all {len(names)} job(s) this drain was waiting on "
                f"permanently failed: {names} — outcomes remain "
                "available via results()"
            )

    def results(self) -> List[SearchOutcome]:
        """Outcomes of all FINISHED jobs, in submission order."""
        with self._lock:
            return [
                self._outcomes[h.uid] for h in self._order
                if h.uid in self._outcomes
            ]

    def outcome(self, handle: JobHandle) -> SearchOutcome:
        return handle.outcome()

    def __len__(self) -> int:
        return len(self._order)

    # ---------------------------------------------------------- lifecycle

    def cancel(self, handle: JobHandle) -> bool:
        """Cancel a pending or mid-flight job.  Its completed trials
        publish immediately as a partial outcome (status "cancelled") and
        its chunk row is frozen through the engine's `done` flag; its
        chunk-mates advance as if nothing happened.  Returns False when the
        job already finished."""
        return self._terminate(handle, "cancelled")

    def fail(self, handle: JobHandle, reason: Optional[str] = None) -> bool:
        """Mark a live job failed (e.g. its external executor died): the
        same mid-flight retirement as `cancel`, status "failed"."""
        return self._terminate(handle, "failed", reason)

    def preempt(self, handle: JobHandle) -> bool:
        """Preempt a live job (status "preempted"): partial results are
        kept and the lockstep slot frees up; a later resubmit starts from
        the class history (fed by converged jobs only)."""
        return self._terminate(handle, "preempted")

    def preempt_below(self, min_priority: int) -> List[JobHandle]:
        """Preempt every live job whose submit-time ``job_priority`` is
        below ``min_priority``.  Returns the preempted handles."""
        with self._lock:
            victims = [
                rec.handle for rec in self._live_recs()
                if rec.job_priority < min_priority
            ]
            for handle in victims:
                self._terminate(handle, "preempted")
            return victims

    def reshard(self, shard=None, devices=None) -> int:
        """Re-bundle live searches onto another device set: waits for
        ROADMAP Queue 1 item 15."""
        raise NotImplementedError(_SHARDING_ITEM)

    def _live_recs(self) -> List[_JobRec]:
        """Every unfinished submission: pending plus live chunk members."""
        recs = list(self._pending)
        for ch in self._chunks:
            recs.extend(m for m in ch.members if m is not None)
        return recs

    def _terminate(
        self, handle: JobHandle, status: str, reason: Optional[str] = None
    ) -> bool:
        with self._lock:
            if handle._outcome is not None:
                return False  # already finished (or already terminated)
            for j, rec in enumerate(self._pending):
                if rec.handle.uid == handle.uid:
                    del self._pending[j]
                    rec.status = status
                    # Never admitted: the outcome is the warm seeds (if any)
                    # and zero executed trials.
                    self._publish(
                        rec, k=len(rec.seed_trials), tried_row=None,
                        stop=-1, pb=-1, failure=reason,
                    )
                    return True
            for ch in self._chunks:
                for i, rec in enumerate(ch.members):
                    if rec is not None and rec.handle.uid == handle.uid:
                        rec.status = status
                        self._kill(ch, i, rec, reason)
                        return True
            return False  # not this session's handle

    def _kill(
        self, ch: _LiveChunk, i: int, rec: _JobRec,
        reason: Optional[str] = None,
    ) -> None:
        """Retire member ``i`` of a live chunk mid-flight: publish its
        partial outcome from a host copy of its row, tombstone the member
        slot, and freeze the row by latching its `done` flag on the device
        (`fast_bo.fleet_step` gates every write on ``live = ~done &
        budget_left``, so a done row is inert)."""
        st = ch.state
        self._publish(
            rec,
            k=int(st.t[i]),
            tried_row=st.tried[i].cpu().numpy(),
            stop=int(st.stop[i]),
            pb=int(st.pb[i]),
            failure=reason,
        )
        ch.members[i] = None
        st.done[i] = True

    # ---------------------------------------------------------- internals

    def _retry_seed(self, job: "FleetJob") -> int:
        """Per-job retry-jitter seed: a hash of (session seed, job name)."""
        h = hashlib.sha256(f"{self.seed}/{job.name}".encode()).digest()
        return int.from_bytes(h[:8], "big")

    def _resolve_profile(self, job: "FleetJob") -> ProfileResult:
        if job.profile_result is not None:
            return job.profile_result
        if job.profile_run is None:
            raise ValueError(
                f"job {job.name!r} has neither profile_result nor profile_run"
            )
        # Memoized per job OBJECT (seed-replica fleets alias one FleetJob):
        # each distinct job profiles once.  The whole resolution (probe +
        # full profile) is one retry unit; emulated run fns are
        # deterministic in the sample size, so a retried resolution returns
        # an identical ProfileResult.
        entry = self._jobs.setdefault(
            id(job), [job, 0, None, 1, 0.0, False]
        )
        if entry[2] is None:
            stats = RetryStats(attempts=0)
            drifted = [False]

            def resolve() -> ProfileResult:
                if self.cache is not None:
                    # `last_drift` is a per-call report on a possibly shared
                    # cache: read it while still holding the cache lock.
                    with self.cache.lock:
                        prof = self.cache.get_or_profile(
                            job.profile_run, job.full_input_size,
                            drift_tolerance=self.drift_tolerance,
                        )
                        drifted[0] = self.cache.last_drift
                    return prof
                return profile_job(job.profile_run, job.full_input_size)

            try:
                profile, stats = call_with_retry(
                    resolve, policy=self.retry,
                    seed=self._retry_seed(job), stats=stats,
                )
            finally:
                # Record the cost even when resolution failed: the failed
                # outcome reports what the attempts burned.
                entry[3], entry[4] = stats.attempts, stats.backoff_s
            entry[2] = profile
            if drifted[0]:
                entry[5] = True
                self.drift_events.append(job.name)
        return entry[2]

    def _register_failed(
        self, job: "FleetJob", error: BaseException
    ) -> JobHandle:
        """Publish a first-class "failed" outcome at submit time; the job
        never enters the pending queue."""
        je = self._jobs.get(id(job))
        handle = JobHandle(
            uid=len(self._order), name=job.name, _session=weakref.ref(self)
        )
        outcome = SearchOutcome(
            name=job.name,
            records=[],
            seeded=[],
            stop_iteration=None,
            phase_boundary=None,
            priority=(),
            remaining=(),
            status="failed",
            failure=f"{type(error).__name__}: {error}",
            profile_attempts=je[3] if je is not None else 1,
            retry_backoff_s=je[4] if je is not None else 0.0,
        )
        self._order.append(handle)
        self._outcomes[handle.uid] = outcome
        handle._outcome = outcome
        self._failed_since_drain.append(handle.uid)
        for listener in self._outcome_listeners:
            listener(outcome)
        return handle

    def _retain(self, job: "FleetJob") -> None:
        """Bump the refcounted per-space and per-job cache entries."""
        space = job.space
        se = self._spaces.get(id(space))
        if se is None:
            se = self._spaces[id(space)] = _SpaceEntry(space)
        se.count += 1
        je = self._jobs.setdefault(id(job), [job, 0, None, 1, 0.0, False])
        je[1] += 1

    def _release(self, rec: _JobRec) -> None:
        """Drop the retired job's share of the caches; evict empty entries
        (a gather layout's (n,n) tensor included)."""
        sid = id(rec.job.space)
        se = self._spaces.get(sid)
        if se is not None:
            se.count -= 1
            if se.count <= 0:
                del self._spaces[sid]
        jid = id(rec.job)
        je = self._jobs.get(jid)
        if je is not None:
            je[1] -= 1
            if je[1] <= 0:
                del self._jobs[jid]

    def _encoding(self, space) -> np.ndarray:
        entry = self._spaces[id(space)]
        if entry.enc is None:
            entry.enc = encode_features(space.encoded())
        return entry.enc

    def _geom(self, space) -> torch.Tensor:
        """Per-space geometry on the device, once per space (seed-replica
        fleets alias one SearchSpace): the (n,d) encoding (feature and
        fused layouts) or the (n,n) distance tensor (gather layout)."""
        entry = self._spaces[id(space)]
        if entry.geom is None:
            enc = self._encoding(space)
            entry.geom = (
                precompute_d2(enc, self.device) if self.layout == "gather"
                else torch.from_numpy(np.ascontiguousarray(enc)).to(self.device)
            )
        return entry.geom

    def _admit(self) -> None:
        """Form lockstep chunks from the pending queue: jobs grouped by
        (space shape, packed capacity), in submission order, sliced into
        chunks of at most `_CHUNK`."""
        if not self._pending:
            return
        groups: Dict[tuple, List[_JobRec]] = {}
        for rec in self._pending:
            groups.setdefault((rec.enc.shape, rec.budget), []).append(rec)
        self._pending = []
        for (shape, cap), members in groups.items():
            n_init_slots = max(1, max(len(r.init_list) for r in members))
            for lo in range(0, len(members), _CHUNK):
                self._chunks.append(
                    self._build_chunk(
                        members[lo : lo + _CHUNK], shape, cap, n_init_slots
                    )
                )

    def _build_chunk(
        self, members: List[_JobRec], shape, cap: int, n_init_slots: int,
    ) -> _LiveChunk:
        """State and arguments of one lockstep chunk, one row per member,
        built on the host and moved to the device once.  The geometry is
        one contiguous (J,·,·) tensor (the EI/argmax kernel takes no
        strided view)."""
        n, d = shape
        rows = len(members)
        capacity = max(cap, 1)  # a zero-budget job still has one (inert) slot
        dev = self.device

        costs = np.zeros((rows, n), np.float32)
        prio_mask = np.zeros((rows, n), bool)
        rem_mask = np.zeros((rows, n), bool)
        init_picks = np.zeros((rows, n_init_slots), np.int32)
        init_count = np.zeros(rows, np.int32)
        max_trials = np.zeros(rows, np.int32)
        obs0 = np.zeros((rows, n), bool)
        tried0 = np.full((rows, capacity), -1, np.int32)
        py0 = np.zeros((rows, capacity), np.float32)
        feats0 = np.zeros((rows, capacity, d), np.float32)
        t0 = np.zeros(rows, np.int32)

        for i, rec in enumerate(members):
            costs[i] = rec.table64.astype(np.float32)
            prio_mask[i] = rec.prio_mask
            rem_mask[i] = rec.rem_mask
            init_picks[i, : len(rec.init_list)] = rec.init_list
            init_count[i] = len(rec.init_list)
            max_trials[i] = rec.budget
            w = len(rec.seed_trials)
            if w:
                idx = np.asarray([s.index for s in rec.seed_trials], np.int64)
                obs0[i, idx] = True
                tried0[i, :w] = idx.astype(np.int32)
                py0[i, :w] = np.asarray(
                    [s.cost for s in rec.seed_trials], np.float32
                )
                # Rows of the canonical float32 encoding, as the on-device
                # observation writes would have filled them.
                feats0[i, :w] = rec.enc[idx]
                t0[i] = w

        state = FleetState.from_numpy(
            {
                "obs": obs0, "tried": tried0, "py": py0, "feats": feats0,
                "t": t0, "stop": np.full(rows, -1, np.int32),
                "pb": np.full(rows, -1, np.int32), "done": np.zeros(rows, bool),
                "last_ei": np.zeros(rows, np.float32),
                "last_best": np.full(rows, np.inf, np.float32),
            },
            dev,
        )

        def put(a):
            return torch.from_numpy(a).to(dev)

        geom = torch.stack([self._geom(rec.job.space) for rec in members])
        args = (
            geom, put(costs), put(prio_mask), put(rem_mask), put(init_picks),
            put(init_count), put(max_trials),
            put(np.full(rows, self.settings.min_observations, np.int32)),
            put(np.full(rows, self.settings.ei_stop_rel, np.float32)),
            put(np.full(rows, self.to_exhaustion, bool)),
        )
        # One extra pass beyond the largest fresh-trial budget: it observes
        # nothing, but it is where a budget-capped job records a phase
        # boundary reached exactly at its last trial, and where budget
        # exhaustion latches `done`.
        steps_needed = int(np.max(max_trials - t0)) + 1
        return _LiveChunk(state, args, members, steps_needed)

    def _retire(self, ch: _LiveChunk) -> None:
        host = {k: ch.state._asdict()[k].cpu().numpy()
                for k in ("tried", "t", "stop", "pb")}
        for i, rec in enumerate(ch.members):
            if rec is None:
                continue  # retired mid-flight; outcome already published
            self._publish(
                rec, k=int(host["t"][i]), tried_row=host["tried"][i],
                stop=int(host["stop"][i]), pb=int(host["pb"][i]),
            )

    def _publish(
        self, rec: _JobRec, k: int, tried_row, stop: int, pb: int,
        failure: Optional[str] = None,
    ) -> None:
        """Build and register ``rec``'s `SearchOutcome` from its engine row
        (slots [w, k) are the executed trials) and release its caches.
        Shared by normal retirement, mid-flight kills (partial rows), and
        pending-queue terminations (k == w, no row)."""
        w = len(rec.seed_trials)
        n_init = len(rec.init_list)
        # Straggler latency is reported (attempts = 2 for the re-dispatched
        # trial), never fed back: the observed cost is the table value.
        plan = getattr(rec.job, "faults", None)
        # Priced jobs carry raw runtime/dollar axes on every record; unpriced
        # jobs keep the legacy record shape.
        rt64, usd64 = rec.axes64 if rec.axes64 is not None else (None, None)
        records = []
        for slot in range(w, k):
            idx = int(tried_row[slot])
            records.append(
                TrialRecord(
                    index=idx,
                    cost=float(rec.table64[idx]),
                    slot=slot,
                    source="init" if slot < n_init else "search",
                    attempts=(
                        2 if plan is not None
                        and plan.is_straggler(rec.job.name, slot) else 1
                    ),
                    runtime_h=None if rt64 is None else float(rt64[idx]),
                    usd=None if usd64 is None else float(usd64[idx]),
                )
            )
        outcome = SearchOutcome(
            name=rec.job.name,
            records=records,
            seeded=list(rec.seed_trials),
            stop_iteration=stop if stop >= 0 else None,
            phase_boundary=pb if pb >= 0 else None,
            priority=tuple(rec.prio_idx.tolist()),
            remaining=tuple(rec.rem_idx.tolist()),
            profile=rec.profile,
            signature=rec.signature,
            status=rec.status,
            profile_attempts=rec.profile_attempts,
            retry_backoff_s=rec.retry_backoff_s,
            failure=failure,
            objective=rec.objective,
            currency=(
                getattr(rec.job, "currency", "USD")
                if rec.axes64 is not None else None
            ),
        )
        self._outcomes[rec.handle.uid] = outcome
        rec.handle._outcome = outcome
        if rec.status == "failed":
            self._failed_since_drain.append(rec.handle.uid)
        # Only CONVERGED searches feed the warm-start class history: a
        # revoked job's partial trials would make later warm seeds depend
        # on cancellation timing.
        if rec.status == "converged" and rec.class_key is not None:
            hist, seen = self._history.setdefault(
                rec.class_key, ([], set())
            )
            for r in records:
                if r.index not in seen:
                    seen.add(r.index)
                    hist.append((r.index, r.cost))
        self._release(rec)
        for listener in self._outcome_listeners:
            listener(outcome)
