"""Fleet tuning: streaming multi-job Bayesian-optimized search.

Port of `repro/fleet/`.  The paper evaluates Ruya one job at a time;
related work (Flora, Blink) pushes toward tuning as a fleet service: many
jobs, shared knowledge, little per-job overhead.  This package provides:

  * `session.TuningSession`, the tuning engine: submit jobs over time;
    `step()` advances every live search one batched BO iteration (newly
    submitted jobs join lockstep chunks between steps); `drain()` and
    `results()` return `TrialRecord` / `SearchOutcome` structures.  The
    session owns the `ProfileCache`, computes the §III-D split on the
    device, and warm-starts searches from completed trials in the same
    memory-signature class.
  * `batched_engine.batched_search`: a one-shot shim over a session, J
    independent Ruya/CherryPick searches in lockstep on the device.
  * `profile_cache.ProfileCache`: Flora-style reuse of profiling runs
    across jobs whose memory patterns match.
  * `driver.tune_fleet`: a one-shot shim (profile with cache, split,
    search), one `RuyaReport` per job.
  * `sharding`: job-axis sharding over devices; a group's lockstep chunks
    are bundled S at a time, one a device, and stepped together
    (`TuningSession(shard=...)`, `batched_search(shard=...)`), each job's
    outcome that of the unsharded session.
  * `retry.RetryPolicy`: deterministic exponential backoff with seeded
    jitter for transient profiling-run failures.
  * `service.TuningService`: the async daemon over a session, one host
    thread per live admission group stepping its own chunks at its own
    pace, thread-safe `submit()` with backpressure (`ServiceSaturated`),
    graceful shutdown and a JSON metrics surface; each job's outcome is
    that of the lockstep drain under any interleaving.
"""

from repro_torch.fleet.batched_engine import BatchedTrace, batched_search
from repro_torch.fleet.driver import FleetJob, cluster_fleet, replay_seeds, tune_fleet
from repro_torch.fleet.profile_cache import MemorySignature, ProfileCache
from repro_torch.fleet.retry import RetryPolicy, RetryStats, call_with_retry
from repro_torch.fleet.service import ServiceSaturated, TuningService
from repro_torch.fleet.sharding import resolve_shard_devices
from repro_torch.fleet.session import (
    FleetFailedError,
    JobHandle,
    SearchOutcome,
    TrialRecord,
    TuningSession,
    canonical_objective,
    objective_table,
)

__all__ = [
    "BatchedTrace",
    "batched_search",
    "FleetFailedError",
    "FleetJob",
    "cluster_fleet",
    "replay_seeds",
    "tune_fleet",
    "JobHandle",
    "MemorySignature",
    "ProfileCache",
    "RetryPolicy",
    "RetryStats",
    "call_with_retry",
    "canonical_objective",
    "objective_table",
    "resolve_shard_devices",
    "SearchOutcome",
    "ServiceSaturated",
    "TrialRecord",
    "TuningService",
    "TuningSession",
]
