"""Fleet tuning: streaming multi-job Bayesian-optimized search on one device.

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
  * `retry.RetryPolicy`: deterministic exponential backoff with seeded
    jitter for transient profiling-run failures.

The reference's multi-device parts (`sharding.resolve_shard_devices`, the
async `service.TuningService` and its `ServiceSaturated`) wait for ROADMAP
Queue 1 item 15.
"""

from repro_torch.fleet.batched_engine import BatchedTrace, batched_search
from repro_torch.fleet.driver import FleetJob, cluster_fleet, replay_seeds, tune_fleet
from repro_torch.fleet.profile_cache import MemorySignature, ProfileCache
from repro_torch.fleet.retry import RetryPolicy, RetryStats, call_with_retry
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
    "SearchOutcome",
    "TrialRecord",
    "TuningSession",
]
