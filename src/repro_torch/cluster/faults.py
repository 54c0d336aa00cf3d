"""Seeded fault injection for the emulated cluster (adversarial fleets).

A `FaultPlan` disturbs a job's profiling/probe runs and its search trials
the way a real cluster does — preempted sample machines (transient, a retry
fixes it), broken job binaries (permanent, no retry can), and straggler
trials that take several times longer than their twins — while keeping the
whole disturbance a pure function of the plan.  Every injection decision is
either scripted (`transient_run_failures`: the first N wrapped calls fail)
or drawn from a sha256 hash of (seed, job key, call index) — the same
deterministic-randomness idiom as `repro_torch.cluster.simulator`'s cost
variance — so a disturbed fleet run is exactly reproducible and the
golden-trace harness can pin its surviving searches bit-identical to an
undisturbed run.

Two invariants make that bit-identity possible, and this module is written
to preserve them:

  * a wrapped run NEVER alters the values a successful call returns — it
    only decides whether the call raises first.  The emulated run fns are
    deterministic in the sample size, so a retried profiling attempt
    replays the identical readings and fits the identical model;
  * straggler latency is REPORTED, never fed back: `straggler_factor` is a
    metric on the trial (surfaced as `TrialRecord.attempts` and the bench's
    straggler counts), not a perturbation of profile runtimes — runtimes
    feed the §III-B calibration loop, and touching them would change sweep
    sizes, profiles, splits, and finally traces.

Stall isolation: under the async service (`repro.fleet.service`) a
straggler-stalled trial slows only its own admission group's dispatch
thread — other groups keep stepping at their own pace, which is exactly
what the open-loop straggler bench (workload G, `benchmarks/fleet_bench`)
measures against the global-lockstep engine.

Stochastic transients are capped by ``max_injected`` so a retried call
site is GUARANTEED to succeed within ``max_injected + 1`` attempts — pick
it below the retry policy's ``max_attempts`` and an adversarial schedule
degrades throughput, never correctness (each aborted attempt consumes at
least one injected fault).  Scripted failures have the same property by
construction.  `PermanentRunError` plans model a broken job: every call
raises, retries fast-fail, and the job surfaces as a first-class failed
outcome.

The port's own numpy copy of the reference module `repro/cluster/faults.py`:
the port never imports the JAX package, and the two stay bit-equal.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Callable, Tuple

from repro_torch.core.profiler import PermanentRunError, TransientRunError

__all__ = ["FaultPlan"]

RunFn = Callable[[float], Tuple[float, float]]


def _hash_unit(*parts: str) -> float:
    """Deterministic uniform in [0, 1) from a string key."""
    h = hashlib.sha256("/".join(parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0**64


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One job's deterministic disturbance schedule.

    ``transient_run_failures`` scripts the first N wrapped run calls to
    raise `TransientRunError` (exact, for pinned scenarios);
    ``transient_rate`` additionally injects hash-drawn transients, at most
    ``max_injected`` in total over the wrapper's lifetime (the termination
    guarantee — see the module docstring).  ``permanent=True`` makes every
    call raise `PermanentRunError`.  Stragglers are per-trial flags drawn
    at ``straggler_rate``; ``straggler_factor`` is the reported latency
    multiplier.
    """

    seed: int = 0
    transient_run_failures: int = 0
    transient_rate: float = 0.0
    max_injected: int = 3
    permanent: bool = False
    straggler_rate: float = 0.0
    straggler_factor: float = 4.0

    def __post_init__(self) -> None:
        if self.transient_run_failures < 0 or self.max_injected < 0:
            raise ValueError("fault counts must be non-negative")
        if not (0.0 <= self.transient_rate <= 1.0):
            raise ValueError(f"transient_rate={self.transient_rate}")
        if not (0.0 <= self.straggler_rate <= 1.0):
            raise ValueError(f"straggler_rate={self.straggler_rate}")
        if self.straggler_factor < 1.0:
            raise ValueError("straggler_factor < 1 is not a straggler")

    def wrap_run(self, run: RunFn, key: str = "job") -> RunFn:
        """Wrap a profiling/probe run fn with this plan's failures.

        The wrapper keeps a call counter (shared across retries — the
        whole point: a retried profiling attempt draws FRESH fault
        decisions while replaying identical successful readings) and an
        injected-fault budget.  Successful calls pass through untouched.

        The counters live behind a lock: seed-replica fleets alias one
        wrapped run fn across jobs, and with the async service those
        jobs submit from concurrent threads — the fault DECISION
        (counter read-increment plus injection-budget check) is atomic,
        while the successful ``run`` call itself executes outside the
        lock (it is deterministic in the sample size, so concurrent
        passes don't contend on profiling).
        """
        lock = threading.Lock()
        calls = [0]
        injected = [0]

        def faulty(sample: float) -> Tuple[float, float]:
            with lock:
                i = calls[0]
                calls[0] += 1
                if self.permanent:
                    raise PermanentRunError(
                        f"{key}: run {i} failed permanently (injected)"
                    )
                if i < self.transient_run_failures:
                    raise TransientRunError(
                        f"{key}: run {i} failed transiently (scripted)"
                    )
                if (
                    self.transient_rate > 0.0
                    and injected[0] < self.max_injected
                    and _hash_unit(
                        "fault", str(self.seed), key, "run", str(i)
                    )
                    < self.transient_rate
                ):
                    injected[0] += 1
                    raise TransientRunError(
                        f"{key}: run {i} failed transiently (injected "
                        f"{injected[0]}/{self.max_injected})"
                    )
            return run(sample)

        return faulty

    def is_straggler(self, key: str, trial: int) -> bool:
        """Deterministic per-trial straggler flag."""
        if self.straggler_rate <= 0.0:
            return False
        return (
            _hash_unit("straggler", str(self.seed), key, str(trial))
            < self.straggler_rate
        )

    def straggler_multiplier(self, key: str, trial: int) -> float:
        """Reported latency multiplier for one trial (1.0 = on time)."""
        return self.straggler_factor if self.is_straggler(key, trial) else 1.0
