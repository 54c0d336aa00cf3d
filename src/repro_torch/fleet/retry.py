"""Deterministic exponential backoff with seeded jitter for profiling runs.

Production profiling runs fail: sample machines get preempted, probe
processes OOM, connections drop.  Ruya's premise — profiling is cheap and
reliable — survives contact with a real cluster only if transient failures
are retried and permanent ones give up *cleanly* (a broken job binary must
not burn `max_attempts × backoff` of budget before surfacing).

Everything here is deterministic.  The backoff for attempt k is the usual
capped exponential, and the jitter — which exists to de-synchronize
retrying clients — comes from a hash of ``(seed, attempt)`` instead of a
live RNG, so a retried fleet run is a pure function of (fault schedule,
session seed): the golden-trace harness can pin a disturbed fleet's
surviving traces bit-identical to an undisturbed run, and a flaky retry
schedule can never be the reason a fixture drifts.  No RNG state is
consumed anywhere (the BO initialization draws stay aligned with the
undisturbed engines).

Classification follows `repro_torch.core.profiler`'s taxonomy:
`TransientRunError` is retried up to ``max_attempts`` with backoff;
`PermanentRunError` — and any exception type not listed in ``transient``
— propagates immediately (fast-fail, zero backoff charged).

The port's copy of the reference module `repro/fleet/retry.py`; the jitter
is the same sha256 hash, so both compute the same schedule.

Sleeping is injectable and OFF by default: this repo drives emulated
clusters, so backoff is *charged* (returned in `RetryStats.backoff_s`)
rather than slept.  Pass ``sleep=time.sleep`` to actually wait.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, List, Optional, Tuple, Type, TypeVar

from repro_torch.core.profiler import TransientRunError

__all__ = [
    "RetryPolicy",
    "RetryStats",
    "backoff_s",
    "backoff_schedule",
    "call_with_retry",
]

T = TypeVar("T")


def _hash_unit(*parts: str) -> float:
    """Deterministic uniform in [0, 1) from a string key (same idiom as
    `repro_torch.cluster.simulator._hash_unit_normal` — sha256, not a live RNG,
    so retry jitter never perturbs the engines' scripted draws)."""
    h = hashlib.sha256("/".join(parts).encode()).digest()
    return int.from_bytes(h[:8], "big") / 2.0**64


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry/backoff parameters for transient profiling-run failures.

    ``max_attempts`` counts ALL attempts including the first (1 = never
    retry).  The backoff before retry k (1-based failure count) is

        min(base_s · multiplier^(k-1), max_backoff_s) · (1 + jitter·u_k)

    with u_k a deterministic uniform in [-1, 1) derived from (seed, k) —
    see `backoff_s`.  ``jitter`` must keep the factor positive (< 1.0).
    """

    max_attempts: int = 4
    base_s: float = 1.0
    multiplier: float = 2.0
    max_backoff_s: float = 60.0
    jitter: float = 0.25

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts={self.max_attempts}: want >= 1")
        if not (0.0 <= self.jitter < 1.0):
            raise ValueError(f"jitter={self.jitter}: want in [0, 1)")
        if self.base_s < 0.0 or self.multiplier < 1.0 or self.max_backoff_s < 0:
            raise ValueError("backoff parameters must be non-negative, "
                             "multiplier >= 1")


@dataclasses.dataclass
class RetryStats:
    """What one retried call cost beyond its successful attempt."""

    attempts: int = 1  # total attempts made (1 = first try succeeded)
    backoff_s: float = 0.0  # total charged backoff (simulated unless slept)


def backoff_s(policy: RetryPolicy, seed: int, attempt: int) -> float:
    """Deterministic backoff before retry ``attempt`` (1-based count of
    failures so far).  A pure function of (policy, seed, attempt)."""
    if attempt < 1:
        raise ValueError(f"attempt={attempt}: retries are 1-based")
    raw = min(
        policy.base_s * policy.multiplier ** (attempt - 1),
        policy.max_backoff_s,
    )
    u = 2.0 * _hash_unit("retry", str(seed), str(attempt)) - 1.0  # [-1, 1)
    return raw * (1.0 + policy.jitter * u)


def backoff_schedule(policy: RetryPolicy, seed: int) -> List[float]:
    """The full deterministic backoff schedule: one entry per possible
    retry (``max_attempts - 1`` entries)."""
    return [backoff_s(policy, seed, k) for k in range(1, policy.max_attempts)]


def call_with_retry(
    fn: Callable[[], T],
    *,
    policy: RetryPolicy,
    seed: int,
    transient: Tuple[Type[BaseException], ...] = (TransientRunError,),
    sleep: Optional[Callable[[float], None]] = None,
    stats: Optional[RetryStats] = None,
) -> Tuple[T, RetryStats]:
    """Call ``fn`` retrying transient failures with deterministic backoff.

    Returns ``(value, RetryStats)``.  Exceptions in ``transient`` are
    retried up to ``policy.max_attempts`` total attempts; the last one is
    re-raised when the budget is exhausted.  Any other exception —
    `PermanentRunError` included — propagates immediately with no backoff
    charged (fast-fail).  ``sleep`` is called with each backoff when given
    (default: backoff is charged to the stats only — emulated clusters
    should not make the test suite wait).  ``stats`` accumulates in place
    when supplied, so one object can aggregate a probe + profile pair.
    """
    st = stats if stats is not None else RetryStats(attempts=0)
    if stats is None:
        st.attempts = 0
    last: Optional[BaseException] = None
    for attempt in range(1, policy.max_attempts + 1):
        st.attempts += 1  # count every attempt, fast-failed ones included
        try:
            value = fn()
        except transient as e:
            last = e
            if attempt == policy.max_attempts:
                raise
            delay = backoff_s(policy, seed, attempt)
            st.backoff_s += delay
            if sleep is not None:
                sleep(delay)
            continue
        return value, st
    raise last  # unreachable: loop either returned or re-raised
