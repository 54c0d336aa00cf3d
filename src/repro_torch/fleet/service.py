"""`TuningService`: the async tuning daemon over `TuningSession`.

Port of `repro/fleet/service.py`.  The session advances every live search
in global lockstep: one `step()` walks every chunk, so the slowest
admission group sets the pace for the whole fleet.  The service removes
the global barrier: each live admission group ((space shape, packed
capacity), the session's chunking unit) gets its own host thread stepping
its own chunks at its own pace,

    service = TuningService(cache=ProfileCache(), max_in_flight=64)
    handle  = service.submit(job, seed=0)   # queues; a group worker admits
                                            # it at ITS next iteration
                                            # boundary and steps it
    service.drain()                         # block until everything lands
    service.metrics()                       # per-group latency, queue
                                            # depth, jobs/sec, fault totals
    service.shutdown(drain=True)

Why this changes no outcome: chunk membership never affects a trace (no
op of the step reduces across the job axis), a submission's warm-start
history snapshot and scripted init draw happen inside `submit()` under the
session lock, and each chunk is only ever stepped by its group's worker.
So every job's outcome equals the single-threaded lockstep drain's, for any
interleaving of the threads.

Scheduling.  `submit()` is thread-safe and applies backpressure: at most
``max_in_flight`` jobs may be submitted but unfinished; at the cap it
blocks (default) or raises `ServiceSaturated`.  Admitted groups go round-
robin over ``devices`` (the visible cards, or the session's device on the
CPU), so on several cards two groups' work runs on two devices.  The host
dispatch of a chunk step runs under the session lock (as in the
reference), so on one card the groups' threads mostly take turns; the
waits for the device (polls, retirement) run outside it.

The worker threads launch the EI/argmax kernel concurrently.  Its binding
shares one finished-block counter buffer per device across calls, which is
safe while calls on a device run on one stream: every thread's current
stream is the device's default stream, and the service creates none.

Lock discipline (the deadlock-freedom argument): the session lock is the
OUTER lock; outcome listeners fire under it and take only the service's
condition variable, so service code never calls into the session while
holding the condition variable.  Workers needing an atomic look at both
sides (the idle-exit check) take the session lock first, then the
condition variable.

``pace`` is a test and benchmark seam: called as ``pace(group_key,
iteration)`` by a group's worker before each of its iterations, outside all
locks.  The interleaving fuzz drives seeded sleeps through it, and the
disturbed scenario uses it to hold a group mid-flight while a test cancels
a victim and reshards.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

import torch

from repro_torch.fleet.session import JobHandle, SearchOutcome, TuningSession

__all__ = ["ServiceSaturated", "TuningService"]


class ServiceSaturated(RuntimeError):
    """`submit()` with ``saturation="raise"`` found the service at its
    ``max_in_flight`` cap.  Back off and resubmit (or size the cap to the
    burst); nothing was enqueued."""


class _GroupStats:
    """Per-group metrics, mutated by the owning worker under the CV."""

    __slots__ = ("iterations", "steps", "last_step_s", "total_step_s",
                 "admitted", "device")

    def __init__(self, device: Optional[str]) -> None:
        self.iterations = 0
        self.steps = 0
        self.last_step_s = 0.0
        self.total_step_s = 0.0
        self.admitted = 0
        self.device = device

    def as_dict(self) -> dict:
        mean = self.total_step_s / self.steps if self.steps else 0.0
        return {
            "iterations": self.iterations,
            "steps": self.steps,
            "admitted": self.admitted,
            "last_step_s": self.last_step_s,
            "mean_step_s": mean,
            "device": self.device,
        }


class _GroupWorker(threading.Thread):
    """One admission group's dispatch loop.

    Spawned when a submit leaves pending work under a group key with no
    live worker; exits when the key has neither pending jobs nor live
    chunks (checked atomically under the session lock, so a racing submit
    either sees the worker in the registry or spawns a fresh one).
    Daemonic: an abandoned service never blocks interpreter exit.
    """

    def __init__(self, service: "TuningService", key: tuple, device) -> None:
        super().__init__(name=f"tuning-group-{key}", daemon=True)
        self.key = key
        self.device = device
        self._service = service
        self.iteration = 0

    def run(self) -> None:
        svc = self._service
        session = svc._session
        try:
            while not svc._halt:
                if svc._paused:
                    svc._idle_wait()
                    continue
                admitted = session._admit_group(self.key, device=self.device)
                chunks = session._chunks_for(self.key)
                if admitted:
                    with svc._cv:
                        svc._stats[self.key].admitted += admitted
                if not chunks:
                    # Idle exit, atomic against submit: the session lock
                    # (outer) guards the pending and chunk scan, and the
                    # registry removal happens inside it, so a concurrent
                    # submit serializes either before (we see its pending
                    # rec and stay) or after (it finds the registry slot
                    # empty and spawns a fresh worker).
                    with session._lock:
                        busy = any(
                            (r.enc.shape, r.budget) == self.key
                            for r in session._pending
                        ) or any(
                            c.group_key == self.key for c in session._chunks
                        )
                        if not busy and not svc._paused:
                            with svc._cv:
                                svc._workers.pop(self.key, None)
                                svc._cv.notify_all()
                            return
                    svc._idle_wait()
                    continue
                self.iteration += 1
                if svc._pace is not None:
                    svc._pace(self.key, self.iteration)
                for ch in chunks:
                    if svc._halt:
                        return
                    t0 = time.monotonic()
                    session._step_chunk(ch)
                    dt = time.monotonic() - t0
                    with svc._cv:
                        st = svc._stats[self.key]
                        st.steps += 1
                        st.last_step_s = dt
                        st.total_step_s += dt
                with svc._cv:
                    svc._stats[self.key].iterations += 1
        except BaseException as e:  # surface in drain(), don't die silently
            with svc._cv:
                svc._errors.append((self.key, e))
                svc._workers.pop(self.key, None)
                svc._cv.notify_all()


class TuningService:
    """Persistent tuning daemon: a `TuningSession` plus per-group worker
    threads, admission backpressure, and a metrics surface.

    Constructor keywords are forwarded to `TuningSession` (``settings``,
    ``cache``, ``layout``, ``shard``, ``retry``, ``device``, ...) unless an
    existing ``session`` is passed; then the service must be its only
    submitter (the in-flight accounting counts one publication per service
    submit).  Like every entry point of the port, the session runs on the
    card unless ``device="cpu"`` is passed.

    ``max_in_flight`` bounds submitted-but-unfinished jobs; ``saturation``
    picks the behavior at the cap: "block" (default) parks the submitter on
    a condition variable until capacity frees, "raise" raises
    `ServiceSaturated` at once.  ``devices`` spreads admission groups
    round-robin: "auto" (the default) is every visible CUDA device when
    the session is on the card, else the session's device; pass a list
    (which may repeat a device), or None to keep the session's device.
    Sharded sessions (``shard=...``) ignore per-group placement: the
    bundle owns its device set.

    ``pace(group_key, iteration)`` is the scheduling seam described in the
    module docstring.  `pause()`/`resume()` gate admission AND stepping;
    submissions still enqueue while paused, which is how a caller makes a
    whole wave's warm-history snapshots atomic with respect to the workers.

    `drain()` blocks until every service-submitted job has published, then
    applies the session's all-failed guard (`FleetFailedError`) over
    exactly the jobs this drain was waiting on.  `shutdown(drain=True)`
    drains first; ``drain=False`` abandons live work (outcomes of finished
    jobs remain readable).  The service is a context manager (`with
    TuningService(...) as svc:` → `shutdown(drain=True)` on a clean exit).
    """

    def __init__(
        self,
        session: Optional[TuningSession] = None,
        *,
        max_in_flight: Optional[int] = None,
        saturation: str = "block",
        pace: Optional[Callable[[tuple, int], None]] = None,
        devices: object = "auto",
        **session_kwargs: object,
    ) -> None:
        if saturation not in ("block", "raise"):
            raise ValueError(f"unknown saturation mode {saturation!r}")
        if session is not None and session_kwargs:
            raise ValueError(
                "pass EITHER an existing session OR TuningSession kwargs"
            )
        if max_in_flight is not None and int(max_in_flight) < 1:
            raise ValueError("max_in_flight must be >= 1")
        # NOT `session or ...`: an empty TuningSession is falsy (__len__).
        self._session = (
            session if session is not None else TuningSession(**session_kwargs)
        )
        self.max_in_flight = None if max_in_flight is None else int(max_in_flight)
        self.saturation = saturation
        self._pace = pace

        home = self._session.device
        if devices == "auto":
            self._devices = (
                [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                if home.type == "cuda" else [home]
            )
        elif devices is None:
            self._devices = []
        else:
            self._devices = [torch.device(d) for d in devices]
        if self._session.shard_devices is not None:
            self._devices = []  # sharded bundles own their placement
        self._next_device = 0

        # ONE condition variable guards all service state (worker registry,
        # stats, in-flight count, pause/halt flags) and carries every
        # signal: capacity freed, job published, worker exited, resume.
        # The session lock is the outer lock (see the module docstring).
        self._cv = threading.Condition()
        self._workers: Dict[tuple, _GroupWorker] = {}
        self._stats: Dict[tuple, _GroupStats] = {}
        self._errors: List[Tuple[tuple, BaseException]] = []
        self._paused = False
        self._halt = False
        self._in_flight = 0
        self._submitted = 0
        self._completed = 0
        self._status_counts: Dict[str, int] = {}
        self._profile_attempts_total = 0
        self._retry_backoff_total = 0.0
        self._straggler_trials = 0
        self._t_start = time.monotonic()
        self._t_first_submit: Optional[float] = None
        self._t_last_complete: Optional[float] = None

        # Fires under the SESSION lock for every published outcome: touch
        # only the CV here (never call back into the session).
        self._session._outcome_listeners.append(self._on_outcome)

    # ------------------------------------------------------------ submit

    def submit(self, job, rng=None, **kwargs) -> JobHandle:
        """Thread-safe submit with backpressure; otherwise exactly
        `TuningSession.submit` (same keywords, same determinism: the
        warm-history snapshot and scripted init draw happen here, so the
        search is fixed however the workers interleave)."""
        with self._cv:
            if self._halt:
                raise RuntimeError("service is shut down")
            while (
                self.max_in_flight is not None
                and self._in_flight >= self.max_in_flight
            ):
                if self.saturation == "raise":
                    raise ServiceSaturated(
                        f"{self._in_flight} jobs in flight >= "
                        f"max_in_flight={self.max_in_flight}"
                    )
                self._cv.wait()
                if self._halt:
                    raise RuntimeError("service is shut down")
            # Reserve the slot before the session call: a submit-time
            # profiling failure publishes DURING submit and the listener's
            # decrement must find the reservation.
            self._in_flight += 1
            self._submitted += 1
            if self._t_first_submit is None:
                self._t_first_submit = time.monotonic()
        try:
            handle = self._session.submit(job, rng, **kwargs)
        except BaseException:
            with self._cv:  # nothing enqueued; release the reservation
                self._in_flight -= 1
                self._submitted -= 1
                self._cv.notify_all()
            raise
        self._ensure_workers()
        return handle

    def _ensure_workers(self) -> None:
        """Spawn a worker for every pending group key that lacks one.
        Session state is read before the CV is taken (lock order)."""
        keys = self._session._pending_group_keys()
        with self._cv:
            if self._halt:
                return
            for key in keys:
                if key in self._workers:
                    continue
                device = None
                if self._devices:
                    device = self._devices[
                        self._next_device % len(self._devices)
                    ]
                    self._next_device += 1
                if key not in self._stats:
                    self._stats[key] = _GroupStats(
                        None if device is None else str(device)
                    )
                worker = _GroupWorker(self, key, device)
                self._workers[key] = worker
                worker.start()
            self._cv.notify_all()

    def _on_outcome(self, outcome: SearchOutcome) -> None:
        # Called under the session lock; CV only (see lock discipline).
        with self._cv:
            self._in_flight -= 1
            self._completed += 1
            self._t_last_complete = time.monotonic()
            self._status_counts[outcome.status] = (
                self._status_counts.get(outcome.status, 0) + 1
            )
            self._profile_attempts_total += outcome.profile_attempts
            self._retry_backoff_total += outcome.retry_backoff_s
            self._straggler_trials += sum(
                1 for r in outcome.records if r.attempts > 1
            )
            self._cv.notify_all()

    # ----------------------------------------------------------- control

    def pause(self) -> None:
        """Park every worker (no admission, no stepping) until `resume`.
        Submissions still enqueue: a paused service is how a caller makes
        a multi-job wave's warm-history snapshots atomic."""
        with self._cv:
            self._paused = True

    def resume(self) -> None:
        with self._cv:
            self._paused = False
            self._cv.notify_all()
        self._ensure_workers()

    def _idle_wait(self, timeout: float = 0.005) -> None:
        with self._cv:
            if not self._halt:
                self._cv.wait(timeout)

    def _raise_worker_errors(self) -> None:
        with self._cv:
            if not self._errors:
                return
            key, err = self._errors[0]
        raise RuntimeError(
            f"group worker {key} died: {type(err).__name__}: {err}"
        ) from err

    # ----------------------------------------------------------- results

    def results(self) -> List[SearchOutcome]:
        return self._session.results()

    def outcome(self, handle: JobHandle) -> SearchOutcome:
        return handle.outcome()

    def cancel(self, handle: JobHandle) -> bool:
        return self._session.cancel(handle)

    def drain(self) -> List[SearchOutcome]:
        """Block until every service-submitted job has published; return
        all outcomes (submission order).  Resumes a paused service (parked
        workers cannot finish anything).  Raises `FleetFailedError` when
        EVERY job this drain was waiting on failed (the session's guard),
        and re-raises the first worker error if a dispatch loop died."""
        session = self._session
        with session._lock:
            waiting: Set[int] = {
                rec.handle.uid for rec in session._live_recs()
            }
            waiting.update(session._failed_since_drain)
            session._failed_since_drain = []
        self.resume()
        with self._cv:
            while self._in_flight > 0 and not self._errors and not self._halt:
                self._cv.wait(0.05)
        self._raise_worker_errors()
        session._check_all_failed(waiting)
        return session.results()

    def shutdown(self, drain: bool = True) -> List[SearchOutcome]:
        """Stop the daemon.  ``drain=True`` (default) finishes live work
        first; ``drain=False`` abandons it (workers exit at their next loop
        check; unfinished handles stay "running" or "pending").
        Idempotent; returns the finished outcomes either way."""
        outcomes: List[SearchOutcome] = []
        if drain and not self._halt:
            outcomes = self.drain()
        with self._cv:
            self._halt = True
            workers = list(self._workers.values())
            self._cv.notify_all()
        for w in workers:
            w.join(timeout=10.0)
        return outcomes if drain else self.results()

    def __enter__(self) -> "TuningService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # Don't mask an in-flight exception with a drain hang: only a
        # clean exit waits for live work.
        self.shutdown(drain=exc_type is None)

    # ----------------------------------------------------------- metrics

    def metrics(self) -> dict:
        """JSON-able operational snapshot: queue depth, in-flight count,
        sustained jobs/sec (completions over the first-submit to last-
        completion window), per-group step latency and iteration counts,
        and the fleet's fault and retry totals (profiling attempts with
        retries, charged backoff seconds, straggler-flagged trials), summed
        from the published outcomes."""
        with self._session._lock:
            queue_depth = len(self._session._pending)
            live_chunks: Dict[tuple, int] = {}
            for ch in self._session._chunks:
                live_chunks[ch.group_key] = live_chunks.get(ch.group_key, 0) + 1
        with self._cv:
            # A rate only over a real window: `is not None` (a monotonic
            # stamp can be 0.0), and at least two completions (one
            # completion's "window" is that job's latency).
            span = None
            if (
                self._t_first_submit is not None
                and self._t_last_complete is not None
                and self._completed >= 2
            ):
                span = self._t_last_complete - self._t_first_submit
                if span <= 0.0:
                    span = None
            groups = {}
            for key, st in self._stats.items():
                g = st.as_dict()
                g["live_chunks"] = live_chunks.get(key, 0)
                g["worker_alive"] = key in self._workers
                groups[str(key)] = g
            return {
                "uptime_s": time.monotonic() - self._t_start,
                "submitted": self._submitted,
                "completed": self._completed,
                "in_flight": self._in_flight,
                "queue_depth": queue_depth,
                "max_in_flight": self.max_in_flight,
                "paused": self._paused,
                "jobs_per_sec": (
                    None if span is None else self._completed / span
                ),
                "statuses": dict(self._status_counts),
                "faults": {
                    "profile_attempts_total": self._profile_attempts_total,
                    "profile_retries_total": (
                        self._profile_attempts_total - self._completed
                        if self._completed else 0
                    ),
                    "retry_backoff_s_total": self._retry_backoff_total,
                    "straggler_trials": self._straggler_trials,
                },
                "groups": groups,
            }
