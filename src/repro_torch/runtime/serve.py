"""Tuning-as-a-service daemon: a supervised `TuningService` with a
periodic JSON metrics snapshot.

Port of `repro/runtime/serve.py`.  The deployment wrapper around
`repro_torch.fleet.service.TuningService` (which owns the scheduling:
per-group dispatch threads, admission backpressure, graceful drain): the
daemon adds a background snapshot thread that writes
`TuningService.metrics()` to disk at a fixed cadence (write, then rename,
so a scraper never reads a torn file) and a `stop(drain=...)` that flushes
a final snapshot.

    daemon = TuningDaemon(metrics_path="artifacts/tuning_metrics.json",
                          cache=ProfileCache(), max_in_flight=128)
    daemon.start()
    handle = daemon.submit(job, seed=0)
    ...
    daemon.stop(drain=True)       # drain, final snapshot, join threads

Like every entry point of the port the session runs on the card unless
``device="cpu"`` is passed.  The token-decode serving loop lives in
`repro_torch.runtime.decode_loop` and is re-exported here as the reference
does.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

from repro_torch.fleet.service import TuningService
from repro_torch.fleet.session import JobHandle, SearchOutcome
from repro_torch.runtime.decode_loop import ServeLoop  # noqa: F401  (re-export)

__all__ = ["ServeLoop", "TuningDaemon"]


class TuningDaemon:
    """Long-running tuning service with periodic metrics snapshots.

    Constructor keywords forward to `TuningService` (and through it to
    `TuningSession`) unless an existing ``service`` is passed.
    ``metrics_path`` (optional) is where the snapshot thread writes the
    JSON metrics surface every ``snapshot_every_s`` seconds; with no path,
    `metrics()` is still available on demand and nothing touches disk.
    The daemon is a context manager: `with TuningDaemon(...) as d:` starts
    it and stops it (draining) on a clean exit.
    """

    def __init__(
        self,
        service: Optional[TuningService] = None,
        *,
        metrics_path: Optional[str] = None,
        snapshot_every_s: float = 5.0,
        **service_kwargs: object,
    ) -> None:
        if service is not None and service_kwargs:
            raise ValueError(
                "pass EITHER an existing service OR TuningService kwargs"
            )
        self.service = service or TuningService(**service_kwargs)
        self.metrics_path = metrics_path
        self.snapshot_every_s = float(snapshot_every_s)
        self._stop = threading.Event()
        self._snapshotter: Optional[threading.Thread] = None

    # --------------------------------------------------------- lifecycle

    def start(self) -> "TuningDaemon":
        """Idempotent; starts the snapshot thread when a path is set."""
        if self.metrics_path is not None and self._snapshotter is None:
            self._snapshotter = threading.Thread(
                target=self._snapshot_loop, name="tuning-metrics", daemon=True
            )
            self._snapshotter.start()
        return self

    def stop(self, drain: bool = True) -> List[SearchOutcome]:
        """Shut the service down (``drain=True`` finishes live work
        first), stop the snapshot thread, and flush a final snapshot."""
        outcomes = self.service.shutdown(drain=drain)
        self._stop.set()
        if self._snapshotter is not None:
            self._snapshotter.join(timeout=5.0)
            self._snapshotter = None
        self.snapshot()
        return outcomes

    def __enter__(self) -> "TuningDaemon":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop(drain=exc_type is None)

    # ------------------------------------------------------- passthrough

    def submit(self, job, rng=None, **kwargs) -> JobHandle:
        return self.service.submit(job, rng, **kwargs)

    def drain(self) -> List[SearchOutcome]:
        return self.service.drain()

    def results(self) -> List[SearchOutcome]:
        return self.service.results()

    def metrics(self) -> dict:
        return self.service.metrics()

    # ----------------------------------------------------------- metrics

    def snapshot(self) -> Optional[str]:
        """Write one metrics snapshot now (atomic rename); returns the
        path, or None when no ``metrics_path`` is configured."""
        if self.metrics_path is None:
            return None
        payload = self.service.metrics()
        payload["snapshot_unix_s"] = time.time()
        directory = os.path.dirname(os.path.abspath(self.metrics_path))
        os.makedirs(directory, exist_ok=True)
        tmp = f"{self.metrics_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, self.metrics_path)
        return self.metrics_path

    def _snapshot_loop(self) -> None:
        while not self._stop.wait(self.snapshot_every_s):
            try:
                self.snapshot()
            except OSError:
                pass  # a disk hiccup must not kill the snapshot thread
