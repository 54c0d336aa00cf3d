"""Fault-tolerant training loop (port of `repro/runtime/loop.py`).

  * **Checkpoint/restart** — periodic async checkpoints; `maybe_restore`
    restores the latest checkpoint if one exists (in place, into the
    state's tensors), and the deterministic data pipeline replays from the
    restored step (identical batches).
  * **Preemption handling** — SIGTERM/SIGINT set a flag; the loop finishes
    the in-flight step, writes a *synchronous* barrier checkpoint, and
    exits cleanly for the cluster manager to restart it elsewhere.
  * **Straggler mitigation** — per-step wall times feed a rolling monitor;
    steps slower than ``threshold × median`` are flagged and counted.
  * **NaN/divergence guard** — a non-finite loss aborts with a clear error
    (after checkpointing the state) rather than silently training garbage.

Each step waits for the card once, to read the loss, as the reference's
``device_get`` does; the step's time is the host's clock around that.
"""

from __future__ import annotations

import dataclasses
import math
import signal
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager

__all__ = ["PreemptionGuard", "StragglerMonitor", "TrainLoop"]


class StragglerMonitor:
    """Rolling per-step wall-time monitor; flags slow steps."""

    def __init__(self, window: int = 50, threshold: float = 1.5) -> None:
        self.window = window
        self.threshold = threshold
        self.times: deque = deque(maxlen=window)
        self.flagged: List[int] = []

    def observe(self, step: int, seconds: float) -> bool:
        """Record a step time; returns True if it is a straggler."""
        is_straggler = False
        if len(self.times) >= 5:
            med = float(np.median(self.times))
            if seconds > self.threshold * med:
                self.flagged.append(step)
                is_straggler = True
        self.times.append(seconds)
        return is_straggler

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


class PreemptionGuard:
    """Converts SIGTERM/SIGINT into a checked flag (restartable exit)."""

    def __init__(self, install: bool = True) -> None:
        self.preempted = False
        self._prev: Dict[int, Any] = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handler)
                except ValueError:  # non-main thread (tests)
                    pass

    def _handler(self, signum, frame) -> None:  # pragma: no cover - signal path
        self.preempted = True

    def trigger(self) -> None:
        """Test hook: simulate a preemption notice."""
        self.preempted = True

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


@dataclasses.dataclass
class TrainLoop:
    """Drives ``train_step`` with checkpointing and failure handling."""

    train_step: Callable  # (state, batch) -> (state, metrics)
    batch_at: Callable[[int], Dict[str, Any]]  # step -> host batch
    place_batch: Callable[[Dict[str, Any]], Dict[str, Any]]
    state: Any
    checkpoints: CheckpointManager
    checkpoint_every: int = 100
    log_every: int = 10
    monitor: StragglerMonitor = dataclasses.field(default_factory=StragglerMonitor)
    guard: Optional[PreemptionGuard] = None
    log_fn: Callable[[str], None] = print

    start_step: int = 0
    metrics_history: List[Dict[str, float]] = dataclasses.field(default_factory=list)

    def maybe_restore(self) -> int:
        """Restore the newest checkpoint if present; returns start step."""
        latest = self.checkpoints.latest_step()
        if latest is None:
            return 0
        self.state, extra = self.checkpoints.restore(self.state)
        self.start_step = int(extra.get("step", latest))
        self.log_fn(f"[restore] resumed from step {self.start_step}")
        return self.start_step

    def run(self, num_steps: int) -> Dict[str, Any]:
        guard = self.guard or PreemptionGuard(install=False)
        step = self.start_step
        end = self.start_step + num_steps
        exit_reason = "completed"

        while step < end:
            t0 = time.monotonic()
            batch = self.place_batch(self.batch_at(step))
            self.state, metrics = self.train_step(self.state, batch)
            loss = float(metrics["loss"])  # the step's one wait for the card
            dt = time.monotonic() - t0
            step += 1

            if not math.isfinite(loss):
                self.checkpoints.wait()
                self.checkpoints.save(step, self.state, extra={"step": step})
                raise FloatingPointError(
                    f"non-finite loss {loss} at step {step}; "
                    f"state checkpointed for post-mortem"
                )

            if self.monitor.observe(step, dt):
                self.log_fn(
                    f"[straggler] step {step} took {dt:.3f}s "
                    f"(median {self.monitor.median:.3f}s)"
                )
            if step % self.log_every == 0 or step == end:
                rec = {"step": step, "loss": loss, "sec": dt}
                self.metrics_history.append(rec)
                self.log_fn(f"[train] step {step} loss {loss:.4f} ({dt:.3f}s)")
            if step % self.checkpoint_every == 0:
                self.checkpoints.save_async(step, self.state, extra={"step": step})

            if guard.preempted:
                # Barrier save: synchronous, then exit for restart.
                self.checkpoints.wait()
                self.checkpoints.save(step, self.state, extra={"step": step})
                self.log_fn(f"[preempt] checkpointed at step {step}; exiting")
                exit_reason = "preempted"
                break

        self.checkpoints.wait()
        if exit_reason == "completed" and (end % self.checkpoint_every) != 0:
            self.checkpoints.save(end, self.state, extra={"step": end})
        return {
            "final_step": step,
            "exit": exit_reason,
            "stragglers": list(self.monitor.flagged),
            "history": self.metrics_history,
        }
