"""What every run shares: the manifest and the files it names, the program's
configuration built from a configuration file, the reading of a profiler
trace, the per-layer metric readers, and the result line.

A run finds everything by name: the cell in ``BENCHMARK.json``, its
configuration in ``portbench/configs/<config>.json``, its traffic in
``portbench/traffic/<traffic>.json``, its limits in
``portbench/limits/<cell>.json`` and each per-layer metric's reader in
``portbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent  # the checkout
BENCH = ROOT / "portbench"
CACHE = BENCH / "_cache"  # build and kernel caches of the program, at fixed paths
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level modules a run must not load

__all__ = ["BENCH", "FORBIDDEN", "ROOT", "Run", "TraceSummary", "cell", "config", "forbidden_modules",
           "limits", "manifest", "port_model_config", "read_metrics", "set_cache_dirs", "summarize",
           "traffic"]


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _entry(items: List[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(name: str) -> dict:
    return _entry(manifest()["workloads"], name, "workload")


def config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def limits(cell_name: str) -> Dict[str, dict]:
    path = BENCH / "limits" / f"{cell_name}.json"
    return json.loads(path.read_text())["limits"] if path.exists() else {}


def set_cache_dirs() -> None:
    """Point every build and kernel cache a library may use at fixed
    directories inside the checkout (the program's own nvcc builds go to
    its ``kernels/_build/``, also inside it)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that a run may not hold, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# The program's configuration, from a configuration file
# ---------------------------------------------------------------------------

def port_model_config(c: dict):
    """The program's `ModelConfig` for configuration file ``c``: its
    architecture's (``arch``), with the keys ``c`` lists in ``reduced``
    taken from ``c``; every other key of the file that names a field of
    `ModelConfig` (a nested group as a dict) must then equal the program's."""
    from repro_torch.configs import get

    model = get(c["arch"]).model

    def value(k):  # a nested group is a dataclass in the program
        now = getattr(model, k)
        return type(now)(**c[k]) if dataclasses.is_dataclass(now) else c[k]

    model = model.replace(**{k: value(k) for k in c["reduced"]})
    fields = {f.name for f in dataclasses.fields(model)} - {"name"}
    want = {k: c[k] for k in c if k in fields}
    got = {k: getattr(model, k) for k in want}
    got = {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v for k, v in got.items()}
    if got != want:
        bad = {k: (want[k], got[k]) for k in want if got[k] != want[k]}
        raise ValueError(f"{c['name']}: the program's {c['arch']} differs from the file: {bad}")
    if c["norm_eps"] != 1e-6:  # the program's RMSNorm epsilon (models/layers.py)
        raise ValueError(f"{c['name']}: the program's RMSNorm epsilon is 1e-6")
    return model


# ---------------------------------------------------------------------------
# One run's state, as the per-layer readers see it
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TraceSummary:
    """What a traced window shows: its length and the device's busy time
    (seconds), the device kernels and copies launched, the device time of
    each kernel by name and under each named profiler range, and the
    longest idle gaps by the host op that was running when they began."""

    window_s: float
    busy_s: float
    launches: int
    kernels_s: Dict[str, float]
    ranges_s: Dict[str, float]
    idle_gaps: List[list]

    def kernel_s(self, names) -> float:
        return sum(s for k, s in self.kernels_s.items() if any(n in k for n in names))

    def top(self, n: int = 10) -> List[list]:
        return [[k, s] for k, s in sorted(self.kernels_s.items(), key=lambda kv: -kv[1])[:n]]


@dataclasses.dataclass
class Run:
    """A run as the per-layer readers see it: the configuration and traffic
    files, the unprofiled window's readings, and the traced window's."""

    config: dict
    traffic: dict
    window: Dict[str, Any]  # the unprofiled window: steps or requests, their times
    trace: Optional[TraceSummary] = None
    traced: Dict[str, Any] = dataclasses.field(default_factory=dict)  # units, launches


def summarize(prof, window_s: float) -> TraceSummary:
    """Read a `torch.profiler` run from its raw events (as `chip_smoke.py`'s
    ``profile_summary`` does: `key_averages()` builds a Python object per
    event, tens of seconds for 10^5 kernels)."""
    from torch.autograd import DeviceType

    kernels: Dict[str, float] = {}
    ranges: Dict[str, float] = {}
    spans, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            s = e.duration_ns() / 1e9
            if e.is_user_annotation():
                ranges[name] = ranges.get(name, 0.0) + s
                continue
            kernels[name[:80]] = kernels.get(name[:80], 0.0) + s
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith("aten::") or name.startswith("portbench."):
            host.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    busy = sum(kernels.values())
    return TraceSummary(window_s=window_s, busy_s=busy, launches=len(spans), kernels_s=kernels,
                        ranges_s=ranges, idle_gaps=_idle_gaps(spans, host))


def _idle_gaps(spans, host, n: int = 10) -> List[list]:
    """The device's idle gaps between its first and last kernel, summed by
    the innermost host op running when each began (gaps under 20 us
    together): [[op, seconds]], the longest first."""
    import bisect

    spans.sort()
    host.sort()
    starts = [h[0] for h in host]
    by: Dict[str, float] = {}
    end = None
    for a, b in spans:
        if end is not None and a > end:
            label = "(gaps under 20 us)"
            if a - end >= 20_000:
                i = bisect.bisect_right(starts, end)
                live = [h for h in host[max(0, i - 300):i] if h[1] >= end]
                label = min(live, key=lambda h: h[1] - h[0])[2] if live else "(no host op)"
            by[label] = by.get(label, 0.0) + (a - end) / 1e9
        end = b if end is None else max(end, b)
    return [[k, s] for k, s in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def read_metrics(names: List[str], run: Run) -> Dict[str, float]:
    """Each per-layer metric's value from its reader
    (``portbench/metrics/<name>.py``, ``read(run) -> float or None``); a
    reader that finds nothing to read leaves its metric out."""
    out = {}
    if str(BENCH / "metrics") not in sys.path:  # the readers share metrics/_shared.py
        sys.path.insert(0, str(BENCH / "metrics"))
    for name in names:
        path = BENCH / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(run)
        if value is not None:
            out[name] = float(value)
    return out
