"""Run one cell of the benchmark of `repro_torch` on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration (``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<mix>.json``), whose ``kind`` selects the driver
(``portbench/drivers/<kind>.py``).  The run sets up, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints as its last line one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared, with its limit.

It exits non-zero and prints no result without enough CUDA cards, without
the program, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import check, harness  # noqa: E402


class Counters:
    """The program's kernel launch counters (K2's)."""

    def read(self) -> dict:
        from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

        return {"k2": flash_attention_cuda.launches}

    def since(self, before: dict) -> dict:
        now = self.read()
        return {k: now[k] - before[k] for k in now}


class Context:
    """One run: its cell, files, seed and window, and the device's clock,
    synchronise and memory."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
                 config: dict = None, traffic: dict = None, t0: float = None):
        import torch

        self.torch = torch
        self.cell, self.seed, self.seconds, self.trace, self.device = (
            cell, seed, seconds, trace, device)
        self.config = config or harness.config(cell["config"])
        self.traffic = traffic or harness.traffic(cell["traffic"])
        self.t0 = T_START if t0 is None else t0
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()

    clock = staticmethod(time.perf_counter)

    def mark(self, what: str) -> None:
        """Print the seconds since the process began, for set-up's breakdown."""
        print(f"portbench: {self.clock() - self.t0:.2f} s {what}", file=sys.stderr)

    def sync(self) -> None:
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    def memory_peak(self) -> int:
        return int(self.torch.cuda.max_memory_allocated()) if self.device != "cpu" else 0

    def free(self) -> None:
        gc.collect()
        if self.device != "cpu":
            self.torch.cuda.empty_cache()

    def counters(self) -> Counters:
        return Counters()


def measure(ctx: Context) -> dict:
    """Run the cell's driver and judge its numbers: the driver's outcome,
    with ``correct`` and ``checks``."""
    driver = importlib.import_module(f"portbench.drivers.{ctx.traffic['kind']}")
    out = driver.run(ctx)
    out["correct"], out["checks"] = check.judge(out["numbers"], harness.limits(ctx.cell["name"]))
    return out


def result_line(cell: dict, out: dict, trace: bool, device: dict) -> dict:
    """The last line: the cell's end-to-end metrics (``--trace 0``) or its
    per-layer ones (``--trace 1``), then ``checks`` last."""
    m = harness.manifest()
    applies = lambda metric: cell["name"] in metric.get("workloads", [cell["name"]])
    if trace:
        run = out["run"]
        names = [x["name"] for x in m["per_layer"] if applies(x)]
        units = {x["name"]: x["unit"] for x in m["per_layer"]}
        values = harness.read_metrics(names, run)
        device = dict(device, busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    else:
        units = {x["name"]: x["unit"] for x in m["end_to_end"]}
        values = {x["name"]: out[x["name"]] for x in m["end_to_end"] if applies(x)}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"], "failed": out["failed"],
            "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
            "device": device}
    if trace:
        line["breakdown"] = {"device_ops": out["run"].trace.top(10),
                             "idle_gaps": out["run"].trace.idle_gaps[:10]}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()}
    return line


def card_line() -> str:
    try:
        got = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        return got.stdout.strip().splitlines()[0] if got.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired, IndexError) as err:
        return f"nvidia-smi unavailable: {err}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    cell = harness.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace))
    out = measure(ctx)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; it may load neither JAX nor the JAX package",
              file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = result_line(cell, out, bool(args.trace), device)
    print(f"portbench: card {card_line()}; reference {out['reference_s']:.1f} s; "
          f"window units {out['attempted']}", file=sys.stderr)
    if "detail" in out:
        print(f"portbench: widest gaps {json.dumps(out['detail'])}", file=sys.stderr)
    for name, value in out["numbers"].items():
        if name not in line["checks"]:
            print(f"read, not compared, {name}: {value!r}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
