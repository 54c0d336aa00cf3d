"""The readings a cell's limits are set from, on the card at the cell's size.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 [--seconds 8] [--out DIR]

In one process (the kernels built once): for each of ``--seeds`` seeds a
sound run of the program (set-up, a short window at the cell's load, the
check's numbers against the reference; `run.measure`), then for the first
``--control-seeds`` seeds the control (the reference with its products in
float8, `common.Precision(fp8=True)`, put in the program's place) and the
faults the cell can have, each read by the same numbers against the
reference.  Prints one JSON line per reading and writes them all to
``--out/calibrate-<cell>.json``.  The lower reading of a number is the
largest a sound run gives; the upper the smallest the control or a fault
gives (see PERF.md for the limits set from them).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import check, harness  # noqa: E402

SEED0 = 3_000_000_000  # the calibration's seeds: SEED0 + i, above 2**31


def train_faults(cell, c, tr, seed, dev):
    from portbench.drivers.train import ReferenceRun

    ref = ReferenceRun(c, tr, seed, dev).result()
    ctl = ReferenceRun(c, tr, seed, dev, fp8=True).result()
    half = ReferenceRun(c, tr, seed, dev, rows=tr["rows"] // 2).result()
    print(json.dumps({"seed": seed, "control_detail": check.train_detail(ctl, ref),
                      "half_batch_detail": check.train_detail(half, ref)}), flush=True)
    out = {"control": check.train_numbers(ctl, ref), "half_batch": check.train_numbers(half, ref)}
    unchanged = dict(ref, change={n: 0.0 for n in ref["change"]})
    out["state_unchanged"] = check.train_numbers(unchanged, ref)
    return out


def prefill_faults(cell, c, tr, seed, dev):
    import torch

    from portbench import reference
    from portbench.drivers.prefill import ReferenceRun, kept_batches

    states = reference.family(c).STATE_NUMBERS
    ref = ReferenceRun(c, tr, seed, dev)
    ctl = ReferenceRun(c, tr, seed, dev, fp8=True, params=ref.p)
    control, altered = [], []
    for i in kept_batches(seed, tr):
        r = ref.outputs(i)
        k = ctl.outputs(i)
        k["tokens"] = k["logits"].argmax(-1)
        control.append(check.prefill_numbers(k, r, states))
        bad = dict(r, tokens=(r["logits"].argmax(-1) + 1) % r["logits"].shape[-1])
        altered.append(check.prefill_numbers(bad, r, states))
        del r, k
        torch.cuda.empty_cache()
    # every kept batch is read here, as in a run that served them all
    return {kind: dict(check.worst(rows), kept_unserved=0.0)
            for kind, rows in (("control", control), ("token_altered", altered))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "portbench"))
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    from portbench.run import Context, measure

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    cell = harness.cell(args.workload)
    readings = []
    for i in range(args.seeds):
        seed = SEED0 + i
        t0 = time.perf_counter()
        ctx = Context(cell, seed, args.seconds, False, t0=t0)
        out = measure(ctx)
        rec = {"seed": seed, "kind": "sound", "numbers": out["numbers"],
               "detail": out.get("detail"),
               "setup_s": out["setup_s"], "reference_s": out["reference_s"],
               "peak": out["memory_peak_bytes"], "wall_s": time.perf_counter() - t0}
        readings.append(rec)
        print(json.dumps(rec), flush=True)
        del out
        ctx.free()
    faults = train_faults if ctx.traffic["kind"] == "train" else prefill_faults
    for i in range(args.control_seeds):
        seed = SEED0 + i
        t0 = time.perf_counter()
        for kind, numbers in faults(cell, ctx.config, ctx.traffic, seed, "cuda").items():
            rec = {"seed": seed, "kind": kind, "numbers": numbers}
            readings.append(rec)
            print(json.dumps(rec), flush=True)
        print(json.dumps({"seed": seed, "faults_s": time.perf_counter() - t0}), flush=True)
        ctx.free()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"calibrate-{args.workload}.json").write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
