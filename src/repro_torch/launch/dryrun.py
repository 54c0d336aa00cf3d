"""Multi-pod dry-run: trace every (arch × shape × mesh) cell (port of
`repro/launch/dryrun.py`).

This is how the distribution config is proven coherent without the
cards: `build_cell(...).lower(mesh)` must run the step on the single-pod
(16, 16) mesh AND the 2-pod (2, 16, 16) mesh for every assigned
architecture × input-shape cell.  The step runs once as rank 0 of a fake
world of 256 or 512 ranks (`launch.mesh.fake_world`), on DTensors whose
shards live on the ``meta`` device, so nothing is allocated; the mesh
describes the card (``--device``, the card by default, without touching
it), and the trace takes the card's kernel routes (`launch.build`).  For
each cell the trace's memory (bytes per device, `StepMemory`) and the
counted cost terms (flops, collective bytes, HBM traffic; see
`launch.hlo_analysis`) are written to a JSON artifact.

The artifact keeps the reference's keys, but for two: ``fits_16g``
(the v5e's HBM) is ``fits_80g``, against the card's 80 GB; and
``xla_cost_analysis`` (XLA's own count, which sees each scan body once) has
no counterpart, as no compiler runs, and is left out.  ``replicated_at``
lists the ops that ran replicated for want of a sharding strategy, with the
bytes each gathered to one device (`parallel.spmd`).  On the multi-pod mesh
a cell whose specs name "pod" and "data" together traces with the two
merged into one mesh dimension of 32 (`launch.build`), which lays out every
tensor as the 3-D mesh does; ``mesh_flattened`` records it, and
``trace_s`` the wall seconds of the step's run.  The default output
directory is ``artifacts/dryrun_torch``, beside the reference's.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # full sweep
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --cell train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi_pod --skip-existing

Each cell runs in a subprocess so one failure cannot take down the sweep;
failures are recorded in the artifact with the exception text.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Optional, Sequence

from repro_torch.launch.autotune import HBM_PER_CHIP

__all__ = ["main", "run_cell"]


def run_cell(arch: str, cell_name: str, mesh_kind: str, device: Optional[str] = None) -> dict:
    """Trace one cell in-process; returns the artifact dict."""
    import repro_torch.configs as C
    from repro_torch.launch.build import build_cell
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.models.model import active_params, total_params

    spec = C.get(arch)
    cell = C.CELLS[cell_name]
    ok, reason = C.cell_applicable(spec.model, cell)
    if not ok:
        return {"status": "skipped", "reason": reason}

    multi = mesh_kind == "multi_pod"
    fake_world(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device=device, abstract=True)
    chips = mesh.size()

    t0 = time.time()
    built = build_cell(spec, cell, mesh)
    lowered = built.lower(mesh)
    t_lower = time.time() - t0
    compiled = lowered.compile()
    t_compile = time.time() - t0 - t_lower

    ma = compiled.memory_analysis()
    peak = (
        ma.argument_size_in_bytes
        + ma.output_size_in_bytes
        - ma.alias_size_in_bytes
        + ma.temp_size_in_bytes
    )
    cost = compiled.cost_analysis()

    return {
        "status": "ok",
        "arch": arch,
        "cell": cell_name,
        "mesh": mesh_kind,
        "chips": chips,
        "kind": built.kind,
        "mesh_flattened": built.mesh_flattened,
        "trace_s": round(lowered.seconds, 2),
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "memory": {
            "argument_bytes": ma.argument_size_in_bytes,
            "output_bytes": ma.output_size_in_bytes,
            "alias_bytes": ma.alias_size_in_bytes,
            "temp_bytes": ma.temp_size_in_bytes,
            "peak_bytes_per_device": int(peak),
            "fits_80g": bool(peak <= HBM_PER_CHIP),
        },
        "hlo_cost": {
            "flops_per_device": cost.flops,
            "collective_bytes_per_device": cost.collective_bytes,
            "hbm_bytes_per_device": cost.hbm_bytes,
            "collective_breakdown": cost.collective_breakdown,
        },
        "kernel_calls": compiled.kernel_calls,
        "replicated_at": compiled.replicated,
        "model": {
            "total_params": total_params(spec.model),
            "active_params": active_params(spec.model),
            "tokens": cell.tokens if built.kind == "train" else cell.global_batch,
        },
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "single_pod", "multi_pod"])
    ap.add_argument("--device", default=None,
                    help="the device the trace describes: cuda (default) or cpu")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--single", action="store_true",
                    help="run one cell in-process and print JSON (internal)")
    args = ap.parse_args(argv)

    if args.single:
        try:
            art = run_cell(args.arch, args.cell, args.mesh, args.device)
        except Exception:
            art = {"status": "failed", "error": traceback.format_exc()[-2000:]}
        print("JSON_ARTIFACT:" + json.dumps(art))
        return

    import repro_torch.configs as C

    archs = [args.arch] if args.arch else C.ARCHS
    cells = [args.cell] if args.cell else list(C.CELLS)
    meshes = [args.mesh] if args.mesh else ["single_pod", "multi_pod"]
    os.makedirs(args.out, exist_ok=True)
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}

    failures = []
    for arch in archs:
        for cell in cells:
            for mesh in meshes:
                path = os.path.join(args.out, f"{arch}__{cell}__{mesh}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {path}")
                    continue
                t0 = time.time()
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--single",
                       "--arch", arch, "--cell", cell, "--mesh", mesh]
                if args.device:
                    cmd += ["--device", args.device]
                proc = subprocess.run(cmd, capture_output=True, text=True, env=env)
                art = None
                for line in proc.stdout.splitlines():
                    if line.startswith("JSON_ARTIFACT:"):
                        art = json.loads(line[len("JSON_ARTIFACT:"):])
                if art is None:
                    art = {"status": "failed",
                           "error": (proc.stderr or proc.stdout)[-2000:]}
                art.setdefault("arch", arch)
                art.setdefault("cell", cell)
                art.setdefault("mesh", mesh)
                art["wall_s"] = round(time.time() - t0, 2)
                with open(path, "w") as f:
                    json.dump(art, f, indent=1)
                status = art["status"]
                extra = ""
                if status == "ok":
                    gib = art["memory"]["peak_bytes_per_device"] / 2**30
                    extra = (f" peak={gib:.2f}GiB trace={art['lower_s']}s"
                             f"{' flattened' if art['mesh_flattened'] else ''}")
                elif status == "skipped":
                    extra = f" ({art['reason'][:50]})"
                else:
                    failures.append((arch, cell, mesh))
                print(f"[{status}] {arch} × {cell} × {mesh}"
                      f" ({time.time()-t0:.0f}s){extra}", flush=True)

    if failures:
        print(f"\nFAILED cells ({len(failures)}):")
        for f_ in failures:
            print("  ", *f_)
        sys.exit(1)
    print("\nAll dry-run cells passed.")


if __name__ == "__main__":
    main()
