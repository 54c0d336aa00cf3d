"""Ruya for the card: memory-aware iterative search over execution
configurations (port of `repro/launch/autotune.py`).

This is the paper's algorithm (`repro_torch.core`) applied beyond its
original domain: the "cluster configuration" becomes an *execution
configuration* (microbatch count × remat policy × FSDP on/off × activation
sequence sharding), the "job" is one (architecture × shape cell) on the
production mesh, and a *trial* is a dry-run of the step
(`launch.build`: one execution on meta shards as rank 0 of the mesh) whose
roofline step-time estimate (max of the compute, memory and collective
terms of `launch.hlo_analysis`) is the cost.  On real cards each trial
would be a short profiled run at scale — expensive — which is exactly the
economics the paper's search-iteration reduction targets.

The mapping of the paper's phases:

  1. *Profiling on reduced hardware* → trace the SAME model at reduced
     global batches and read the trace's peak bytes per device; fit the
     §III-C OLS memory model of peak bytes vs tokens per device per
     (remat, FSDP, sequence sharding).
  2. *Categorization* → activations make training cells LINEAR in tokens
     per device with a flat parameters+optimizer offset; decode cells come
     out FLAT.  Unclear readings fall back to plain BO (the paper's §III-D
     fallback).
  3. *Search-space split* → configurations whose predicted peak exceeds the
     card's 80 GB are deprioritized (the memory-bottleneck analogue: over
     HBM the penalty is OOM or remat, a hard cliff).
  4. *CherryPick BO with EI* → the port's engine (`core.bayesopt`, on the
     card unless ``device="cpu"``), cost = roofline seconds.

The environment is `TunerEnv`, the reference's `TpuTunerEnv`, and the
peaks are the card's (NVIDIA H100 80GB HBM3 (SXM), 700 W, spec sheet):
989e12 bf16 dense flop/s, 3.35e12 B/s of HBM, and 50e9 B/s for the
collectives, one 400 Gb/s NDR port per card (a 256-card mesh spans 32
nodes of 8; NVLink's 450e9 B/s holds only within a node).  The trials'
dry-runs describe the card; ``device`` is where the BO runs.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.autotune --arch granite-8b \\
      --cell train_4k [--budget 10] [--exhaustive] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import DeviceLike

__all__ = ["ExecVariant", "HBM_PER_CHIP", "PEAKS", "TunerEnv", "main", "predict_peaks",
           "run_autotune", "variant_space"]

HBM_PER_CHIP = 80 * 10**9  # NVIDIA H100 80GB HBM3 (SXM), spec sheet
PEAKS = {"flops": 989e12, "hbm": 3.35e12, "ici": 50e9}  # the same card, 700 W, spec sheet


@dataclasses.dataclass(frozen=True)
class ExecVariant:
    """One point of the execution-configuration search space."""

    num_microbatches: int
    remat: str  # none | dots | full
    fsdp: bool
    seq_shard: bool  # Megatron-style sequence parallelism on activations

    @property
    def name(self) -> str:
        return (f"micro{self.num_microbatches}-{self.remat}"
                f"{'-fsdp' if self.fsdp else ''}"
                f"{'-seqshard' if self.seq_shard else ''}")

    def features(self) -> Tuple[float, ...]:
        # CherryPick encodes configs "by their principal features".
        return (
            math.log2(self.num_microbatches),
            {"none": 0.0, "dots": 1.0, "full": 2.0}[self.remat],
            1.0 if self.fsdp else 0.0,
            1.0 if self.seq_shard else 0.0,
        )


def variant_space(cell_kind: str) -> List[ExecVariant]:
    if cell_kind != "train":
        # serving has no microbatch/remat axis; sweep sharding choices only
        return [
            ExecVariant(1, "none", fsdp, seq)
            for fsdp in (False, True)
            for seq in (False, True)
        ]
    out = []
    for micro in (1, 2, 4, 8, 16):
        for remat in ("none", "dots", "full"):
            for fsdp in (True, False):
                for seq in (False, True):
                    out.append(ExecVariant(micro, remat, fsdp, seq))
    return out


def _roofline_s(c) -> float:
    return max(c.flops / PEAKS["flops"], c.hbm_bytes / PEAKS["hbm"],
               c.collective_bytes / PEAKS["ici"])


class TunerEnv:
    """Profiling + trial execution against the dry-run machinery (the
    reference's `TpuTunerEnv`).  The trials trace on meshes that describe
    the card, as rank 0 of a fake world (`launch.mesh.fake_world`)."""

    def __init__(self, arch: str, cell_name: str, multi_pod: bool = False,
                 cache_path: Optional[str] = None) -> None:
        import repro_torch.configs as C
        from repro_torch.launch.mesh import fake_world, make_production_mesh

        self.C = C
        self.arch = arch
        self.spec = C.get(arch)
        self.cell = C.CELLS[cell_name]
        fake_world(512 if multi_pod else 256)
        self.mesh = make_production_mesh(multi_pod=multi_pod, abstract=True)
        self.chips = self.mesh.size()
        self.trial_cache: Dict[str, Dict] = {}
        self.cache_path = cache_path
        if cache_path and os.path.exists(cache_path):
            with open(cache_path) as f:
                self.trial_cache = json.load(f)

    # -- shared plumbing -----------------------------------------------------

    def _built(self, variant: ExecVariant, cell=None):
        from repro_torch.launch.build import build_cell, rules_for

        spec = dataclasses.replace(
            self.spec, model=self.spec.model.replace(remat_policy=variant.remat)
        )
        ex = spec.exec.replace(
            num_microbatches=variant.num_microbatches,
            remat=variant.remat,
            fsdp=variant.fsdp,
            seq_shard=variant.seq_shard,  # overrides the arch default
        )
        cell = cell or self.cell
        rules = rules_for(dataclasses.replace(spec, exec=ex), cell, self.mesh)
        return build_cell(spec, cell, self.mesh, rules=rules, exec_override=ex)

    def _compile_peak_and_cost(self, variant: ExecVariant, cell=None):
        built = self._built(variant, cell)
        compiled = built.lower(self.mesh).compile()
        ma = compiled.memory_analysis()
        peak = (ma.argument_size_in_bytes + ma.output_size_in_bytes
                - ma.alias_size_in_bytes + ma.temp_size_in_bytes)
        return peak, compiled.cost_analysis()

    # -- phase 1: profiling runs ----------------------------------------------

    def profile_run_fn(self, variant: ExecVariant):
        """(tokens-per-device) -> (chip_seconds_cost, peak_bytes).

        The Ruya profiler drives this with small sample sizes — here small
        global batches of the full model, the analogue of dataset samples on
        one machine."""

        def run(tokens_per_device: float) -> Tuple[float, float]:
            total = int(tokens_per_device) * self.chips
            seq = min(self.cell.seq_len, max(256, total))
            gb = max(1, total // seq)
            cell = self.C.ShapeCell("profile", seq, gb, self.cell.kind)
            peak, cost = self._compile_peak_and_cost(variant, cell)
            return _roofline_s(cost) * self.chips, float(peak)

        return run

    # -- phase 4: one search trial ---------------------------------------------

    def trial_cost_fn(self, space: List[ExecVariant]):
        def cost(idx: int) -> float:
            v = space[idx]
            if v.name not in self.trial_cache:
                try:
                    peak, c = self._compile_peak_and_cost(v)
                    step_s = _roofline_s(c)
                    # memory-bottleneck cliff: configs over HBM pay the
                    # remat/offload penalty (or are simply infeasible)
                    over = max(peak / HBM_PER_CHIP, 1.0)
                    penalty = 1.0 if over <= 1.0 else (2.0 + 4.0 * (over - 1.0))
                    self.trial_cache[v.name] = {
                        "peak_bytes": float(peak),
                        "roofline_s": float(step_s),
                        "cost_chip_s": float(step_s * penalty),
                        "terms": {
                            "compute": c.flops / PEAKS["flops"],
                            "memory": c.hbm_bytes / PEAKS["hbm"],
                            "collective": c.collective_bytes / PEAKS["ici"],
                        },
                    }
                except Exception as e:  # infeasible config = huge cost
                    self.trial_cache[v.name] = {
                        "error": str(e)[:200], "cost_chip_s": 1e9,
                    }
                if self.cache_path:
                    with open(self.cache_path, "w") as f:
                        json.dump(self.trial_cache, f, indent=1)
            return self.trial_cache[v.name]["cost_chip_s"]

        return cost

    def search_space(self):
        from repro_torch.core.search_space import Configuration, SearchSpace

        space = variant_space(self.cell.kind)
        # "total memory" of a config = HBM it leaves for the job: constant
        # per card — what varies is the REQUIREMENT, predicted per config by
        # the memory model.  Available memory is encoded so the §III-D split
        # can compare requirement vs availability per config.
        configs = [
            Configuration(
                name=v.name,
                features=v.features(),
                total_memory=float(HBM_PER_CHIP),
                num_nodes=self.chips,
                meta=v,
            )
            for v in space
        ]
        return space, SearchSpace(configs)


def predict_peaks(env: TunerEnv, space: List[ExecVariant]):
    """Paper phases 1–2 for every (remat, fsdp, seq) combination: profile
    peak-vs-tokens at reduced batches, extrapolate to the full cell.

    Returns {variant.name: predicted_peak_bytes} and the fitted models."""
    from repro_torch.core.memory_model import fit_memory_model

    cell = env.cell
    full_tokens_per_dev = cell.tokens / env.chips
    preds: Dict[str, float] = {}
    models = {}
    # Group variants: microbatching divides tokens-per-device per microbatch.
    base_keys = sorted({(v.remat, v.fsdp, v.seq_shard) for v in space})
    for remat, fsdp, seq in base_keys:
        probe = ExecVariant(1, remat, fsdp, seq)
        run = env.profile_run_fn(probe)
        fractions = (0.125, 0.25, 0.5)
        sizes, readings = [], []
        for frac in fractions:
            tpd = full_tokens_per_dev * frac
            _, peak = run(tpd)
            sizes.append(tpd)
            readings.append(peak)
        model = fit_memory_model(sizes, readings)
        models[(remat, fsdp, seq)] = model
        for v in space:
            if (v.remat, v.fsdp, v.seq_shard) != (remat, fsdp, seq):
                continue
            tpd = full_tokens_per_dev / v.num_microbatches
            if model.category.value == "linear":
                preds[v.name] = model.estimate(tpd)
            elif model.category.value == "flat":
                preds[v.name] = float(np.mean(readings))
            else:
                preds[v.name] = float("nan")
    return preds, models


def run_autotune(arch: str, cell: str, *, budget: int = 12,
                 multi_pod: bool = False, seed: int = 0,
                 cache_path: Optional[str] = None,
                 exhaustive: bool = False, device: DeviceLike = None) -> Dict:
    """The four phases for (``arch`` × ``cell``); the BO runs on ``device``
    (the card unless ``"cpu"``).  Returns the reference's result dict."""
    from repro_torch.core.bayesopt import BOSettings, ruya_search

    env = TunerEnv(arch, cell, multi_pod=multi_pod, cache_path=cache_path)
    space, sspace = env.search_space()

    print(f"[autotune] {arch} × {cell}: {len(space)} configurations")
    preds, models = predict_peaks(env, space)

    # §III-D split: prioritize configs predicted to fit the per-card HBM.
    prio, rest = [], []
    any_unclear = any(math.isnan(p) for p in preds.values())
    if any_unclear:
        prio = list(range(len(space)))  # fallback: plain BO
    else:
        for i, v in enumerate(space):
            (prio if preds[v.name] <= HBM_PER_CHIP * 1.05 else rest).append(i)
        if not prio:  # nothing fits → prioritize minimal-requirement extremes
            order = np.argsort([preds[v.name] for v in space])
            k = max(1, len(space) // 7)
            prio = sorted(int(i) for i in order[:k])
            rest = sorted(set(range(len(space))) - set(prio))
    print(f"[autotune] priority group: {len(prio)}/{len(space)} configs "
          f"predicted to fit {HBM_PER_CHIP/1e9:.0f} GB/card")

    cost_fn = env.trial_cost_fn(space)
    settings = BOSettings(max_iters=None if exhaustive else budget,
                          min_observations=min(6, len(prio)))
    trace = ruya_search(
        sspace, cost_fn, np.random.default_rng(seed), prio, rest,
        settings=settings, to_exhaustion=exhaustive, device=device,
    )
    best = space[trace.best_index]
    result = {
        "arch": arch,
        "cell": cell,
        "trials": len(trace.tried),
        "best": best.name,
        "best_cost_chip_s": trace.best_cost,
        "tried": [space[i].name for i in trace.tried],
        "costs": trace.costs,
        "priority_size": len(prio),
        # the trace's own fields, for holding two runs' traces to each other
        "tried_index": [int(i) for i in trace.tried],
        "priority": [int(i) for i in prio],
        "stop_iteration": trace.stop_iteration,
        "phase_boundary": trace.phase_boundary,
        "predicted_peaks_gib": {k: v / 2**30 for k, v in preds.items()},
        "trial_details": {space[i].name: env.trial_cache.get(space[i].name)
                          for i in trace.tried},
    }
    print(f"[autotune] best: {best.name} "
          f"(roofline {trace.best_cost:.2f} chip-s/step) "
          f"after {len(trace.tried)} trials")
    return result


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", default="train_4k")
    ap.add_argument("--budget", type=int, default=12)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache", default=None)
    ap.add_argument("--exhaustive", action="store_true")
    ap.add_argument("--device", default=None, help="where the BO runs: cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    result = run_autotune(
        args.arch, args.cell, budget=args.budget, multi_pod=args.multi_pod,
        seed=args.seed, cache_path=args.cache, exhaustive=args.exhaustive,
        device=args.device,
    )
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
