"""The prefill traffic: a closed loop of request batches through the
program's serving loop (`repro_torch.runtime.decode_loop.ServeLoop.generate`
over `Model.prefill`), each request answered with its first token.

The buckets (batch, prompt length) come in cycles, each cycle every bucket
once in an order drawn from (seed, cycle), and the window serves whole
cycles until ``--seconds`` have passed, so every seed sends the same mix;
a batch's Zipf prompts are drawn from (seed, batch).  A batch's cache
holds exactly its prompts (``max_len`` = prompt length).  Set-up serves one
batch of each bucket.  A request's time to first token runs from its
batch's start to the first token on the host.

The check: ``checked_per_bucket`` batches of each bucket among the first
cycles, drawn from the seed, keep what the timed path produced for them:
their last-position logits, served tokens and the states the prefill wrote
to the cache (the family's ``CACHE_KEYS``).  Each kept batch's outputs go
to the host once its first tokens are there, so that the card holds no
more than a deployment would; the window's clock stops for that copy,
which is the check's and not the program's.  Once the window has closed and
the program is gone, the reference (`portbench/reference/<family>.py`)
runs the same prompts on the same weights and the two are compared.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from portbench import check, reference, tokens, weights
from portbench.harness import Run, port_model_config, summarize

__all__ = ["ReferenceRun", "kept_batches", "plan", "prompts", "run"]

RANGE_BATCH = "portbench.prefill_batch"
_CHECK_CYCLES = 4  # the kept batches come from the first cycles


def plan(seed: int, tr: dict, i: int) -> tuple:
    """The bucket (batch, prompt length) of batch ``i``."""
    n = len(tr["buckets"])
    order = tokens.rng_for(seed, 2, i // n).permutation(n)
    return tuple(tr["buckets"][order[i % n]])


def prompts(seed: int, tr: dict, i: int, vocab: int) -> np.ndarray:
    b, t = plan(seed, tr, i)
    return tokens.zipf_tokens(tokens.rng_for(seed, 3, i), (b, t), min(vocab, tr["vocab_cap"]),
                              tr["zipf_alpha"])


def kept_batches(seed: int, tr: dict) -> List[int]:
    """``checked_per_bucket`` batches of each bucket among the first
    `_CHECK_CYCLES` cycles, drawn from the seed."""
    n = len(tr["buckets"])
    rng = tokens.rng_for(seed, 5)
    kept = []
    for bucket in tr["buckets"]:
        idx = [i for i in range(_CHECK_CYCLES * n) if plan(seed, tr, i) == tuple(bucket)]
        kept += sorted(rng.choice(idx, size=tr["checked_per_bucket"], replace=False).tolist())
    return sorted(kept)


def run(ctx) -> Dict[str, Any]:
    from repro_torch.models.model import Model
    from repro_torch.runtime.decode_loop import ServeLoop
    from repro_torch.runtime.steps import make_serve_steps

    c, tr, seed, dev = ctx.config, ctx.traffic, ctx.seed, ctx.device
    cfg = port_model_config(c)
    ctx.mark("imports")
    model = Model(cfg, params=weights.nest(weights.draw(c, seed, dev, served=True)), device=dev)
    model.cast_weights_()
    ctx.sync()
    ctx.mark("weights")
    prefill_step, decode_step = make_serve_steps(model)
    family = reference.family(c)
    keep = set(kept_batches(seed, tr))
    kept: Dict[int, dict] = {}
    now = {"batch": None}

    def prefill_kept(params, batch, cache):
        logits, cache = prefill_step(params, batch, cache)
        if now["batch"] in keep:
            kept[now["batch"]] = {"logits": logits[:, -1],
                                  **{k: cache[key] for k, key in family.CACHE_KEYS.items()}}
        return logits, cache

    params = model.params_tree()
    loops = {tuple(b): ServeLoop(prefill_kept, decode_step, params,
                                 init_cache=lambda b=b: model.init_cache(b[0], b[1]))
             for b in tr["buckets"]}

    def serve(i: int, ids: np.ndarray) -> np.ndarray:
        now["batch"] = i
        got = loops[tuple(ids.shape)].generate({"tokens": ids}, tr["new_tokens"])["tokens"]
        return got[:, 0]

    # -- set-up: one batch of each bucket --------------------------------------
    for j, (b, t) in enumerate(tr["buckets"]):
        ids = tokens.zipf_tokens(tokens.rng_for(seed, 4, j), (b, t),
                                 min(c["vocab_size"], tr["vocab_cap"]), tr["zipf_alpha"])
        serve(-1, ids)
        ctx.mark(f"warm-up {b} x {t}")
    ctx.sync()
    setup_s = ctx.clock() - ctx.t0

    # -- the window: a closed loop of whole cycles -------------------------------
    ttft: List[float] = []
    served: Dict[int, np.ndarray] = {}
    shapes: List[tuple] = []
    done_tokens = 0
    i = 0
    cycle = len(tr["buckets"])
    stopped = 0.0  # seconds the clock stood still for the check's copies
    t_open = ctx.clock()
    while ctx.clock() - t_open - stopped < ctx.seconds or i % cycle:
        ids = prompts(seed, tr, i, c["vocab_size"])
        t0 = ctx.clock()
        first = serve(i, ids)
        t1 = ctx.clock()
        ttft += [t1 - t0] * ids.shape[0]
        if i in keep:
            served[i] = first
            kept[i] = {k: v.cpu() for k, v in kept[i].items()}
            stopped += ctx.clock() - t1
        done_tokens += ids.size
        shapes.append(ids.shape)
        i += 1
    window_s = ctx.clock() - t_open - stopped
    ctx.mark(f"window closed; its clock stood still {stopped:.3f} s for the check's copies")
    ttft_ms = np.asarray(ttft) * 1e3
    window = {"ttft_ms": ttft_ms.tolist(), "shapes": shapes, "window_s": window_s}
    out: Dict[str, Any] = {
        "setup_s": setup_s, "attempted": len(ttft), "failed": 0,
        "prefill_tokens_per_s": done_tokens / window_s,
        "ttft_p95_ms": float(np.percentile(ttft_ms, 95))}

    # -- one traced cycle, after the window ------------------------------------
    run_ = Run(config=c, traffic=tr, window=window)
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        counters = ctx.counters()
        before = counters.read()
        traced = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = ctx.clock()
            for _ in range(tr["profiled_cycles"] * len(tr["buckets"])):
                ids = prompts(seed, tr, i, c["vocab_size"])
                with record_function(RANGE_BATCH):
                    serve(i, ids)
                traced.append(ids.shape)
                i += 1
            traced_s = ctx.clock() - t0
        run_.trace = summarize(prof, traced_s)
        run_.traced = {"batches": traced, "launches": counters.since(before)}
        del prof
    out["run"] = run_
    out["memory_peak_bytes"] = ctx.memory_peak()

    # -- the check, once the program is gone ------------------------------------
    missing = keep - set(served)
    got = {i: dict(kept[i], tokens=served[i]) for i in sorted(set(served))}
    del loops, params, model, kept, prefill_step, decode_step
    ctx.free()
    t0 = ctx.clock()
    ref = ReferenceRun(c, tr, seed, dev)
    per_batch = [check.prefill_numbers(got[i], ref.outputs(i), family.STATE_NUMBERS)
                 for i in sorted(got)]
    out["numbers"] = check.worst(per_batch) if per_batch else {}
    out["numbers"]["kept_unserved"] = float(len(missing))  # a kept batch the window never reached
    out["reference_s"] = ctx.clock() - t0
    return out


class ReferenceRun:
    """The reference's forward over a batch's prompts on the run's weights
    (drawn again from the seed, or ``params``); ``fp8`` lowers its products
    (the control)."""

    def __init__(self, c: dict, tr: dict, seed: int, device, *, fp8: bool = False,
                 params: Dict[str, torch.Tensor] = None):
        from portbench.reference import common

        common.f32_only()
        self.c, self.tr, self.seed, self.device = c, tr, seed, device
        self.prec = common.Precision(fp8=fp8)
        # the served weights, each read in float32 where the reference uses it
        self.p = params if params is not None else weights.draw(c, seed, device, served=True)

    def outputs(self, i: int) -> Dict[str, torch.Tensor]:
        ids = torch.as_tensor(prompts(self.seed, self.tr, i, self.c["vocab_size"]),
                              device=self.device)
        return reference.family(self.c).prefill(self.p, self.c, ids, self.prec)
