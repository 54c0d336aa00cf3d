"""The training traffic: the program's training step
(`repro_torch.runtime.steps.make_train_step`) on fresh Zipf batches of
``rows`` x ``seq_len`` tokens, one a step, drawn from (seed, step).

Set-up builds the model from the run's weights and the step with its
AdamW state, and drives it through its first ``checked_steps`` steps, the
rows of each batch all different; those steps compile and warm up what the
window runs, and give what the check compares: each step's loss and the
norm of each leaf's change over those steps.  The window then runs whole steps, each ending in a synchronise,
until ``--seconds`` have passed.  Once it has closed and the program is
gone, the reference (`portbench/reference/<family>.py`) trains the same
weights on the same batches and the two are compared.
"""

from __future__ import annotations

import gc
from typing import Any, Dict, List

import torch

from portbench import check, tokens, weights
from portbench.harness import Run, port_model_config, summarize

__all__ = ["ReferenceRun", "batch_tokens", "leaf_norms", "named_leaves", "run"]

RANGE_STEP = "portbench.train_step"


def named_leaves(tree: Any, prefix: str = ""):
    """(dotted name, tensor) of a parameter-shaped tree, as `weights.layout` names them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@torch.no_grad()
def leaf_norms(pairs) -> Dict[str, float]:
    """{name: float32 norm} of (name, tensor) pairs, read to the host at once."""
    pairs = list(pairs)
    norms = torch.stack([torch.linalg.vector_norm(t.float()) for _, t in pairs]).cpu()
    return {n: float(v) for (n, _), v in zip(pairs, norms)}


def batch_tokens(seed: int, step: int, tr: dict, vocab: int, device) -> torch.Tensor:
    rng = tokens.rng_for(seed, 1, step)
    ids = tokens.zipf_tokens(rng, (tr["rows"], tr["seq_len"]), min(vocab, tr["vocab_cap"]),
                             tr["zipf_alpha"])
    return torch.as_tensor(ids, device=device)


@torch.no_grad()
def _change_norms(c: dict, seed: int, device, params: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{name: norm of params[name] - its initial value}, the initial values
    drawn again from the seed one at a time."""
    out = {}
    for name, p0 in weights.iter_draw(c, seed, device, served=False):
        out[name] = torch.linalg.vector_norm(params[name].float() - p0)
        del p0
    return {n: float(v) for n, v in zip(out, torch.stack(list(out.values())).cpu())}


def run(ctx) -> Dict[str, Any]:
    from repro_torch.configs import get as get_arch
    from repro_torch.models.model import Model
    from repro_torch.runtime import steps as port_steps

    c, tr, seed, dev = ctx.config, ctx.traffic, ctx.seed, ctx.device
    opt = tr["optimizer"]
    cfg = port_model_config(c)
    ex = get_arch(c["arch"]).exec.replace(
        optimizer="adamw", num_microbatches=tr["microbatches"],
        learning_rate=opt["learning_rate"], weight_decay=opt["weight_decay"],
        warmup_steps=opt["warmup_steps"], total_steps=opt["total_steps"],
        grad_clip=opt["grad_clip"], bf16_grad_reduce=opt["bf16_grad_reduce"])
    ctx.mark("imports")
    model = Model(cfg, params=weights.nest(weights.draw(c, seed, dev, served=False)), device=dev)
    state = port_steps.init_train_state(model, ex)
    ctx.sync()
    ctx.mark("weights and optimizer state")
    step_fn = port_steps.make_train_step(model, ex)
    batch = lambda s: {"tokens": batch_tokens(seed, s, tr, c["vocab_size"], dev)}

    # -- set-up: the first steps, which the check follows ---------------------
    losses = []
    for s in range(tr["checked_steps"]):
        state, metrics = step_fn(state, batch(s))
        losses.append(float(metrics["loss"]))
        ctx.mark(f"checked step {s + 1}")
    change = _change_norms(c, seed, dev, dict(named_leaves(state["params"])))
    ctx.sync()
    setup_s = ctx.clock() - ctx.t0

    # -- the window ------------------------------------------------------------
    times: List[float] = []
    step = tr["checked_steps"]
    t_open = ctx.clock()
    while ctx.clock() - t_open < ctx.seconds:
        t0 = ctx.clock()
        state, metrics = step_fn(state, batch(step))
        ctx.sync()
        times.append(ctx.clock() - t0)
        step += 1
    rows_tokens = tr["rows"] * tr["seq_len"]
    window = {"step_s": times}
    out: Dict[str, Any] = {"setup_s": setup_s, "attempted": len(times), "failed": 0,
                           "train_tokens_per_s": rows_tokens * len(times) / sum(times)}

    # -- the traced steps, after the window ------------------------------------
    run_ = Run(config=c, traffic=tr, window=window)
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        counters = ctx.counters()
        before = counters.read()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = ctx.clock()
            for _ in range(tr["profiled_steps"]):
                with record_function(RANGE_STEP):
                    state, metrics = step_fn(state, batch(step))
                    ctx.sync()
                step += 1
            traced_s = ctx.clock() - t0
        run_.trace = summarize(prof, traced_s)
        run_.traced = {"steps": tr["profiled_steps"], "launches": counters.since(before)}
        del prof
    out["run"] = run_
    out["memory_peak_bytes"] = ctx.memory_peak()

    # -- the check, once the program is gone ------------------------------------
    del state, step_fn, model, metrics
    ctx.free()
    got = {"losses": losses, "change": change}
    t0 = ctx.clock()
    ref = ReferenceRun(c, tr, seed, dev).result()
    out["numbers"] = check.train_numbers(got, ref)
    out["detail"] = check.train_detail(got, ref)
    out["reference_s"] = ctx.clock() - t0
    return out


class ReferenceRun:
    """The reference's first steps on the run's weights and batches: its
    losses and change norms, the program's numbers' counterparts, and the
    norms of its first gradients (which leaves move).  ``fp8`` lowers its products (the control); ``rows`` keeps
    only the first rows of every batch (a fault: half the batch left out,
    the mean taken over the rest)."""

    def __init__(self, c: dict, tr: dict, seed: int, device, *, fp8: bool = False,
                 rows: int = None):
        self.c, self.tr, self.seed, self.device = c, tr, seed, device
        self.fp8, self.rows = fp8, rows

    def result(self) -> Dict[str, Any]:
        from portbench import reference
        from portbench.reference import common

        common.f32_only()
        c, tr = self.c, self.tr
        p = weights.draw(c, self.seed, self.device, served=False)
        batches = [batch_tokens(self.seed, s, tr, c["vocab_size"], self.device)
                   for s in range(tr["checked_steps"])]
        micro = tr["microbatches"]
        if self.rows is not None:
            batches = [b[:self.rows] for b in batches]
            micro = max(1, micro * self.rows // tr["rows"])
        first = {}

        def on_step(step, grads):
            if step == 1:
                first.update(leaf_norms(grads.items()))

        losses = common.train_steps(p, c, batches, tr["optimizer"], micro,
                                    common.Precision(fp8=self.fp8),
                                    loss_fn=reference.family(c).microbatch_loss, on_step=on_step)
        change = _change_norms(c, self.seed, self.device, p)
        del p
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()
        return {"losses": losses, "first_grad": first, "change": change}
