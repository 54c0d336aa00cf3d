"""A run driven to its end on the CPU, the card's look skipped, with the
timed path broken underneath: ``correct`` comes out false against the
cell's limits, once for each fault a one-chip cell can have (a step that
returns its state unchanged; half the batch left out, the mean taken over
the rest; a token altered where it is produced)."""

import time

import pytest
import torch
from smoke import smoke_config, smoke_traffic

from portbench import harness

SEED = 2**31 + 4321


def _run(cell_name):
    from portbench.run import Context, measure

    cell = harness.cell(cell_name)
    c, tr = smoke_config(cell["config"]), smoke_traffic(cell["traffic"])
    ctx = Context(cell, SEED, 2.0, False, device="cpu", config=c, traffic=tr, t0=time.perf_counter())
    return measure(ctx)


def _broken_step(monkeypatch, fault):
    from repro_torch.runtime import steps

    make = steps.make_train_step

    def make_broken(model, ex):
        step = make(model, ex)

        def broken(state, batch):
            if fault == "half_batch":
                rows = batch["tokens"].shape[0] // 2
                return step(state, {"tokens": batch["tokens"][:rows]})
            saved = [p.detach().clone() for p in steps.flatten(state)]
            new, metrics = step(state, batch)
            with torch.no_grad():
                for p, s in zip(steps.flatten(state), saved):
                    p.copy_(s)
            return state, metrics

        return broken

    monkeypatch.setattr(steps, "make_train_step", make_broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_broken_training_step_is_not_correct(monkeypatch, fault):
    _broken_step(monkeypatch, fault)
    out = _run("granite-8b.train-4k")
    assert out["correct"] is False, out["checks"]


def test_altered_token_is_not_correct(monkeypatch):
    from repro_torch.runtime.decode_loop import ServeLoop

    generate = ServeLoop.generate

    def altered(self, batch, max_new_tokens, **kw):
        got = generate(self, batch, max_new_tokens, **kw)
        got["tokens"] = got["tokens"] + 1
        return got

    monkeypatch.setattr(ServeLoop, "generate", altered)
    out = _run("granite-8b.prefill-mix")
    assert out["correct"] is False and out["checks"]["token_gap"][0] > out["checks"]["token_gap"][1]
