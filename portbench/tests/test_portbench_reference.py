"""The plain references against the program at smoke width on the CPU: the
program's training step and prefill, driven as a run drives them, agree
with the reference within bfloat16's reach, and the float8 control reads
several times further off."""

import time

import pytest
from smoke import smoke_config, smoke_traffic

from portbench import calibrate, check, harness, weights

SEED = 2**31 + 1234
WINDOW_S = 2.0  # the smoke prefill's first 4 cycles, which hold its checked batches, fit in it


def _measure(cell_name, **traffic):
    from portbench.run import Context, measure

    cell = harness.cell(cell_name)
    c, tr = smoke_config(cell["config"]), smoke_traffic(cell["traffic"], **traffic)
    ctx = Context(cell, SEED, WINDOW_S, False, device="cpu", config=c, traffic=tr,
                  t0=time.perf_counter())
    return measure(ctx), cell, c, tr


@pytest.mark.parametrize("name", ["granite-8b-12l", "granite-8b"])
def test_weights_fill_the_programs_tree(name):
    from repro_torch.models.model import Model

    c = smoke_config(name)
    flat = weights.draw(c, SEED, "cpu", served=True)
    model = Model(harness.port_model_config(c), params=weights.nest(flat), device="cpu")
    assert {n for n, _ in model.named_parameters()} == set(flat)
    again = weights.draw(c, SEED, "cpu", served=True)
    assert all((flat[n] == again[n]).all() for n in flat)


def test_train_step_agrees_and_the_control_does_not():
    out, cell, c, tr = _measure("granite-8b.train-4k")
    n = out["numbers"]
    assert n["loss_gap"] < 2e-3 and n["change_gap"] < 0.01, n
    ctl = calibrate.train_faults(cell, c, tr, SEED, "cpu")["control"]
    assert ctl["loss_gap"] > 2 * n["loss_gap"] and ctl["change_gap"] > 2 * n["change_gap"], (ctl, n)


@pytest.mark.parametrize("cell_name", ["granite-8b.prefill-mix"])
def test_prefill_agrees_and_the_control_does_not(cell_name):
    out, cell, c, tr = _measure(cell_name)
    n = out["numbers"]
    assert n["kept_unserved"] == 0
    assert n["logit_err"] < 0.3 and n["kv_err"] < 0.02, n
    ctl = calibrate.prefill_faults(cell, c, tr, SEED, "cpu")
    assert ctl["control"]["logit_err"] > 3 * n["logit_err"], (ctl, n)
    assert ctl["token_altered"]["token_gap"] > 0.5
    assert set(ctl["control"]) == set(n), (ctl, n)  # the readings carry every number a run has


def test_judge_compares_the_numbers_the_limits_name():
    ok, table = check.judge({"a": 0.1, "b": 0.2}, {"a": {"limit": 1.0}})
    assert ok and table == {"a": [0.1, 1.0]}
    assert not check.judge({"b": 0.1}, {"a": {"limit": 1.0}})[0]  # a limit without its number
    assert not check.judge({"a": float("nan")}, {"a": {"limit": 1.0}})[0]
    assert not check.judge({"a": 2.0}, {"a": {"limit": 1.0}})[0]
    assert not check.judge({"a": 0.1}, {})[0]  # a cell without limits
