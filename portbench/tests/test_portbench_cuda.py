"""On the card, at each cell's own size (one seed each, a 16 s window,
about a minute a cell): a sound run of the program comes out correct, and the float8
control and every fault the cell can have come out not correct against the
cell's limits.  Run with ``-m cuda``; without a card they skip."""

import time

import pytest

from portbench import calibrate, check, harness

pytestmark = pytest.mark.cuda
SEED = 2**31 + 2718
CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.fixture(autouse=True)
def free_the_card():
    """Each test starts with the card's cache emptied: the cells' peaks
    reach 65 GB of its 80."""
    yield
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(card, name):
    from portbench.run import Context, measure

    ctx = Context(harness.cell(name), SEED, 16.0, False, t0=time.perf_counter())
    out = measure(ctx)
    ctx.free()
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_are_not_correct(card, name):
    """Each reading has every number the limits name, and at least one of
    them lies over its limit."""
    cell = harness.cell(name)
    c, tr = harness.config(cell["config"]), harness.traffic(cell["traffic"])
    faults = calibrate.train_faults if tr["kind"] == "train" else calibrate.prefill_faults
    for kind, numbers in faults(cell, c, tr, SEED, card).items():
        ok, table = check.judge(numbers, harness.limits(name))
        assert all(v is not None for v, _ in table.values()), (kind, table)
        assert not ok and any(v > lim for v, lim in table.values()), (kind, table)
