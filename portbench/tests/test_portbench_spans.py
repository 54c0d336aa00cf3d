"""The readers of the program's profiler ranges on synthetic runs: each
reads its range's device time per traced step or batch, in milliseconds,
and finds nothing without a trace, without its range, or without traced
units."""

import importlib.util

import pytest

from portbench import harness

TRAIN = {"grads_ms.train": "train.grads", "optimizer_ms.train": "optim.update"}
PREFILL = {"attn_core_ms.prefill": "attention.core", "mlp_ms.prefill": "mlp"}
READERS = {**TRAIN, **PREFILL}
SPANS = [m for m in harness.manifest()["per_layer"] if m["source"] == "program_span"]


def _trace(ranges_s):
    return harness.TraceSummary(window_s=3.2, busy_s=3.1, launches=20184, kernels_s={"k": 3.1},
                                ranges_s=ranges_s, idle_gaps=[])


def _train(ranges_s, steps=2):
    return harness.Run(config={}, traffic={}, window={}, trace=_trace(ranges_s),
                       traced={"steps": steps, "launches": {"k2": 64}})


def _prefill(ranges_s, batches=((8, 1024), (4, 2048), (2, 4096), (1, 8192))):
    return harness.Run(config={}, traffic={}, window={}, trace=_trace(ranges_s),
                       traced={"batches": list(batches), "launches": {"k2": 0}})


def test_the_manifest_names_each_reader_once_in_its_one_cell():
    assert {m["name"] for m in SPANS} >= set(READERS)
    for m in SPANS:
        if m["name"] in READERS:
            cell = "granite-8b.train-4k" if m["name"] in TRAIN else "granite-8b.prefill-mix"
            assert m["workloads"] == [cell] and m["unit"] == "ms" and m["better"] == "lower"


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_the_programs_range(name, monkeypatch):
    from repro_torch import spans

    monkeypatch.syspath_prepend(str(harness.BENCH / "metrics"))  # as `read_metrics` runs them
    path = harness.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.RANGE == READERS[name] and mod.RANGE in {
        spans.ATTENTION_CORE, spans.MLP, spans.TRAIN_GRADS, spans.OPTIM_UPDATE}


@pytest.mark.parametrize("name, seconds, per", [
    ("grads_ms.train", 0.1, 50.0), ("optimizer_ms.train", 0.3, 150.0),
    ("attn_core_ms.prefill", 2.8, 700.0), ("mlp_ms.prefill", 0.6, 150.0)])
def test_milliseconds_per_traced_step_or_batch(name, seconds, per):
    make = _train if name in TRAIN else _prefill
    others = {r: 9.0 for r in READERS.values() if r != READERS[name]}
    got = harness.read_metrics([name], make({READERS[name]: seconds, **others}))
    assert got == {name: pytest.approx(per)}


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_without_a_trace_the_range_or_traced_units(name):
    make = _train if name in TRAIN else _prefill
    ranges = {r: 1.0 for r in READERS.values()}
    untraced = make(ranges)
    untraced.trace = None
    assert harness.read_metrics([name], untraced) == {}
    assert harness.read_metrics([name], make({k: v for k, v in ranges.items()
                                              if k != READERS[name]})) == {}
    none = _train(ranges, steps=0) if name in TRAIN else _prefill(ranges, batches=())
    assert harness.read_metrics([name], none) == {}
    # the other kind of run: a training step's trace has no traced batches, and back
    other = _prefill(ranges) if name in TRAIN else _train(ranges)
    assert harness.read_metrics([name], other) == {}
