"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import re

import pytest

from portbench import harness

M = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in M["end_to_end"]}
CELLS = {w["name"]: w for w in M["workloads"]}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj|_dim$|_rank$|head|expand|"
                    r"experts_per_tok|d_model|d_ff|d_inner)")


def _applies(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert M["command"] == ["python3", "portbench/run.py"]
    assert M["paths"] == ["portbench"]


def test_names_units_and_text_fields():
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for x in M[part]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for x in M["configs"] + M["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for m in M["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


@pytest.mark.parametrize("kind, keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source", "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entry_keys(kind, keys):
    for x in M[kind]:
        assert set(x) <= keys and set(x) >= keys - {"workloads"}, x


def test_configs_have_source_reduced_and_file():
    for c in M["configs"]:
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        assert c["file"].startswith("portbench/configs/")
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTHS.search(k), k
    assert {w["config"] for w in M["workloads"]} == {c["name"] for c in M["configs"]}


def test_cells_one_chip_files_and_unique_pairs():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in M["workloads"]:
        assert w["chips"] in (1, 4)
        assert (harness.BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (harness.BENCH / "limits" / f"{w['name']}.json").exists()
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, len(M["workloads"]) // 4)


def test_metrics_sources_bounds_and_readers():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()


def test_every_per_layer_metric_moves_one_metric_its_cells_report():
    for m in M["per_layer"]:
        assert m["moves"] in E2E and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert cell in CELLS and _applies(E2E[m["moves"]], cell), (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for cell in CELLS:
        e2e = [m["name"] for m in M["end_to_end"] if _applies(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_applies(m, cell) for m in M["per_layer"])


def test_run_seconds_fits_the_check_at_24_cells():
    s = M["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_limits_name_every_number_with_its_readings():
    for w in M["workloads"]:
        lim = harness.limits(w["name"])
        assert lim, w["name"]
        for name, x in lim.items():
            assert x["limit"] >= 0 and "lower" in x and "upper" in x, (w["name"], name)
            if x["upper"] is not None:
                assert x["lower"] <= x["limit"] < x["upper"], (w["name"], name)
