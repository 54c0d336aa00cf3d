"""What the benchmark may load and read: no JAX, no JAX package (top-level
names compared whole, as `repro_torch` begins with `repro`), nothing of the
program in the reference or the counts, nothing of the JAX package's
benchmarks; and no result without a card."""

import ast
import json
import subprocess
import sys

import pytest

from portbench import harness

SOURCES = sorted(p for p in harness.BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_jax_or_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), tops


@pytest.mark.parametrize("sub", ["reference", "counts"])
def test_reference_and_counts_import_nothing_of_the_program(sub):
    for path in (harness.BENCH / sub).rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "repro_torch" not in tops, path


def test_reads_nothing_of_the_jax_packages_benchmarks():
    for path in SOURCES:
        text = path.read_text()
        assert "BENCH_fleet" not in text and "benchmarks/" not in text, path


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.forbidden_modules()


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cell = harness.manifest()["workloads"][0]["name"]
    got = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload", cell,
                          "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=harness.ROOT)
    assert got.returncode != 0
    for line in got.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
