"""The port stands alone: no JAX, no `repro`, and no silent CPU fallback.

  * No file under `src/repro_torch/`, and not `chip_smoke.py`, imports
    `jax` or the JAX package `repro` (an AST scan of every import).
  * Every port module imports in a fresh interpreter where importing
    `jax` or `repro` fails.
  * The entry points run on the card unless the caller passes
    ``device="cpu"``: without a card they raise before any trial.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(name, line) for name, line in _imported_roots(path) if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(_modules()) >= 20


def test_scans_cover_every_subpackage():
    """Both scans walk the whole package: each subpackage's modules are in them."""
    mods = set(_modules())
    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    for sub in ("core", "cluster", "fleet", "kernels.ei_argmax", "kernels.flash_attention",
                "kernels.ssd", "kernels.rmsnorm", "models", "configs", "data", "runtime",
                "launch", "optim", "parallel", "checkpoint"):
        assert any(m.startswith(f"repro_torch.{sub}.") for m in mods), sub
        assert any(f.startswith(f"src/repro_torch/{sub.replace('.', '/')}/") for f in files), sub


def profiled_model(sim):
    from repro_torch.core.profiler import profile_job

    return profile_job(sim.profile_run_fn(), sim.job.input_gb * 1024.0**3).model


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    from repro_torch.cluster.simulator import ClusterSimulator
    from repro_torch.core import bayesopt, fast_bo, search_space, tuner
    from repro_torch.device import resolve_device
    from repro_torch.fleet import TuningSession, batched_search, cluster_fleet, tune_fleet

    sim = ClusterSimulator.for_job("kmeans/spark/bigdata")
    jobs = cluster_fleet(["kmeans/spark/bigdata"])
    calls = []

    def cost_fn(i):
        calls.append(i)
        return float(sim.normalized[i])

    rng = np.random.default_rng(0)
    for run in (
        lambda: resolve_device(None),
        lambda: fast_bo.SequentialProbe(sim.space.encoded(), 8),
        lambda: fast_bo.bo_step(sim.space.encoded(), np.eye(69, dtype=bool)[0],
                                sim.costs, np.ones(69, bool)),
        lambda: fast_bo.FleetState.from_numpy(
            {k: np.zeros(3) for k in fast_bo.FleetState._fields}),
        lambda: bayesopt.cherrypick_search(sim.space, cost_fn, rng),
        lambda: bayesopt.ruya_search(sim.space, cost_fn, rng, [0, 1, 2], [3, 4]),
        lambda: tuner.run_ruya(space=sim.space, cost_fn=cost_fn, rng=rng,
                               profile_run=sim.profile_run_fn(),
                               full_input_size=sim.job.input_gb * 1024.0**3),
        lambda: tuner.run_cherrypick(space=sim.space, cost_fn=cost_fn, rng=rng),
        lambda: tuner.run_ruya(space=sim.space, cost_table=sim.normalized, rng=rng,
                               profile_run=sim.profile_run_fn(),
                               full_input_size=sim.job.input_gb * 1024.0**3),
        lambda: tuner.run_cherrypick(space=sim.space, cost_table=sim.normalized, rng=rng),
        lambda: TuningSession(),
        lambda: tune_fleet(jobs, [rng]),
        lambda: tune_fleet(jobs, [rng], engine="sequential"),
        lambda: batched_search(sim.space, [sim.normalized], [rng]),
        lambda: fast_bo.precompute_d2(sim.space.encoded()),
        lambda: search_space.split_masks_device(sim.space, profiled_model(sim), 1.0),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
    assert calls == []  # no trial ran before the refusal


def test_cpu_on_request(no_card):
    from repro_torch.cluster.simulator import ClusterSimulator
    from repro_torch.core import bayesopt

    sim = ClusterSimulator.for_job("kmeans/spark/bigdata")
    trace = bayesopt.cherrypick_search(sim.space, sim.cost_fn(), np.random.default_rng(0),
                                       settings=bayesopt.BOSettings(max_iters=5), device="cpu")
    assert len(trace.tried) == 5
    with pytest.raises(ValueError):
        bayesopt.cherrypick_search(sim.space, sim.cost_fn(), np.random.default_rng(0),
                                   device="meta")


def test_train_entry_points_raise_without_a_card(no_card, tmp_path):
    """The training path refuses before any step: the model, and with it the
    CLI, resolve the device first."""
    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models.model import Model

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(configs.smoke("qwen3-8b").model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "qwen3-8b", "--smoke", "--steps", "1",
                    "--ckpt-dir", str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()
