"""The port's autotuner (`repro_torch.launch.autotune`) against the JAX
package's (`repro.launch.autotune`).

  * `variant_space` gives the reference's names and features.
  * One stub environment, injected into both packages in the place of
    their environments (the reference's `TpuTunerEnv`, the port's
    `TunerEnv`), drives `predict_peaks` and `run_autotune`: the predicted
    peaks (as a share of each package's HBM line: the v5e's 16 GiB, the
    card's 80 GB) and their memory categories, the priority and the rest
    groups, and the search's trace under the tie-aware comparator of
    `repro_torch.testing`.
  * One real `run_autotune` runs on smoke granite-8b at a (2, 4) mesh of a
    fake world, its trials traced on the meta device.

JAX is up before the reference's module is imported, so its guard on the
host device count never fires in this process.
"""

import math
import types

import numpy as np
import pytest

import jax

jax.devices()  # JAX initialized first: the reference's module then leaves XLA_FLAGS alone

import repro.core.bayesopt as ref_bayesopt
from repro.core import search_space as ref_ss
from repro.launch import autotune as ref_at

import repro_torch.core.bayesopt as port_bayesopt
from repro_torch import configs as C
from repro_torch.core import search_space as port_ss
from repro_torch.launch import autotune as at
from repro_torch.launch import mesh as port_mesh
from repro_torch.testing import compare_traces, port_ei_at
from torch_dist import fake_world

CELLS = {  # the stub's cells: (tokens, kind)
    "train_4k": (4096 * 256, "train"),
    "decode_32k": (32768 * 128, "decode"),
}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_variant_space_matches_reference(kind):
    got, want = at.variant_space(kind), ref_at.variant_space(kind)
    assert [v.name for v in got] == [v.name for v in want]
    assert [v.features() for v in got] == [v.features() for v in want]


def stub_env(ss, hbm: float):
    """An environment over one package's `Configuration`/`SearchSpace`
    classes, with peaks that are shares of ``hbm``: linear in tokens per
    device for training (an offset plus activations cut by remat and
    sequence sharding), flat for serving; costs a smooth function of the
    features."""

    class Stub:
        def __init__(self, arch, cell_name, multi_pod=False, cache_path=None):
            tokens, kind = CELLS[cell_name]
            self.cell = types.SimpleNamespace(tokens=tokens, kind=kind, seq_len=4096)
            self.chips = 256
            self.trial_cache = {}

        def profile_run_fn(self, v):
            full = self.cell.tokens / self.chips

            def run(tpd):
                if self.cell.kind != "train":
                    return 1.0, hbm * (0.30 - 0.05 * v.fsdp)
                act = {"none": 1.0, "dots": 0.6, "full": 0.3}[v.remat] * (0.5 if v.seq_shard
                                                                          else 1.0)
                return 1.0, hbm * ((0.27 if v.fsdp else 0.71) + 1.57 * act * tpd / full)

            return run

        def trial_cost_fn(self, space):
            def cost(i):
                v = space[i]
                f = v.features()
                c = 1.0 + 0.3 * (f[0] - 1.7) ** 2 + 0.2 * f[1] + 0.15 * f[2] - 0.1 * f[3]
                self.trial_cache[v.name] = {"cost_chip_s": c}
                return c

            return cost

        def search_space(self):
            space = at.variant_space(self.cell.kind)
            configs = [ss.Configuration(name=v.name, features=v.features(),
                                        total_memory=float(hbm), num_nodes=self.chips, meta=v)
                       for v in space]
            return space, ss.SearchSpace(configs)

    return Stub


REF_STUB = stub_env(ref_ss, ref_at.HBM_PER_CHIP)
PORT_STUB = stub_env(port_ss, at.HBM_PER_CHIP)


@pytest.mark.parametrize("cell", list(CELLS))
def test_predict_peaks_match_reference(cell):
    ref_space = ref_at.variant_space(CELLS[cell][1])
    want, want_models = ref_at.predict_peaks(REF_STUB("a", cell), ref_space)
    got, got_models = at.predict_peaks(PORT_STUB("a", cell), at.variant_space(CELLS[cell][1]))
    assert list(got) == list(want)
    for name in want:
        assert got[name] / at.HBM_PER_CHIP == pytest.approx(want[name] / ref_at.HBM_PER_CHIP,
                                                           rel=1e-6)
    assert {k: m.category.value for k, m in got_models.items()} == \
        {k: m.category.value for k, m in want_models.items()}
    # no share at the split's line (1.05), where the last bit would decide
    assert all(abs(p / ref_at.HBM_PER_CHIP - 1.05) > 1e-3 for p in want.values())


def recording(module, sink):
    search = module.ruya_search

    def recorded(space, cost_fn, rng, prio, rest, **kw):
        sink["pools"] = [list(prio)] + ([list(rest)] if len(rest) else [])
        sink["trace"] = search(space, cost_fn, rng, prio, rest, **kw)
        sink["encoded"] = space.encoded()
        return sink["trace"]

    return recorded


@pytest.mark.parametrize("cell", list(CELLS))
def test_run_autotune_matches_reference(cell, monkeypatch):
    ref, port = {}, {}
    monkeypatch.setattr(ref_at, "TpuTunerEnv", REF_STUB)
    monkeypatch.setattr(at, "TunerEnv", PORT_STUB)
    monkeypatch.setattr(ref_bayesopt, "ruya_search", recording(ref_bayesopt, ref))
    monkeypatch.setattr(port_bayesopt, "ruya_search", recording(port_bayesopt, port))
    want = ref_at.run_autotune("stub", cell, budget=12, seed=0)
    got = at.run_autotune("stub", cell, budget=12, seed=0, device="cpu")
    assert got["priority_size"] == want["priority_size"]
    assert port["pools"] == ref["pools"]
    n = len(at.variant_space(CELLS[cell][1]))
    cmp = compare_traces(ref["trace"], port["trace"],
                         port_ei_at(np.asarray(ref["encoded"]), ref["pools"], n, ref["trace"],
                                    device="cpu"),
                         first_bo_step=port_bayesopt.BOSettings().n_init)
    print(cell, cmp)
    if cmp.full:
        assert got["tried"] == want["tried"] and got["best"] == want["best"]
        assert got["best_cost_chip_s"] == pytest.approx(want["best_cost_chip_s"])


def test_run_autotune_end_to_end_on_a_fake_mesh(monkeypatch):
    """Smoke granite-8b × decode_32k on a (2, 4) mesh: every trial a dry-run
    on meta shards, the BO on the CPU."""
    with fake_world(8):
        mesh = port_mesh.make_mesh((2, 4), ("data", "model"), "cpu", abstract=True)
        monkeypatch.setattr(C, "get", lambda arch: C.smoke_variant(C.REGISTRY[arch]))
        monkeypatch.setattr(port_mesh, "fake_world", lambda size: None)
        monkeypatch.setattr(port_mesh, "make_production_mesh", lambda **kw: mesh)
        result = at.run_autotune("granite-8b", "decode_32k", budget=4, seed=0, device="cpu")
    names = [v.name for v in at.variant_space("decode")]
    assert 1 <= result["trials"] <= len(names) and result["best"] in names
    assert result["tried"] == [names[i] for i in result["tried_index"]]
    details = [d for d in result["trial_details"].values()]
    assert all(d["peak_bytes"] > 0 and d["roofline_s"] > 0 for d in details)
    assert math.isfinite(result["best_cost_chip_s"])
    assert all(p > 0 or math.isnan(p) for p in result["predicted_peaks_gib"].values())
