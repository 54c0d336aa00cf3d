"""Whole searches: the port's `ruya_search` / `cherrypick_search` / `run_ruya`
against the JAX package's sequential searches, and against the committed
`tests/golden/n512-budgeted.json` fixture.

Both packages get the same space, the same cost function and a
`np.random.default_rng(seed)` each, so they draw the same init picks.
Traces are held step by step with `repro_torch.testing.compare_traces`:
every pick and stop decision equal, or a tie certified under the
reference's own EI at that step (EI_RTOL/EI_ATOL), which ends the
comparison of that trace.  Such a trace is reported (a warning) and not
counted as a match; each test requires a stated number of full matches.
"""

import json
import os
import warnings

import numpy as np
import pytest

from repro.cluster.simulator import ClusterSimulator as RefSim
from repro.cluster.workloads import JOBS as REF_JOBS
from repro.core import bayesopt as ref_bo
from repro.core.profiler import profile_job as ref_profile
from repro.core.search_space import split_search_space as ref_split
from repro_torch.cluster.simulator import ClusterSimulator as PortSim
from repro_torch.core import bayesopt as port_bo
from repro_torch.core import tuner as port_tuner
from repro_torch.core.search_space import Configuration, SearchSpace
from repro_torch.testing import compare_traces, packed_state
from test_torch_fast_bo import ref_ei_rows

GiB = 1024.0**3
FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "n512-budgeted.json")


def ref_ei_at(encoded, pools, capacity, trace):
    """`compare_traces`' ``ei_at`` from the reference's feature layout, one
    EI row per tied (lengthscale, noise) grid point."""
    enc = np.asarray(encoded, np.float32)

    def ei_at(k):
        state = packed_state(encoded, pools, capacity, trace.tried[:k], trace.costs[:k])
        return ref_ei_rows(enc, *state)

    return ei_at


def hold(ref, got, pools, capacity, space, n_init, what):
    """Compare, report a tie end; True for a full match."""
    cmp = compare_traces(ref, got, ref_ei_at(space.encoded(), pools, capacity, ref),
                         first_bo_step=n_init)
    if not cmp.full:
        warnings.warn(f"{what}: {cmp.detail} (not counted as a match)")
    return cmp


def job_setup(key):
    rs, ps = RefSim.for_job(key), PortSim.for_job(key)
    size = rs.job.input_gb * GiB
    prof = ref_profile(rs.profile_run_fn(), size)
    prio, rest = ref_split(rs.space, prof.model, size, per_node_overhead=0.5 * GiB)
    return rs, ps, prof, prio, rest


# One job of each memory category, and the job whose requirement no
# configuration meets (the extremes fallback).
JOBS = ["kmeans/spark/bigdata", "join/spark/huge", "linregr/spark/huge",
        "naivebayes/spark/bigdata"]
SEEDS = (0, 1, 2)


@pytest.mark.parametrize("layout", ["feature", "fused"])
@pytest.mark.parametrize("key", JOBS)
def test_searches_match_reference(key, layout):
    """Ruya and CherryPick with the paper's stop criterion, seeds 0-2: at
    least 5 of the 6 traces match in full."""
    rs, ps, _, prio, rest = job_setup(key)
    n = len(rs.space)
    pools = [prio, rest] if rest else [prio]
    full = 0
    for s in SEEDS:
        r = ref_bo.ruya_search(rs.space, rs.cost_fn(), np.random.default_rng(s), prio, rest)
        g = port_bo.ruya_search(ps.space, ps.cost_fn(), np.random.default_rng(s), prio, rest,
                                layout=layout, device="cpu")
        cap = ref_bo.trial_budget(len(prio), len(rest), ref_bo.BOSettings())
        full += hold(r, g, pools, cap, rs.space, min(3, len(prio)), f"{key} ruya {s}").full
        r = ref_bo.cherrypick_search(rs.space, rs.cost_fn(), np.random.default_rng(s))
        g = port_bo.cherrypick_search(ps.space, ps.cost_fn(), np.random.default_rng(s),
                                      layout=layout, device="cpu")
        full += hold(r, g, [list(range(n))], n, rs.space, 3, f"{key} cherrypick {s}").full
    assert full >= 5, f"only {full} of 6 traces matched in full"


TABLE2_JOBS = sorted(REF_JOBS)


@pytest.mark.parametrize("key", TABLE2_JOBS)
def test_exhaustion_traces_agree_on_table2_metrics(key):
    """Every Table II job, Ruya and CherryPick run to exhaustion (the
    protocol of Table II), seed 0: late in a search the picks are among
    configurations whose EI is zero to float32, so a trace may end at a
    certified tie; up to that step every Table II quantity (iterations to
    cost <= 1.2, 1.1, 1.0 x optimal) agrees with the reference's."""
    rs, ps, _, prio, rest = job_setup(key)
    n = len(rs.space)
    runs = (
        (ref_bo.ruya_search(rs.space, rs.cost_fn(), np.random.default_rng(0), prio, rest,
                            to_exhaustion=True),
         port_bo.ruya_search(ps.space, ps.cost_fn(), np.random.default_rng(0), prio, rest,
                             to_exhaustion=True, layout="fused", device="cpu"),
         [prio, rest] if rest else [prio], min(3, len(prio))),
        (ref_bo.cherrypick_search(rs.space, rs.cost_fn(), np.random.default_rng(0),
                                  to_exhaustion=True),
         port_bo.cherrypick_search(ps.space, ps.cost_fn(), np.random.default_rng(0),
                                   to_exhaustion=True, layout="fused", device="cpu"),
         [list(range(n))], 3),
    )
    for r, g, pools, n_init in runs:
        cmp = hold(r, g, pools, n, rs.space, n_init, f"{key} exhaustion")
        assert cmp.steps >= n_init
        for th in (1.2, 1.1, 1.0):
            it = r.iterations_until(th)
            if it is not None and it <= cmp.steps:
                assert g.iterations_until(th) == it, th
        assert sorted(g.tried) == list(range(n))


def test_run_ruya_matches_reference_pipeline():
    """profile → memory model → split → search through the public entry
    point, against the reference's `run_ruya` on the same live trials."""
    from repro.core.tuner import run_ruya as ref_run_ruya

    key = "pagerank/hadoop/huge"
    rs, ps = RefSim.for_job(key), PortSim.for_job(key)
    kw = dict(full_input_size=rs.job.input_gb * GiB, per_node_overhead=0.5 * GiB)
    full = 0
    for s in (0, 1):
        r = ref_run_ruya(profile_run=rs.profile_run_fn(), space=rs.space, cost_fn=rs.cost_fn(),
                         rng=np.random.default_rng(s), **kw)
        g = port_tuner.run_ruya(profile_run=ps.profile_run_fn(), space=ps.space,
                                cost_fn=ps.cost_fn(), rng=np.random.default_rng(s),
                                device="cpu", **kw)
        assert (g.priority, g.remaining) == (r.priority, r.remaining)
        assert g.memory_model.category.value == r.memory_model.category.value
        pools = [list(r.priority), list(r.remaining)] if r.remaining else [list(r.priority)]
        full += hold(r.trace, g.trace, pools, len(rs.space), rs.space,
                     min(3, len(r.priority)), f"run_ruya {s}").full
    assert full >= 1
    g = port_tuner.run_cherrypick(space=ps.space, cost_fn=ps.cost_fn(),
                                  rng=np.random.default_rng(0), device="cpu")
    r = ref_bo.cherrypick_search(rs.space, rs.cost_fn(), np.random.default_rng(0))
    hold(r, g, [list(range(len(rs.space)))], len(rs.space), rs.space, 3, "run_cherrypick")


def test_cost_table_path_waits_for_the_fleet_slice():
    """The ``cost_table`` path, which waited for the fleet slice and now runs
    as a fleet of one (`tune_fleet`, the session's device split): `run_ruya`
    and `run_cherrypick` against the reference's sequential searches fed
    the host split, two jobs x seeds 0-1, the paper's stop criterion; at
    least 7 of the 8 traces match in full.  Malformed calls still raise."""
    full = 0
    for key in ("kmeans/spark/bigdata", "join/spark/huge"):
        rs, ps, prof, prio, rest = job_setup(key)
        n = len(rs.space)
        kw = dict(full_input_size=rs.job.input_gb * GiB, per_node_overhead=0.5 * GiB)
        for s in (0, 1):
            g = port_tuner.run_ruya(profile_run=ps.profile_run_fn(), space=ps.space,
                                    cost_table=ps.normalized, rng=np.random.default_rng(s),
                                    device="cpu", **kw)
            r = ref_bo.ruya_search(rs.space, rs.cost_fn(), np.random.default_rng(s), prio, rest)
            assert (list(g.priority), list(g.remaining)) == (prio, rest)
            assert g.memory_model.category.value == prof.model.category.value
            cap = ref_bo.trial_budget(len(prio), len(rest), ref_bo.BOSettings())
            full += hold(r, g.trace, [prio, rest] if rest else [prio], cap, rs.space,
                         min(3, len(prio)), f"run_ruya cost_table {key} {s}").full
            g = port_tuner.run_cherrypick(space=ps.space, cost_table=ps.normalized,
                                          rng=np.random.default_rng(s), device="cpu")
            r = ref_bo.cherrypick_search(rs.space, rs.cost_fn(), np.random.default_rng(s))
            full += hold(r, g, [list(range(n))], n, rs.space, 3,
                         f"run_cherrypick cost_table {key} {s}").full
    assert full >= 7, f"only {full} of 8 traces matched in full"
    ps = PortSim.for_job("kmeans/spark/bigdata")
    with pytest.raises(ValueError):
        port_tuner.run_ruya(space=ps.space, cost_table=ps.normalized, cost_fn=ps.cost_fn(),
                            rng=np.random.default_rng(0), device="cpu")
    with pytest.raises(ValueError):
        port_tuner.run_cherrypick(space=ps.space, rng=np.random.default_rng(0), device="cpu")
    with pytest.raises(ValueError):
        port_tuner.run_ruya(space=ps.space, cost_fn=ps.cost_fn(), rng=np.random.default_rng(0),
                            profile_result=None, objective="cost", device="cpu")
    with pytest.raises(ValueError, match="pricing axes"):
        port_tuner.run_ruya(space=ps.space, cost_table=ps.normalized, objective="cost",
                            profile_run=ps.profile_run_fn(), rng=np.random.default_rng(0),
                            device="cpu")


def synth_space_table(n, d=5, seed=0):
    """`tests/golden/scenarios.py::synth_space_table`, built with the port's
    own `SearchSpace` (same RNG stream)."""
    rng = np.random.default_rng(seed + n)
    feats = rng.normal(size=(n, d))
    space = SearchSpace([
        Configuration(name=f"s{i}", features=tuple(float(v) for v in feats[i]),
                      total_memory=float(i) * GiB)
        for i in range(n)
    ])
    w = rng.normal(size=d)
    z = feats @ w
    z = (z - z.mean()) / max(float(z.std()), 1e-9)
    return space, 1.0 + (z - 0.7) ** 2 + 0.05 * rng.random(n)


class _Trace:
    def __init__(self, outcome):
        self.tried = [r["index"] for r in outcome["records"]]
        self.costs = [r["cost"] for r in outcome["records"]]
        self.stop_iteration = outcome["stop_iteration"]
        self.phase_boundary = outcome["phase_boundary"]


@pytest.mark.golden
@pytest.mark.parametrize("layout", ["feature", "fused"])
def test_n512_budgeted_fixture(layout):
    """The seven two-phase Ruya jobs of the fixture (max_iters = 10): at
    least 5 of 7 traces match the committed records in full."""
    with open(FIXTURE) as f:
        outcomes = json.load(f)["outcomes"]
    space, table = synth_space_table(512)
    st = port_bo.BOSettings(max_iters=10)
    prio, rest = list(range(50)), list(range(50, 512))
    cap = port_bo.trial_budget(len(prio), len(rest), st)
    full = 0
    for s, outcome in enumerate(outcomes):
        got = port_bo.ruya_search(space, lambda i: float(table[i]), np.random.default_rng(s),
                                  prio, rest, settings=st, to_exhaustion=True,
                                  layout=layout, device="cpu")
        full += hold(_Trace(outcome), got, [prio, rest], cap, space, 3, f"n512 j{s}").full
    assert full >= 5, f"only {full} of {len(outcomes)} fixture traces matched in full"


def test_fused_search_past_128_configurations_without_a_budget():
    """CherryPick with the paper's stop criterion and no trial budget over a
    200-configuration space: the packed capacity B is 200, past the 128 the
    card's EI/argmax kernel once took.  The port's fused layout against the
    reference's fused lane, seeds 0 and 1: each trace matches or ends at a
    certified tie, and at least one matches in full."""
    from repro.core.search_space import Configuration as RefConfiguration
    from repro.core.search_space import SearchSpace as RefSearchSpace

    space, table = synth_space_table(200)
    ref_space = RefSearchSpace([RefConfiguration(name=c.name, features=c.features,
                                                 total_memory=c.total_memory)
                                for c in space.configs])
    n = len(space)
    assert port_bo.trial_budget(n, 0, port_bo.BOSettings()) == n == 200
    full = 0
    for s in (0, 1):
        r = ref_bo.cherrypick_search(ref_space, lambda i: float(table[i]),
                                     np.random.default_rng(s), layout="fused")
        g = port_bo.cherrypick_search(space, lambda i: float(table[i]), np.random.default_rng(s),
                                      layout="fused", device="cpu")
        assert len(g.tried) > 3  # BO steps ran past the scripted init
        full += hold(r, g, [list(range(n))], n, ref_space, 3, f"n200 cherrypick {s}").full
    assert full >= 1, "no trace matched in full"
