"""The port's host-side numpy modules against the JAX package's, exactly.

`repro_torch` keeps its own copies of the numpy-only modules (memory
model, profiler, search space and split, the emulated cluster) so that it
never imports the JAX package.  The copies must stay bit-equal: for all 16
Table I jobs the cost tables, profiling results and §III-D splits are
compared with exact equality, and the memory-cliff model against the
committed `tests/golden/spill-surface.json` fixture.
"""

import json
import os

import numpy as np
import pytest

from repro.cluster import faults as ref_faults
from repro.cluster import pricing as ref_pricing
from repro.cluster import simulator as ref_sim
from repro.cluster.nodes import make_cluster_search_space as ref_space
from repro.cluster.workloads import JOBS as REF_JOBS
from repro.core.memory_model import fit_memory_model as ref_fit
from repro.core.profiler import profile_job as ref_profile
from repro.core.search_space import split_search_space as ref_split
from repro_torch.cluster import faults as port_faults
from repro_torch.cluster import pricing as port_pricing
from repro_torch.cluster import simulator as port_sim
from repro_torch.cluster.nodes import make_cluster_search_space as port_space
from repro_torch.cluster.workloads import JOBS as PORT_JOBS
from repro_torch.core.memory_model import fit_memory_model as port_fit
from repro_torch.core.profiler import PermanentRunError, TransientRunError
from repro_torch.core.profiler import profile_job as port_profile
from repro_torch.core.search_space import split_search_space as port_split

GiB = 1024.0**3
FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "spill-surface.json")
JOB_KEYS = sorted(REF_JOBS)


def _model_tuple(m):
    return (m.category.value, m.slope, m.intercept, m.r2, m.sizes, m.readings)


def _profile_tuple(p):
    return (p.sizes, p.readings, p.total_time_s, p.calibration_runs, _model_tuple(p.model))


def test_job_catalogs_match():
    assert sorted(PORT_JOBS) == JOB_KEYS and len(JOB_KEYS) == 16
    for key in JOB_KEYS:
        assert PORT_JOBS[key] == REF_JOBS[key] or (
            vars(PORT_JOBS[key]) == vars(REF_JOBS[key])
        ), key


def test_search_space_encoding_matches():
    r, p = ref_space(), port_space()
    assert [c.name for c in r.configs] == [c.name for c in p.configs]
    assert np.array_equal(r.encoded(), p.encoded())
    assert np.array_equal(r.memories(), p.memories())
    assert np.array_equal(r.num_nodes(), p.num_nodes())


@pytest.mark.parametrize("key", JOB_KEYS)
def test_job_tables_profile_and_split_match(key):
    """Cost/runtime tables, the §III-B profiling run, the §III-C model and
    the §III-D split: exactly the reference's, job by job."""
    rs, ps = ref_sim.ClusterSimulator.for_job(key), port_sim.ClusterSimulator.for_job(key)
    assert np.array_equal(rs.costs, ps.costs)
    assert np.array_equal(rs.normalized, ps.normalized)
    assert np.array_equal(
        ref_sim.job_runtime_table(REF_JOBS[key]), port_sim.job_runtime_table(PORT_JOBS[key])
    )
    assert rs.optimal_index() == ps.optimal_index()
    size = rs.job.input_gb * GiB
    rp = ref_profile(rs.profile_run_fn(), size)
    pp = port_profile(ps.profile_run_fn(), size)
    assert _profile_tuple(rp) == _profile_tuple(pp)
    for overhead in (0.0, 0.5 * GiB):
        assert ref_split(rs.space, rp.model, size, per_node_overhead=overhead) == port_split(
            ps.space, pp.model, size, per_node_overhead=overhead
        )


def test_spill_surface_matches_golden_fixture():
    with open(FIXTURE) as f:
        fixture = json.load(f)
    configs = port_sim.enumerate_cluster_configs()
    assert [c.name for c in configs] == fixture["configs"]
    got = {
        key: [float(port_sim._spill_factor(job, c)) for c in configs]
        for key, job in sorted(PORT_JOBS.items())
    }
    assert got == fixture["spill"]


@pytest.mark.parametrize("seed", range(4))
def test_memory_model_fit_matches(seed):
    rng = np.random.default_rng(seed)
    sizes = np.sort(rng.uniform(1e8, 1e10, size=5))
    for readings in (
        3.0 * sizes + 1e8,  # linear
        np.full(5, 4e9) + rng.normal(0, 1e6, size=5),  # flat
        3.0 * sizes * (1.0 + 0.4 * rng.normal(size=5)),  # unclear
    ):
        assert _model_tuple(ref_fit(list(sizes), list(readings))) == _model_tuple(
            port_fit(list(sizes), list(readings))
        )


def test_price_catalogs_match():
    configs = port_sim.enumerate_cluster_configs()
    for seed in (0, 3):
        ref_cats = ref_pricing.default_catalogs(seed)
        port_cats = port_pricing.default_catalogs(seed)
        assert sorted(ref_cats) == sorted(port_cats)
        for name in ref_cats:
            for epoch in (0, 5):
                assert np.array_equal(
                    ref_cats[name].price_table(epoch=epoch),
                    port_cats[name].price_table(configs, epoch=epoch),
                ), (name, epoch)
    key = JOB_KEYS[0]
    cat = port_pricing.spot(seed=1)
    ref_priced = ref_sim.ClusterSimulator.for_job(key, catalog=ref_pricing.spot(seed=1), epoch=2)
    port_priced = port_sim.ClusterSimulator.for_job(key, catalog=cat, epoch=2)
    assert np.array_equal(ref_priced.costs, port_priced.costs)


def test_fault_plans_match():
    """Injected profiling faults fire at the same calls, with the port's
    own error classes."""
    plan_kw = dict(seed=4, transient_run_failures=1, transient_rate=0.5, max_injected=3,
                   straggler_rate=0.3)
    rp, pp = ref_faults.FaultPlan(**plan_kw), port_faults.FaultPlan(**plan_kw)

    def run(s):
        return s, 2.0 * s

    rw, pw = rp.wrap_run(run, "k"), pp.wrap_run(run, "k")
    for i in range(12):
        outcomes = []
        for w, exc in ((rw, Exception), (pw, (TransientRunError, PermanentRunError))):
            try:
                outcomes.append(("ok", w(float(i))))
            except exc as e:
                outcomes.append((type(e).__name__, str(e)))
        assert outcomes[0] == outcomes[1], i
    assert [rp.straggler_multiplier("k", t) for t in range(20)] == [
        pp.straggler_multiplier("k", t) for t in range(20)
    ]
