"""The port's device split (`split_masks_device`) against the host split.

`split_masks_device(device="cpu")` must give exactly the priority lists of
both the reference's host `split_search_space` and the port's own copy of
it: mask == list equality, no tolerance, in every branch of the §III-D rule
(FLAT, LINEAR with some, none or all configurations qualifying, UNCLEAR),
with memory ties broken in stable order, for the 16 paper jobs' profiles,
and over random spaces.  The remaining group is always the complement.
The reference's own device split needs `jax.experimental.enable_x64`,
which the installed JAX no longer has, so it is not called here.
"""

import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.cluster.simulator import ClusterSimulator as RefSim
from repro.cluster.workloads import JOBS as REF_JOBS
from repro.core import memory_model as ref_mm
from repro.core import search_space as ref_ss
from repro.core.profiler import profile_job as ref_profile
from repro_torch.cluster.simulator import ClusterSimulator as PortSim
from repro_torch.core import memory_model as port_mm
from repro_torch.core import search_space as port_ss
from repro_torch.core.profiler import profile_job as port_profile

GiB = 1024.0**3


def spaces(mems, nodes, d=3, seed=0):
    """The same configurations as a reference and a port `SearchSpace`."""
    feats = np.random.default_rng(seed).normal(size=(len(mems), d))
    out = []
    for mod in (ref_ss, port_ss):
        out.append(mod.SearchSpace([
            mod.Configuration(name=f"c{i}", features=tuple(float(v) for v in feats[i]),
                              total_memory=float(m), num_nodes=int(k))
            for i, (m, k) in enumerate(zip(mems, nodes))
        ]))
    return out


def models(category, slope=0.0, intercept=0.0, readings=(1.0,)):
    out = []
    for mod in (ref_mm, port_mm):
        out.append(mod.MemoryModel(category=mod.MemoryCategory(category), slope=slope,
                                   intercept=intercept, r2=1.0, sizes=(1.0,),
                                   readings=tuple(readings)))
    return out


def check(ref_space, port_space, ref_model, port_model, size, **kw):
    """Device mask == both host lists; returns the priority count."""
    r_prio, r_rest = ref_ss.split_search_space(ref_space, ref_model, size, **kw)
    p_prio, p_rest = port_ss.split_search_space(port_space, port_model, size, **kw)
    assert (p_prio, p_rest) == (r_prio, r_rest)
    mask = port_ss.split_masks_device(port_space, port_model, size, device="cpu", **kw)
    assert mask.dtype == torch.bool and mask.device.type == "cpu"
    mask = mask.numpy()
    assert np.flatnonzero(mask).tolist() == r_prio
    if r_rest:
        assert np.flatnonzero(~mask).tolist() == r_rest
    else:  # UNCLEAR and all-qualify: the whole space, no remainder
        assert mask.all()
    return len(r_prio)


def test_four_branches_and_the_all_qualify_case():
    n = 200
    rng = np.random.default_rng(1)
    mems = rng.uniform(8, 512, size=n) * GiB
    nodes = rng.integers(1, 17, size=n)
    rs, ps = spaces(mems, nodes)
    kw = dict(per_node_overhead=0.5 * GiB)
    # FLAT: the k lowest-memory configs.
    assert check(rs, ps, *models("flat", readings=(3e9, 4e9)), 1e12, **kw) == round(n / 7)
    # LINEAR, some qualify.
    k = check(rs, ps, *models("linear", slope=2.0, intercept=1e9), 100 * GiB, **kw)
    assert 0 < k < n
    # LINEAR, none qualify: the extremes, 15 % at each end.
    assert check(rs, ps, *models("linear", slope=50.0), 100 * GiB, **kw) == 2 * round(0.15 * n)
    # LINEAR, all qualify: no reduction.
    assert check(rs, ps, *models("linear", slope=1e-6), 1.0, **kw) == n
    # UNCLEAR: the whole space.
    assert check(rs, ps, *models("unclear"), 100 * GiB, **kw) == n


@pytest.mark.parametrize("category,slope", [("flat", 0.0), ("linear", 50.0)])
def test_memory_ties_break_in_stable_order(category, slope):
    """Few distinct memories, so the FLAT cut and both extremes fall inside
    runs of equal memory: the lowest indices of a run come first."""
    n = 97
    rng = np.random.default_rng(2)
    mems = rng.choice([16.0, 32.0, 64.0, 128.0], size=n) * GiB
    rs, ps = spaces(mems, np.ones(n, int))
    check(rs, ps, *models(category, slope=slope, readings=(1e9,)), 100 * GiB)


def test_requirement_on_the_boundary():
    """A config whose memory equals the requirement exactly qualifies (>=),
    the requirement rounded as the host rule rounds it."""
    nodes = np.array([1, 2, 3, 4, 5])
    req, leeway, over = 10 * GiB, 0.1, 0.5 * GiB
    exact = req * (1.0 + leeway) + over * nodes
    mems = exact.copy()
    mems[1] = np.nextafter(mems[1], 0)  # one ulp short
    rs, ps = spaces(mems, nodes)
    ref_m, port_m = models("linear", slope=1.0, intercept=0.0)
    assert check(rs, ps, ref_m, port_m, req, per_node_overhead=over, leeway=leeway) == 4


@pytest.mark.parametrize("key", sorted(REF_JOBS))
def test_paper_jobs(key):
    """Each Table II job's own profile over the 69-configuration grid."""
    rs, ps = RefSim.for_job(key), PortSim.for_job(key)
    size = rs.job.input_gb * GiB
    r_prof = ref_profile(rs.profile_run_fn(), size)
    p_prof = port_profile(ps.profile_run_fn(), size)
    assert p_prof.model.category.value == r_prof.model.category.value
    check(rs.space, ps.space, r_prof.model, p_prof.model, size, per_node_overhead=0.5 * GiB)


def random_case(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    distinct = int(rng.integers(1, 12))
    mems = rng.choice(rng.uniform(1, 64, size=distinct), size=n) * GiB
    nodes = rng.integers(1, 9, size=n)
    cat = ["flat", "linear", "unclear"][int(rng.integers(3))]
    slope = float(rng.choice([1e-3, 0.5, 2.0, 50.0]))
    kw = dict(per_node_overhead=float(rng.choice([0.0, 0.5])) * GiB,
              leeway=float(rng.uniform(0, 0.3)),
              flat_fraction=float(rng.uniform(0.05, 0.5)),
              extreme_fraction=float(rng.uniform(0.05, 0.5)))
    return mems, nodes, cat, slope, float(rng.uniform(1, 100)) * GiB, kw


@pytest.mark.parametrize("seed", range(40))
def test_random_spaces(seed):
    mems, nodes, cat, slope, size, kw = random_case(seed)
    rs, ps = spaces(mems, nodes)
    check(rs, ps, *models(cat, slope=slope, intercept=1e8, readings=(2e9,)), size, **kw)


@settings(max_examples=60, deadline=None)
@given(st.integers(min_value=0, max_value=2**31 - 1))
def test_property_device_split_equals_host_split(seed):
    mems, nodes, cat, slope, size, kw = random_case(seed)
    rs, ps = spaces(mems, nodes)
    check(rs, ps, *models(cat, slope=slope, intercept=1e8, readings=(2e9,)), size, **kw)
