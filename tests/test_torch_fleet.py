"""The port's fleet engine (`repro_torch.fleet`) against the JAX package.

  * `batched_search` against the reference's `batched_search` in each
    layout (explicit pools, so the reference's session skips its device
    split, which needs `jax.experimental.enable_x64`, gone from the
    installed JAX);
  * `batched_search` against the port's own sequential engine, with
    heterogeneous shapes and capacities and one, five and nine jobs (two
    chunks), and a job's trace independent of its chunk-mates: the port
    runs a chunk of one without the reference's dummy row;
  * `tune_fleet` in both modes (the session's device split) against the
    reference's sequential `ruya_search` / `cherrypick_search` fed the host
    split, and the port's two engines against each other;
  * `retry`'s backoff schedule and `ProfileCache`'s signatures, hits and
    drift decisions exactly equal to the reference's.

Traces are held with `repro_torch.testing.compare_traces`: every pick and
stop decision equal, or a tie certified under the reference's EI, which
ends that trace's comparison (reported, not counted as a match).  Each
test states the number of full matches it requires.
"""

import numpy as np
import pytest

from repro.cluster.simulator import ClusterSimulator as RefSim
from repro.cluster.workloads import JOBS as REF_JOBS
from repro.core import bayesopt as ref_bo
from repro.core.profiler import TransientRunError as RefTransient
from repro.fleet import batched_search as ref_batched_search
from repro.fleet import profile_cache as ref_pc
from repro.fleet import retry as ref_retry
from repro_torch.cluster.simulator import ClusterSimulator as PortSim
from repro_torch.core import bayesopt as port_bo
from repro_torch.core.profiler import TransientRunError as PortTransient
from repro_torch.fleet import (
    FleetJob,
    batched_search,
    cluster_fleet,
    tune_fleet,
)
from repro_torch.fleet import profile_cache as port_pc
from repro_torch.fleet import retry as port_retry
from repro_torch.testing import compare_traces, port_ei_at
from test_torch_search import JOBS, hold, job_setup, synth_space_table

GiB = 1024.0**3


@pytest.mark.parametrize("layout", ["feature", "gather", "fused"])
def test_batched_search_matches_reference(layout):
    """Two paper jobs with their Ruya splits, seeds 0-2 each, one lockstep
    chunk of six on each side, the paper's stop criterion: at least 5 of
    the 6 traces match the reference's in full."""
    specs = [(k, s) for k in ("kmeans/spark/bigdata", "join/spark/huge") for s in range(3)]
    setups = {k: (rs, ps, prio, rest)
              for k in dict(specs) for rs, ps, _, prio, rest in [job_setup(k)]}
    ref = ref_batched_search(
        [setups[k][0].space for k, _ in specs], [setups[k][0].normalized for k, _ in specs],
        [np.random.default_rng(s) for _, s in specs],
        priority=[setups[k][2] for k, _ in specs], remaining=[setups[k][3] for k, _ in specs],
        layout=layout,
    )
    got = batched_search(
        [setups[k][1].space for k, _ in specs], [setups[k][1].normalized for k, _ in specs],
        [np.random.default_rng(s) for _, s in specs],
        priority=[setups[k][2] for k, _ in specs], remaining=[setups[k][3] for k, _ in specs],
        layout=layout, device="cpu",
    )
    full = 0
    for j, (k, s) in enumerate(specs):
        rs, _, prio, rest = setups[k]
        cap = ref_bo.trial_budget(len(prio), len(rest), ref_bo.BOSettings())
        full += hold(ref.job_trace(j), got.job_trace(j), [prio, rest] if rest else [prio], cap,
                     rs.space, min(3, len(prio)), f"{k} seed {s} {layout}").full
    assert full >= 5, f"only {full} of 6 traces matched in full"


def fleet_specs(J):
    """J heterogeneous jobs: two spaces (n = 80, d = 4 and n = 120, d = 3),
    CherryPick and Ruya-style pools of several sizes, one of them smaller
    than the budget, so five jobs group into three (shape, capacity)
    chunks, one of a single job; J = 9 puts nine jobs in one group, two
    chunks."""
    sp_a, tb_a = synth_space_table(80, d=4)
    sp_b, tb_b = synth_space_table(120, d=3)
    kinds = [
        (sp_a, tb_a, list(range(80)), []),
        (sp_a, tb_a, list(range(0, 80, 4)), [i for i in range(80) if i % 4]),
        (sp_b, tb_b, list(range(120)), []),
        (sp_b, tb_b, list(range(30)), list(range(30, 60))),
        (sp_b, tb_b, list(range(5)), list(range(5, 9))),  # capacity 9, below max_iters
    ]
    if J == 9:
        return [kinds[1] + (s,) for s in range(9)]
    return [kinds[j % len(kinds)] + (j,) for j in range(J)]


@pytest.mark.parametrize("layout", ["feature", "fused"])
@pytest.mark.parametrize("J", [1, 5, 9])
def test_batched_search_matches_sequential_engine(J, layout):
    """Every job's lockstep trace against the port's sequential engine
    (`SequentialProbe`, J = 1) with the same seed and pools, BOSettings
    (max_iters = 12), the stop criterion armed: all J match in full."""
    specs = fleet_specs(J)
    st = port_bo.BOSettings(max_iters=12)
    bt = batched_search(
        [s[0] for s in specs], [s[1] for s in specs],
        [np.random.default_rng(s[4]) for s in specs],
        priority=[s[2] for s in specs], remaining=[s[3] for s in specs],
        settings=st, layout=layout, device="cpu",
    )
    full = 0
    for j, (space, table, prio, rest, seed) in enumerate(specs):
        seq = port_bo.ruya_search(space, lambda i, t=table: float(t[i]),
                                  np.random.default_rng(seed), prio, rest, settings=st,
                                  layout=layout, device="cpu")
        pools = [prio, rest] if rest else [prio]
        cap = port_bo.trial_budget(len(prio), len(rest), st)
        cmp = compare_traces(seq, bt.job_trace(j),
                             port_ei_at(space.encoded(), pools, cap, seq, "cpu"),
                             first_bo_step=3)
        full += cmp.full
    assert full == J, f"{full} of {J} traces matched in full"


@pytest.mark.parametrize("layout", ["feature", "fused", "gather"])
def test_trace_does_not_depend_on_chunk_mates(layout):
    """One job alone (a chunk of one, no dummy row), and the same job as row
    3 of two different chunks of eight: the three traces match in full."""
    space, table = synth_space_table(90, d=4)
    st = port_bo.BOSettings(max_iters=14)
    prio, rest = list(range(20)), list(range(20, 90))

    def run(mates):
        pr = [prio] * 8 if mates else [prio]
        rs = [rest] * 8 if mates else [rest]
        seeds = [100 + m for m in mates[:3]] + [5] + [100 + m for m in mates[3:]] if mates else [5]
        bt = batched_search(space, [table] * len(seeds), [np.random.default_rng(s) for s in seeds],
                            priority=pr, remaining=rs, settings=st, layout=layout, device="cpu")
        return bt.job_trace(3 if mates else 0)

    alone = run([])
    cap = port_bo.trial_budget(len(prio), len(rest), st)
    for mates in ([1, 2, 3, 4, 5, 6, 7], [9, 8, 7, 6, 5, 4, 3]):
        got = run(mates)
        cmp = compare_traces(alone, got, port_ei_at(space.encoded(), [prio, rest], cap, alone,
                                                    "cpu"), first_bo_step=3)
        assert cmp.full, cmp.detail
        assert got.tried == alone.tried and got.stop_iteration == alone.stop_iteration


@pytest.mark.parametrize("mode", ["ruya", "cherrypick"])
def test_tune_fleet_matches_reference_sequential_search(mode):
    """`tune_fleet` over the four test jobs (one of each memory category and
    the extremes fallback) x seeds 0-1, the paper's stop criterion: the
    port's lockstep session (device split) against the reference's
    sequential searches fed the host split; at least 7 of 8 match in full.
    The port's sequential engine must give the same splits and match its
    batched engine in all 8."""
    jobs = cluster_fleet(JOBS)
    fleet = [j for j in jobs for _ in range(2)]
    seeds = [s for _ in jobs for s in range(2)]
    got = tune_fleet(fleet, [np.random.default_rng(s) for s in seeds], mode=mode, device="cpu")
    seq = tune_fleet(fleet, [np.random.default_rng(s) for s in seeds], mode=mode, device="cpu",
                     engine="sequential")
    full = full_seq = 0
    for job, s, g, q in zip(fleet, seeds, got, seq):
        rs, _, prof, prio, rest = job_setup(job.name)
        if mode == "cherrypick":
            prio, rest = list(range(len(rs.space))), []
            r = ref_bo.cherrypick_search(rs.space, rs.cost_fn(), np.random.default_rng(s))
            assert g.profile is None
        else:
            r = ref_bo.ruya_search(rs.space, rs.cost_fn(), np.random.default_rng(s), prio, rest)
            assert g.memory_model.category.value == prof.model.category.value
        assert (list(g.priority), list(g.remaining)) == (prio, rest)
        assert (q.priority, q.remaining) == (g.priority, g.remaining)
        pools = [prio, rest] if rest else [prio]
        cap = ref_bo.trial_budget(len(prio), len(rest), ref_bo.BOSettings())
        full += hold(r, g.trace, pools, cap, rs.space, min(3, len(prio)),
                     f"{job.name} {mode} seed {s}").full
        full_seq += compare_traces(q.trace, g.trace,
                                   port_ei_at(rs.space.encoded(), pools, cap, q.trace, "cpu"),
                                   first_bo_step=min(3, len(prio))).full
    assert full >= 7, f"only {full} of 8 traces matched the reference in full"
    assert full_seq == 8, f"only {full_seq} of 8 traces matched across the port's engines"


def test_fleet_entry_points_validate():
    ps = PortSim.for_job("kmeans/spark/bigdata")
    rng = [np.random.default_rng(0)]
    with pytest.raises(ValueError):
        batched_search(ps.space, [ps.normalized], rng, layout="sparse", device="cpu")
    with pytest.raises(ValueError):
        batched_search(ps.space, [ps.normalized], rng * 2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        batched_search(ps.space, [ps.normalized], rng, shard=2, device="cpu")
    job = cluster_fleet(["kmeans/spark/bigdata"])
    with pytest.raises(NotImplementedError, match="item 15"):
        tune_fleet(job, rng, shard=2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        tune_fleet(job, rng, shard=2, engine="sequential", device="cpu")
    with pytest.raises(ValueError):
        tune_fleet(job, rng, engine="vmap", device="cpu")
    with pytest.raises(ValueError):
        tune_fleet(job, rng * 2, device="cpu")


POLICIES = [dict(), dict(max_attempts=7, base_s=0.5, multiplier=3.0, max_backoff_s=10.0,
                         jitter=0.5), dict(max_attempts=1), dict(jitter=0.0, multiplier=1.0)]


@pytest.mark.parametrize("kw", POLICIES)
def test_retry_schedule_equals_reference(kw):
    rp, pp = ref_retry.RetryPolicy(**kw), port_retry.RetryPolicy(**kw)
    for seed in (0, 1, 12345, 2**63 - 1):
        assert port_retry.backoff_schedule(pp, seed) == ref_retry.backoff_schedule(rp, seed)
        for k in range(1, 5):
            assert port_retry.backoff_s(pp, seed, k) == ref_retry.backoff_s(rp, seed, k)


@pytest.mark.parametrize("fails", [0, 2, 3, 6])
def test_call_with_retry_equals_reference(fails):
    """A run that fails transiently ``fails`` times: the same attempts,
    charged backoff, and success or re-raise on both sides."""
    results = []
    for mod, exc in ((ref_retry, RefTransient), (port_retry, PortTransient)):
        calls = [0]

        def fn():
            calls[0] += 1
            if calls[0] <= fails:
                raise exc("flaky")
            return calls[0]

        stats = mod.RetryStats(attempts=0)
        try:
            value, _ = mod.call_with_retry(fn, policy=mod.RetryPolicy(max_attempts=4), seed=9,
                                           transient=(exc,), stats=stats)
        except exc:
            value = "raised"
        results.append((value, stats.attempts, stats.backoff_s))
    assert results[0] == results[1]


def _scaled(run, factor):
    def scaled(size):
        rt, peak = run(size)
        return rt, peak * factor
    return scaled


def test_profile_cache_matches_reference():
    """The 16 paper jobs twice, then scaled-memory variants of four, through
    a reference and a port `ProfileCache` with drift detection: each call's
    signature, hit/miss/drift decision and returned model are equal."""
    keys = sorted(REF_JOBS)
    rc, pc = ref_pc.ProfileCache(), port_pc.ProfileCache()
    calls = [(k, 1.0) for k in keys] * 2 + [(k, f) for k in keys[:4] for f in (1.3, 3.0)]
    for key, factor in calls:
        rs, ps = RefSim.for_job(key), PortSim.for_job(key)
        size = rs.job.input_gb * GiB
        r = rc.get_or_profile(_scaled(rs.profile_run_fn(), factor), size, drift_tolerance=0.1)
        p = pc.get_or_profile(_scaled(ps.profile_run_fn(), factor), size, drift_tolerance=0.1)
        assert pc.last_drift == rc.last_drift, key
        rsig, psig = rc.signature(r.model), pc.signature(p.model)
        assert (psig.category, psig.slope_bucket, psig.intercept_bucket) == (
            rsig.category, rsig.slope_bucket, rsig.intercept_bucket), key
        assert p.model.category.value == r.model.category.value
        assert (p.model.slope, p.model.intercept, p.model.r2) == (
            r.model.slope, r.model.intercept, r.model.r2), key
    assert (pc.hits, pc.misses, pc.drift_reprofiles, len(pc)) == (
        rc.hits, rc.misses, rc.drift_reprofiles, len(rc))
    assert pc.hits >= 16 and pc.probe_time_s == rc.probe_time_s
