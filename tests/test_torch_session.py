"""The port's `TuningSession` against the JAX package's, and its lifecycle.

  * handle transitions, submission order, and a job submitted after steps;
  * warm starts (capacity-aware seeding, class history, a mid-flight
    submission) against the reference session: the seeds exactly equal,
    the traces held under `compare_traces`;
  * determinism, and that a warm-started submission consumes no RNG;
  * `cancel` / `fail` / `preempt` / `preempt_below` mid-flight leave the
    chunk-mates' traces those of an undisturbed run, and retirement
    releases the per-space and per-job state;
  * transient and permanent profiling faults, and `FleetFailedError`;
  * `objective_table` and `SearchOutcome.as_dict` / `from_dict` against the
    reference's JSON;
  * `n512-budgeted` through the port's session.

The reference session computes its §III-D split with
`split_masks_device`, which needs `jax.experimental.enable_x64`, gone from
the installed JAX.  Where a test runs a profiled reference session it puts
the reference's host rule, `split_search_space`, in its place as a mask
(the reference pins the two equal); nothing else of the reference changes.
Each trace comparison states its required number of full matches.
"""

import json
import os
import types
import warnings

import numpy as np
import pytest

import repro.fleet.session as ref_session_mod
from repro.cluster.faults import FaultPlan as RefFaultPlan
from repro.cluster.pricing import spot as ref_spot
from repro.core.search_space import split_search_space as ref_split
from repro.fleet import ProfileCache as RefProfileCache
from repro.fleet import TuningSession as RefSession
from repro.fleet import cluster_fleet as ref_cluster_fleet
from repro.fleet.session import SearchOutcome as RefOutcome
from repro.fleet.session import TrialRecord as RefRecord
from repro.fleet.session import objective_table as ref_objective_table
from repro_torch.cluster.faults import FaultPlan
from repro_torch.cluster.pricing import spot
from repro_torch.core import bayesopt as port_bo
from repro_torch.fleet import (
    FleetFailedError,
    FleetJob,
    ProfileCache,
    SearchOutcome,
    TrialRecord,
    TuningSession,
    cluster_fleet,
    objective_table,
)
from repro_torch.fleet.retry import RetryPolicy, backoff_s
from repro_torch.testing import compare_traces, port_ei_at
from test_torch_search import FIXTURE, _Trace, hold, ref_ei_at, synth_space_table

GOLDEN = os.path.dirname(FIXTURE)


@pytest.fixture
def ref_host_split(monkeypatch):
    """The reference session's split through its host rule (see above)."""
    def host_mask(space, model, input_size, **kw):
        prio, _ = ref_split(space, model, input_size, **kw)
        mask = np.zeros(len(space), bool)
        mask[prio] = True
        return mask

    monkeypatch.setattr(ref_session_mod, "split_masks_device", host_mask)


def as_trace(out):
    """A `SearchOutcome`'s observations (seeds first) as a trace record;
    the registers count packed slots, seeds included."""
    obs = list(out.seeded) + list(out.records)
    return types.SimpleNamespace(
        tried=[r.index for r in obs], costs=[r.cost for r in obs],
        stop_iteration=out.stop_iteration, phase_boundary=out.phase_boundary,
    )


def hold_outcome(ref, got, space, settings, what):
    """Compare two `SearchOutcome`s of one submission: equal splits and warm
    seeds, then the observation sequences under `compare_traces` with the
    reference's EI.  Returns the comparison; a tie end is reported as a
    warning."""
    prio, rest = list(ref.priority), list(ref.remaining)
    assert (list(got.priority), list(got.remaining)) == (prio, rest), what
    assert [r.as_dict() for r in got.seeded] == [r.as_dict() for r in ref.seeded], what
    assert [r.source for r in got.records[:3]] == [r.source for r in ref.records[:3]], what
    pools = [prio, rest] if rest else [prio]
    cap = port_bo.trial_budget(len(prio), len(rest), settings)
    fixed = len(ref.seeded) + sum(r.source == "init" for r in ref.records)
    r_tr = as_trace(ref)
    cmp = compare_traces(r_tr, as_trace(got), ref_ei_at(space.encoded(), pools, cap, r_tr),
                         ei_stop_rel=settings.ei_stop_rel, first_bo_step=fixed)
    if not cmp.full:
        warnings.warn(f"{what}: {cmp.detail} (not counted as a match)")
    return cmp


def cp_session(**kw):
    kw.setdefault("mode", "cherrypick")
    kw.setdefault("device", "cpu")
    return TuningSession(**kw)


def synth_job(name="job", n=90, d=4):
    space, table = synth_space_table(n, d=d)
    return FleetJob(name=name, space=space, cost_table=table)


def test_handle_transitions_and_order():
    session = cp_session(to_exhaustion=True, settings=port_bo.BOSettings(max_iters=5))
    assert session.step() == 0 and session.drain() == [] and len(session) == 0
    with pytest.raises(ValueError):
        session.submit(synth_job())
    with pytest.raises(ValueError):
        session.submit(synth_job(), np.random.default_rng(0), seed=1)
    handles = [session.submit(synth_job(name), seed=i) for i, name in enumerate("xyz")]
    h = handles[0]
    assert h.status == "pending" and not h.done
    with pytest.raises(RuntimeError):
        h.outcome()
    assert session.step() == 3  # budget 5: six steps
    assert h.status == "running"
    outs = session.drain()
    assert [o.name for o in outs] == ["x", "y", "z"]
    assert h.status == "done" and len(h.outcome().records) == 5
    assert [r.source for r in h.outcome().records] == ["init"] * 3 + ["search"] * 2
    assert not h.cancel() and session.step() == 0
    assert session._spaces == {} and session._jobs == {}  # released at retirement


@pytest.mark.parametrize("layout", ["feature", "fused"])
def test_submit_after_step(layout):
    """A job submitted after three steps forms its own chunk and runs the
    trace of a sequential search with its seed (a full match)."""
    job = synth_job()
    space, table = job.space, job.cost_table
    session = cp_session(to_exhaustion=True, layout=layout)
    session.submit(job, seed=0)
    for _ in range(3):
        session.step()
    late = session.submit(FleetJob(name="late", space=space, cost_table=table), seed=7)
    session.drain()
    seq = port_bo.cherrypick_search(space, lambda i: float(table[i]), np.random.default_rng(7),
                                    to_exhaustion=True, layout=layout, device="cpu")
    n = len(space)
    cmp = compare_traces(seq, late.outcome().trace(),
                         port_ei_at(space.encoded(), [list(range(n))], n, seq, "cpu"),
                         first_bo_step=3)
    assert cmp.full, cmp.detail


def run_waves(make_session, fleet, cache):
    """Wave 0 drained cold; wave 1 (new seeds) drained warm; wave 2 half
    submitted, stepped three times, the rest submitted mid-flight."""
    session = make_session(cache=cache, warm_start=True, to_exhaustion=False)
    handles = [session.submit(j, seed=i) for i, j in enumerate(fleet)]
    session.drain()
    handles += [session.submit(j, seed=100 + i) for i, j in enumerate(fleet)]
    session.drain()
    half = len(fleet) // 2
    handles += [session.submit(j, seed=200 + i) for i, j in enumerate(fleet[:half])]
    for _ in range(3):
        session.step()
    handles += [session.submit(j, seed=300 + i) for i, j in enumerate(fleet[half:])]
    session.drain()
    return session, [h.outcome() for h in handles]


WARM_KEYS = ["linregr/spark/huge", "logregr/spark/bigdata", "join/spark/huge",
             "kmeans/spark/bigdata", "naivebayes/spark/huge"]


def test_warm_start_matches_reference(ref_host_split):
    """Five paper jobs (UNCLEAR, FLAT, LINEAR and the extremes fallback) in
    three waves through a session with a `ProfileCache` and warm starts,
    on both sides: the same signatures, cache hits and warm hits.  Outcomes
    are compared in submission order while their class history matched:
    the seeds equal slot for slot and the traces under `compare_traces`.
    A trace ending at a certified tie gives its class another history, so
    that class's later outcomes are reported, not compared.  At least 9
    outcomes match in full."""
    ref_s, ref_outs = run_waves(lambda **kw: RefSession(**kw), ref_cluster_fleet(WARM_KEYS),
                                RefProfileCache())
    got_s, got_outs = run_waves(lambda **kw: TuningSession(device="cpu", **kw),
                                cluster_fleet(WARM_KEYS), ProfileCache())
    assert got_s.warm_hits == ref_s.warm_hits >= 10
    assert (got_s.cache.hits, got_s.cache.misses) == (ref_s.cache.hits, ref_s.cache.misses)
    spaces = {j.name: j.space for j in ref_cluster_fleet(WARM_KEYS)}
    full, tied_classes = 0, set()
    for k, (r, g) in enumerate(zip(ref_outs, got_outs)):
        sig = (g.signature.category, g.signature.slope_bucket, g.signature.intercept_bucket)
        assert sig == (r.signature.category, r.signature.slope_bucket,
                       r.signature.intercept_bucket), k
        if sig in tied_classes:
            warnings.warn(f"{r.name} #{k}: its class history ended at a tie (not compared)")
            continue
        cmp = hold_outcome(r, g, spaces[r.name], port_bo.BOSettings(), f"{r.name} #{k}")
        full += cmp.full
        if not cmp.full:
            tied_classes.add(sig)
    assert full >= 9, f"only {full} of {len(ref_outs)} outcomes matched in full"


def test_capacity_aware_seeding_and_class_history():
    job = cluster_fleet(["join/spark/huge"])[0]
    st = port_bo.BOSettings(max_iters=10)
    session = TuningSession(settings=st, to_exhaustion=True, device="cpu")
    cold = session.submit(job, seed=0)
    session.drain()
    warm = session.submit(job, seed=1)
    other = session.submit(job, seed=2, warm_start=False)
    cp = session.submit(job, seed=3, mode="cherrypick")  # no signature: never seeded
    session.drain()
    c, w = cold.outcome(), warm.outcome()
    assert [s.index for s in w.seeded] == [r.index for r in c.records][: 10 - 3]
    assert len(w.seeded) + len(w.records) <= 10 and w.records[0].source == "search"
    assert not other.outcome().seeded and not cp.outcome().seeded
    assert session.warm_hits == 1 and session.warm_trials == 7


def test_warm_start_is_deterministic_and_consumes_no_rng():
    job = cluster_fleet(["join/spark/huge"])[0]

    def run(seed2):
        session = TuningSession(warm_start=True, device="cpu")
        session.submit(job, seed=0)
        session.drain()
        rng = np.random.default_rng(seed2)
        state = rng.bit_generator.state
        h = session.submit(job, rng)
        assert rng.bit_generator.state == state  # seeded: no draw
        session.drain()
        return h.outcome()

    a, b = run(1), run(999)
    assert a.seeded and a.as_dict() == b.as_dict()
    assert json.dumps(a.as_dict()) == json.dumps(run(1).as_dict())


@pytest.mark.parametrize("layout", ["feature", "fused"])
def test_kills_leave_chunk_mates_unchanged(layout):
    """Eight CherryPick searches in one chunk.  After five steps one is
    cancelled, one failed, one preempted, and `preempt_below` evicts the
    low-ranked one; a pending submission is cancelled before admission.
    The four survivors match the undisturbed run in full; each victim's
    partial record is a prefix of its undisturbed one."""
    job = synth_job()
    st = port_bo.BOSettings(max_iters=14)

    def session_with_fleet():
        s = cp_session(settings=st, to_exhaustion=True, layout=layout)
        hs = [s.submit(job, seed=i, job_priority=(-1 if i == 6 else 0)) for i in range(8)]
        return s, hs

    base, bh = session_with_fleet()
    base.drain()
    s, hs = session_with_fleet()
    for _ in range(5):
        s.step()
    pending = s.submit(job, seed=50)
    assert s.cancel(hs[1]) and s.fail(hs[3], "executor died") and s.preempt(hs[5])
    assert s.preempt_below(0) == [hs[6]]
    assert s.cancel(pending) and pending.outcome().records == []
    assert not s.cancel(hs[1])  # twice: a no-op
    s.drain()
    statuses = {1: "cancelled", 3: "failed", 5: "preempted", 6: "preempted"}
    n = len(job.space)
    for i, (b, h) in enumerate(zip(bh, hs)):
        ref, got = b.outcome(), h.outcome()
        if i in statuses:
            assert got.status == statuses[i] and h.status == statuses[i]
            k = len(got.records)
            assert 3 <= k < len(ref.records)
            assert [r.as_dict() for r in got.records] == [r.as_dict() for r in ref.records[:k]]
            continue
        tr = ref.trace()
        cmp = compare_traces(tr, got.trace(),
                             port_ei_at(job.space.encoded(), [list(range(n))], 14, tr, "cpu"),
                             first_bo_step=3)
        assert cmp.full, (i, cmp.detail)
    assert hs[3].outcome().failure == "executor died"
    assert s._spaces == {} and s._jobs == {}


def test_profiling_faults_match_reference(ref_host_split):
    """Two transient profiling failures are retried (3 attempts, the
    reference's deterministic backoff charged); a permanent failure is a
    "failed" outcome at submit; a drain waiting only on failed jobs raises
    `FleetFailedError`.  Outcomes as the reference's: the failed ones equal
    as JSON, the retried one's fields equal and its trace a full match."""
    keys = ["join/spark/huge", "kmeans/spark/bigdata"]

    def run(mk, fleet_fn, plan_cls):
        plans = {keys[0]: plan_cls(transient_run_failures=2),
                 keys[1]: plan_cls(permanent=True)}
        jobs = fleet_fn(keys, faults=plans)
        session = mk()
        ok = session.submit(jobs[0], seed=0)
        bad = session.submit(jobs[1], seed=0)
        assert bad.done and bad.status == "failed"
        outs = session.drain()  # mixed: no raise
        lone = mk()
        lone.submit(fleet_fn([keys[1]], faults={keys[1]: plan_cls(permanent=True)})[0], seed=1)
        with pytest.raises(Exception) as err:
            lone.drain()
        return ok.outcome(), bad.outcome(), outs, err.value, lone.results()

    r_ok, r_bad, r_outs, r_err, r_lone = run(lambda: RefSession(), ref_cluster_fleet,
                                             RefFaultPlan)
    g_ok, g_bad, g_outs, g_err, g_lone = run(lambda: TuningSession(device="cpu"),
                                             cluster_fleet, FaultPlan)
    assert isinstance(g_err, FleetFailedError) and type(r_err).__name__ == "FleetFailedError"
    assert g_bad.as_dict() == r_bad.as_dict() and g_lone[0].as_dict() == r_lone[0].as_dict()
    assert g_bad.failure.startswith("PermanentRunError")
    assert g_ok.profile_attempts == r_ok.profile_attempts == 3
    seed = TuningSession(device="cpu")._retry_seed(cluster_fleet([keys[0]])[0])
    charged = sum(backoff_s(RetryPolicy(), seed, k) for k in (1, 2))
    assert g_ok.retry_backoff_s == r_ok.retry_backoff_s == charged
    assert [o.name for o in g_outs] == [o.name for o in r_outs]
    space = ref_cluster_fleet([keys[0]])[0].space
    assert hold_outcome(r_ok, g_ok, space, port_bo.BOSettings(), "retried job").full


OBJECTIVES = ["runtime", "cost", {"runtime": 1.0, "cost": 3.0}, (("cost", 2.0),)]


@pytest.mark.parametrize("objective", OBJECTIVES, ids=str)
def test_objective_table_and_priced_outcomes_match_reference(objective):
    """Priced paper jobs (a spot catalog): the score tables exactly equal
    the reference's, and a CherryPick session's priced outcomes (records
    with runtime and dollars, objective and currency) serialize as the
    reference's do, their traces a full match."""
    keys = ["kmeans/spark/bigdata", "join/spark/huge"]
    r_jobs = ref_cluster_fleet(keys, catalog=ref_spot(3), epoch=1)
    g_jobs = cluster_fleet(keys, catalog=spot(3), epoch=1)
    for r, g in zip(r_jobs, g_jobs):
        assert np.array_equal(objective_table(g, objective), ref_objective_table(r, objective))
    ref = RefSession(mode="cherrypick", objective=objective)
    got = TuningSession(mode="cherrypick", objective=objective, device="cpu")
    for r, g in zip(r_jobs, g_jobs):
        ref.submit(r, seed=4)
        got.submit(g, seed=4)
    for r, g, job in zip(ref.drain(), got.drain(), r_jobs):
        rd, gd = r.as_dict(), g.as_dict()
        assert {k: v for k, v in gd.items() if k != "records"} == {
            k: v for k, v in rd.items() if k != "records"}
        assert hold_outcome(r, g, job.space, port_bo.BOSettings(), job.name).full
        assert gd["records"] == rd["records"]
        assert g.pareto() and g.best_usd == r.best_usd


def golden_outcomes():
    """Each committed fixture's outcomes (the files that hold outcomes)."""
    for name in sorted(os.listdir(GOLDEN)):
        if name.endswith(".json"):
            with open(os.path.join(GOLDEN, name)) as f:
                for k, d in enumerate(json.load(f).get("outcomes", [])):
                    yield pytest.param(d, id=f"{name}:{k}")


@pytest.mark.parametrize("d", list(golden_outcomes()))
def test_outcome_json_round_trips_as_the_reference(d):
    """Every committed reference outcome loads through the port's
    `from_dict` and serializes back to the same JSON, as the reference's
    own round trip does; each record likewise."""
    got = SearchOutcome.from_dict(d)
    assert json.dumps(got.as_dict(), sort_keys=True) == json.dumps(d, sort_keys=True)
    assert got.as_dict() == RefOutcome.from_dict(d).as_dict()
    for r in d["records"] + d["seeded"]:
        assert TrialRecord.from_dict(r).as_dict() == RefRecord.from_dict(r).as_dict() == r
    assert got.trace().tried == RefOutcome.from_dict(d).trace().tried


def test_outcome_schema_rejects_what_the_reference_rejects():
    d = {"index": 1, "cost": 1.0, "slot": 0, "source": "guess"}
    with pytest.raises(ValueError):
        TrialRecord.from_dict(d)
    with pytest.raises(ValueError):
        RefRecord.from_dict(d)
    out = {"name": "x", "records": [], "seeded": [], "stop_iteration": None,
           "phase_boundary": None, "priority": [], "remaining": [], "status": "lost"}
    with pytest.raises(ValueError):
        SearchOutcome.from_dict(out)
    with pytest.raises(RuntimeError):
        SearchOutcome.from_dict(dict(out, status="failed")).best_cost


@pytest.mark.parametrize("layout", ["feature", "fused"])
def test_n512_budgeted_fixture_through_the_session(layout):
    """The fixture's seven two-phase Ruya jobs submitted to one session, as
    `tests/golden/scenarios.py` built it (explicit pools, max_iters = 10,
    to exhaustion): at least 5 of 7 traces match the committed records in
    full."""
    with open(FIXTURE) as f:
        outcomes = json.load(f)["outcomes"]
    space, table = synth_space_table(512)
    st = port_bo.BOSettings(max_iters=10)
    prio, rest = list(range(50)), list(range(50, 512))
    session = TuningSession(settings=st, to_exhaustion=True, layout=layout, device="cpu")
    for s in range(len(outcomes)):
        session.submit(FleetJob(name=f"j{s}", space=space, cost_table=table), seed=s,
                       priority=prio, remaining=rest)
    got = session.drain()
    cap = port_bo.trial_budget(len(prio), len(rest), st)
    full = 0
    for s, (ref, g) in enumerate(zip(outcomes, got)):
        assert g.name == ref["name"] and list(g.priority) == ref["priority"]
        full += hold(_Trace(ref), g.trace(), [prio, rest], cap, space, 3, f"n512 j{s}").full
    assert full >= 5, f"only {full} of {len(outcomes)} fixture traces matched in full"


def test_session_rejects_impossible_shard_count():
    """The reference's `test_session_rejects_impossible_shard_count`: more
    shards than CUDA devices raise, naming the count, at construction and
    at `reshard`; a device list that disagrees with ``shard`` raises."""
    import torch

    too_many = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="device"):
        TuningSession(shard=too_many, device="cpu")
    with pytest.raises(ValueError, match="device"):
        TuningSession(device="cpu").reshard(too_many)
    with pytest.raises(ValueError, match="disagrees"):
        TuningSession(shard=3, devices=["cpu", "cpu"], device="cpu")
    assert TuningSession(devices=["cpu", "cpu"], device="cpu").shard_devices == (
        torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        TuningSession(layout="sparse", device="cpu")
    with pytest.raises(ValueError):
        TuningSession(mode="grid", device="cpu")


def test_gather_geometry_released_with_its_last_job():
    """Two jobs over one space share one (n,n) tensor; it stays while either
    is live and goes with the last."""
    job = synth_job(n=60)
    session = cp_session(layout="gather", to_exhaustion=True)
    a = session.submit(job, seed=0)
    b = session.submit(FleetJob(name="b", space=job.space, cost_table=job.cost_table), seed=1)
    session.step()
    (entry,) = session._spaces.values()
    assert entry.count == 2 and tuple(entry.geom[session.device].shape) == (60, 60)
    session.cancel(a)
    assert entry.count == 1 and session._spaces
    session.drain()
    assert session._spaces == {} and b.done
