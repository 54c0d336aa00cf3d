"""The port's async tuning service (`TuningService`) and daemon (`TuningDaemon`).

Port of `tests/test_service.py`, in three layers:

  * Outcomes: `n512-budgeted` through the service held to the committed
    fixture as `test_torch_session.py` holds the session; the other
    scenarios (the n = 69 exhaustion fleet, the warm session, the elastic
    fleet), sharded and unsharded, equal to the port's single-threaded
    lockstep drain, `as_dict()` verbatim; the disturbed elastic fleet
    driven through the service (a pace gate holds every group mid-flight
    while a victim is cancelled and the fleet resharded); and the
    interleaving fuzz, seeded sleeps through the ``pace`` hook, every job
    equal to the lockstep drain.
  * Scheduling: backpressure in both modes, `ProfileCache` shared by 16
    threads and by two services (one miss), placement, worker errors,
    shutdown.
  * The metrics surface and the daemon's snapshot file.

Every test carries the ``service`` marker, so `tests/conftest.py` arms its
60 s watchdog; each finishes in seconds on the CPU, and every wait here has
a timeout.
"""

import hashlib
import json
import os
import threading
import time

import pytest
import torch

from repro_torch.core import bayesopt as port_bo
from repro_torch.core.bayesopt import BOSettings
from repro_torch.fleet import (
    FleetJob,
    ProfileCache,
    ServiceSaturated,
    TuningService,
    TuningSession,
)
from repro_torch.runtime import TuningDaemon
from repro_torch.runtime.serve import ServeLoop
from test_torch_search import FIXTURE, _Trace, hold, synth_space_table
from test_torch_sharding import (
    cpu_devices,
    elastic_job,
    faulty_elastic_jobs,
    flat_profile,
    quad_space,
    quad_table,
    run_elastic_fleet,
    run_warm_session,
    strip,
)

pytestmark = pytest.mark.service


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """These tensors are small: torch's intra-op threads buy nothing here,
    and beside the other test workers their spin-waits slow a step down
    many times over, so this module runs on one (restored after)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SERVICE_KEYS = ("max_in_flight", "saturation", "pace", "devices")


def service(**kw):
    """A service over a CPU session; ``shard=S`` shards it over one CPU
    device named S times (the session is built first: the service's own
    ``devices=`` is its placement of groups)."""
    own = {k: kw.pop(k) for k in SERVICE_KEYS if k in kw}
    return TuningService(session(**kw), **own)


def session(**kw):
    kw.setdefault("device", "cpu")
    shard = kw.pop("shard", None)
    return TuningSession(**kw, **cpu_devices(shard))


def through_service(run, paused=False, **kw):
    """Run ``run(engine)`` with a service as the engine, shut down after.
    ``paused`` parks the workers while a wave is submitted and again after
    each drain, which makes each wave's warm-history snapshots atomic."""
    svc = service(**kw)
    if paused:
        svc.pause()
        drain = svc.drain

        def drain_and_park():
            out = drain()
            svc.pause()
            return out

        svc.drain = drain_and_park
    try:
        return run(svc)
    finally:
        svc.shutdown(drain=False)


# ------------------------------------------------------------ outcomes


def n512(engine):
    """`tests/golden/scenarios.py::run_n512_budgeted` on ``engine``."""
    space, table = synth_space_table(512)
    for s in range(7):
        engine.submit(FleetJob(name=f"j{s}", space=space, cost_table=table), seed=s,
                      priority=list(range(50)), remaining=list(range(50, 512)))
    return engine.drain()


def n69(engine):
    """`tests/golden/scenarios.py::run_n69_exhaustion` on ``engine``."""
    space, table = synth_space_table(69)
    for s in range(4):
        engine.submit(FleetJob(name=f"j{s}", space=space, cost_table=table), seed=s)
    return engine.drain()


@pytest.mark.parametrize("layout", ["feature", "fused"])
def test_n512_budgeted_fixture_through_the_service(layout):
    """The fixture's seven two-phase jobs through the service: at least 5
    of 7 traces match the committed records in full (as through the
    session), and every outcome equals the lockstep drain's."""
    kw = dict(settings=BOSettings(max_iters=10), to_exhaustion=True, layout=layout)
    got = through_service(n512, **kw)
    assert [o.as_dict() for o in got] == [o.as_dict() for o in n512(session(**kw))]
    with open(FIXTURE) as f:
        outcomes = json.load(f)["outcomes"]
    space, _ = synth_space_table(512)
    prio, rest = list(range(50)), list(range(50, 512))
    cap = port_bo.trial_budget(len(prio), len(rest), kw["settings"])
    full = 0
    for s, (ref, g) in enumerate(zip(outcomes, got)):
        assert g.name == ref["name"] and list(g.priority) == ref["priority"]
        full += hold(_Trace(ref), g.trace(), [prio, rest], cap, space, 3, f"n512 j{s}").full
    assert full >= 5, f"only {full} of {len(outcomes)} fixture traces matched in full"


@pytest.mark.parametrize("scenario,shard", [
    ("n512", 2), ("n69", None), ("n69", 2), ("elastic", None), ("elastic", 2),
])
def test_scenario_through_the_service_equals_lockstep(scenario, shard):
    """The golden scenarios through the service, unsharded and over two
    shards: every outcome equals the unsharded lockstep drain's."""
    if scenario == "elastic":
        want = [o.as_dict() for o in run_elastic_fleet()]

        def run(engine):
            for s in range(8):
                engine.submit(elastic_job(f"e{s}", s), seed=s)
            return engine.drain()

        kw = dict(settings=BOSettings(max_iters=12), warm_start=False)
    else:
        run = {"n512": n512, "n69": n69}[scenario]
        kw = (dict(settings=BOSettings(max_iters=10), to_exhaustion=True) if scenario == "n512"
              else dict(mode="cherrypick", to_exhaustion=True))
        want = [o.as_dict() for o in run(session(**kw))]
    shards = []

    def run_and_look(engine):
        shards.append(engine._session.shard_devices)
        return run(engine)

    assert [o.as_dict() for o in through_service(run_and_look, shard=shard, **kw)] == want
    assert shards == [None if shard is None else (torch.device("cpu"),) * shard]


@pytest.mark.parametrize("shard", [None, 3])
def test_warm_session_through_the_service(shard):
    """The warm-session scenario through a paused service (each wave
    submitted while the workers are parked): the lockstep outcomes, seeds
    included."""
    def run(engine):
        space, table, prof = quad_space(), quad_table(), flat_profile()

        def job(name):
            return FleetJob(name=name, space=space, cost_table=table, full_input_size=10e9,
                            profile_result=prof)

        for s in range(3):
            engine.submit(job(f"cold{s}"), seed=s)
        engine.drain()
        for s in range(2):
            engine.submit(job(f"warm{s}"), seed=10 + s)
        for s in range(2):
            engine.submit(job(f"cp{s}"), seed=20 + s, mode="cherrypick")
        engine.drain()
        return engine.results()

    want = [o.as_dict() for o in run_warm_session(None)]
    got = through_service(run, paused=True, shard=shard, warm_start=True)
    assert [o.as_dict() for o in got] == want


@pytest.mark.chaos
def test_disturbed_elastic_fleet_through_the_service():
    """The pace gate parks every group past its third iteration; the victim
    is cancelled and the fleet resharded 2 → 1 while the workers are held;
    then the gate opens and the drain finishes.  Survivors equal the
    undisturbed run, modulo the fault-reporting fields."""
    gate = threading.Event()
    parked = set()
    parked_cv = threading.Condition()

    def pace(key, iteration):
        if gate.is_set() or iteration <= 3:
            return
        with parked_cv:
            parked.add(key)
            parked_cv.notify_all()
        gate.wait(30.0)

    svc = service(shard=2, settings=BOSettings(max_iters=12), warm_start=False, pace=pace)
    try:
        svc.pause()
        handles = [svc.submit(job, seed=s) for s, job in enumerate(faulty_elastic_jobs())]
        victim = svc.submit(elastic_job("victim", 0), seed=99)
        keys = svc._session._pending_group_keys()
        svc.resume()
        deadline = time.monotonic() + 30.0
        with parked_cv:
            while parked != keys:
                assert time.monotonic() < deadline, (parked, keys)
                parked_cv.wait(0.1)
        assert any(ch.n_shards == 2 for ch in svc._session._chunks)
        assert victim.cancel()
        assert svc._session.reshard(shard=None) == 8  # shard loss, mid-flight
        gate.set()
        svc.drain()
    finally:
        gate.set()
        svc.shutdown(drain=False)
    want = [strip(o.as_dict()) for o in run_elastic_fleet()]
    assert [strip(h.outcome().as_dict()) for h in handles] == want
    assert victim.status == "cancelled" and victim.outcome().records


def fuzz_jobs():
    """Three groups with unique names: CherryPick over n = 69, explicit
    two-phase pools over n = 512, profiled Ruya over n = 20."""
    space69, table69 = synth_space_table(69)
    space512, table512 = synth_space_table(512)
    prof = flat_profile()
    jobs = [(FleetJob(name=f"a{s}", space=space69, cost_table=table69), s,
             {"mode": "cherrypick"}) for s in range(4)]
    jobs += [(FleetJob(name=f"b{s}", space=space512, cost_table=table512), 10 + s,
              {"priority": list(range(50)), "remaining": list(range(50, 512))})
             for s in range(4)]
    jobs += [(FleetJob(name=f"c{s}", space=quad_space(), cost_table=quad_table(),
                       full_input_size=10e9, profile_result=prof), 20 + s, {})
             for s in range(4)]
    return jobs


FUZZ_KW = dict(layout="feature", settings=BOSettings(max_iters=10), warm_start=False)


@pytest.fixture(scope="module")
def fuzz_reference():
    ref = session(**FUZZ_KW)
    for job, seed, kw in fuzz_jobs():
        ref.submit(job, seed=seed, **kw)
    return {o.name: o.as_dict() for o in ref.drain()}


@pytest.mark.parametrize("fuzz_seed,shard", [(s, None) for s in range(8)] + [(8, 2), (9, 3)])
def test_any_interleaving_matches_single_threaded(fuzz_reference, fuzz_seed, shard):
    """Seeded adversarial scheduling: the pace hook sleeps 0-7 ms, drawn
    from a hash of (seed, group, iteration), skewing the three groups'
    progress differently per seed, with submissions racing the workers'
    admission loops.  Every job's `as_dict()` equals the single-threaded
    lockstep drain's."""
    def pace(key, iteration):
        h = hashlib.sha256(f"{fuzz_seed}/{key}/{iteration}".encode()).digest()
        time.sleep((h[0] % 8) * 0.001)

    svc = service(pace=pace, shard=shard, **FUZZ_KW)
    try:
        handles = [svc.submit(job, seed=seed, **kw) for job, seed, kw in fuzz_jobs()]
        got = {o.name: o.as_dict() for o in svc.drain()}
    finally:
        svc.shutdown(drain=False)
    assert got == fuzz_reference
    assert all(h.status == "done" for h in handles)


def test_concurrent_submitters_stress(fuzz_reference):
    """Twelve submitter threads (more than the cores) race the workers with
    the interpreter switching threads every 10 µs: no submission and no
    completion is lost (the in-flight count returns to 0, the counters
    equal the jobs) and every job equals the lockstep drain's."""
    import sys

    jobs = fuzz_jobs()
    svc = service(**FUZZ_KW)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        barrier = threading.Barrier(len(jobs))
        errors = []

        def submit(job, seed, kw):
            try:
                barrier.wait(timeout=30.0)
                svc.submit(job, seed=seed, **kw)
            except BaseException as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=submit, args=a) for a in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
            assert not t.is_alive()
        assert not errors
        got = {o.name: o.as_dict() for o in svc.drain()}
        m = svc.metrics()
    finally:
        sys.setswitchinterval(interval)
        svc.shutdown(drain=False)
    assert got == fuzz_reference
    assert (m["submitted"], m["completed"], m["in_flight"]) == (len(jobs), len(jobs), 0)
    assert sum(g["admitted"] for g in m["groups"].values()) == len(jobs)


# ---------------------------------------------------------- scheduling


def cp_job(name, n=69):
    space, table = synth_space_table(n)
    return FleetJob(name=name, space=space, cost_table=table)


def test_saturation_raise():
    svc = service(max_in_flight=2, saturation="raise", **FUZZ_KW)
    try:
        svc.pause()  # nothing completes, so the cap binds
        for s in range(2):
            svc.submit(cp_job(f"j{s}"), seed=s, mode="cherrypick")
        with pytest.raises(ServiceSaturated):
            svc.submit(cp_job("j2"), seed=2, mode="cherrypick")
        outs = svc.drain()  # resumes and finishes the two admitted jobs
    finally:
        svc.shutdown(drain=False)
    assert [o.name for o in outs] == ["j0", "j1"]


def test_saturation_block_parks_submitter_until_capacity():
    svc = service(max_in_flight=1, **FUZZ_KW)
    try:
        svc.pause()
        svc.submit(cp_job("first"), seed=0, mode="cherrypick")
        second_done = threading.Event()

        def blocked_submit():
            svc.submit(cp_job("second"), seed=1, mode="cherrypick")
            second_done.set()

        t = threading.Thread(target=blocked_submit, daemon=True)
        t.start()
        time.sleep(0.2)
        assert not second_done.is_set()  # "first" cannot finish while paused
        svc.resume()  # "first" completes, capacity frees, the submit returns
        assert second_done.wait(timeout=30.0)
        t.join(timeout=10.0)
        svc.drain()
    finally:
        svc.shutdown(drain=False)
    assert sorted(o.name for o in svc.results()) == ["first", "second"]


def test_validation():
    with pytest.raises(ValueError):
        service(max_in_flight=0)
    with pytest.raises(ValueError):
        service(saturation="drop")
    with pytest.raises(ValueError):
        TuningService(TuningSession(device="cpu"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TuningService()  # the card by default: refused without one


def test_concurrent_get_or_profile_single_class():
    """16 threads racing one empty cache with same-class jobs: one miss, 15
    hits, every thread the one shared profile."""
    cache = ProfileCache()
    n_threads = 16
    barrier = threading.Barrier(n_threads)
    results, errors = [], []

    def run_fn(sample_bytes):
        time.sleep(0.001)  # widen the probe window
        return sample_bytes * 5e-7, 0.9 * sample_bytes + 1e9

    def worker():
        try:
            barrier.wait(timeout=30.0)
            results.append(cache.get_or_profile(run_fn, 10e9))
        except BaseException as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not errors and len(results) == n_threads
    assert (cache.misses, cache.hits) == (1, n_threads - 1)
    assert all(r is results[0] for r in results)


def test_shared_cache_across_concurrent_services():
    """Two services submitting same-class profiled jobs concurrently through
    one cache: one full profile run in all."""
    cache = ProfileCache()

    def run_fn(sample_bytes):
        return sample_bytes * 5e-7, 0.8 * sample_bytes + 1e9

    svcs = [service(cache=cache, settings=BOSettings(max_iters=8), warm_start=False)
            for _ in range(2)]
    try:
        barrier = threading.Barrier(2)

        def drive(svc, tag):
            barrier.wait(timeout=30.0)
            for s in range(3):
                svc.submit(FleetJob(name=f"{tag}{s}", space=quad_space(), cost_table=quad_table(),
                                    full_input_size=10e9, profile_run=run_fn), seed=s)
            svc.drain()

        threads = [threading.Thread(target=drive, args=(svc, tag), daemon=True)
                   for svc, tag in zip(svcs, "xy")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=45.0)
            assert not t.is_alive()
    finally:
        for svc in svcs:
            svc.shutdown(drain=False)
    assert (cache.misses, cache.hits) == (1, 5)


def test_placement_round_robin_and_sharded_sessions_ignore_it():
    """Groups go round-robin over ``devices`` ("auto" on the CPU is the
    session's device); a sharded session keeps its bundles' devices."""
    auto = service(**FUZZ_KW)
    assert auto._devices == [torch.device("cpu")]
    auto.shutdown(drain=False)
    svc = service(devices=["cpu", "cpu"], **FUZZ_KW)
    try:
        for job, seed, kw in fuzz_jobs():
            svc.submit(job, seed=seed, **kw)
        svc.drain()
        groups = svc.metrics()["groups"]
    finally:
        svc.shutdown(drain=False)
    assert len(groups) == 3 and {g["device"] for g in groups.values()} == {"cpu"}
    sharded = service(shard=2, devices=["cpu"] * 3, **FUZZ_KW)
    assert sharded._devices == [] and len(sharded._session.shard_devices) == 2
    sharded.shutdown(drain=False)


def test_worker_error_surfaces_in_drain():
    def pace(key, iteration):
        raise OSError("executor lost")

    svc = service(pace=pace, **FUZZ_KW)
    try:
        svc.submit(cp_job("j0"), seed=0, mode="cherrypick")
        with pytest.raises(RuntimeError, match="executor lost"):
            svc.drain()
    finally:
        svc.shutdown(drain=False)


def test_shutdown_without_drain_keeps_finished_results():
    svc = service(**FUZZ_KW)
    svc.submit(cp_job("j0"), seed=0, mode="cherrypick")
    svc.drain()
    svc.shutdown(drain=False)
    assert [o.name for o in svc.results()] == ["j0"]
    with pytest.raises(RuntimeError):
        svc.submit(cp_job("j1"), seed=1, mode="cherrypick")
    assert svc.shutdown(drain=True) == []  # idempotent


def test_context_manager_drains_on_a_clean_exit():
    with service(**FUZZ_KW) as svc:
        h = svc.submit(cp_job("j0"), seed=0, mode="cherrypick")
    assert h.status == "done" and svc._halt


# ------------------------------------------------------------- metrics


def test_metrics_schema_and_counters():
    svc = service(max_in_flight=8, **FUZZ_KW)
    try:
        for s in range(3):
            svc.submit(cp_job(f"j{s}"), seed=s, mode="cherrypick")
        svc.drain()
        m = svc.metrics()
    finally:
        svc.shutdown(drain=False)
    json.dumps(m)  # the whole surface is JSON-able
    assert (m["submitted"], m["completed"], m["in_flight"], m["queue_depth"]) == (3, 3, 0, 0)
    assert m["statuses"] == {"converged": 3} and m["jobs_per_sec"] > 0
    assert m["faults"] == {"profile_attempts_total": 3, "profile_retries_total": 0,
                           "retry_backoff_s_total": 0.0, "straggler_trials": 0}
    (g,) = m["groups"].values()  # one admission group
    assert g["iterations"] > 0 and g["steps"] > 0
    assert g["mean_step_s"] > 0 and g["last_step_s"] > 0
    assert g["admitted"] == 3 and g["live_chunks"] == 0 and g["device"] == "cpu"


def test_zero_job_snapshot_has_no_rate():
    svc = service(**FUZZ_KW)
    try:
        m = svc.metrics()
    finally:
        svc.shutdown(drain=False)
    json.dumps(m)
    assert m["submitted"] == m["completed"] == 0 and m["jobs_per_sec"] is None


def test_one_job_snapshot_has_no_rate():
    """One completion's window is that job's latency: no rate."""
    svc = service(**FUZZ_KW)
    try:
        svc.submit(cp_job("only"), seed=0, mode="cherrypick")
        svc.drain()
        m = svc.metrics()
    finally:
        svc.shutdown(drain=False)
    json.dumps(m)
    assert m["completed"] == 1 and m["statuses"] == {"converged": 1}
    assert m["jobs_per_sec"] is None


def test_fault_counters_aggregate_from_outcomes():
    svc = service(settings=BOSettings(max_iters=12), warm_start=False)
    try:
        svc.submit(faulty_elastic_jobs()[0], seed=0)  # two transient faults
        svc.submit(elastic_job("clean", 1), seed=1)
        svc.drain()
        m = svc.metrics()
    finally:
        svc.shutdown(drain=False)
    assert m["faults"]["profile_attempts_total"] == 4  # 3 + 1
    assert m["faults"]["profile_retries_total"] == 2
    assert m["faults"]["retry_backoff_s_total"] > 0


def test_daemon_snapshots_metrics_json(tmp_path):
    path = tmp_path / "tuning_metrics.json"
    with TuningDaemon(metrics_path=str(path), snapshot_every_s=0.05, device="cpu",
                      **FUZZ_KW) as daemon:
        for s in range(2):
            daemon.submit(cp_job(f"j{s}"), seed=s, mode="cherrypick")
        outs = daemon.drain()
        assert [o.name for o in outs] == ["j0", "j1"]
        deadline = time.monotonic() + 10.0
        while not path.exists():  # the snapshot thread writes on its own
            assert time.monotonic() < deadline
            time.sleep(0.01)
    payload = json.loads(path.read_text())  # stop() flushed a final snapshot
    assert payload["completed"] == 2 and payload["in_flight"] == 0
    assert "snapshot_unix_s" in payload and payload["groups"]
    assert not os.path.exists(f"{path}.tmp")
    assert daemon.snapshot() == str(path) and TuningDaemon(service(**FUZZ_KW)).snapshot() is None
    assert ServeLoop.__module__ == "repro_torch.runtime.decode_loop"
    with pytest.raises(ValueError):
        TuningDaemon(service(**FUZZ_KW), device="cpu")
