"""The port's job-axis sharding (`repro_torch.fleet.sharding`) and `reshard`.

  * Shard invariance (`tests/test_sharded_fleet.py`'s suite): mixes of two
    space shapes and mixed packed capacities drained through an unsharded
    session and through sessions sharded over S = 2, 3 and 4 devices, every
    outcome's `as_dict()` equal, verbatim.  torch has one CPU device, so
    the shards are one device named S times (``devices=["cpu"] * S``),
    which runs the bundle code as on S cards.  Hypothesis lane where the
    package is installed, seeded lane always.
  * `resolve_shard_devices`'s unit cases, with the CUDA counts
    monkeypatched.
  * The disturbed elastic fleet (a port copy of
    `tests/golden/scenarios.py::run_elastic_fleet_disturbed`): transient
    profiling faults, a victim cancelled mid-flight, then a live
    `reshard`, in both directions; the survivors equal the undisturbed run.
  * The port's unsharded drain held to the reference's `TuningSession` on
    explicit-pool fleets and on `cost_table` fleets (CherryPick over paper
    jobs) under `compare_traces`: the reference's own sharded lanes fail on
    the installed JAX (`shard_map`'s scan carry), so the sharded runs are
    held bit for bit to the port's unsharded one, and that one to the
    reference.

The scenario builders here (`quad_space`, `flat_profile`, `elastic_job`,
...) are port copies of `tests/golden/scenarios.py`'s, which builds the
reference's jobs; `tests/test_torch_service.py` imports them.
"""

import warnings

import numpy as np
import pytest
import torch

from hypothesis_compat import HAVE_HYPOTHESIS, given, settings as hyp_settings, st

from repro.core.bayesopt import BOSettings as RefSettings
from repro.core.search_space import Configuration as RefConfiguration
from repro.core.search_space import SearchSpace as RefSpace
from repro.fleet import FleetJob as RefJob
from repro.fleet import TuningSession as RefSession
from repro.fleet import cluster_fleet as ref_cluster_fleet
from repro_torch.cluster.faults import FaultPlan
from repro_torch.core import bayesopt as port_bo
from repro_torch.core.bayesopt import BOSettings
from repro_torch.core.memory_model import fit_memory_model
from repro_torch.core.profiler import ProfileResult
from repro_torch.core.search_space import Configuration, SearchSpace
from repro_torch.fleet import FleetJob, TuningSession, cluster_fleet, resolve_shard_devices
from repro_torch.fleet import sharding
from test_torch_search import ref_ei_at, synth_space_table

GiB = 1024.0**3
FAULT_FIELDS = ("profile_attempts", "retry_backoff_s")  # tests/test_golden_traces.py's


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """These tensors are small: torch's intra-op threads buy nothing here,
    and beside the other test workers their spin-waits slow a step down
    many times over, so this module runs on one (restored after)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cpu_devices(shard):
    """``shard`` as the session's keywords: one CPU device named S times."""
    return {} if shard is None else {"devices": ["cpu"] * shard}


# ---------------------------------------------------------------- scenarios
# Port copies of `tests/golden/scenarios.py`'s builders (same draws).


def flat_profile():
    model = fit_memory_model([1e9, 2e9, 3e9], [5e9, 5e9, 5e9])
    return ProfileResult(sizes=(1e9, 2e9, 3e9), readings=(5e9,) * 3, total_time_s=1.0,
                         calibration_runs=1, model=model)


def quad_space(n=20):
    return SearchSpace([Configuration(name=f"c{i}", features=(float(i),),
                                      total_memory=float(i) * GiB) for i in range(n)])


def quad_table(n=20, optimum=9):
    return np.array([1.0 + 0.05 * (i - optimum) ** 2 for i in range(n)])


def _linear_run(slope, runtime_per_byte=5e-7):
    """Deterministic profiling emulator: peak memory exactly linear, so a
    retried run returns the identical model."""
    def run(sample_bytes):
        return sample_bytes * runtime_per_byte, slope * sample_bytes + 1e9

    return run


def elastic_job(name, idx):
    """Two memory classes, alternating (scenarios.py's `_elastic_job`)."""
    return FleetJob(name=name, space=quad_space(), cost_table=quad_table(),
                    full_input_size=10e9, profile_run=_linear_run(0.8 if idx % 2 == 0 else 1.2))


def run_elastic_fleet(shard=None):
    """The undisturbed run: 8 two-class Ruya jobs, profiled, drained."""
    session = TuningSession(settings=BOSettings(max_iters=12), warm_start=False, device="cpu",
                            **cpu_devices(shard))
    for s in range(8):
        session.submit(elastic_job(f"e{s}", s), seed=s)
    return session.drain()


def faulty_elastic_jobs():
    """The eight jobs with transient profiling faults on e0 and e3."""
    jobs = []
    for s in range(8):
        job = elastic_job(f"e{s}", s)
        if s in (0, 3):
            job.profile_run = FaultPlan(seed=s, transient_run_failures=2).wrap_run(
                job.profile_run, job.name)
        jobs.append(job)
    return jobs


def run_elastic_fleet_disturbed(shard=2, reshard_to=None, steps_before=3):
    """scenarios.py's adversarial replay: faults on e0 and e3, a ninth
    victim job cancelled after ``steps_before`` steps, then a live
    `reshard` from ``shard`` devices to ``reshard_to``.  Returns (survivor
    outcomes in submission order, victim outcome, jobs re-bundled)."""
    session = TuningSession(settings=BOSettings(max_iters=12), warm_start=False, device="cpu",
                            **cpu_devices(shard))
    handles = [session.submit(job, seed=s) for s, job in enumerate(faulty_elastic_jobs())]
    victim = session.submit(elastic_job("victim", 0), seed=99)
    for _ in range(steps_before):
        session.step()
    assert victim.cancel()
    moved = session.reshard(**({"devices": ["cpu"] * reshard_to} if reshard_to else {}))
    assert session.shard_devices == (None if reshard_to is None else (torch.device("cpu"),) * reshard_to)
    session.drain()
    return [h.outcome() for h in handles], victim.outcome(), moved


def run_warm_session(shard=None):
    """scenarios.py's `run_warm_session`: a cold profiled wave drained, then
    warm starts sharing chunks with cold CherryPick jobs, drained."""
    space, table, prof = quad_space(), quad_table(), flat_profile()

    def job(name):
        return FleetJob(name=name, space=space, cost_table=table, full_input_size=10e9,
                        profile_result=prof)

    session = TuningSession(warm_start=True, to_exhaustion=False, device="cpu",
                            **cpu_devices(shard))
    for s in range(3):
        session.submit(job(f"cold{s}"), seed=s)
    session.drain()
    for s in range(2):
        session.submit(job(f"warm{s}"), seed=10 + s)
    for s in range(2):
        session.submit(job(f"cp{s}"), seed=20 + s, mode="cherrypick")
    session.drain()
    return session.results()


def strip(d, fields=FAULT_FIELDS):
    return {k: v for k, v in d.items() if k not in fields}


# ---------------------------------------------------------- shard invariance

N_SPACES = ((12, 3), (18, 5))  # (n, d): two shapes so groups really mix


def _spaces_tables(space_cls=SearchSpace, config_cls=Configuration):
    out = []
    for n, d in N_SPACES:
        rng = np.random.default_rng(n * 7 + d)
        feats = rng.normal(size=(n, d))
        space = space_cls([config_cls(name=f"s{i}", features=tuple(float(v) for v in feats[i]),
                                      total_memory=float(i)) for i in range(n)])
        z = feats @ rng.normal(size=d)
        z = (z - z.mean()) / max(float(z.std()), 1e-9)
        out.append((space, 1.0 + (z - 0.7) ** 2 + 0.05 * rng.random(n)))
    return out


SPACES = _spaces_tables()
SETTINGS = BOSettings(max_iters=6)


def _drain_mix(mix, shard):
    """mix: [(space index, pool size, seed)]: outcome dicts in submission
    order.  A pool size below n gives the jobs of one session different
    packed capacities B = min(pool, max_iters)."""
    session = TuningSession(mode="cherrypick", to_exhaustion=True, settings=SETTINGS,
                            device="cpu", **cpu_devices(shard))
    handles = [
        session.submit(FleetJob(name=f"m{k}", space=SPACES[si][0], cost_table=SPACES[si][1]),
                       seed=seed, priority=list(range(pool)))
        for k, (si, pool, seed) in enumerate(mix)
    ]
    session.drain()
    return [h.outcome().as_dict() for h in handles]


def _seeded_mixes(seed, count=4, max_jobs=12):
    rng = np.random.default_rng(seed)
    return [
        [(int(rng.integers(0, len(SPACES))), int(rng.integers(4, 7)), int(rng.integers(0, 10**6)))
         for _ in range(int(rng.integers(1, max_jobs)))]
        for _ in range(count)
    ]


if HAVE_HYPOTHESIS:

    @given(
        mix=st.lists(st.tuples(st.integers(0, len(SPACES) - 1), st.integers(4, 6),
                               st.integers(0, 10**6)), min_size=1, max_size=9),
        shard=st.sampled_from((2, 3, 4)),
    )
    @hyp_settings(max_examples=8, deadline=None)
    def test_random_mix_shard_invariant_hypothesis(mix, shard):
        assert _drain_mix(mix, shard) == _drain_mix(mix, None)


@pytest.mark.parametrize("shard", [2, 3, 4])
def test_random_mix_shard_invariant_seeded(shard):
    """Four seeded mixes of up to 11 jobs over both shapes and three
    capacities: every outcome at S shards equals the unsharded one."""
    for mix in _seeded_mixes(4242 + shard):
        assert _drain_mix(mix, shard) == _drain_mix(mix, None), (shard, mix)


def test_chunk_splits_are_inert():
    """An odd group at S = 2 splits into shards of 2 and 1 rows (no dummy
    row): every job equals both the unsharded run and its own solo
    session."""
    mix = [(0, 5, 11), (0, 5, 22), (0, 5, 33)]
    ref = _drain_mix(mix, None)
    assert _drain_mix(mix, 2) == ref
    for k, (si, pool, seed) in enumerate(mix):
        solo = _drain_mix([(si, pool, seed)], None)[0]
        solo["name"] = ref[k]["name"]  # submission-order names differ
        assert solo == ref[k]


@pytest.mark.parametrize("jobs,shard,want", [
    (19, 2, [(2, [8, 8]), (1, [3])]),  # rows 8: a bundle of 16, a leftover chunk of 3
    (7, 4, [(4, [2, 2, 2, 1])]),  # rows 2: four shards, the last shorter
    (3, 3, [(2, [2, 1])]),  # rows 2 (the reference's minimum): two shards
    (20, 3, [(3, [7, 7, 6])]),  # rows ceil(20/3) = 7
])
def test_bundle_layout_follows_the_reference_rule(jobs, shard, want):
    """Rows = min(8, max(2, ceil(M/S))), S chunks a bundle, each shard on
    its device and holding exactly its members; K1's path (the fused
    layout) steps each shard once a bundle step; outcomes equal the
    unsharded run's."""
    space, table = SPACES[0]
    outs = {}
    for s in (None, shard):
        session = TuningSession(mode="cherrypick", to_exhaustion=True, settings=SETTINGS,
                                layout="fused", device="cpu", **cpu_devices(s))
        hs = [session.submit(FleetJob(name=f"j{k}", space=space, cost_table=table), seed=k)
              for k in range(jobs)]
        session.step()
        if s is not None:
            got = [(ch.n_shards, [len(st.t) for st in ch.shards()]) for ch in session._chunks]
            assert got == want
            assert all(len(ch.members) == sum(rows) for ch, (_, rows) in zip(session._chunks, got))
        session.drain()
        outs[s] = [h.outcome().as_dict() for h in hs]
    assert outs[shard] == outs[None]


def test_sharded_update_counts_one_update_per_shard(monkeypatch):
    """A bundle step is one `_fleet_update` per shard, on that shard's
    state (the counting seam `chip_smoke.py` uses)."""
    calls = []
    real = sharding._fleet_update

    def counted(state, *args, **kw):
        calls.append(len(state.t))
        return real(state, *args, **kw)

    monkeypatch.setattr(sharding, "_fleet_update", counted)
    space, table = SPACES[1]
    session = TuningSession(mode="cherrypick", settings=SETTINGS, device="cpu",
                            **cpu_devices(3))
    for k in range(5):
        session.submit(FleetJob(name=f"j{k}", space=space, cost_table=table), seed=k)
    session.step()
    assert calls == [2, 2, 1]
    with pytest.raises(ValueError, match="3 shards"):
        sharding.sharded_update([torch.device("cpu")] * 3, 0.0, "feature")([], [])


def test_warm_and_cold_neighbors_shard_invariant():
    """Warm seeding composes with sharding: a seeded job sharing a bundle
    with cold jobs reproduces the unsharded session's outcomes exactly,
    seeds included."""
    ref = [o.as_dict() for o in run_warm_session(None)]
    assert any(o["seeded"] for o in ref)
    assert [o.as_dict() for o in run_warm_session(3)] == ref


# ------------------------------------------------------------- resolution


@pytest.fixture
def cards(monkeypatch):
    """Set the number of visible CUDA devices."""
    def set_count(k):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: k)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: k > 0)

    return set_count


def test_default_is_unsharded(cards):
    cards(4)
    assert resolve_shard_devices() is None
    assert resolve_shard_devices(1) is None
    assert resolve_shard_devices(None, None, "cpu") is None


def test_auto_uses_visible_cards_on_the_card_only(cards):
    cards(4)
    assert resolve_shard_devices("auto") == tuple(torch.device("cuda", i) for i in range(4))
    assert resolve_shard_devices("auto", device="cuda:0") is not None
    assert resolve_shard_devices("auto", device="cpu") is None  # one CPU device
    cards(1)
    assert resolve_shard_devices("auto") is None
    cards(0)
    assert resolve_shard_devices("auto", device="cpu") is None


def test_explicit_count(cards):
    cards(2)
    assert resolve_shard_devices(2) == (torch.device("cuda", 0), torch.device("cuda", 1))
    cards(3)
    assert len(resolve_shard_devices(2, device="cpu")) == 2  # CUDA devices, whatever the session


def test_too_many_shards_fails_loudly(cards):
    cards(2)
    with pytest.raises(ValueError, match="only 2 CUDA device"):
        resolve_shard_devices(3)
    cards(0)
    with pytest.raises(ValueError, match="only 0 CUDA device"):
        resolve_shard_devices(2, device="cpu")
    with pytest.raises(ValueError):
        resolve_shard_devices(0)


def test_explicit_devices_win(cards):
    cards(0)
    assert resolve_shard_devices(devices=["cpu"]) is None  # one device: unsharded
    two = resolve_shard_devices(devices=["cpu", "cpu"])
    assert two == (torch.device("cpu"),) * 2  # a device may repeat
    assert resolve_shard_devices("auto", ["cpu"] * 3) == (torch.device("cpu"),) * 3
    with pytest.raises(ValueError, match="disagrees"):
        resolve_shard_devices(shard=3, devices=["cpu", "cpu"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_shard_devices(devices=["cuda:0", "cuda:0"])  # no card: refused
    cards(1)
    assert resolve_shard_devices(devices=["cuda:0"] * 2) == (torch.device("cuda", 0),) * 2


# ------------------------------------------------------ elastic and churn


@pytest.fixture(scope="module")
def undisturbed():
    return [o.as_dict() for o in run_elastic_fleet()]


@pytest.mark.parametrize("shard,reshard_to", [(2, None), (None, 2), (2, 4)],
                         ids=["shard-loss", "join", "widen"])
def test_disturbed_elastic_fleet_survivors_match(undisturbed, shard, reshard_to):
    """Faults on two jobs (retried: identical profiles), a victim cancelled
    after three steps, then a live `reshard`: the eight survivors equal the
    undisturbed unsharded run, modulo the fault-reporting fields; the
    victim keeps its partial trials."""
    survivors, victim, moved = run_elastic_fleet_disturbed(shard, reshard_to)
    assert moved == 8
    assert [strip(o.as_dict()) for o in survivors] == [strip(d) for d in undisturbed]
    assert [o.profile_attempts for o in survivors] == [3, 1, 1, 3, 1, 1, 1, 1]
    assert victim.status == "cancelled" and len(victim.records) == 3


def test_sharded_elastic_fleet_equals_unsharded(undisturbed):
    assert [o.as_dict() for o in run_elastic_fleet(2)] == undisturbed


def test_kill_in_a_bundle_latches_its_shard():
    """A mid-flight cancel of the first row of a bundle's second shard:
    that row freezes, its partial trials are a prefix of the undisturbed
    run's, and every other job is unchanged."""
    space, table = SPACES[1]

    def run(cancel):
        session = TuningSession(mode="cherrypick", to_exhaustion=True, settings=SETTINGS,
                                device="cpu", **cpu_devices(2))
        hs = [session.submit(FleetJob(name=f"j{k}", space=space, cost_table=table), seed=k)
              for k in range(6)]
        for _ in range(4):
            session.step()
        if cancel:
            (ch,) = session._chunks
            assert ch.n_shards == 2 and not bool(ch.state[1].done[0])
            assert session.cancel(hs[3])
            assert bool(ch.state[1].done[0]) and ch.members[3] is None
        session.drain()
        return [h.outcome().as_dict() for h in hs]

    base, got = run(False), run(True)
    assert got[3]["status"] == "cancelled" and 0 < len(got[3]["records"]) < len(base[3]["records"])
    assert got[3]["records"] == base[3]["records"][: len(got[3]["records"])]
    assert [d for k, d in enumerate(got) if k != 3] == [d for k, d in enumerate(base) if k != 3]


def test_gather_geometry_per_device_released_with_its_last_job():
    """A bundle over two CPU names of one space: the geometry is cached once
    per device key and released with the space's last job."""
    space, table = SPACES[0]
    session = TuningSession(mode="cherrypick", layout="gather", settings=SETTINGS,
                            device="cpu", devices=["cpu", "cpu"])
    for k in range(4):
        session.submit(FleetJob(name=f"j{k}", space=space, cost_table=table), seed=k)
    session.step()
    (entry,) = session._spaces.values()
    assert list(entry.geom) == [torch.device("cpu")]
    assert tuple(entry.geom[torch.device("cpu")].shape) == (12, 12)
    session.drain()
    assert session._spaces == {}


# ------------------------------------------------------- against the reference


def ref_spaces_tables():
    return _spaces_tables(RefSpace, RefConfiguration)


def hold_all(ref_outs, got_outs, encs, pools, caps, what):
    """Count full matches of port outcomes against reference ones."""
    from repro_torch.testing import compare_traces

    full = 0
    for k, (r, g) in enumerate(zip(ref_outs, got_outs)):
        assert g.name == r.name and list(g.priority) == list(r.priority), (what, k)
        r_tr, g_tr = r.trace(), g.trace()
        cmp = compare_traces(r_tr, g_tr, ref_ei_at(encs[k], pools[k], caps[k], r_tr),
                             first_bo_step=sum(x.source == "init" for x in r.records))
        if not cmp.full:
            warnings.warn(f"{what} {r.name}: {cmp.detail} (not counted as a match)")
        full += cmp.full
    return full


@pytest.mark.parametrize("shard", [2, 4])
def test_explicit_pool_fleet_matches_reference(shard):
    """`n512-budgeted`'s seven two-phase jobs with explicit pools, and the
    mixed-shape CherryPick mix: the reference's unsharded session against
    the port's unsharded drain under `compare_traces` (at least 8 of the 10
    traces in full), and the port's sharded drain equal to its unsharded
    one, verbatim."""
    st = port_bo.BOSettings(max_iters=10)
    prio, rest = list(range(50)), list(range(50, 512))
    space, table = synth_space_table(512)
    from golden.scenarios import synth_space_table as ref_synth

    r_space, r_table = ref_synth(512)
    mix = [(0, 5, 3), (1, 6, 4), (0, 12, 5)]
    r_sp = ref_spaces_tables()

    ref = RefSession(settings=RefSettings(max_iters=10), to_exhaustion=True)
    for s in range(7):
        ref.submit(RefJob(name=f"j{s}", space=r_space, cost_table=r_table), seed=s,
                   priority=prio, remaining=rest)
    ref_mix = RefSession(mode="cherrypick", to_exhaustion=True, settings=RefSettings(max_iters=6))
    for k, (si, pool, seed) in enumerate(mix):
        ref_mix.submit(RefJob(name=f"m{k}", space=r_sp[si][0], cost_table=r_sp[si][1]),
                       seed=seed, priority=list(range(pool)))

    def port(s):
        session = TuningSession(settings=st, to_exhaustion=True, device="cpu", **cpu_devices(s))
        for j in range(7):
            session.submit(FleetJob(name=f"j{j}", space=space, cost_table=table), seed=j,
                           priority=prio, remaining=rest)
        return session.drain()

    got = port(None)
    assert [o.as_dict() for o in port(shard)] == [o.as_dict() for o in got]
    assert _drain_mix(mix, shard) == _drain_mix(mix, None)
    mix_sess = TuningSession(mode="cherrypick", to_exhaustion=True, settings=SETTINGS, device="cpu")
    for k, (si, pool, seed) in enumerate(mix):
        mix_sess.submit(FleetJob(name=f"m{k}", space=SPACES[si][0], cost_table=SPACES[si][1]),
                        seed=seed, priority=list(range(pool)))
    cap = port_bo.trial_budget(50, 462, st)
    full = hold_all(ref.drain(), got, [space.encoded()] * 7, [[prio, rest]] * 7, [cap] * 7, "n512")
    full += hold_all(ref_mix.drain(), mix_sess.drain(),
                     [SPACES[si][0].encoded() for si, _, _ in mix],
                     [[list(range(pool))] for _, pool, _ in mix],
                     [port_bo.trial_budget(pool, 0, SETTINGS) for _, pool, _ in mix], "mix")
    assert full >= 8, f"only {full} of 10 traces matched the reference in full"


def test_cost_table_fleet_matches_reference():
    """CherryPick over two paper jobs (their cost tables), seeds 0-2, the
    paper's stop criterion (exhaustion traces end among candidates whose EI
    underflows, ROADMAP Queue 3): the reference's unsharded session against
    the port's unsharded drain (at least 5 of 6 in full), the port's drain
    at S = 2 equal to its unsharded one."""
    keys = ["kmeans/spark/bigdata", "join/spark/huge"]
    ref = RefSession(mode="cherrypick")
    for job in ref_cluster_fleet(keys):
        for s in range(3):
            ref.submit(job, seed=s)

    def port(s):
        session = TuningSession(mode="cherrypick", device="cpu", **cpu_devices(s))
        for job in cluster_fleet(keys):
            for seed in range(3):
                session.submit(job, seed=seed)
        return session.drain()

    got = port(None)
    assert [o.as_dict() for o in port(2)] == [o.as_dict() for o in got]
    jobs = [j for j in ref_cluster_fleet(keys) for _ in range(3)]
    full = hold_all(ref.drain(), got, [j.space.encoded() for j in jobs],
                    [[list(range(len(j.space)))] for j in jobs], [len(j.space) for j in jobs],
                    "cost_table")
    assert full >= 5, f"only {full} of 6 traces matched the reference in full"
