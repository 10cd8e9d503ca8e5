"""The port's simulator against the JAX package's: the same database,
events and traffic through both packages' ``simulate`` must give equal
traces, under every registered policy, open- and closed-loop traffic,
continuous batching, and mesh-sliced stages with mesh events.  Also the
copies of the DP oracle and the mesh cost model, on random databases."""
import dataclasses

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.core as jax_core  # noqa: E402
import repro.core.exhaustive as jax_exhaustive  # noqa: E402
import repro.core.mesh as jax_mesh  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.core.exhaustive as port_exhaustive  # noqa: E402
import repro_torch.core.mesh as port_mesh  # noqa: E402
import repro.api as jax_api  # noqa: E402
import repro_torch.api as port_api  # noqa: E402

NUM_EPS = 4
POLICIES = ("odin", "lls", "hybrid", "oracle", "none")
WORKLOADS = ("closed", "poisson", "bursty")
DATABASES = ("vgg16", "transformer")


def _db(core, which: str):
    if which == "vgg16":
        return core.synthetic_database("vgg16", seed=0)
    costs = np.random.default_rng(5).uniform(0.5, 1.5, 24)
    return core.transformer_database(costs, seed=1)


def _peak(core, db) -> float:
    return core.optimal_partition(db, [0] * NUM_EPS, NUM_EPS)[1]


def _events(core, db, n: int, mesh: bool) -> list:
    """Interference events, plus one mesh-contention episode when a
    mesh is armed (as tests/test_sharding.py builds them)."""
    evs = list(core.generate_events(n, NUM_EPS, db.num_scenarios, 20, 10,
                                    seed=3))
    if mesh:
        evs.append(core.InterferenceEvent(start=n // 3, duration=n // 4,
                                          ep=0, scenario=0, kind="mesh",
                                          factor=6.0))
    return evs


def _kwargs(core, db, workload: str, batching: str, mesh: bool,
            n: int) -> dict:
    peak = _peak(core, db)
    kw = dict(num_queries=n, events=_events(core, db, n, mesh))
    if workload == "poisson":
        kw.update(workload="poisson",
                  workload_kwargs=dict(rate=0.7 * peak, seed=1))
    elif workload == "bursty":
        kw.update(workload="bursty",
                  workload_kwargs=dict(burst_rate=2.0 * peak,
                                       base_rate=0.2 * peak,
                                       mean_burst=20.0 / peak,
                                       mean_gap=40.0 / peak, seed=2))
    if batching == "continuous":
        kw.update(batching="continuous", max_batch=8,
                  buckets="pow2:64:512", lengths="bimodal",
                  lengths_kwargs=dict(short=48, long=420, p_long=0.25,
                                      seed=11),
                  batch_overhead=0.02 / peak)
    if mesh:
        kw["mesh"] = dict(devices=8, coll_cost=0.5)
    return kw


def _run_spec(api, db, scheduler: str, kw: dict):
    """The kwargs as one RunSpec of the given package's ``api``, run."""
    kw = dict(kw)
    batching = api.BatchingSpec(
        mode=kw.pop("batching", None), max_batch=kw.pop("max_batch", None),
        buckets=kw.pop("buckets", None), lengths=kw.pop("lengths", None),
        lengths_kwargs=kw.pop("lengths_kwargs", None),
        batch_overhead=kw.pop("batch_overhead", 0.0))
    workload = api.WorkloadSpec(name=kw.pop("workload", "closed"),
                                kwargs=kw.pop("workload_kwargs", None))
    return api.run(api.RunSpec(
        db=db, num_eps=NUM_EPS, batching=batching, workload=workload,
        scheduler=api.SchedulerSpec(name=scheduler, alpha=4), **kw))


def _equal(a, b) -> bool:
    """Equal, or within 1e-12 relative; NaNs in the same places."""
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    a, b = np.asarray(a, float), np.asarray(b, float)
    return a.shape == b.shape and bool(np.allclose(
        a, b, rtol=1e-12, atol=0.0, equal_nan=True))


def assert_same_trace(a, b) -> None:
    sa, sb = a.summary(), b.summary()
    assert list(sa) == list(sb)
    bad = {k: (sa[k], sb[k]) for k in sa if not _equal(sa[k], sb[k])}
    assert not bad, bad
    assert a.configs_trace == b.configs_trace
    assert a.mesh_trace == b.mesh_trace
    for col in ("latencies", "throughputs", "serial_mask", "queue_delays",
                "batch_sizes", "collective_fracs"):
        x, y = getattr(a, col), getattr(b, col)
        assert (x is None) == (y is None), col
        if x is not None:
            assert _equal(x, y), col
    assert (a.num_rebalances, a.total_trials, a.mitigation_lengths) == \
        (b.num_rebalances, b.total_trials, b.mitigation_lengths)


@pytest.mark.parametrize("mesh", [False, True], ids=["flat", "mesh"])
@pytest.mark.parametrize("batching", ["none", "continuous"])
@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("scheduler", POLICIES)
@pytest.mark.parametrize("which", DATABASES)
def test_simulate_equals_jax(which, scheduler, workload, batching, mesh):
    n = 400
    jdb, db = _db(jax_core, which), _db(port_core, which)
    np.testing.assert_array_equal(db.table, jdb.table)
    kw = _kwargs(port_core, db, workload, batching, mesh, n)
    jkw = _kwargs(jax_core, jdb, workload, batching, mesh, n)
    if mesh:
        port = _run_spec(port_api, db, scheduler, kw)
        ref = _run_spec(jax_api, jdb, scheduler, jkw)
        assert port.mesh_trace is not None
        assert all(sum(m) == 8 and min(m) >= 1 for m in port.mesh_trace)
    else:
        port = port_core.simulate(db, NUM_EPS, scheduler=scheduler,
                                  alpha=4, **kw)
        ref = jax_core.simulate(jdb, NUM_EPS, scheduler=scheduler,
                                alpha=4, **jkw)
    assert len(port.latencies) == n
    assert_same_trace(port, ref)
    if scheduler == "oracle":
        assert port.total_trials == 0
    if scheduler == "none":
        assert port.num_rebalances == 0


@pytest.mark.parametrize("seed", range(6))
def test_optimal_partitions_equal_jax(seed):
    rng = np.random.default_rng(seed)
    m, n = int(rng.integers(6, 20)), int(rng.integers(2, 6))
    table = rng.uniform(0.1, 3.0, (m, 5))
    db = port_core.LayerDatabase(table, [f"s{k}" for k in range(5)])
    jdb = jax_core.LayerDatabase(table, [f"s{k}" for k in range(5)])
    scen = list(rng.integers(0, 5, n))
    a = port_exhaustive.optimal_partition(db, scen, n)
    assert a == jax_exhaustive.optimal_partition(jdb, scen, n)
    if m <= 12:
        assert port_exhaustive.brute_force_partition(db, scen, n) == \
            jax_exhaustive.brute_force_partition(jdb, scen, n)
        assert a[1] == pytest.approx(
            port_exhaustive.brute_force_partition(db, scen, n)[1])
    coll = tuple(rng.uniform(0.0, 0.5, m))
    f = float(rng.uniform(1.0, 4.0))
    got = port_exhaustive.optimal_partition_mesh(
        db, scen, n, port_mesh.MeshSpec(8, coll_costs=coll), coll_factor=f)
    want = jax_exhaustive.optimal_partition_mesh(
        jdb, scen, n, jax_mesh.MeshSpec(8, coll_costs=coll), coll_factor=f)
    assert got == want


@pytest.mark.parametrize("seed", range(4))
def test_mesh_helpers_equal_jax(seed):
    rng = np.random.default_rng(10 + seed)
    n = int(rng.integers(2, 6))
    devices = int(rng.integers(n, 12))
    m = int(rng.integers(n, 20))
    assert list(port_mesh.assignments(devices, n)) == \
        list(jax_mesh.assignments(devices, n))
    assert port_mesh.balanced_assignment(devices, n) == \
        jax_mesh.balanced_assignment(devices, n)
    for d in range(1, 9):
        assert port_mesh.ring_factor(d) == jax_mesh.ring_factor(d)
    spec = port_mesh.MeshSpec(devices, coll_cost=float(rng.uniform(0, 1)))
    jspec = jax_mesh.MeshSpec(devices, coll_cost=spec.coll_cost)
    assert spec.to_dict() == jspec.to_dict()
    assert port_mesh.resolve_mesh(spec.to_dict()) == spec
    assert port_mesh.resolve_mesh(devices) == port_mesh.MeshSpec(devices)
    np.testing.assert_array_equal(spec.layer_costs(m), jspec.layer_costs(m))
    compute = rng.uniform(0.1, 2.0, n)
    config = list(rng.multinomial(m - n, np.ones(n) / n) + 1)
    assign = next(iter(jax_mesh.assignments(devices, n)))
    f = float(rng.uniform(1.0, 3.0))
    np.testing.assert_array_equal(
        port_mesh.mesh_stage_times(compute, config, assign, spec, f),
        jax_mesh.mesh_stage_times(compute, config, assign, jspec, f))
    assert port_mesh.collective_frac(compute, config, assign, spec, f) == \
        jax_mesh.collective_frac(compute, config, assign, jspec, f)


def test_databases_and_events_equal_jax():
    for which in DATABASES:
        np.testing.assert_array_equal(_db(port_core, which).table,
                                      _db(jax_core, which).table)
    assert [dataclasses.asdict(s) for s in port_core.paper_scenarios()] == \
        [dataclasses.asdict(s) for s in jax_core.paper_scenarios()]
    db = _db(port_core, "vgg16")
    ev = port_core.generate_events(500, NUM_EPS, db.num_scenarios, 10, 10,
                                   seed=4)
    jev = jax_core.generate_events(500, NUM_EPS, db.num_scenarios, 10, 10,
                                   seed=4)
    assert [dataclasses.asdict(e) for e in ev] == \
        [dataclasses.asdict(e) for e in jev]
    tl = port_core.EventTimeline(ev, NUM_EPS,
                                 severity=db.scenario_severities())
    jtl = jax_core.EventTimeline(jev, NUM_EPS,
                                 severity=db.scenario_severities())
    for q in range(0, 500, 7):
        assert tl.scenarios_at(q) == jtl.scenarios_at(q)
        assert tl.next_change(q) == jtl.next_change(q)
    fleet = [port_core.InterferenceEvent(0, 5, 0, 1, replica=r)
             for r in (None, 0, 1)]
    assert len(port_core.events_for_replica(fleet, 1)) == 2


def test_core_exports_equal_jax():
    names = {n for n in dir(jax_core) if not n.startswith("_")}
    port_names = {n for n in dir(port_core) if not n.startswith("_")}
    assert names <= port_names
    assert port_core.PAPER_SETTINGS == jax_core.PAPER_SETTINGS
