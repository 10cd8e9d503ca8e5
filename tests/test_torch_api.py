"""The port's RunSpec / run(spec) surface against the JAX package's:
equal ``to_dict`` output and round trips, the same errors, equal traces
from the fleet targets, and the live engine's mesh branches (the model
over measured stage times, the summary keys) on the CPU."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.api as jax_api  # noqa: E402
import repro_torch.api as api  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import simulate as jax_simulate  # noqa: E402
from repro.core.database import synthetic_database as jax_db  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    InterferenceEvent,
    LayerDatabase,
    generate_events,
    optimal_partition,
    simulate,
    synthetic_database,
)
from repro_torch.models import Model  # noqa: E402
from repro_torch.schedulers import OraclePolicy  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from test_torch_fleet import _diff as _fleet_diff  # noqa: E402
from test_torch_workloads import JAX, PORT, FakeExecutor  # noqa: E402

NUM_EPS = 4


@pytest.fixture(scope="module")
def db():
    return synthetic_database("vgg16", seed=0)


def _events(n):
    evs = list(generate_events(n, NUM_EPS, 12, 20, 10, seed=3))
    evs.append(InterferenceEvent(start=n // 3, duration=n // 4, ep=0,
                                 scenario=0, kind="mesh", factor=6.0))
    return evs


def _both(**fields):
    """The same spec built by both packages from plain values (sub-specs
    as dicts, events as dicts)."""
    return api.RunSpec(**fields), jax_api.RunSpec(**fields)


SPECS = {
    "db-mesh": dict(num_eps=4, num_queries=300, seed=2,
                    events=[dict(start=10, duration=5, ep=1, scenario=3),
                            dict(start=50, duration=20, ep=0, scenario=0,
                                 kind="mesh", factor=4.0)],
                    mesh=dict(devices=8, coll_cost=0.5),
                    scheduler=dict(name="odin", alpha=4,
                                   initial_config=[4, 4, 4, 5]),
                    workload=dict(name="poisson",
                                  kwargs={"rate": 0.02, "seed": 1}),
                    admission=dict(name="queue_cap", kwargs={"cap": 16})),
    "live-batched": dict(num_eps=2,
                         batching=dict(mode="continuous", max_batch=8,
                                       buckets="pow2:64:512",
                                       explore_in_batch=True),
                         telemetry=dict(trace_mode="streaming",
                                        sink_interval=50),
                         scheduler=dict(name="hybrid", rel_threshold=0.1)),
    "fleet": dict(num_queries=100, freq_period=5, duration=3,
                  cluster=dict(num_replicas=3, router="least_outstanding",
                               pools=["a", "b", "a"]),
                  faults=dict(plan="crash@10+5", hedge_after=2.0),
                  retries=dict(policy=2), tiers=dict(spec="interactive")),
    "defaults": dict(),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_to_dict_equals_jax_and_round_trips(name, db):
    spec, ref = _both(**SPECS[name])
    d = spec.to_dict()
    assert d == ref.to_dict()
    d = json.loads(json.dumps(d))                # JSON-clean
    assert api.RunSpec.from_dict(d, db=db) == spec.replace(db=db)
    assert api.RunSpec.from_dict(d) == spec
    if spec.mesh is not None:
        assert spec.mesh.to_dict() == ref.mesh.to_dict()


def _raises(spec_fields: dict, handles=None):
    """(type, message) each package's run raises for the same spec."""
    out = []
    for pkg in (api, jax_api):
        with pytest.raises(Exception) as info:
            pkg.run(pkg.RunSpec(**spec_fields, **(handles or {})))
        out.append((type(info.value), str(info.value)))
    return out


class _Dummy:
    """A handle no branch reaches before the error under test."""


@pytest.mark.parametrize("case", [
    "no-target", "db-hedging", "mesh-on-live", "engine-hedging",
    "engine-cluster", "replicas-faults", "cluster-mesh"])
def test_run_errors_equal_jax(case, db):
    fields, handles = {
        "no-target": (dict(num_queries=10), None),
        "db-hedging": (dict(num_queries=10,
                            faults=dict(hedge_after=1.0)), dict(db=db)),
        "mesh-on-live": (dict(mesh=8), dict(engine=_Dummy())),
        "engine-hedging": (dict(faults=dict(hedge_after=1.0)),
                           dict(engine=_Dummy())),
        "engine-cluster": (dict(cluster=dict(num_replicas=2)),
                           dict(engine=_Dummy())),
        "replicas-faults": (dict(faults=dict(plan="crash@1+2")),
                            dict(replicas=[_Dummy()])),
        "cluster-mesh": (dict(num_queries=10, mesh=8,
                              cluster=dict(num_replicas=2)), dict(db=db)),
    }[case]
    port, ref = _raises(fields, handles)
    assert port == ref


def test_run_type_errors_equal_jax(db):
    for pkg in (api, jax_api):
        with pytest.raises(TypeError, match="takes a RunSpec"):
            pkg.run({"db": db})
        with pytest.raises(TypeError, match="SchedulerSpec"):
            pkg.RunSpec(db=db, scheduler="odin")


class _FleetEngine:
    """A stand-in for a live engine in a fleet: its own runtime and a
    deterministic executor (``FakeExecutor``) of the given package."""

    def __init__(self, pkg, seed):
        self.pkg, self.seed = pkg, seed
        self.runtime = pkg.Runtime(pkg.policy("odin"), [3, 3, 3, 3])
        self.scheduler = "odin"
        self.executor = self             # on_recover's warm_buckets

    def query_executor(self, queries, schedule, max_batch=1):
        return FakeExecutor(self.pkg, self.runtime, np.full(40, 64),
                            schedule, seed=self.seed, max_batch=max_batch)

    def warm_buckets(self, seqs, max_batch):
        pass

    def estimated_peak_throughput(self):
        return 250.0


def _fleet_target_spec(case, pkg, run_api, db_):
    """One spec per fleet target, admission, fault, retry and tier
    branch, built from the given package."""
    from repro.cluster import Replica as JaxReplica
    from repro_torch.cluster import Replica
    replica_cls = Replica if pkg is PORT else JaxReplica
    poisson = dict(name="poisson", kwargs=dict(rate=0.05, seed=1))
    return {
        "db-cluster": run_api.RunSpec(
            db=db_, num_queries=60, workload=poisson,
            cluster=run_api.ClusterSpec(num_replicas=2,
                                        router="odin_aware")),
        "replicas": run_api.RunSpec(
            replicas=[replica_cls(executor=e.query_executor([], lambda q:
                                                            [1.0] * 4),
                                  runtime=e.runtime)
                      for e in (_FleetEngine(pkg, 0), _FleetEngine(pkg, 1))],
            num_queries=30, workload=dict(name="poisson",
                                          kwargs=dict(rate=400.0, seed=1)),
            cluster=run_api.ClusterSpec(router="least_outstanding")),
        "engines": run_api.RunSpec(
            engines=[_FleetEngine(pkg, 0), _FleetEngine(pkg, 1)],
            queries=list(range(30)), schedule=lambda q: [1.0] * 4,
            workload=dict(name="poisson", kwargs=dict(rate=400.0, seed=1)),
            faults=run_api.FaultsSpec(plan="flaky@0+100:p=0.3"),
            retries=run_api.RetriesSpec(policy=2),
            cluster=run_api.ClusterSpec(num_replicas=2,
                                        router="round_robin")),
        "faults": run_api.RunSpec(db=db_, num_queries=10,
                                  faults=run_api.FaultsSpec(
                                      plan="crash@1+2")),
        "retries": run_api.RunSpec(db=db_, num_queries=10,
                                   faults=run_api.FaultsSpec(
                                       plan="flaky@0+10:p=0.5"),
                                   retries=run_api.RetriesSpec(policy=2)),
        "tiers": run_api.RunSpec(db=db_, num_queries=10,
                                 tiers=run_api.TiersSpec(
                                     spec="interactive")),
        "admission": run_api.RunSpec(db=db_, num_queries=60,
                                     workload=poisson,
                                     admission=run_api.AdmissionSpec(
                                         name="queue_cap",
                                         kwargs={"cap": 4})),
    }[case]


@pytest.mark.parametrize("case", [
    "db-cluster", "replicas", "engines", "faults", "retries", "tiers",
    "admission"])
def test_fleet_targets_wait_for_item_6f(case, db):
    """The fleet targets and the admission, fault, retry and tier
    branches (which once raised NotImplementedError while the fleet
    layers were not copied) now run, and their traces equal the JAX
    package's for the same spec."""
    a = api.run(_fleet_target_spec(case, PORT, api, db))
    b = jax_api.run(_fleet_target_spec(case, JAX, jax_api,
                                       jax_db("vgg16", seed=0)))
    assert type(a).__module__.startswith("repro_torch.")
    assert type(b).__module__.startswith("repro.")
    d = _fleet_diff(a, b) or _fleet_diff(a.summary(), b.summary())
    assert d is None, d
    s = a.summary()
    if case in ("faults", "retries", "engines"):
        assert s["num_failed"] + s["num_retried"] > 0
    if case == "admission":
        assert s["num_shed"] > 0


@pytest.mark.parametrize("sched", ["odin", "hybrid", "oracle"])
def test_spec_path_equals_kwarg_path_and_jax(sched, db):
    """run(RunSpec(db=...)) is simulate(...) in the port, and equals the
    JAX package's run of the same spec (mesh armed)."""
    a = api.run(api.RunSpec(db=db, num_eps=NUM_EPS, num_queries=300,
                            scheduler=api.SchedulerSpec(name=sched)))
    b = simulate(db, NUM_EPS, scheduler=sched, num_queries=300)
    c = jax_simulate(jax_db("vgg16", seed=0), NUM_EPS, scheduler=sched,
                     num_queries=300)
    for x in (b, c):
        np.testing.assert_array_equal(a.latencies, x.latencies)
        assert a.configs_trace == x.configs_trace
    m = api.run(api.RunSpec(db=db, num_eps=NUM_EPS, num_queries=300,
                            events=_events(300), mesh=8,
                            scheduler=api.SchedulerSpec(name=sched)))
    jm = jax_api.run(jax_api.RunSpec(
        db=jax_db("vgg16", seed=0), num_eps=NUM_EPS, num_queries=300,
        events=[dataclasses.asdict(e) for e in _events(300)], mesh=8,
        scheduler=jax_api.SchedulerSpec(name=sched)))
    np.testing.assert_array_equal(m.latencies, jm.latencies)
    assert (m.configs_trace, m.mesh_trace) == (jm.configs_trace,
                                               jm.mesh_trace)


# ---------------------------------------------------------------------------
# the live engine's mesh branches and api route, on the CPU


@pytest.fixture(scope="module")
def live():
    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"), num_layers=8)
    params = Model(cfg).init_params(0, device="cpu")
    rng = np.random.default_rng(0)
    queries = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64)))
               for _ in range(20)]
    return cfg, params, queries


@pytest.fixture(scope="module")
def jax_live():
    cfg = dataclasses.replace(jax_smoke("qwen2-0.5b"), num_layers=8)
    params = JaxModel(cfg).init_params(jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(0)
    queries = [jnp.asarray(rng.integers(0, cfg.vocab_size, (1, 64)))
               for _ in range(12)]
    return cfg, params, queries


def _cf_schedule(q):
    return 5.0 if 5 <= q < 12 else 1.0


def _slow(q):
    return [1.0, 3.0 if 4 <= q < 14 else 1.0, 1.0, 1.0]


MESH = dict(devices=8, coll_cost=0.002)
MESH_KEYS = {"mesh_devices", "num_mesh_resizes", "mean_collective_frac",
             "p99_collective_frac"}


def test_mesh_engine_summary_keys_equal_jax_engine(live, jax_live):
    cfg, params, queries = live
    eng = ServingEngine(cfg, params, num_eps=NUM_EPS, scheduler="odin",
                        alpha=3, mesh=api.MeshSpec(**MESH),
                        coll_factor_schedule=_cf_schedule, device="cpu")
    eng.executor.warmup(1, 64)
    trace = eng.serve(queries, _slow)
    s = trace.summary()
    assert trace.mesh_devices == 8
    assert all(sum(a) == 8 and min(a) >= 1 for a in trace.mesh_trace)
    fr = np.asarray(trace.collective_fracs)
    assert fr.shape == (len(queries),)
    assert np.all((fr >= 0.0) & (fr < 1.0))
    jcfg, jparams, jqueries = jax_live
    jeng = JaxEngine(jcfg, jparams, num_eps=NUM_EPS, scheduler="odin",
                     alpha=3, mesh=jax_api.MeshSpec(**MESH),
                     coll_factor_schedule=_cf_schedule)
    jeng.executor.warmup(1, 64)
    js = jeng.serve(jqueries, _slow).summary()
    assert list(s) == list(js)
    assert MESH_KEYS <= set(s)
    plain = ServingEngine(cfg, params, num_eps=NUM_EPS, scheduler="odin",
                          alpha=3, executor=eng.executor, device="cpu")
    unsharded = plain.serve(queries[:6], _slow)
    assert unsharded.mesh_trace is None
    assert not (MESH_KEYS & unsharded.summary().keys())


@pytest.mark.parametrize("seed", range(3))
def test_mesh_model_equals_jax_engine(seed, live, jax_live):
    """On the same block-time estimates and measured stage times, the
    engines' time sources, peak estimates and mesh model agree."""
    cfg, params, _ = live
    jcfg, jparams, _ = jax_live
    rng = np.random.default_rng(seed)
    mesh = dict(devices=8, coll_cost=float(rng.uniform(0.001, 0.01)))
    eng = ServingEngine(cfg, params, num_eps=NUM_EPS, mesh=mesh,
                        coll_factor_schedule=_cf_schedule, device="cpu")
    jeng = JaxEngine(jcfg, jparams, num_eps=NUM_EPS, mesh=mesh,
                     coll_factor_schedule=_cf_schedule)
    assert eng._initial_assignment == jeng._initial_assignment
    np.testing.assert_array_equal(eng._coll_times, jeng._coll_times)
    bt = rng.uniform(0.001, 0.01, cfg.num_blocks)
    eng._block_times, jeng._block_times = bt.copy(), bt.copy()
    assert eng.estimated_peak_throughput() == \
        jeng.estimated_peak_throughput()
    slow = rng.uniform(1.0, 3.0, NUM_EPS)
    live_ex = eng.query_executor([], _slow)
    jlive_ex = jeng.query_executor([], _slow)
    for q in (0, 7):
        assert eng._coll_factor_at(q) == jeng._coll_factor_at(q)
        live_ex._cf = jlive_ex._cf = eng._coll_factor_at(q)
        src = eng._measured_source(slow, live_ex._cf)
        jsrc = jeng._measured_source(slow, jlive_ex._cf)
        for config, assign in (([2, 2, 2, 2], [2, 2, 2, 2]),
                               ([1, 3, 4, 0], [1, 2, 4, 1])):
            np.testing.assert_array_equal(src.stage_times(config, assign),
                                          jsrc.stage_times(config, assign))
            assert src.collective_frac(config, assign) == \
                jsrc.collective_frac(config, assign)
            st = rng.uniform(0.001, 0.05, NUM_EPS)
            assert live_ex._mesh_model(st, config, assign) == \
                jlive_ex._mesh_model(st, config, assign)


def _oracle_solver(config, source):
    """DP optimum over a database with one column per EP: the block
    times times that EP's slowdown."""
    table = source.block_times[:, None] * source.slowdowns[None, :]
    n = table.shape[1]
    db = LayerDatabase(table, [f"ep{e}" for e in range(n)])
    return optimal_partition(db, list(range(n)), n)[0]


@pytest.mark.parametrize("scheduler", ["hybrid", "oracle"])
def test_engine_serves_through_api_run(scheduler, live, monkeypatch):
    """serve() is one RunSpec through api.run; hybrid moves blocks off
    the slowed stage, the live oracle commits with no serial query."""
    cfg, params, queries = live
    calls = []
    real_run = api.run
    monkeypatch.setattr(api, "run",
                        lambda spec: calls.append(spec) or real_run(spec))
    policy = (OraclePolicy(_oracle_solver) if scheduler == "oracle"
              else "hybrid")
    eng = ServingEngine(cfg, params, num_eps=NUM_EPS, scheduler=policy,
                        alpha=3, device="cpu")
    eng.executor.warmup(1, 64)
    trace = eng.serve(queries, _slow)
    assert len(calls) == 1 and calls[0].engine is eng
    assert all(sum(c) == cfg.num_blocks for c in trace.configs)
    assert min(c[1] for c in trace.configs[6:14]) < 2
    if scheduler == "oracle":
        assert trace.scheduler == eng.scheduler == "oracle"
        assert trace.summary()["serial_frac"] == 0.0
        assert trace.total_trials == 0
    else:
        assert trace.num_rebalances >= 1
