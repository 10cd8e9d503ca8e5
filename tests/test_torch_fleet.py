"""The port's fleet, admission, fault and QoS layers against the JAX
package's: equal registries and presets, equal fault plans and retry
budgets, and equal traces (to 1e-12) from ``api.run`` over the database
simulator and over deterministic executors, for every router, admission
policy and autoscaler, with and without faults, retries, hedging, tiers
and pools."""
import dataclasses
import inspect
import math

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.api as jax_api  # noqa: E402
import repro.cluster as jax_cluster  # noqa: E402
import repro.cluster.registry as jax_router_reg  # noqa: E402
import repro.control as jax_control  # noqa: E402
import repro.control.registry as jax_control_reg  # noqa: E402
import repro.faults as jax_faults  # noqa: E402
import repro.qos as jax_qos  # noqa: E402
import repro_torch.api as port_api  # noqa: E402
import repro_torch.cluster as port_cluster  # noqa: E402
import repro_torch.cluster.registry as port_router_reg  # noqa: E402
import repro_torch.control as port_control  # noqa: E402
import repro_torch.control.registry as port_control_reg  # noqa: E402
import repro_torch.faults as port_faults  # noqa: E402
import repro_torch.qos as port_qos  # noqa: E402
from repro.core.database import synthetic_database as jax_db  # noqa: E402
from repro_torch.core.database import synthetic_database as port_db  # noqa: E402
from test_torch_workloads import JAX, PORT, FakeExecutor  # noqa: E402

RTOL = 1e-12


def _diff(a, b, path="trace"):
    """The first place where ``a`` and ``b`` differ by more than RTOL
    (relative; NaNs equal NaNs), or None."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        if type(a).__name__ != type(b).__name__:
            return f"{path}: {type(a).__name__} != {type(b).__name__}"
        for f in dataclasses.fields(a):
            d = _diff(getattr(a, f.name), getattr(b, f.name),
                      f"{path}.{f.name}")
            if d:
                return d
        return None
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape:
            return f"{path}: shapes {a.shape} != {b.shape}"
        if a.dtype.kind in "fc" or b.dtype.kind in "fc":
            ok = np.isclose(a.astype(float), b.astype(float), rtol=RTOL,
                            atol=0.0, equal_nan=True)
            return None if bool(np.all(ok)) else f"{path}: {a} != {b}"
        return None if np.array_equal(a, b) else f"{path}: {a} != {b}"
    if isinstance(a, float) or isinstance(b, float):
        a, b = float(a), float(b)
        if a == b or (math.isnan(a) and math.isnan(b)):
            return None
        if abs(a - b) <= RTOL * max(abs(a), abs(b)):
            return None
        return f"{path}: {a} != {b}"
    if isinstance(a, dict) and isinstance(b, dict):
        if list(a) != list(b):
            return f"{path}: keys {list(a)} != {list(b)}"
        for k in a:
            d = _diff(a[k], b[k], f"{path}[{k!r}]")
            if d:
                return d
        return None
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return f"{path}: lengths {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            d = _diff(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else f"{path}: {a!r} != {b!r}"


def assert_traces_equal(port, ref):
    """Every field (per replica and fleet-wide) and the summary."""
    assert type(port).__module__.startswith("repro_torch.")
    assert type(ref).__module__.startswith("repro.")
    d = _diff(port, ref) or _diff(port.summary(), ref.summary(), "summary")
    assert d is None, d


# ---------------------------------------------------------------------------
# registries, presets, fault plans and retry budgets

REGISTRIES = {
    "router": (port_router_reg._REGISTRY, jax_router_reg._REGISTRY),
    "admission": (port_control_reg._ADMISSION, jax_control_reg._ADMISSION),
    "autoscaler": (port_control_reg._AUTOSCALER,
                   jax_control_reg._AUTOSCALER),
}


def test_registries_list_the_same_names():
    assert port_cluster.available_routers() == \
        jax_cluster.available_routers()
    assert port_control.available_admission_policies() == \
        jax_control.available_admission_policies()
    assert port_control.available_autoscalers() == \
        jax_control.available_autoscalers()
    assert port_qos.available_tiers() == jax_qos.available_tiers()
    assert port_qos.available_deadlines() == jax_qos.available_deadlines()


def _signature(cls):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(cls.__init__).parameters.values()]


#: kwargs a built-in needs to be constructed at all.
REQUIRED = {"slo_shed": dict(slo=1.0), "adaptive_batch": dict(slo=1.0)}


@pytest.mark.parametrize("kind,name", [
    (kind, name) for kind in REGISTRIES
    for name in sorted(REGISTRIES[kind][1].available())])
def test_builtin_has_the_same_defaults(kind, name):
    port_reg, jax_reg = REGISTRIES[kind]
    pc, jc = port_reg.cls(name), jax_reg.cls(name)
    assert pc.__module__.startswith("repro_torch.")
    assert pc.__qualname__ == jc.__qualname__
    assert _signature(pc) == _signature(jc)
    assert port_reg._entries[name][1] == jax_reg._entries[name][1]
    a = port_reg.make(name, **REQUIRED.get(name, {}))
    b = jax_reg.make(name, **REQUIRED.get(name, {}))
    assert _diff(vars(a), vars(b), name) is None


@pytest.mark.parametrize("name", ["interactive", "standard", "best_effort"])
def test_tier_preset_is_the_same(name):
    a, b = port_qos.get_tier(name), jax_qos.get_tier(name)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    mix = f"{name},interactive" if name != "interactive" else name
    shares = [0.3, 0.7] if "," in mix else None
    pa = port_qos.resolve_tiers(mix, dict(shares=shares, seed=4), 50)
    pb = jax_qos.resolve_tiers(mix, dict(shares=shares, seed=4), 50)
    assert _diff(pa, pb) is None


FAULT_SPECS = [
    "crash@200+100:r=0",
    "flaky@0+1000:p=0.05,slowdown@300+50:f=2.5",
    "hang@400+20:s=0.5:r=1",
    "crash@5+3,flaky@0+1000:p=0.2",
    "crash@0.5+1.5:r=0,flaky@0+100:p=0.1",
    ["flaky@50+100:p=0.3", "slowdown@120+60:f=2"],
]


@pytest.mark.parametrize("time_indexed", [False, True],
                         ids=["query_indexed", "time_indexed"])
@pytest.mark.parametrize("spec", FAULT_SPECS, ids=range(len(FAULT_SPECS)))
def test_fault_specs_parse_to_equal_plans(spec, time_indexed):
    a = port_faults.resolve_faults(spec, seed=3, time_indexed=time_indexed)
    b = jax_faults.resolve_faults(spec, seed=3, time_indexed=time_indexed)
    assert a.time_indexed == b.time_indexed == time_indexed
    assert _diff(a, b) is None
    # The injectors draw the same outcomes for every (replica, query,
    # attempt) on either clock.
    for r in (0, 1):
        ia = port_faults.FaultInjector(a, replica=r, timeout=0.25)
        ib = jax_faults.FaultInjector(b, replica=r, timeout=0.25)
        for q in range(0, 600, 7):
            for _ in range(2):
                ea, eb = ia.check(q, 0.01 * q), ib.check(q, 0.01 * q)
                assert type(ea).__name__ == type(eb).__name__
                assert str(ea) == str(eb)


@pytest.mark.parametrize("spec", [
    "crash@1", "crash@a+b", "crash@1+2:x=3", "boom@1+2", "crash@1+2:r"])
def test_bad_fault_specs_raise_the_same_error(spec):
    errors = []
    for pkg in (port_faults, jax_faults):
        with pytest.raises(ValueError) as info:
            pkg.parse_fault_spec(spec)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("retries", [
    None, 0, 2, dict(max_retries=3, backoff=50.0, jitter=0.5, seed=2),
    dict(max_retries=1, timeout=0.5, batch_policy="subset")],
    ids=["none", "zero", "two", "jitter", "timeout"])
def test_resolve_retries_is_the_same(retries):
    a = port_faults.resolve_retries(retries)
    b = jax_faults.resolve_retries(retries)
    assert (a is None) == (b is None)
    if a is not None:
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert [a.delay(q, k) for q in range(5) for k in range(3)] == \
            [b.delay(q, k) for q in range(5) for k in range(3)]


def test_retry_spec_errors_are_the_same():
    for bad in (dict(max_retries=-1), dict(batch_policy="some"), True):
        errors = []
        for pkg in (port_faults, jax_faults):
            with pytest.raises((ValueError, TypeError)) as info:
                pkg.resolve_retries(bad)
            errors.append((type(info.value).__name__, str(info.value)))
        assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# api.run over the database simulator: db + ClusterSpec

N_FLEET = 160
ROUTERS = ["round_robin", "least_outstanding", "odin_aware", "edf",
           "downgrade"]
ADMISSIONS = {"none": None, "queue_cap": dict(cap=3),
              "slo_shed": dict(slo=1500.0), "value_shed": dict(slo=1500.0),
              "adaptive_batch": dict(slo=1500.0)}
AUTOSCALERS = ["static", "load_profile"]
#: tests/test_qos.py's two custom tiers (deadlines in the database's
#: time units).
GOLD_BATCH = [dict(name="gold", priority=2, value=10.0, deadline=800.0),
              dict(name="batch", priority=0, value=1.0, deadline=6000.0)]
DATABASES = {}


def _databases(pkg):
    if pkg not in DATABASES:
        make = port_db if pkg is port_api else jax_db
        DATABASES[pkg] = (make("vgg16", base_time=10.0, seed=0),
                          make("vgg16", base_time=5.0, seed=0))
    return DATABASES[pkg]


def _fleet_spec(pkg, router, admission, autoscaler, faults, tiers):
    """Overloaded bursty traffic on 4 replicas with interference on
    replica 2 (time-indexed); under ``load_profile`` a lighter Poisson
    load, at which it resizes the fleet.  ``faults`` adds a crash of
    replica 1, a flaky window, retries and hedging; ``tiers`` adds two
    tiers and a heterogeneous fleet with a small pool."""
    full, small = _databases(pkg)
    workload = (dict(name="poisson", kwargs=dict(rate=0.02, seed=7))
                if autoscaler == "load_profile" else
                dict(name="bursty", kwargs=dict(
                    burst_rate=0.16, base_rate=0.004, mean_burst=400.0,
                    mean_gap=400.0, seed=7)))
    fields = dict(
        db=full, num_eps=4, num_queries=N_FLEET, seed=1,
        scheduler=dict(name="odin", alpha=4), workload=workload,
        admission=dict(name=admission, kwargs=ADMISSIONS[admission]),
        events=[dict(start=200.0, duration=1200.0, ep=1, scenario=6,
                     replica=2)],
        events_time_indexed=True,
        cluster=dict(num_replicas=4, router=router, autoscaler=autoscaler))
    if faults:
        fields["faults"] = dict(
            plan="crash@600+900:r=1,flaky@0+100000:p=0.1",
            hedge_after=400.0,
            health_kwargs=dict(failure_threshold=1, cooldown=300.0))
        fields["retries"] = dict(policy=dict(max_retries=2, backoff=50.0))
    if tiers:
        fields["tiers"] = dict(spec=GOLD_BATCH,
                               kwargs=dict(shares=[0.3, 0.7], seed=5))
        fields["cluster"].update(databases=[full, full, small, small],
                                 pools=("default", "default", "small",
                                        "small"))
    return pkg.RunSpec(**fields)


@pytest.mark.parametrize("tiers", [False, True], ids=["untiered", "tiers"])
@pytest.mark.parametrize("faults", [False, True], ids=["clean", "faults"])
@pytest.mark.parametrize("autoscaler", AUTOSCALERS)
@pytest.mark.parametrize("admission", list(ADMISSIONS))
@pytest.mark.parametrize("router", ROUTERS)
def test_simulated_fleet_trace_equals_jax(router, admission, autoscaler,
                                          faults, tiers):
    a = port_api.run(_fleet_spec(port_api, router, admission, autoscaler,
                                 faults, tiers))
    b = jax_api.run(_fleet_spec(jax_api, router, admission, autoscaler,
                                faults, tiers))
    assert_traces_equal(a, b)
    assert a.num_queries == N_FLEET
    s = a.summary()
    if faults:
        assert s["num_retried"] > 0 and s["downtime_s"] > 0
    if tiers:
        assert "tier_gold_num" in s


def test_simulated_fleet_exercises_each_layer():
    """The matrix above is not vacuous: admission sheds, the autoscaler
    resizes, the downgrade router downgrades, hedges happen."""
    t = port_api.run(_fleet_spec(port_api, "downgrade", "value_shed",
                                 "static", True, True))
    s = t.summary()
    assert t.num_shed > 0 and s["num_hedged"] > 0
    assert s["tier_batch_downgraded"] > 0 and s["tier_gold_downgraded"] == 0
    t = port_api.run(_fleet_spec(port_api, "odin_aware", "none",
                                 "load_profile", False, False))
    assert len(t.active_timeline) > 1


@pytest.mark.parametrize("trace_mode", ["dense", "streaming"])
def test_simulate_cluster_kwargs_and_streaming_equal_jax(trace_mode):
    """The kwargs wrapper ``simulate_cluster`` is the spec path, in both
    trace modes."""
    kw = dict(scheduler="odin", alpha=4, num_queries=120, router="edf",
              workload="poisson", workload_kwargs=dict(rate=0.03, seed=3),
              admission="slo_shed", admission_kwargs=dict(slo=900.0),
              trace_mode=trace_mode, retries=2, hedge_after=300.0,
              faults="flaky@0+100000:p=0.2", tiers=GOLD_BATCH)
    a = port_cluster.simulate_cluster(_databases(port_api)[0], 4, 3, **kw)
    b = jax_cluster.simulate_cluster(_databases(jax_api)[0], 4, 3, **kw)
    assert type(a).__name__ == type(b).__name__
    if trace_mode == "dense":
        assert_traces_equal(a, b)
    else:
        assert _diff(a.summary(), b.summary(), "summary") is None
        assert _diff(a.replica_counts, b.replica_counts) is None
        assert _diff([r.snapshot() for r in a.replicas],
                     [r.snapshot() for r in b.replicas], "snapshots") is None


# ---------------------------------------------------------------------------
# the replicas target over deterministic executors

N_REPLICA_QUERIES = 60


def _replica_schedule(r):
    def schedule(q):
        slow = [1.0] * 4
        if r == 1 and 5 <= q < 25:
            slow[1] = 3.0
        return slow
    return schedule


def _replicas(pkg, cluster, n=3, max_batch=1):
    lengths = np.full(N_REPLICA_QUERIES, 64)
    reps = []
    for r in range(n):
        runtime = pkg.Runtime(pkg.policy("odin"), [3, 3, 3, 3])
        fx = FakeExecutor(pkg, runtime, lengths, _replica_schedule(r),
                          seed=r, max_batch=max_batch)
        reps.append(cluster.Replica(executor=fx, runtime=runtime,
                                    pool="small" if r == 2 else "default"))
    return reps


REPLICA_CONTROL = dict(
    workload=dict(name="poisson", kwargs=dict(rate=700.0, seed=2)),
    admission=dict(name="slo_shed", kwargs=dict(slo=0.02)),
    retries=dict(policy=2),
    tiers=dict(spec="interactive,best_effort",
               kwargs=dict(shares=[0.4, 0.6], seed=1)))


@pytest.mark.parametrize("control", [False, True],
                         ids=["plain", "admission_tiers_retries_batch"])
@pytest.mark.parametrize("router", ROUTERS)
def test_replicas_target_equals_jax_run_cluster(router, control):
    traces = []
    for pkg, api, cluster in ((PORT, port_api, port_cluster),
                              (JAX, jax_api, jax_cluster)):
        fields = dict(REPLICA_CONTROL) if control else dict(
            workload=dict(name="bursty", kwargs=dict(
                burst_rate=900.0, base_rate=50.0, mean_burst=0.05,
                mean_gap=0.05, seed=3)))
        reps = _replicas(pkg, cluster, max_batch=4 if control else 1)
        traces.append(api.run(api.RunSpec(
            replicas=reps, num_queries=N_REPLICA_QUERIES,
            cluster=dict(router=router, max_batch=4 if control else 1),
            **fields)))
    assert_traces_equal(*traces)
    assert traces[0].num_queries == N_REPLICA_QUERIES


def test_run_cluster_kwargs_equal_the_spec_path():
    a = port_cluster.run_cluster(
        _replicas(PORT, port_cluster), N_REPLICA_QUERIES,
        workload="poisson", workload_kwargs=dict(rate=700.0, seed=2),
        router="odin_aware", admission="queue_cap",
        admission_kwargs=dict(cap=2))
    b = jax_cluster.run_cluster(
        _replicas(JAX, jax_cluster), N_REPLICA_QUERIES,
        workload="poisson", workload_kwargs=dict(rate=700.0, seed=2),
        router="odin_aware", admission="queue_cap",
        admission_kwargs=dict(cap=2))
    assert_traces_equal(a, b)
    assert a.num_shed > 0
