"""The port's copies of the numpy serving layers against the originals:
workloads (arrival generators, length samplers, buckets, batch formation),
telemetry (sketch, rollup, streaming collector), the registry, the typed
errors, and the shared run loop, which must give equal traces when one
deterministic executor drives both packages' loops."""
import dataclasses
import json
import types

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.control.base as jax_control  # noqa: E402
import repro.telemetry as jax_tel  # noqa: E402
import repro.util.errors as jax_errors  # noqa: E402
import repro.workloads as jax_wl  # noqa: E402
import repro.workloads.batching as jax_batching  # noqa: E402
import repro.workloads.runner as jax_runner  # noqa: E402
import repro_torch.control.base as port_control  # noqa: E402
import repro_torch.telemetry as port_tel  # noqa: E402
import repro_torch.util.errors as port_errors  # noqa: E402
import repro_torch.workloads as port_wl  # noqa: E402
import repro_torch.workloads.batching as port_batching  # noqa: E402
import repro_torch.workloads.runner as port_runner  # noqa: E402
from repro.pipeline import MeasuredTimeSource as JaxSource  # noqa: E402
from repro.schedulers.defaults import (  # noqa: E402
    MEASURED_DETECTOR_MODE as JAX_MODE,
)
from repro.schedulers.registry import make_scheduler as jax_scheduler  # noqa: E402
from repro.schedulers.runtime import RebalanceRuntime as JaxRuntime  # noqa: E402
from repro_torch.pipeline import MeasuredTimeSource  # noqa: E402
from repro_torch.pipeline.executor import next_pow2  # noqa: E402
from repro_torch.schedulers import MEASURED_DETECTOR_MODE  # noqa: E402
from repro_torch.schedulers import make_scheduler  # noqa: E402
from repro_torch.schedulers.runtime import RebalanceRuntime  # noqa: E402
from repro_torch.util.registry import Registry  # noqa: E402

JAX = types.SimpleNamespace(
    wl=jax_wl, tel=jax_tel, runner=jax_runner, batching=jax_batching,
    Source=JaxSource, Runtime=JaxRuntime,
    policy=lambda name: jax_scheduler(name, alpha=3, detector=JAX_MODE))
PORT = types.SimpleNamespace(
    wl=port_wl, tel=port_tel, runner=port_runner, batching=port_batching,
    Source=MeasuredTimeSource, Runtime=RebalanceRuntime,
    policy=lambda name: make_scheduler(name, alpha=3,
                                       detector=MEASURED_DETECTOR_MODE))


def _equal(a, b) -> bool:
    """Equal values, arrays elementwise with NaNs in the same places."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape:
            return False
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            return bool(np.array_equal(a.astype(float), b.astype(float),
                                       equal_nan=True))
        return bool(np.array_equal(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (np.isnan(a) and np.isnan(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(_equal(a[k], b[k]) for k in a)
    return a == b


def _assert_summaries_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    bad = {k: (a[k], b[k]) for k in a if not _equal(a[k], b[k])}
    assert not bad, bad


# ---------------------------------------------------------------------------
# arrival generators and length samplers

WORKLOADS = [
    ("closed", {}),
    ("poisson", dict(rate=40.0, seed=3)),
    ("bursty", dict(burst_rate=120.0, base_rate=5.0, mean_burst=0.4,
                    mean_gap=0.9, seed=5)),
    ("diurnal", dict(mean_rate=30.0, period=4.0, amplitude=0.6, phase=0.3,
                     seed=7)),
    ("ramp", dict(start_rate=5.0, end_rate=60.0, ramp_time=3.0, seed=9)),
    ("trace", dict(inter_arrivals=[0.01, 0.0, 0.3, 0.02, 0.5])),
]


@pytest.mark.parametrize("name,kwargs", WORKLOADS, ids=[w[0] for w in WORKLOADS])
def test_generators_draw_the_same_arrivals(name, kwargs):
    assert port_wl.available_workloads() == jax_wl.available_workloads()
    a = port_wl.make_workload(name, **kwargs)
    b = jax_wl.make_workload(name, **kwargs)
    assert type(a).__module__ == "repro_torch.workloads.generators"
    for n in (1, 7, 300):
        assert _equal(a.inter_arrivals(n), b.inter_arrivals(n))
        assert _equal(port_runner.resolve_arrivals(a, None, n),
                      jax_runner.resolve_arrivals(b, None, n))


LENGTHS = [
    ("fixed", dict(length=96)),
    ("uniform", dict(lo=16, hi=200, seed=4)),
    ("bimodal", dict(short=64, long=1024, p_long=0.25, seed=0)),
    ("trace", dict(lengths=[5, 17, 300, 64])),
]


@pytest.mark.parametrize("name,kwargs", LENGTHS, ids=[s[0] for s in LENGTHS])
def test_length_samplers_draw_the_same_lengths(name, kwargs):
    assert port_wl.available_lengths() == jax_wl.available_lengths()
    for n in (1, 9, 500):
        assert _equal(port_wl.make_lengths(name, **kwargs).sample(n),
                      jax_wl.make_lengths(name, **kwargs).sample(n))
    # Resolved through a workload that carries its own lengths, too.
    wa = port_wl.with_lengths(port_wl.make_workload("poisson", rate=3.0),
                              port_wl.make_lengths(name, **kwargs))
    wb = jax_wl.with_lengths(jax_wl.make_workload("poisson", rate=3.0),
                             jax_wl.make_lengths(name, **kwargs))
    assert _equal(port_wl.resolve_lengths(None, None, 33, workload=wa),
                  jax_wl.resolve_lengths(None, None, 33, workload=wb))
    assert _equal(port_wl.resolve_lengths(name, kwargs, 33),
                  jax_wl.resolve_lengths(name, kwargs, 33))


@pytest.mark.parametrize("spec", ["pow2:32:64", "pow2:256:1024",
                                  "pow2:17:300", "64,128,512", "single"])
@pytest.mark.parametrize("mode", ["drain", "continuous"])
def test_buckets_and_batch_former_match(spec, mode):
    fa = port_batching.resolve_batching(mode, max_batch=8, buckets=spec,
                                        explore_in_batch=True, seq=300)
    fb = jax_batching.resolve_batching(mode, max_batch=8, buckets=spec,
                                       explore_in_batch=True, seq=300)
    assert (fa.mode, fa.max_batch, fa.explore_in_batch, fa.continuous) == \
        (fb.mode, fb.max_batch, fb.explore_in_batch, fb.continuous)
    assert _equal(fa.buckets.edges, fb.buckets.edges)
    assert repr(fa.buckets) == repr(fb.buckets)
    top = int(fb.buckets.edges[-1])
    lengths = np.random.default_rng(0).integers(1, top + 1, 200)
    assert _equal(fa.padded_lengths(lengths), fb.padded_lengths(lengths))
    assert fa.padded_lengths(None) is fb.padded_lengths(None) is None
    for n in (1, 17, top):
        assert fa.buckets.pad(n) == fb.buckets.pad(n)
    assert port_batching.next_pow2(37) == jax_batching.next_pow2(37) == 64
    for bad in (fa.buckets, fb.buckets):
        with pytest.raises(ValueError, match="exceeds"):
            bad.pad(int(bad.edges[-1]) + 1)
    assert port_batching.resolve_batching("none") is None
    assert jax_batching.resolve_batching(None) is None


def test_registry_loads_the_ports_builtins():
    """The workload registry imports its builtins by module name: the
    port's must name its own generators module, never the JAX package's
    (the AST check of tests/test_torch_isolation.py cannot see strings)."""
    assert port_wl.registry._REGISTRY._builtins_module in (
        None, "repro_torch.workloads.generators")
    assert port_wl.workload_class("bursty") is port_wl.BurstyWorkload
    reg = Registry("thing")

    @reg.register("a", scale=2)
    class A:
        def __init__(self, scale, seed=0):
            self.scale, self.seed = scale, seed

    made = reg.make("a", seed=4, unused=1)
    assert (made.scale, made.seed, A.name) == (2, 4, "a")
    with pytest.raises(ValueError, match="unknown thing"):
        reg.make("b")


def test_errors_copy_keeps_the_hierarchy():
    for name in jax_errors.__all__:
        assert hasattr(port_errors, name), name
    assert port_errors.is_transient(port_errors.DispatchTimeoutError(2.0, 1))
    assert port_errors.is_transient(port_errors.ReplicaUnavailableError(0))
    assert not port_errors.is_transient(
        port_errors.MixedSequenceLengthError([3, 4]))
    for pkg in (port_errors, jax_errors):
        assert issubclass(pkg.ReplicaUnavailableError,
                          pkg.TransientQueryError)
        assert issubclass(pkg.MixedSequenceLengthError, ValueError)
    assert str(port_errors.DispatchTimeoutError(2.0, 1)) == \
        str(jax_errors.DispatchTimeoutError(2.0, 1))
    view = dict(query=3, arrival=1.5, wait=0.2, est_service=0.1,
                est_latency=0.4, tier=1, priority=2)
    fields = [f.name for f in dataclasses.fields(jax_control.AdmissionView)]
    assert fields == [f.name for f in
                      dataclasses.fields(port_control.AdmissionView)]
    kw = {k: v for k, v in view.items() if k in fields}
    assert dataclasses.asdict(port_control.AdmissionView(**kw)) == \
        dataclasses.asdict(jax_control.AdmissionView(**kw))


# ---------------------------------------------------------------------------
# telemetry


@pytest.mark.parametrize("n", [10, 5000, 40000])
def test_sketch_matches(n):
    rng = np.random.default_rng(n)
    vals = rng.lognormal(size=n)
    a, b = port_tel.QuantileSketch(), jax_tel.QuantileSketch()
    for chunk in np.array_split(vals, 7):
        a.add(chunk)
        b.add(chunk)
    for p in (0, 1, 50, 90, 99, 99.9, 100):
        assert _equal(a.percentile(p), b.percentile(p))
    assert (a.n, a.min, a.max, a.sum) == (b.n, b.min, b.max, b.sum)
    assert _equal(a.cdf(1.0), b.cdf(1.0))
    m_a = port_tel.QuantileSketch.merged([a, a.copy()])
    m_b = jax_tel.QuantileSketch.merged([b, b.copy()])
    assert _equal(m_a.percentile(99), m_b.percentile(99))


@pytest.mark.parametrize("retention", ["collapse", "ring"])
def test_rollup_matches(retention):
    rng = np.random.default_rng(1)
    t = np.cumsum(rng.exponential(0.01, 3000))
    done = t + rng.exponential(0.05, 3000)
    rolls = [pkg.tel.WindowedRollup(width=0.05, max_windows=64,
                                    retention=retention)
             for pkg in (PORT, JAX)]
    for r in rolls:
        for lo in range(0, 3000, 500):
            r.observe_arrivals(t[lo:lo + 500])
            r.observe_completions(done[lo:lo + 500],
                                  done[lo:lo + 500] - t[lo:lo + 500])
            r.observe_shed(t[lo:lo + 500:50])
    a, b = rolls
    assert (a.num_windows, a.width) == (b.num_windows, b.width)
    assert _equal(a.edges(), b.edges())
    assert _equal(list(a.rates()), list(b.rates()))


def test_streaming_collector_matches():
    """One record stream through both collectors: the same summaries,
    registry snapshots and sink emissions."""
    rng = np.random.default_rng(2)
    chunks = []
    t = 0.0
    for _ in range(12):
        n = 80
        arr = t + np.cumsum(rng.exponential(0.004, n))
        svc = rng.exponential(0.01, n)
        qd = rng.exponential(0.005, n)
        chunks.append(dict(latencies=svc + qd, service=svc, queue_delay=qd,
                           throughputs=1.0 / rng.uniform(0.002, 0.004, n),
                           serial=rng.random(n) < 0.1, arrivals=arr,
                           completions=arr + svc + qd,
                           depths=rng.integers(0, 6, n),
                           batch_sizes=rng.integers(1, 5, n).astype(float),
                           padded=np.full(n, 256.0),
                           actual=rng.integers(60, 257, n).astype(float)))
        t = float(arr[-1])
    results = []
    for pkg in (PORT, JAX):
        sink = pkg.tel.MemorySink()
        col = pkg.tel.StreamingCollector(slo=0.05, sink=sink,
                                         sink_interval=100)
        for c in chunks:
            col.observe_chunk(c["latencies"], c["service"],
                              c["queue_delay"], c["throughputs"],
                              c["serial"], c["arrivals"], c["completions"],
                              c["depths"], batch_sizes=c["batch_sizes"],
                              padded_tokens=c["padded"],
                              actual_tokens=c["actual"])
            col.emit()
        col.observe_shed(np.array([0.5, 0.7]))
        trace = col.finish(scheduler="odin", workload="bursty",
                           num_rebalances=2, total_trials=5,
                           mitigation_lengths=[2, 3])
        results.append((trace.summary(), json.dumps(
            trace.snapshot(), sort_keys=True, default=str),
            json.dumps(sink.snapshots, sort_keys=True, default=str),
            trace.prometheus()))
    (sa, ja, ka, pa), (sb, jb, kb, pb) = results
    _assert_summaries_equal(sa, sb)
    assert ja == jb and ka == kb and pa == pb


# ---------------------------------------------------------------------------
# the run loop, driven by one deterministic executor


class FakeExecutor:
    """A deterministic stand-in for the live engine's query executor.

    Per-block times come from a seed (with a per-query jitter drawn up
    front) and are stretched by the slowdown schedule; all times are
    virtual.  It keeps an EMA of per-block estimates like the engine,
    arms detection after its first measurement, and provides every hook
    the run loop drives: ``begin_query``, ``execute``, ``execute_many``,
    ``steady_horizon``, ``configure_batching`` and ``begin_dispatch``
    (a builder with ``add``, ``next_boundary``, ``join`` and ``finish``).
    It returns the records of whichever package ``pkg`` drives it.
    """

    def __init__(self, pkg, runtime, lengths, schedule, seed=0,
                 max_batch=1, blocks=12):
        self.pkg, self.runtime = pkg, runtime
        self.lengths = np.asarray(lengths, dtype=np.int64)
        self.queries = self.lengths          # the loop only counts them
        self.schedule = schedule
        self.max_batch = max(1, int(max_batch))
        rng = np.random.default_rng(seed)
        self.bt = rng.uniform(0.5e-3, 1.5e-3, blocks)
        self.jitter = rng.uniform(0.99, 1.01, (len(lengths), blocks))
        self.est = None
        self._slow = None
        self.former = None
        self._padded = None

    @property
    def batch_mode(self):
        return "batch" if self.max_batch > 1 else None

    @property
    def max_chunk(self):
        return self.max_batch

    def stage_times(self, q, config, rows):
        counts = np.asarray(config)
        per_block = self.bt * self.jitter[q] * rows
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        out = np.zeros(len(counts))
        nz = counts > 0
        out[nz] = np.add.reduceat(per_block, starts[nz])
        return out * np.asarray(self.schedule(q), float)

    def _width(self, q):
        return int(self._padded[q] if self._padded is not None
                   else self.lengths[q])

    def begin_query(self, q):
        self._slow = np.asarray(self.schedule(q), float)
        if self.est is None:
            return None
        return self.pkg.Source(self.est, self._slow)

    def steady_horizon(self, q):
        base, width, n = self.schedule(q), self._width(q), 1
        while (n < self.max_batch and q + n < len(self.lengths)
               and self._width(q + n) == width
               and self.schedule(q + n) == base):
            n += 1
        return n

    def configure_batching(self, former, lengths, padded):
        self.former = former
        self._padded = None if padded is None else np.asarray(padded)
        if former is not None:
            self.max_batch = max(self.max_batch, former.max_batch)

    def _measure(self, config, st):
        counts = np.asarray(config)
        per_block = np.repeat(st / self._slow / np.maximum(counts, 1),
                              counts)
        first = self.est is None
        self.est = (per_block.copy() if first
                    else 0.5 * self.est + 0.5 * per_block)
        if first:
            self.runtime.arm(self.pkg.Source(self.est, self._slow))
        live = [i for i, c in enumerate(config) if c > 0]
        return float(st[live].max())

    def execute(self, q, step):
        st = self.stage_times(q, step.config, 1)
        latency = float(st.sum())
        tmax = self._measure(step.config, st)
        thr = 1.0 / (latency if self.former is not None else tmax)
        return self.pkg.wl.QueryRecord(service_latency=latency,
                                       throughput=thr)

    def execute_many(self, q0, steps):
        n = len(steps)
        st = self.stage_times(q0, steps[0].config, n)
        wall = float(st.sum())
        tmax = max(self._measure(steps[0].config, st / n), 1e-12)
        return self.pkg.wl.BatchRecord(
            service_latencies=wall - np.arange(n) * tmax,
            throughputs=np.broadcast_to(1.0 / tmax, n))

    def begin_dispatch(self, q0, step):
        return FakeDispatch(self, q0, step)


class FakeDispatch:
    """A formed dispatch on a virtual clock: each stage costs its rows'
    time; a joiner pays its own catch-up through the stages run so far."""

    def __init__(self, fx, q0, step):
        self.fx, self.q0, self.config = fx, q0, list(step.config)
        self.S, self.seq = len(self.config), fx._width(q0)
        self.members, self.starts = [], []
        self.stage, self.clock, self.rows = 0, 0.0, 0
        self.launched = False
        self.stage_times = np.zeros(self.S)
        self.stage_members = np.zeros(self.S)
        self.actual = 0.0

    def add(self, q):
        self.members.append(q)
        self.starts.append(0.0)
        self.actual += float(self.fx.lengths[q])

    def _run_stage(self):
        if not self.launched:
            self.launched, self.rows = True, len(self.members)
        s = self.stage
        st = self.fx.stage_times(self.q0, self.config, self.rows)[s]
        self.stage_members[s] = len(self.members)
        self.stage_times[s] = st
        self.clock += st
        self.stage += 1

    def next_boundary(self):
        self._run_stage()
        return None if self.stage >= self.S else self.clock

    def join(self, q):
        assert 0 < self.stage < self.S
        self.starts.append(self.clock)
        self.clock += float(self.fx.stage_times(
            q, self.config, 1)[:self.stage].sum())
        self.rows += 1
        self.members.append(q)
        self.actual += float(self.fx.lengths[q])

    def finish(self):
        while self.stage < self.S:
            self._run_stage()
        drain = self.clock + 1e-4
        self.fx._measure(self.config, self.stage_times
                         / np.maximum(self.stage_members, 1.0))
        return self.fx.pkg.wl.DispatchRecord(
            start_offsets=self.starts, drain=drain, throughput=1.0 / drain,
            padded_tokens=float(next_pow2(self.rows)) * float(self.seq),
            actual_tokens=self.actual)


N_QUERIES = 60


def _loop_schedule(q):
    slow = [1.0] * 4
    if 15 <= q < 40:
        slow[1] = 3.0
    return slow


LOOP_WORKLOADS = {
    "closed": None,
    "poisson": dict(rate=60.0, seed=1),
    "bursty": dict(burst_rate=80.0, base_rate=10.0, mean_burst=0.3,
                   mean_gap=0.2, seed=2),
    "trace": dict(inter_arrivals=list(np.random.default_rng(3).exponential(
        1 / 50.0, 40))),
}
BATCHING = {
    "none": dict(max_batch=1, mode=None),
    "max_batch_4": dict(max_batch=4, mode=None),
    "drain": dict(max_batch=4, mode="drain"),
    "continuous": dict(max_batch=4, mode="continuous"),
    "drain_explore": dict(max_batch=4, mode="drain", explore=True),
    "continuous_explore": dict(max_batch=4, mode="continuous",
                               explore=True),
}


def _drive(pkg, workload, batching, trace_mode, sink=False):
    lengths = np.random.default_rng(4).choice([40, 64, 100, 256], N_QUERIES,
                                              p=[0.3, 0.3, 0.2, 0.2])
    runtime = pkg.Runtime(pkg.policy("odin"), [3, 3, 3, 3])
    b = BATCHING[batching]
    former = pkg.batching.resolve_batching(
        b["mode"], max_batch=b["max_batch"], buckets="pow2:64:256",
        explore_in_batch=b.get("explore", False), seq=256)
    fx = FakeExecutor(pkg, runtime, lengths, _loop_schedule,
                      max_batch=(former.max_batch if former is not None
                                 else b["max_batch"]))
    memory = pkg.tel.MemorySink() if sink else None
    trace = pkg.runner._run_pipeline_impl(
        fx, runtime, N_QUERIES, workload=workload,
        workload_kwargs=LOOP_WORKLOADS[workload], scheduler_name="odin",
        trace_mode=trace_mode, metrics_sink=memory, sink_interval=16,
        former=former, lengths=(lengths if former is not None else None))
    trace.peak_throughput = 123.0
    return trace, memory


def _trace_fields(trace):
    if getattr(trace, "trace_mode", "dense") == "streaming":
        return dict(summary=trace.summary(), rebalances=trace.num_rebalances,
                    trials=trace.total_trials,
                    mitigations=trace.mitigation_lengths,
                    final=trace.final_config, snapshot=json.dumps(
                        trace.snapshot(), sort_keys=True, default=str))
    return {f.name: getattr(trace, f.name)
            for f in dataclasses.fields(trace)}


@pytest.mark.parametrize("trace_mode", ["dense", "streaming"])
@pytest.mark.parametrize("batching", list(BATCHING))
@pytest.mark.parametrize("workload", list(LOOP_WORKLOADS))
def test_run_loop_traces_are_equal(workload, batching, trace_mode):
    (a, sink_a), (b, sink_b) = (_drive(pkg, workload, batching, trace_mode,
                                       sink=True) for pkg in (PORT, JAX))
    assert type(a).__module__.startswith("repro_torch.")
    assert type(b).__module__.startswith("repro.")
    fa, fb = _trace_fields(a), _trace_fields(b)
    assert list(fa) == list(fb)
    bad = [k for k in fa if not _equal(fa[k], fb[k])]
    assert not bad, {k: (fa[k], fb[k]) for k in bad[:3]}
    _assert_summaries_equal(a.summary(), b.summary())
    assert json.dumps(sink_a.snapshots, sort_keys=True, default=str) == \
        json.dumps(sink_b.snapshots, sort_keys=True, default=str)
    assert len(sink_a.snapshots) >= 1
    if trace_mode == "dense":
        assert len(a.latencies) == N_QUERIES
        if BATCHING[batching]["mode"] == "continuous" and workload in (
                "bursty", "poisson"):
            assert a.summary()["mean_batch_occupancy"] > 1.0


@pytest.mark.parametrize("workload", ["poisson", "bursty", "trace"])
def test_run_loop_covers_joins_and_rebalances(workload):
    """The parity cases above exercise what they claim to: ODIN
    rebalances, formed batches fill, and continuous joins happen, as
    many in either package."""
    joins = {}
    for pkg in (PORT, JAX):
        lengths = np.random.default_rng(4).choice(
            [40, 64, 100, 256], N_QUERIES, p=[0.3, 0.3, 0.2, 0.2])
        runtime = pkg.Runtime(pkg.policy("odin"), [3, 3, 3, 3])
        former = pkg.batching.resolve_batching(
            "continuous", max_batch=4, buckets="pow2:64:256", seq=256)
        fx = FakeExecutor(pkg, runtime, lengths, _loop_schedule)
        made = []
        orig = fx.begin_dispatch

        def spy(q0, step, orig=orig, made=made):
            made.append(orig(q0, step))
            return made[-1]

        fx.begin_dispatch = spy
        trace = pkg.runner._run_pipeline_impl(
            fx, runtime, N_QUERIES, workload=workload,
            workload_kwargs=LOOP_WORKLOADS[workload], former=former,
            lengths=lengths)
        assert trace.num_rebalances >= 1
        assert trace.summary()["mean_batch_occupancy"] > 1.0
        joins[pkg is PORT] = sum(int(np.count_nonzero(d.starts))
                                 for d in made)
    assert joins[True] == joins[False] >= 1


@pytest.mark.parametrize("kwargs", [
    dict(admission="slo_shed", admission_kwargs=dict(slo=0.01)),
    dict(admission="queue_cap", admission_kwargs=dict(cap=2)),
    dict(faults="crash@5+3"),
    dict(faults="flaky@0+40:p=0.3", retries=2),
    dict(tiers="interactive,best_effort"),
], ids=["admission", "queue_cap", "faults", "retries", "tiers"])
def test_deferred_branches_raise(kwargs):
    """The admission, fault, retry and tier branches of the run loop
    (which once raised NotImplementedError while the control plane was
    not copied) give traces equal to the JAX loop's, through both
    ``_run_pipeline_impl`` and ``run_pipeline``."""
    for entry in ("_run_pipeline_impl", "run_pipeline"):
        traces = []
        for pkg in (PORT, JAX):
            runtime = pkg.Runtime(pkg.policy("odin"), [3, 3, 3, 3])
            fx = FakeExecutor(pkg, runtime, np.full(40, 64), _loop_schedule)
            run = (getattr(pkg.runner, entry) if entry.startswith("_")
                   else pkg.wl.run_pipeline)
            traces.append(run(fx, runtime, 40, workload="poisson",
                              workload_kwargs=dict(rate=500.0, seed=1),
                              **kwargs))
        a, b = traces
        fa, fb = _trace_fields(a), _trace_fields(b)
        assert list(fa) == list(fb)
        bad = [k for k in fa if not _equal(fa[k], fb[k])]
        assert not bad, {k: (fa[k], fb[k]) for k in bad[:3]}
        _assert_summaries_equal(a.summary(), b.summary())
        s = a.summary()
        if "admission" in kwargs:
            assert s["num_shed"] > 0
        if "faults" in kwargs:
            assert s["num_failed"] + s["num_retried"] > 0


def test_none_admission_is_the_disabled_control_plane():
    """"none" admits everything, as in the JAX package, where it gives
    the trace of a run without a control plane."""
    traces = []
    for admission in (None, "none"):
        runtime = RebalanceRuntime(PORT.policy("odin"), [3, 3, 3, 3])
        fx = FakeExecutor(PORT, runtime, np.full(30, 64), _loop_schedule)
        traces.append(port_wl.run_pipeline(
            fx, runtime, 30, workload="poisson",
            workload_kwargs=dict(rate=100.0, seed=0), admission=admission))
    _assert_summaries_equal(traces[0].summary(), traces[1].summary())
    assert traces[1].admission == "none"
