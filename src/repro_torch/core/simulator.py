"""Query-driven pipeline simulator (paper §4 methodology).

Simulates an inference pipeline of N stages bound to N execution places
serving a window of queries (paper: 4000).  Interference events start
every ``freq_period`` queries on a random EP with a random scenario from
the database and last ``duration`` queries (overlaps resolve to the
highest-severity scenario; :class:`~repro_torch.core.events.EventTimeline`).
The scheduler under test is any registered :mod:`repro_torch.schedulers`
policy (``odin`` / ``lls`` / ``oracle`` / ``none`` / ``hybrid`` / user
plugins); the per-query detect → explore → commit state machine is the
:class:`~repro_torch.schedulers.runtime.RebalanceRuntime` and the per-query
tick itself is :func:`repro_torch.workloads.run_pipeline` — both shared with
the live serving engine, so during a rebalancing phase queries are
processed serially — one query per trial — exactly the paper's
exploration-overhead accounting.

Traffic is pluggable (:mod:`repro_torch.workloads`): the default ``closed``
workload reproduces the paper's saturated back-to-back stream
bit-for-bit; open-loop workloads (``poisson`` / ``bursty`` / ``trace``)
add arrival-queueing so latency decomposes into queueing delay +
service time.

The port's copy of the JAX package's ``core/simulator.py``; only import
paths differ.  ``tests/test_torch_simulator.py`` holds it equal to the
original.
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from repro_torch.core.database import LayerDatabase
from repro_torch.core.events import (  # noqa: F401  (re-exported, back-compat)
    EventTimeline,
    InterferenceEvent,
    generate_events,
)
from repro_torch.core.exhaustive import optimal_partition, optimal_partition_mesh
from repro_torch.core.mesh import (
    MeshSpec,
    balanced_assignment,
    collective_frac as _mesh_coll_frac,
    mesh_stage_times,
    resolve_mesh,
)
from repro_torch.core.pipeline_state import (
    balanced_config,
    pipelined_latency,
    serial_latency,
    throughput,
)
from repro_torch.schedulers.base import SchedulerPolicy
from repro_torch.schedulers.registry import make_scheduler
from repro_torch.schedulers.runtime import RebalanceRuntime, RuntimeStep
from repro_torch.workloads import (
    BatchRecord,
    PipelineTrace,
    QueryRecord,
    Workload,
)
from repro_torch.workloads.runner import _run_pipeline_impl
from repro_torch.workloads.base import DispatchRecord
from repro_torch.workloads.batching import resolve_batching


class SimTimeSource:
    """StageTimeSource backed by the database + current per-EP scenarios.

    Mesh-aware (docs/SHARDING.md): when built with a
    :class:`~repro_torch.core.mesh.MeshSpec`, ``stage_times(config,
    assignment)`` prices the sharded cost model — explorers pass trial
    assignments explicitly; single-argument calls (detectors, latency
    estimators) use the *committed* :attr:`assignment` the runtime
    syncs onto this source.  ``mesh=None`` (or no committed assignment
    yet) returns the unsharded compute times bit-identically.
    """

    def __init__(self, db: LayerDatabase, scenarios,
                 mesh: Optional[MeshSpec] = None):
        self.db = db
        self.scenarios = list(scenarios)
        self.mesh = mesh
        self.assignment = None       # committed slices; the runtime syncs
        self.coll_factor = 1.0       # mesh-event inflation (begin_query)
        self._layer_costs = (mesh.layer_costs(db.num_layers)
                             if mesh is not None else None)

    def stage_times(self, config, assignment=None) -> np.ndarray:
        compute = self.db.stage_times(config, self.scenarios)
        if self.mesh is None:
            return compute
        a = assignment if assignment is not None else self.assignment
        if a is None:
            return compute
        return mesh_stage_times(compute, config, a, self.mesh,
                                self.coll_factor,
                                layer_costs=self._layer_costs)

    def collective_frac(self, config, assignment=None) -> float:
        """Bottleneck stage's collective share (0.0 unsharded)."""
        if self.mesh is None:
            return 0.0
        a = assignment if assignment is not None else self.assignment
        if a is None:
            return 0.0
        compute = self.db.stage_times(config, self.scenarios)
        return _mesh_coll_frac(compute, config, a, self.mesh,
                               self.coll_factor,
                               layer_costs=self._layer_costs)


def _dispatch_throughput(spans: np.ndarray) -> float:
    """Throughput a dispatch record reports: one batch per full drain.

    Batched dispatch is group-synchronous — the engine launches the
    next dispatch only after this one retires — so the head occupancy
    (``1/throughput``) is the whole wall, not the bottleneck stage.
    Every dispatch site (profile, builder, execute, execute_many) goes
    through this one helper so the floats agree bit-for-bit.
    """
    total = float(np.sum(spans))
    return 1.0 / total if total > 0.0 else float("inf")


#: Deprecated alias — the simulator now returns the unified
#: :class:`repro_torch.workloads.PipelineTrace` (same fields plus the
#: arrival-queue surface).
SimResult = PipelineTrace


class DatabaseQueryExecutor:
    """Simulator-side :class:`~repro_torch.workloads.QueryExecutor`.

    The environment advance is the interference-event timeline; query
    "execution" is a database lookup evaluated with the paper's latency
    model (pipelined when steady, serial during exploration trials).
    Provides the resource-constrained DP optimum as the trace's
    reference throughput.

    Batch-granular fast path: the scenario vector is piecewise-constant
    between interference-event edges, so a steady chunk needs exactly
    one database gather per (config, scenario-segment) —
    ``execute_many`` broadcasts it; ``steady_horizon`` is the distance
    to the next event edge.  ``batch_mode = "vector"``: chunking is a
    pure computational speedup, per-query semantics unchanged.

    ``time_indexed=True`` anchors the event windows on the arrival
    clock instead of the query index (open-loop runs only): the run
    loop announces the arrival times via :meth:`set_arrivals` before
    serving, and each query's environment is the scenario vector at its
    *arrival time* — how replica-scoped cluster events stay wall-clock
    aligned across replicas serving different query counts
    (docs/CLUSTER.md).

    **Batched-dispatch cost model** (active only when a
    :class:`~repro_torch.workloads.batching.BatchFormer` is attached via
    :meth:`configure_batching`; everything below is bypassed otherwise,
    keeping pre-batching runs bit-identical): a stage executing a
    member set ``M`` takes ``overhead + t_s * sum_i(Lpad_i /
    length_ref)`` — a fixed per-dispatch stage cost (kernel launch +
    sync) plus compute linear in padded tokens.  A solo query's service
    time is the sum over occupied stages, and so is its head occupancy:
    batched dispatch is group-synchronous — the next dispatch launches
    only after this one drains, which is exactly why continuous joins
    pay (the steady-state ``pipelined_latency`` model keeps governing
    non-batched runs).
    """

    batch_mode = "vector"

    def __init__(self, db: LayerDatabase, num_eps: int,
                 events: List[InterferenceEvent], oracle,
                 time_indexed: bool = False,
                 mesh: Optional[MeshSpec] = None):
        self.db = db
        self.num_eps = num_eps
        self.mesh = mesh
        self.timeline = EventTimeline(events, num_eps,
                                      severity=db.scenario_severities(),
                                      time_indexed=time_indexed)
        self.scenarios = [0] * num_eps
        self.source = SimTimeSource(db, self.scenarios, mesh=mesh)
        self._oracle = oracle    # tuple(scenarios) -> (config, throughput)
        self._arrivals = None    # set by the run loop (time-indexed only)
        self.former = None       # BatchFormer (configure_batching)
        self._lengths = None     # per-query actual lengths
        self._padded = None      # per-query bucket-padded lengths
        self.batch_overhead = 0.0
        self.length_ref = None   # resolved at configure_batching time

    # -- batched dispatch (opt-in) ------------------------------------------
    def set_cost_model(self, batch_overhead: float,
                       length_ref: Optional[float] = None) -> None:
        """Tune the dispatch cost model (see class docs): fixed
        per-stage dispatch overhead, and the sequence length the
        database's profiled times correspond to (``None`` = derive from
        the run's largest padded length at :meth:`configure_batching`
        time)."""
        self.batch_overhead = float(batch_overhead)
        if length_ref is not None and length_ref <= 0:
            raise ValueError(f"length_ref must be > 0, got {length_ref}")
        self.length_ref = None if length_ref is None else float(length_ref)

    def configure_batching(self, former, lengths, padded) -> None:
        """Run-loop hook: attach the batch former + per-query lengths
        (actual and bucket-padded) before serving begins."""
        self.former = former
        self._lengths = lengths
        self._padded = padded
        if self.length_ref is None:
            self.length_ref = (float(np.max(padded))
                               if padded is not None else 1.0)

    def _lfrac(self, q: int) -> float:
        """Padded-length compute fraction of query ``q`` vs. the
        reference length the database times were profiled at."""
        if self._padded is None:
            return 1.0
        return float(self._padded[q]) / self.length_ref

    def _dispatch_times(self, config, lfrac: float,
                        assignment=None) -> np.ndarray:
        """Per-stage solo dispatch times under the batching cost model.
        On sharded runs the stage times already carry the committed (or
        explicitly passed trial) assignment's cost model."""
        times = self.source.stage_times(config, assignment)
        return np.where(times > 0.0,
                        self.batch_overhead + times * lfrac, 0.0)

    def dispatch_profile(self, q: int, config) -> tuple:
        """(wall, throughput, last_join_offset) of a solo dispatch of ``q``.

        ``throughput`` goes through the same helper a size-1 dispatch
        record reports, so the run loop's predicted head occupancy
        (``1/throughput``) is bit-identical to the ledger advance the
        executed dispatch will make.  ``last_join_offset`` is the clock
        offset of the final stage boundary a continuous joiner could
        still enter at — the vectorized path proves a stretch join-free
        by checking successor arrivals against it.
        """
        tp = self._dispatch_times(config, self._lfrac(q))
        wall = float(np.sum(tp))
        join = float(np.sum(tp[:-1])) if len(tp) > 1 else 0.0
        return wall, _dispatch_throughput(tp), join

    def begin_dispatch(self, q0: int, step: RuntimeStep):
        """Start forming a dispatch headed by query ``q0``."""
        return _SimDispatchBuilder(self, step.config, step.mesh)

    def set_arrivals(self, arrivals) -> None:
        """Run-loop hook: the per-query arrival times (``None`` for a
        closed loop).  Only consulted when the timeline is
        time-indexed, which requires an open-loop workload."""
        if self.timeline.time_indexed and arrivals is None:
            raise ValueError(
                "time-indexed interference events need an open-loop "
                "workload: a closed loop has no arrival clock to anchor "
                "the event windows on")
        self._arrivals = arrivals

    def _clock(self, q: int):
        """The timeline key for query ``q``: its arrival time on a
        time-indexed timeline, its index otherwise."""
        if not self.timeline.time_indexed:
            return q
        if self._arrivals is None:
            raise ValueError("time-indexed events: set_arrivals() was "
                             "never called with the arrival times")
        t = self._arrivals[q]
        if t is None:      # a closed-loop driver fed a clock of Nones
            raise ValueError(
                "time-indexed interference events need an open-loop "
                "workload: a closed loop has no arrival clock to anchor "
                "the event windows on")
        return t

    def begin_query(self, q: int) -> SimTimeSource:
        clock = self._clock(q)
        new_scen = self.timeline.scenarios_at(clock)
        if new_scen != self.scenarios:
            self.scenarios[:] = new_scen
            self.source.scenarios[:] = new_scen
        if self.mesh is not None:
            self.source.coll_factor = self.timeline.coll_factor_at(clock)
        return self.source

    def steady_horizon(self, q: int) -> int:
        if not self.timeline.time_indexed:
            return self.timeline.next_change(q) - q
        # Queries arriving before the next event edge share q's
        # environment; the horizon is how many of them there are.
        edge = self.timeline.next_change(self._arrivals[q])
        if edge == float("inf"):
            return len(self._arrivals) - q
        return int(np.searchsorted(self._arrivals, edge, side="left")) - q

    def reference_throughput(self, q: int) -> float:
        return self._oracle(tuple(self.scenarios))[1]

    def execute(self, q: int, step: RuntimeStep) -> QueryRecord:
        if self.former is not None:
            # Dispatch cost model: a solo query traverses its own
            # dispatch — sum of per-stage costs; dispatches are
            # group-synchronous, so the head is held for the full
            # drain.  Serial trials traverse the same stages (the
            # drain wait is the run loop's business).
            tp = self._dispatch_times(step.config, self._lfrac(q),
                                      step.mesh)
            cf = (self.source.collective_frac(step.config, step.mesh)
                  if self.mesh is not None else 0.0)
            return QueryRecord(service_latency=float(np.sum(tp)),
                               throughput=_dispatch_throughput(tp),
                               collective_frac=cf)
        times = self.source.stage_times(step.config, step.mesh)
        latency = (serial_latency(times) if step.serial
                   else pipelined_latency(times))
        cf = (self.source.collective_frac(step.config, step.mesh)
              if self.mesh is not None else 0.0)
        return QueryRecord(service_latency=latency,
                           throughput=throughput(times),
                           collective_frac=cf)

    def execute_many(self, q0: int, steps) -> BatchRecord:
        # Steady chunks share one (config, scenario-segment): one
        # database gather serves every query in the chunk, broadcast
        # to the chunk without materializing per-query copies.
        n = len(steps)
        cfs = None
        if self.mesh is not None:
            cfs = np.broadcast_to(
                self.source.collective_frac(steps[0].config,
                                            steps[0].mesh), n)
        if self.former is not None:
            # Chunks under a former are join-free solo stretches at one
            # padded length (the run loop cuts at bucket changes and
            # join points), so one dispatch profile broadcasts — the
            # identical floats a size-1 dispatch builder would report.
            tp = self._dispatch_times(steps[0].config, self._lfrac(q0),
                                      steps[0].mesh)
            return BatchRecord(
                service_latencies=np.broadcast_to(float(np.sum(tp)), n),
                throughputs=np.broadcast_to(_dispatch_throughput(tp), n),
                collective_fracs=cfs)
        times = self.source.stage_times(steps[0].config, steps[0].mesh)
        return BatchRecord(
            service_latencies=np.broadcast_to(pipelined_latency(times), n),
            throughputs=np.broadcast_to(throughput(times), n),
            collective_fracs=cfs)


class _SimDispatchBuilder:
    """Analytic dispatch builder (``begin_dispatch`` protocol).

    Tracks every span the dispatch executes — per-stage batch times
    plus joiners' catch-up runs — as a list; ``drain`` is their sum and
    the head is held for the largest one.  All reductions go through
    the same numpy calls ``execute``/``execute_many`` use, so a size-1
    dispatch is bit-identical to the vectorized solo-stretch path (the
    chunked == scalar invariant extends to batched runs).
    """

    def __init__(self, ex: "DatabaseQueryExecutor", config,
                 assignment=None):
        self._ex = ex
        self._times = ex.source.stage_times(config, assignment)
        self._coll_frac = (ex.source.collective_frac(config, assignment)
                           if ex.mesh is not None else 0.0)
        self._live = self._times > 0.0
        self._c = ex.batch_overhead
        self._S = len(self._times)
        self._stage = 0
        self._spans: List[float] = []
        self._starts: List[float] = []
        self._sum_lfrac = 0.0
        self._padded_tok = 0.0
        self._actual_tok = 0.0
        self._row_lfrac: Optional[float] = None   # head bucket, set on add
        self._row_pad: Optional[float] = None

    def _count_tokens(self, q: int) -> None:
        ex = self._ex
        if ex._padded is not None:
            # Rows occupy the dispatch width (the head's bucket) —
            # formation members share it, joiners pad up to it.
            self._padded_tok += (self._row_pad
                                 if self._row_pad is not None
                                 else float(ex._padded[q]))
            actual = ex._lengths[q] if ex._lengths is not None \
                else ex._padded[q]
            self._actual_tok += float(actual)

    def _clock(self) -> float:
        if not self._spans:
            return 0.0
        return float(np.sum(np.asarray(self._spans)))

    def add(self, q: int) -> None:
        if self._stage != 0:
            raise RuntimeError("add() after launch; use join()")
        if self._row_lfrac is None:
            self._row_lfrac = self._ex._lfrac(q)
            if self._ex._padded is not None:
                self._row_pad = float(self._ex._padded[q])
        self._sum_lfrac += self._row_lfrac
        self._starts.append(0.0)
        self._count_tokens(q)

    def next_boundary(self) -> Optional[float]:
        if self._stage >= self._S:
            return None
        s = self._stage
        T = (self._c + float(self._times[s]) * self._sum_lfrac
             if self._live[s] else 0.0)
        self._spans.append(T)
        self._stage += 1
        if self._stage >= self._S:
            return None      # drained: nothing left to join
        return self._clock()

    def join(self, q: int) -> None:
        if not 0 < self._stage < self._S:
            raise RuntimeError("join() is only valid at a stage boundary")
        lf = self._ex._lfrac(q)
        # Service begins at the boundary; the batch then waits out the
        # joiner's solo catch-up through the already-executed stages —
        # one fused ``run_stages(0, s)`` launch (a single dispatch
        # overhead), compute linear in the joiner's padded tokens.
        self._starts.append(self._clock())
        done = self._live[:self._stage]
        comp = float(np.sum(np.where(
            done, self._times[:self._stage] * lf, 0.0)))
        if bool(np.any(done)):
            self._spans.append(self._c + comp)
        self._sum_lfrac += lf
        self._count_tokens(q)

    def finish(self) -> DispatchRecord:
        while self._stage < self._S:
            self.next_boundary()
        spans = np.asarray(self._spans, float)
        return DispatchRecord(start_offsets=np.asarray(self._starts),
                              drain=float(np.sum(spans)),
                              throughput=_dispatch_throughput(spans),
                              padded_tokens=self._padded_tok,
                              actual_tokens=self._actual_tok,
                              collective_frac=self._coll_frac)


def _simulate_impl(db: LayerDatabase,
             num_eps: int,
             scheduler: Union[str, SchedulerPolicy] = "odin",
             alpha: int = 10,
             num_queries: int = 4000,
             freq_period: int = 10,
             duration: int = 10,
             seed: int = 0,
             rel_threshold: Optional[float] = None,
             events: Optional[List[InterferenceEvent]] = None,
             initial_config: Optional[List[int]] = None,
             workload: Union[str, Workload, None] = "closed",
             workload_kwargs: Optional[dict] = None,
             chunking: bool = True,
             max_chunk: Optional[int] = None,
             events_time_indexed: bool = False,
             admission: Union[str, object, None] = None,
             admission_kwargs: Optional[dict] = None,
             trace_mode: str = "dense",
             metrics_sink=None,
             sink_interval: Optional[int] = None,
             batching=None,
             max_batch: int = 8,
             buckets=None,
             explore_in_batch: bool = False,
             lengths=None,
             lengths_kwargs: Optional[dict] = None,
             batch_overhead: float = 0.0,
             length_ref: Optional[float] = None,
             faults=None,
             retries=None,
             tiers=None,
             tiers_kwargs: Optional[dict] = None,
             mesh=None) -> PipelineTrace:
    """Run one (scheduler, interference-setting, workload) simulation.

    ``scheduler`` is a registry name (``repro_torch.schedulers``) or an
    already-constructed :class:`SchedulerPolicy` instance; ``workload``
    likewise resolves through :mod:`repro_torch.workloads` (``closed`` —
    the default, the paper's saturated stream — or an open-loop
    process such as ``workload="poisson",
    workload_kwargs={"rate": ..., "seed": ...}``).
    ``rel_threshold=None`` uses the shared
    :data:`repro_torch.schedulers.DEFAULT_REL_THRESHOLD`.

    ``chunking=False`` forces the scalar per-query tick (the fast path
    is the default; closed-loop traces are bit-identical either way —
    see docs/WORKLOADS.md "Batching & the fast path").

    ``events_time_indexed=True`` interprets ``events`` on the arrival
    clock instead of the query index (open-loop workloads only; events
    must then be supplied explicitly — ``generate_events`` produces
    query-indexed starts).

    ``admission`` selects a :mod:`repro_torch.control` admission policy
    (e.g. ``admission="slo_shed", admission_kwargs={"slo": ...}``);
    shed queries are reported through the trace's shed/goodput
    surface.  The default (no policy) admits everything.

    ``trace_mode="streaming"`` / ``metrics_sink`` select the flat-memory
    telemetry path (docs/TELEMETRY.md): streaming runs return a
    :class:`~repro_torch.telemetry.StreamingTrace` with the same ``summary()``
    keys, and a sink receives periodic metric snapshots in either mode.

    ``batching`` turns on formed dispatch (docs/WORKLOADS.md
    "Continuous batching & length buckets"): ``"drain"`` stacks queued
    arrivals at dispatch instants, ``"continuous"`` additionally folds
    them in at stage boundaries; ``max_batch`` / ``buckets`` /
    ``explore_in_batch`` parameterize the
    :class:`~repro_torch.workloads.batching.BatchFormer`.  ``lengths``
    attaches a per-query sequence-length distribution
    (:mod:`repro_torch.workloads.lengths`); ``batch_overhead`` is the fixed
    per-stage dispatch cost and ``length_ref`` the sequence length the
    database times were profiled at (defaults to the largest bucket
    edge, else the largest sampled length).  ``batching=None`` (the
    default) bypasses all of it — bit-identical to pre-batching runs.

    ``faults`` injects deterministic failures (docs/FAULTS.md): a
    :class:`~repro_torch.faults.FaultPlan`, a spec string such as
    ``"crash@100+50"``, or a list of either; ``retries`` configures the
    transient-failure retry budget (``RetrySpec``, int, or dict).
    ``faults=None`` leaves every trace bit-identical to a fault-free
    build.

    ``mesh`` shards every stage over a slice of a device mesh
    (docs/SHARDING.md): a :class:`~repro_torch.core.mesh.MeshSpec`, a device
    count, or a kwargs dict (``{"devices": 8, "coll_cost": ...}``).
    Stage times follow the sharded cost model, the rebalance action
    space grows to (boundary, slice) moves, ``kind="mesh"`` events
    inflate collective time, and the trace gains the mesh surface
    (``mesh_trace`` / ``collective_fracs`` / mesh summary keys).
    ``mesh=None`` (the default) is bit-identical to an unsharded build.

    ``tiers`` stamps every arrival with a QoS tier (docs/QOS.md): a
    :class:`~repro_torch.qos.TierAssigner`, pre-built
    :class:`~repro_torch.qos.TierPlan`, preset-name string such as
    ``"interactive,best_effort"``, or a sequence of tier specs
    (``tiers_kwargs`` feeds the assignment mixture/seed).  Tiered
    traces grow per-tier accounting; ``tiers=None`` (the default)
    leaves every trace bit-identical to an untier-ed build.
    """
    if events is None:
        if events_time_indexed:
            raise ValueError("events_time_indexed=True needs explicit "
                             "events: generate_events() produces "
                             "query-indexed windows")
        events = generate_events(num_queries, num_eps, db.num_scenarios,
                                 freq_period, duration, seed)
    mesh_spec = resolve_mesh(mesh)
    config = (list(initial_config) if initial_config is not None
              else balanced_config(db.num_layers, num_eps))
    # Interference-free peak throughput of the starting configuration:
    # by assumption (§3.1) the initial config is the balanced optimum.
    clean = SimTimeSource(db, [0] * num_eps, mesh=mesh_spec)
    # Start from the true clean optimum so "peak" matches the paper's
    # "throughput of the inference pipeline when executing alone".
    if mesh_spec is None:
        if initial_config is None:
            opt_cfg, _ = optimal_partition(db, [0] * num_eps, num_eps)
            config = opt_cfg
        init_assign = None
    else:
        init_assign = balanced_assignment(mesh_spec.devices, num_eps)
        if initial_config is None:
            opt_cfg, opt_assign, _ = optimal_partition_mesh(
                db, [0] * num_eps, num_eps, mesh_spec)
            config, init_assign = list(opt_cfg), list(opt_assign)
        clean.assignment = list(init_assign)
    peak = throughput(clean.stage_times(config))

    # Cache the oracle per scenario-vector (it is deterministic); it backs
    # both the resource-constrained reference and the oracle policy.  On
    # sharded runs the key also carries the live collective-contention
    # factor and the value's first element is a (config, assignment) pair.
    oracle_cache = {}

    def _oracle(scen_key):
        if mesh_spec is None:
            if scen_key not in oracle_cache:
                oracle_cache[scen_key] = optimal_partition(
                    db, list(scen_key), num_eps)
            return oracle_cache[scen_key]
        f = executor.source.coll_factor
        key = (scen_key, f)
        if key not in oracle_cache:
            cfg, assign, T = optimal_partition_mesh(
                db, list(scen_key), num_eps, mesh_spec, coll_factor=f)
            oracle_cache[key] = ((cfg, assign), T)
        return oracle_cache[key]

    executor = DatabaseQueryExecutor(db, num_eps, events, _oracle,
                                     time_indexed=events_time_indexed,
                                     mesh=mesh_spec)
    former = resolve_batching(batching, max_batch=max_batch,
                              buckets=buckets,
                              explore_in_batch=explore_in_batch)
    if length_ref is None and former is not None \
            and former.buckets is not None:
        length_ref = float(former.buckets.edges[-1])
    executor.set_cost_model(batch_overhead, length_ref)

    def oracle_solver(cfg, src):
        opt = _oracle(tuple(executor.scenarios))[0]
        if mesh_spec is not None:
            return (list(opt[0]), list(opt[1]))
        return list(opt)

    if isinstance(scheduler, str):
        sched_name = scheduler
        policy = make_scheduler(scheduler, alpha=alpha,
                                rel_threshold=rel_threshold,
                                solver=oracle_solver)
    else:
        policy = scheduler
        sched_name = getattr(policy, "name", type(policy).__name__)
    runtime = RebalanceRuntime(policy, config, mesh=init_assign)

    return _run_pipeline_impl(
        executor, runtime, num_queries,
        workload=workload, workload_kwargs=workload_kwargs,
        scheduler_name=sched_name, peak_throughput=peak,
        chunking=chunking, max_chunk=max_chunk,
        admission=admission,
        admission_kwargs=admission_kwargs,
        trace_mode=trace_mode, metrics_sink=metrics_sink,
        sink_interval=sink_interval,
        former=former, lengths=lengths,
        lengths_kwargs=lengths_kwargs,
        faults=faults, retries=retries,
        tiers=tiers, tiers_kwargs=tiers_kwargs)


def simulate(db: LayerDatabase,
             num_eps: int,
             scheduler: Union[str, SchedulerPolicy] = "odin",
             alpha: int = 10,
             num_queries: int = 4000,
             freq_period: int = 10,
             duration: int = 10,
             seed: int = 0,
             rel_threshold: Optional[float] = None,
             events: Optional[List[InterferenceEvent]] = None,
             initial_config: Optional[List[int]] = None,
             workload: Union[str, Workload, None] = "closed",
             workload_kwargs: Optional[dict] = None,
             chunking: bool = True,
             max_chunk: Optional[int] = None,
             events_time_indexed: bool = False,
             admission: Union[str, object, None] = None,
             admission_kwargs: Optional[dict] = None,
             trace_mode: str = "dense",
             metrics_sink=None,
             sink_interval: Optional[int] = None,
             batching=None,
             max_batch: int = 8,
             buckets=None,
             explore_in_batch: bool = False,
             lengths=None,
             lengths_kwargs: Optional[dict] = None,
             batch_overhead: float = 0.0,
             length_ref: Optional[float] = None,
             faults=None,
             retries=None,
             tiers=None,
             tiers_kwargs: Optional[dict] = None) -> PipelineTrace:
    """Run one (scheduler, interference-setting, workload) simulation.

    Thin wrapper over the unified :class:`repro_torch.api.RunSpec` path (one
    declaration, one dispatcher — docs/API.md); the kwargs here map
    1:1 onto spec fields, traces are bit-identical either way, and
    *new* options land on the spec instead of this signature — e.g.
    mesh-sliced stages (docs/SHARDING.md) are
    ``run(RunSpec(db=db, ..., mesh=MeshSpec(...)))`` only.  See
    :func:`_simulate_impl` for the full kwarg-level documentation.
    """
    from repro_torch import api
    spec = api.RunSpec(
        db=db, num_eps=num_eps, num_queries=num_queries,
        freq_period=freq_period, duration=duration, seed=seed,
        events=events, events_time_indexed=events_time_indexed,
        scheduler=api.SchedulerSpec(name=scheduler, alpha=alpha,
                                    rel_threshold=rel_threshold,
                                    initial_config=initial_config),
        workload=api.WorkloadSpec(name=workload, kwargs=workload_kwargs),
        admission=api.AdmissionSpec(name=admission,
                                    kwargs=admission_kwargs),
        batching=api.BatchingSpec(mode=batching, max_batch=max_batch,
                                  buckets=buckets,
                                  explore_in_batch=explore_in_batch,
                                  chunking=chunking, max_chunk=max_chunk,
                                  lengths=lengths,
                                  lengths_kwargs=lengths_kwargs,
                                  batch_overhead=batch_overhead,
                                  length_ref=length_ref),
        faults=api.FaultsSpec(plan=faults),
        retries=api.RetriesSpec(policy=retries),
        tiers=api.TiersSpec(spec=tiers, kwargs=tiers_kwargs),
        telemetry=api.TelemetrySpec(trace_mode=trace_mode,
                                    metrics_sink=metrics_sink,
                                    sink_interval=sink_interval))
    return api.run(spec)


# The paper's 9 frequency/duration settings (§4.2).
PAPER_SETTINGS = [(f, d) for f in (2, 10, 100) for d in (2, 10, 100)]
