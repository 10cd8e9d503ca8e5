"""Live serving engine: scheduler policies against *measured* stage times.

The port's counterpart of the JAX package's ``serving/engine.py``: each
query runs for real through the
:class:`~repro_torch.pipeline.executor.LocalPipelineExecutor`, its stage
times are measured, an EMA of per-block times feeds a
:class:`~repro_torch.pipeline.executor.MeasuredTimeSource`, and the
detect → explore → commit machine
:class:`~repro_torch.schedulers.runtime.RebalanceRuntime` picks the
configuration of the next query.  Interference is injected as per-EP
slowdown factors that stretch the measured stage times.

The per-query loop is the port's copy of the shared run loop
(:func:`repro_torch.workloads.runner._run_pipeline_impl`): the engine only
supplies physical time.  Any workload plugs in (closed loop by default;
``poisson`` / ``bursty`` / ``diurnal`` / ``ramp`` / ``trace`` for open-loop
runs, with queueing accounted in wall-clock seconds).

``serve(..., max_batch=N)`` stacks open-loop arrivals that queued behind
the pipeline into one ``run_batch`` -- one set of stage launches per
burst -- while the detector still observes every query.

``serve(..., batching="continuous", buckets=...)`` runs length-bucketed
formed dispatches stage by stage through the executor's ``run_stages``;
a query that arrives while a same-bucket batch is in flight joins it at
the next stage boundary with one fused catch-up launch.  ``"drain"``
forms the same batches and runs them to completion.

``ServingEngine(..., mesh=MeshSpec(...))`` arms mesh-sliced stages
(docs/SHARDING.md) as in the JAX live engine: a scheduler-side model over
the measured compute times.  Each stage's measured time is divided by its
devices and a modelled collective term is added
(:func:`~repro_torch.core.mesh.mesh_stage_times`); the scheduler explores
(boundary, slice) moves over that model, and the trace reports the
modelled bottleneck and its collective share.  Every stage still runs on
the one card, and no slice of the card is resized: wall-clock service
latencies stay the measured ones.

``serve`` is a thin wrapper over :func:`repro_torch.api.run`, with the
JAX engine's admission policies, fault injection, retries and QoS tiers
(``repro_torch.control``, ``faults``, ``qos``).  A fleet of engines runs
through :func:`repro_torch.cluster.serve_cluster`; same-arch replicas
share one executor.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mesh import (
    balanced_assignment,
    collective_frac as _mesh_collective_frac,
    mesh_stage_times,
    resolve_mesh,
)
from repro_torch.core.pipeline_state import balanced_config, throughput
from repro_torch.pipeline.executor import (
    LocalPipelineExecutor,
    MeasuredTimeSource,
    next_pow2,
    stage_bounds,
)
from repro_torch.schedulers.defaults import (
    DEFAULT_ALPHA,
    MEASURED_DETECTOR_MODE,
)
from repro_torch.schedulers.base import SchedulerPolicy
from repro_torch.schedulers.registry import make_scheduler
from repro_torch.schedulers.runtime import RebalanceRuntime, RuntimeStep
from repro_torch.util.errors import QueryError
from repro_torch.workloads import (
    BatchRecord,
    DispatchRecord,
    PipelineTrace,
    QueryRecord,
    Workload,
    resolve_batching,
)
from repro_torch.workloads.runner import _run_pipeline_impl

#: The JAX package's alias: ``serve()`` returns the unified
#: :class:`~repro_torch.workloads.PipelineTrace`.
ServeMetrics = PipelineTrace


class _LiveQueryExecutor:
    """Engine-side :class:`~repro_torch.workloads.QueryExecutor`.

    Each query runs for real through the engine's executor; the scheduler
    runtime is polled with a ``MeasuredTimeSource`` over the engine's
    per-block time estimates.  Until the first query has been measured
    there are none, so :meth:`begin_query` returns ``None`` and the query
    runs steady; detection is armed after it.

    With ``max_batch > 1`` the executor opts into the run loop's real
    batching (``batch_mode = "batch"``): queries that have already
    arrived are drained into one ``run_batch`` call.  The scheduler is
    still polled per query, so rebalance and trial accounting stay
    aligned with the unbatched run.
    """

    def __init__(self, engine: "ServingEngine",
                 queries: Sequence[torch.Tensor], slowdown_schedule,
                 max_batch: int = 1):
        self.engine = engine
        self.queries = queries
        self.schedule = slowdown_schedule
        self.max_batch = max(1, int(max_batch))
        self._slow: Optional[np.ndarray] = None
        self._cf = 1.0  # live collective-contention factor (mesh runs)
        # Formed-dispatch state (the run loop's configure_batching hook
        # fills it in when a BatchFormer is attached).
        self.former = None
        self._lengths: Optional[np.ndarray] = None
        self._padded: Optional[np.ndarray] = None

    @property
    def batch_mode(self) -> Optional[str]:
        return "batch" if self.max_batch > 1 else None

    @property
    def max_chunk(self) -> int:
        return self.max_batch

    def begin_query(self, q: int) -> Optional[MeasuredTimeSource]:
        self._slow = np.asarray(self.schedule(q), float)
        self._cf = self.engine._coll_factor_at(q)
        if self.engine._block_times is None:
            return None
        return self.engine._measured_source(self._slow, self._cf)

    def steady_horizon(self, q: int) -> int:
        """Constant-interference run length from ``q``: a batch shares
        one slowdown vector (a schedule edge ends the chunk), one
        collective-contention factor when a mesh is armed, and one
        dispatch width (a change of sequence length, or of bucket edge
        with buckets attached, ends it)."""
        base = np.asarray(self.schedule(q), float)
        cf = self.engine._coll_factor_at(q)
        width = self._width(q)
        n = 1
        while (n < self.max_batch and q + n < len(self.queries)
               and self._width(q + n) == width
               and self.engine._coll_factor_at(q + n) == cf
               and np.array_equal(np.asarray(self.schedule(q + n), float),
                                  base)):
            n += 1
        return n

    def _width(self, q: int) -> int:
        """Sequence length query ``q`` dispatches at (its bucket edge when
        buckets are attached, its raw length otherwise)."""
        if self._padded is not None:
            return int(self._padded[q])
        return int(self.queries[q].shape[-1])

    # -- formed dispatch (run-loop hooks) -----------------------------------
    def configure_batching(self, former, lengths, padded) -> None:
        """Run-loop hook: attach the dispatch former and the per-query
        (raw, padded) lengths, and warm the closed bucketed shape set --
        power-of-two row counts x the bucket edges the traffic uses -- so
        no dispatch inside the serving loop measures a first-shape
        allocation."""
        self.former = former
        self._lengths = (None if lengths is None
                         else np.asarray(lengths, dtype=np.int64))
        self._padded = (None if padded is None
                        else np.asarray(padded, dtype=np.int64))
        if former is None:
            return
        self.max_batch = max(self.max_batch, int(former.max_batch))
        if self._padded is not None:
            edges = sorted({int(s) for s in self._padded})
        else:
            edges = sorted({int(t.shape[-1]) for t in self.queries})
        max_rows = max((int(t.shape[0]) for t in self.queries), default=1)
        self.engine.executor.warm_buckets(edges, self.max_batch * max_rows)

    def _dispatch_tokens(self, q: int) -> torch.Tensor:
        """Query ``q``'s tokens, right-padded with token 0 to its bucket
        edge, so every dispatch shape comes from the warm set.  Causal
        attention and the causal scan leave the real positions
        untouched."""
        t = self.queries[q]
        if self._padded is None:
            return t
        seq, raw = int(self._padded[q]), int(t.shape[-1])
        if seq == raw:
            return t
        return F.pad(t, (0, seq - raw))

    def begin_dispatch(self, q0: int,
                       step: RuntimeStep) -> "_LiveDispatchBuilder":
        return _LiveDispatchBuilder(self, q0, step)

    def _measure(self, config, first_measurement: bool):
        """Post-execution bookkeeping shared by every path: bottleneck
        time, EMA estimate refresh, first-measurement detector arming."""
        eng = self.engine

        def finish(stage_times_per_query: np.ndarray) -> float:
            live = [i for i, c in enumerate(config) if c > 0]
            tmax = float(stage_times_per_query[live].max())
            eng._update_block_estimates(config, stage_times_per_query,
                                        self._slow)
            if first_measurement:
                # Arm detection against this query's measured conditions,
                # so interference beginning at the very next query is a
                # shift from this baseline rather than the baseline.
                eng.runtime.arm(eng._measured_source(self._slow, self._cf))
            return tmax

        return finish

    def _mesh_model(self, stage_times: np.ndarray, config,
                    assignment) -> tuple:
        """Scheduler-side sharded-stage model over *measured* per-stage
        compute times: (modeled bottleneck time, collective share).
        Wall-clock service latencies are never rewritten -- only the
        capability/throughput signal the admission ledger and the trace
        columns consume (docs/SHARDING.md)."""
        eng = self.engine
        mt = mesh_stage_times(stage_times, config, assignment, eng.mesh,
                              self._cf, layer_costs=eng._coll_times)
        live = [i for i, c in enumerate(config) if c > 0]
        tmax = float(np.asarray(mt)[live].max())
        cf = _mesh_collective_frac(stage_times, config, assignment,
                                   eng.mesh, self._cf,
                                   layer_costs=eng._coll_times)
        return max(tmax, 1e-12), cf

    def execute(self, q: int, step: RuntimeStep) -> QueryRecord:
        eng = self.engine
        if self.former is not None:
            tokens = self._dispatch_tokens(q)
            rows = int(tokens.shape[0])
            pr = next_pow2(rows)
            eng.executor.ensure_warm(pr, int(tokens.shape[-1]))
            tokens = _pad_rows(tokens, rows)
        else:
            tokens = self.queries[q]
        finish = self._measure(step.config, eng._block_times is None)
        t0 = time.perf_counter()
        # run_query synchronises after the head, so the window closes on
        # the card's work, not on its enqueue.
        _, st = eng.executor.run_query(tokens, step.config,
                                       slowdowns=self._slow)
        latency = time.perf_counter() - t0
        tmax = finish(st)
        coll_frac = 0.0
        if eng.mesh is not None and step.mesh is not None:
            tmax, coll_frac = self._mesh_model(st, step.config, step.mesh)
        if self.former is not None:
            # A formed dispatch is group-synchronous: a solo dispatch holds
            # the pipeline for its full drain, like a singleton batch.
            return QueryRecord(service_latency=latency,
                               throughput=1.0 / max(latency, 1e-12),
                               collective_frac=coll_frac)
        return QueryRecord(service_latency=latency,
                           throughput=1.0 / max(tmax, 1e-12),
                           collective_frac=coll_frac)

    def execute_many(self, q0: int, steps) -> BatchRecord:
        eng = self.engine
        n = len(steps)
        batch = [self.queries[q0 + i] for i in range(n)]
        # Never measure a first-shape allocation as service time.  The key
        # set is bounded here (rows never exceed max_batch, one sequence
        # length per chunk).
        eng.executor.ensure_warm(sum(int(t.shape[0]) for t in batch),
                                 int(batch[0].shape[-1]))
        finish = self._measure(steps[0].config, eng._block_times is None)
        t0 = time.perf_counter()
        _, st = eng.executor.run_batch(batch, steps[0].config,
                                       slowdowns=self._slow)
        wall = time.perf_counter() - t0
        # Stage times cover the whole batch; the EMA takes the per-query
        # share.
        tmax = max(finish(st / n), 1e-12)
        coll_fracs = None
        if eng.mesh is not None and steps[0].mesh is not None:
            tmax, cf = self._mesh_model(st / n, steps[0].config,
                                        steps[0].mesh)
            coll_fracs = np.broadcast_to(cf, n)
        # The batch holds the admission head for one batch-bottleneck beat
        # per member (occupancy tmax_batch / n) and every member completes
        # when the batch drains.  The run loop staggers member starts by
        # that occupancy, so service = wall - i * occupancy lands every
        # completion at dispatch + wall.
        return BatchRecord(
            service_latencies=wall - np.arange(n) * tmax,
            throughputs=np.broadcast_to(1.0 / tmax, n),
            collective_fracs=coll_fracs)


def _pad_rows(arr: torch.Tensor, rows: int) -> torch.Tensor:
    """``arr`` with zero rows appended up to the next power of two."""
    pr = next_pow2(rows)
    if pr > rows:
        arr = torch.cat([arr, arr.new_zeros((pr - rows,) + arr.shape[1:])])
    return arr


class _LiveDispatchBuilder:
    """One physical batched dispatch, executed stage by stage.

    Formation members are stacked (sequence-padded to the bucket edge,
    rows rounded up to a power of two) and embedded once; the run loop
    then drives the pipeline one stage at a time through the executor's
    ``run_stages``.  At each stage boundary a newly arrived same-bucket
    query can :meth:`join`: it pays one fused catch-up launch (embed, then
    every block of stages ``[0, s)`` in one ``stage_fn`` call over the
    joiner alone), and its rows are spliced into the in-flight batch,
    which resumes wider.

    All times are wall-clock offsets from the dispatch launch, each read
    after a ``torch.cuda.synchronize()`` (the executor's), so the EMA sees
    the card's time and not the host's enqueue.  A dispatch is
    group-synchronous (the next launches only after this one drains), so
    the record's throughput is ``1 / drain``.  Tensors made by
    ``stage_fn`` are inference tensors: every splice runs under
    ``torch.inference_mode()``.
    """

    def __init__(self, live: _LiveQueryExecutor, q0: int,
                 step: RuntimeStep):
        self._live = live
        eng = live.engine
        self._ex = eng.executor
        self._config = list(step.config)
        self._mesh = (list(step.mesh) if step.mesh is not None else None)
        self._S = len(self._config)
        self._bounds = stage_bounds(self._config)
        self._slow = live._slow
        self._first = eng._block_times is None
        self._seq = live._width(q0)
        self._members: List[int] = []
        self._starts: List[float] = []
        self._stage = 0
        self._launched = False
        self._t0 = 0.0
        self._x: Optional[torch.Tensor] = None
        self._positions: Optional[torch.Tensor] = None
        self._rows = 0       # real (non-padding) rows in self._x
        self._stage_times = np.zeros(self._S)
        self._stage_members = np.zeros(self._S)
        self._actual_tok = 0.0

    def add(self, q: int) -> None:
        """Formation member: present from stage 0 (start offset 0)."""
        self._members.append(q)
        self._starts.append(0.0)
        self._count_tokens(q)

    def _count_tokens(self, q: int) -> None:
        live = self._live
        rows = int(live.queries[q].shape[0])
        raw = (int(live._lengths[q]) if live._lengths is not None
               else int(live.queries[q].shape[-1]))
        self._actual_tok += float(rows) * float(raw)

    @torch.inference_mode()
    def _launch(self) -> None:
        toks = [self._live._dispatch_tokens(q) for q in self._members]
        tokens = toks[0] if len(toks) == 1 else torch.cat(toks)
        rows = int(tokens.shape[0])
        self._ex.ensure_warm(next_pow2(rows), self._seq)
        tokens = _pad_rows(tokens, rows)
        self._rows = rows
        self._launched = True
        self._t0 = time.perf_counter()
        self._x, self._positions = self._ex.embed_tokens(tokens)

    @torch.inference_mode()
    def _run_stage(self) -> None:
        s = self._stage
        self._stage_members[s] = len(self._members)
        self._x, st = self._ex.run_stages(
            self._x, self._positions, self._config, s, s + 1,
            slowdowns=self._slow, bounds=self._bounds)
        self._stage_times[s] = float(st[0])
        self._stage += 1

    def next_boundary(self) -> Optional[float]:
        """Run the next stage; return the boundary's wall-clock offset (a
        join opportunity) or ``None`` after the final stage."""
        if not self._launched:
            self._launch()
        self._run_stage()
        if self._stage >= self._S:
            return None
        return time.perf_counter() - self._t0

    @torch.inference_mode()
    def join(self, q: int) -> None:
        if not 0 < self._stage < self._S:
            raise QueryError("join() is only valid at a stage boundary")
        live, ex = self._live, self._ex
        tokens = live._dispatch_tokens(q)
        jrows = int(tokens.shape[0])
        new_rows = self._rows + jrows
        # Both shapes the timed window touches, checked warm up front.
        ex.ensure_warm(next_pow2(jrows), self._seq)
        ex.ensure_warm(next_pow2(new_rows), self._seq)
        tokens = _pad_rows(tokens, jrows)
        self._starts.append(time.perf_counter() - self._t0)
        # One fused catch-up launch: embed, then every block of stages
        # [0, s) in a single stage_fn call and one synchronise, however
        # many stages the batch already ran (a per-stage loop would price
        # a join like a near-full solo query).
        h, positions = ex.embed_tokens(tokens)
        t1 = time.perf_counter()
        h = ex.stage_fn(h, positions, self._bounds[0][0],
                        self._bounds[self._stage - 1][1])
        ex._sync()
        if self._slow is not None:
            # Interference for the fused span: stretch by the mean
            # slowdown of the stages it covers (run_stages does this per
            # stage; the fused launch cannot attribute within).
            stretch = float(np.mean(
                np.asarray(self._slow, float)[:self._stage]))
            if stretch > 1.0:
                time.sleep((time.perf_counter() - t1) * (stretch - 1.0))
        # Splice the joiner's real rows into the in-flight batch and
        # re-pad to the next power of two.
        x = _pad_rows(torch.cat([self._x[:self._rows], h[:jrows]]),
                      new_rows)
        ex._sync()
        self._x = x
        self._positions = ex._positions(int(x.shape[0]), self._seq)
        self._rows = new_rows
        self._members.append(q)
        self._count_tokens(q)

    @torch.inference_mode()
    def finish(self) -> DispatchRecord:
        if not self._launched:
            self._launch()
        while self._stage < self._S:
            self._run_stage()
        self._ex.head(self._x)       # synchronised; the logits are dropped
        drain = time.perf_counter() - self._t0
        # Per-query stage-time attribution for the EMA: each stage's time
        # is shared by the members present when it ran (a joiner's
        # catch-up is dispatch latency, not a per-block time signal).
        done = self._live._measure(self._config, self._first)
        per_query = self._stage_times / np.maximum(self._stage_members, 1.0)
        done(per_query)
        coll_frac = 0.0
        if self._live.engine.mesh is not None and self._mesh is not None:
            _, coll_frac = self._live._mesh_model(per_query, self._config,
                                                  self._mesh)
        return DispatchRecord(
            start_offsets=np.asarray(self._starts, float),
            drain=drain,
            throughput=1.0 / max(drain, 1e-12),
            padded_tokens=float(next_pow2(self._rows)) * float(self._seq),
            actual_tokens=self._actual_tok,
            collective_frac=coll_frac)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: Dict, num_eps: int,
                 scheduler: Union[str, SchedulerPolicy] = "odin",
                 alpha: int = DEFAULT_ALPHA,
                 rel_threshold: Optional[float] = None,
                 estimate_beta: float = 0.5,
                 executor: Optional[LocalPipelineExecutor] = None,
                 mesh=None,
                 coll_factor_schedule=None,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        # Mesh-sliced stages (docs/SHARDING.md): scheduler-side modeling
        # over measured compute times.  ``mesh`` accepts anything
        # :func:`repro_torch.core.mesh.resolve_mesh` takes;
        # ``coll_factor_schedule(q) -> float`` emulates collective
        # contention the way ``slowdown_schedule`` emulates compute
        # interference.  Unset (the default), every mesh code path is
        # dormant.
        self.mesh = resolve_mesh(mesh)
        self.coll_factor_schedule = coll_factor_schedule
        self._coll_times = (self.mesh.layer_costs(cfg.num_blocks)
                            if self.mesh is not None else None)
        self._initial_assignment = (
            balanced_assignment(self.mesh.devices, num_eps)
            if self.mesh is not None else None)
        # ``executor`` lets several engines share one pipeline (and its
        # warmed shapes) while each keeps its own runtime and estimates.
        self.executor = (executor if executor is not None
                         else LocalPipelineExecutor(cfg, params, device))
        self.num_eps = num_eps
        # Weight of the newest measurement in the per-block clean-time
        # EMA.  0.5 tracks fast; 0 freezes the estimates, which makes
        # scheduling decisions reproducible across serving windows.
        self.estimate_beta = float(estimate_beta)
        if isinstance(scheduler, str):
            self.policy = make_scheduler(scheduler, alpha=alpha,
                                         rel_threshold=rel_threshold,
                                         detector=MEASURED_DETECTOR_MODE)
            self.scheduler = scheduler
        else:
            self.policy = scheduler
            self.scheduler = getattr(scheduler, "name",
                                     type(scheduler).__name__)
        self._initial_config = balanced_config(cfg.num_blocks, num_eps)
        self.runtime = RebalanceRuntime(self.policy, self._initial_config,
                                        mesh=self._initial_assignment)
        # EMA of measured per-block times feeds the scheduler's trial
        # evaluations between real executions.
        self._block_times: Optional[np.ndarray] = None

    def _coll_factor_at(self, q: int) -> float:
        """Collective-contention factor for query ``q`` (1.0 quiet /
        unsharded)."""
        if self.mesh is None or self.coll_factor_schedule is None:
            return 1.0
        return float(self.coll_factor_schedule(q))

    def _measured_source(self, slowdowns,
                         coll_factor: float = 1.0) -> MeasuredTimeSource:
        """The scheduler's time source over the current block-time
        estimates -- mesh-aware when a mesh is armed (the runtime syncs
        the committed assignment on every poll)."""
        if self.mesh is None:
            return MeasuredTimeSource(self._block_times, slowdowns)
        return MeasuredTimeSource(self._block_times, slowdowns,
                                  mesh=self.mesh,
                                  coll_times=self._coll_times,
                                  assignment=self.runtime.mesh,
                                  coll_factor=coll_factor)

    @property
    def config(self) -> List[int]:
        """Current committed stage configuration."""
        return list(self.runtime.config)

    def reset_policy(self) -> None:
        """Fresh serving window: abandon any in-flight phase, re-arm
        detection, and restart from the balanced initial configuration.
        Block-time estimates are kept (they describe the model); with
        ``estimate_beta = 0`` this makes scheduling reproducible across
        windows, e.g. for A/B comparisons of ``serve(..., max_batch=...)``.
        """
        self.runtime.reset(self._initial_config,
                           mesh=self._initial_assignment)

    def estimated_peak_throughput(self) -> float:
        """Interference-free throughput of the starting configuration from
        the clean per-block estimates; NaN until a query was measured."""
        if self._block_times is None:
            return float("nan")
        clean = MeasuredTimeSource(self._block_times,
                                   np.ones(self.num_eps),
                                   mesh=self.mesh,
                                   coll_times=self._coll_times,
                                   assignment=self._initial_assignment)
        return throughput(clean.stage_times(self._initial_config))

    def _update_block_estimates(self, config: Sequence[int],
                                stage_times: np.ndarray,
                                slowdowns: Sequence[float]) -> None:
        """Refresh per-block clean-time estimates from a measured query:
        each stage's de-slowed per-block time spread over its blocks, one
        fused EMA update.  The first measurement seeds the estimates."""
        counts = np.asarray(config, dtype=np.int64)
        per_stage = (np.asarray(stage_times, float)
                     / np.maximum(np.asarray(slowdowns, float), 1e-9)
                     / np.maximum(counts, 1))
        per_block = np.repeat(per_stage, counts)
        if self._block_times is None:
            self._block_times = per_block.copy()
            return
        b = self.estimate_beta
        self._block_times[:] = (1.0 - b) * self._block_times + b * per_block

    def query_executor(self, queries: Sequence[torch.Tensor],
                       slowdown_schedule,
                       max_batch: int = 1) -> _LiveQueryExecutor:
        """This engine's :class:`~repro_torch.workloads.QueryExecutor`
        half, for drivers of the shared run loop."""
        return _LiveQueryExecutor(self, queries, slowdown_schedule,
                                  max_batch=max_batch)

    def _serve_impl(self, queries: Sequence[torch.Tensor],
                    slowdown_schedule,
                    workload: Union[str, Workload, None] = "closed",
                    workload_kwargs: Optional[dict] = None,
                    max_batch: int = 1,
                    batching: Union[str, object, None] = None,
                    buckets: Union[str, object, None] = None,
                    explore_in_batch: bool = False,
                    admission: Union[str, object, None] = None,
                    admission_kwargs: Optional[dict] = None,
                    trace_mode: str = "dense",
                    metrics_sink=None,
                    sink_interval: Optional[int] = None,
                    faults=None,
                    retries=None,
                    tiers=None,
                    tiers_kwargs: Optional[dict] = None) -> PipelineTrace:
        """Serve ``queries`` under ``slowdown_schedule(q) -> per-EP
        slowdown factors (>= 1.0)``.

        ``workload`` picks the arrival process
        (``repro_torch.workloads``): the default closed loop executes
        back to back; open-loop workloads (rates in queries per second of
        wall-clock time) also report queueing delay and offered against
        achieved load.

        ``max_batch > 1`` stacks queued arrivals, up to ``max_batch`` per
        dispatch.  Batches never span an interference edge or a
        rebalance, and only queries that have already arrived join (a
        closed loop still serves one at a time).

        ``batching`` selects the formed-dispatch path: ``"drain"`` forms
        length-bucketed batches that run to completion; ``"continuous"``
        also admits arrivals into the in-flight batch at stage boundaries
        (one fused catch-up launch each).  ``buckets`` picks the length
        buckets (``"pow2:lo:hi"``, an edge list, ``"single"`` for one
        bucket at the longest query, or ``None`` for raw lengths); queries are right-padded to their
        bucket edge and batches row-padded to powers of two, so every
        dispatch shape comes from a small warmed set.
        ``explore_in_batch`` lets an exploration trial ride at the head of
        a formed batch.  With ``batching`` set, ``max_batch`` caps the
        dispatch width.

        ``trace_mode="streaming"`` / ``metrics_sink`` select the
        flat-memory telemetry path: streaming runs return a
        :class:`~repro_torch.telemetry.StreamingTrace`, sinks receive
        periodic snapshots in either mode.

        ``admission`` selects a :mod:`repro_torch.control` admission
        policy (e.g. ``admission="slo_shed", admission_kwargs={"slo":
        0.25}``, the SLO in wall-clock seconds); shed queries never reach
        the executor.

        ``faults`` / ``retries`` inject deterministic failures and arm the
        retry budget by wrapping this engine's executor in a
        :class:`~repro_torch.faults.FaultingExecutor`; a single engine's
        fault windows are indexed by query.  Only
        :class:`~repro_torch.util.errors.TransientQueryError` and its
        subclasses are retried: any other error (a CUDA error, a kernel
        that fails to build) ends the run.

        ``tiers`` / ``tiers_kwargs`` stamp arrivals with QoS tiers, drawn
        in the shared run loop as in the simulator.
        """
        seq_max = max((int(t.shape[-1]) for t in queries), default=1)
        former = resolve_batching(batching, max_batch=max_batch,
                                  buckets=buckets,
                                  explore_in_batch=explore_in_batch,
                                  seq=seq_max)
        lengths = None
        if former is not None:
            # The real query shapes are the length distribution here.
            lengths = np.array([int(t.shape[-1]) for t in queries],
                               dtype=np.int64)
        live = self.query_executor(
            queries, slowdown_schedule,
            max_batch=(former.max_batch if former is not None
                       else max_batch))
        trace = _run_pipeline_impl(live, self.runtime, len(queries),
                                   workload=workload,
                                   workload_kwargs=workload_kwargs,
                                   scheduler_name=self.scheduler,
                                   admission=admission,
                                   admission_kwargs=admission_kwargs,
                                   trace_mode=trace_mode,
                                   metrics_sink=metrics_sink,
                                   sink_interval=sink_interval,
                                   former=former,
                                   lengths=lengths,
                                   faults=faults, retries=retries,
                                   tiers=tiers, tiers_kwargs=tiers_kwargs)
        # The peak reference only exists after measurement: stamp it
        # post hoc so the trace's SLO metrics work like the simulator's.
        trace.peak_throughput = self.estimated_peak_throughput()
        return trace

    def serve(self, queries: Sequence[torch.Tensor],
              slowdown_schedule,
              workload: Union[str, Workload, None] = "closed",
              workload_kwargs: Optional[dict] = None,
              max_batch: int = 1,
              batching: Union[str, object, None] = None,
              buckets: Union[str, object, None] = None,
              explore_in_batch: bool = False,
              admission: Union[str, object, None] = None,
              admission_kwargs: Optional[dict] = None,
              trace_mode: str = "dense",
              metrics_sink=None,
              sink_interval: Optional[int] = None,
              faults=None,
              retries=None,
              tiers=None,
              tiers_kwargs: Optional[dict] = None) -> PipelineTrace:
        """Serve ``queries`` under ``slowdown_schedule(q) -> per-EP
        slowdown factors``.

        Thin wrapper over the unified :class:`repro_torch.api.RunSpec`
        path (one declaration, one dispatcher -- docs/API.md); the kwargs
        here map 1:1 onto spec fields, and physical per-engine state like
        the device mesh lives on the :class:`ServingEngine` constructor.
        See :meth:`_serve_impl` for the kwarg-level documentation.
        """
        from repro_torch import api
        spec = api.RunSpec(
            engine=self, queries=queries, schedule=slowdown_schedule,
            workload=api.WorkloadSpec(name=workload,
                                      kwargs=workload_kwargs),
            admission=api.AdmissionSpec(name=admission,
                                        kwargs=admission_kwargs),
            batching=api.BatchingSpec(mode=batching, max_batch=max_batch,
                                      buckets=buckets,
                                      explore_in_batch=explore_in_batch),
            faults=api.FaultsSpec(plan=faults),
            retries=api.RetriesSpec(policy=retries),
            tiers=api.TiersSpec(spec=tiers, kwargs=tiers_kwargs),
            telemetry=api.TelemetrySpec(trace_mode=trace_mode,
                                        metrics_sink=metrics_sink,
                                        sink_interval=sink_interval))
        return api.run(spec)
