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

Mesh-sliced stages (ROADMAP item 6d), the ``repro.api`` surface (6e) and
admission, faults, retries and QoS tiers (6f) wait for later slices.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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
from repro_torch.schedulers.policies import make_scheduler
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
        if self.engine._block_times is None:
            return None
        return self.engine._measured_source(self._slow)

    def steady_horizon(self, q: int) -> int:
        """Constant-interference run length from ``q``: a batch shares
        one slowdown vector (a schedule edge ends the chunk) and one
        dispatch width (a change of sequence length, or of bucket edge
        with buckets attached, ends it)."""
        base = np.asarray(self.schedule(q), float)
        width = self._width(q)
        n = 1
        while (n < self.max_batch and q + n < len(self.queries)
               and self._width(q + n) == width
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
                eng.runtime.arm(eng._measured_source(self._slow))
            return tmax

        return finish

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
        if self.former is not None:
            # A formed dispatch is group-synchronous: a solo dispatch holds
            # the pipeline for its full drain, like a singleton batch.
            return QueryRecord(service_latency=latency,
                               throughput=1.0 / max(latency, 1e-12))
        return QueryRecord(service_latency=latency,
                           throughput=1.0 / max(tmax, 1e-12))

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
        # The batch holds the admission head for one batch-bottleneck beat
        # per member (occupancy tmax_batch / n) and every member completes
        # when the batch drains.  The run loop staggers member starts by
        # that occupancy, so service = wall - i * occupancy lands every
        # completion at dispatch + wall.
        return BatchRecord(
            service_latencies=wall - np.arange(n) * tmax,
            throughputs=np.broadcast_to(1.0 / tmax, n))


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
        done(self._stage_times / np.maximum(self._stage_members, 1.0))
        return DispatchRecord(
            start_offsets=np.asarray(self._starts, float),
            drain=drain,
            throughput=1.0 / max(drain, 1e-12),
            padded_tokens=float(next_pow2(self._rows)) * float(self._seq),
            actual_tokens=self._actual_tok)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: Dict, num_eps: int,
                 scheduler: str = "odin",
                 alpha: int = DEFAULT_ALPHA,
                 rel_threshold: Optional[float] = None,
                 estimate_beta: float = 0.5,
                 executor: Optional[LocalPipelineExecutor] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        # ``executor`` lets several engines share one pipeline (and its
        # warmed shapes) while each keeps its own runtime and estimates.
        self.executor = (executor if executor is not None
                         else LocalPipelineExecutor(cfg, params, device))
        self.num_eps = num_eps
        # Weight of the newest measurement in the per-block clean-time
        # EMA.  0.5 tracks fast; 0 freezes the estimates, which makes
        # scheduling decisions reproducible across serving windows.
        self.estimate_beta = float(estimate_beta)
        self.scheduler = scheduler
        self.policy = make_scheduler(scheduler, alpha=alpha,
                                     rel_threshold=rel_threshold,
                                     detector=MEASURED_DETECTOR_MODE)
        self._initial_config = balanced_config(cfg.num_blocks, num_eps)
        self.runtime = RebalanceRuntime(self.policy, self._initial_config)
        # EMA of measured per-block times feeds the scheduler's trial
        # evaluations between real executions.
        self._block_times: Optional[np.ndarray] = None

    def _measured_source(self, slowdowns) -> MeasuredTimeSource:
        """The scheduler's time source over the current estimates."""
        return MeasuredTimeSource(self._block_times, slowdowns)

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
        self.runtime.reset(self._initial_config)

    def estimated_peak_throughput(self) -> float:
        """Interference-free throughput of the starting configuration from
        the clean per-block estimates; NaN until a query was measured."""
        if self._block_times is None:
            return float("nan")
        clean = MeasuredTimeSource(self._block_times, np.ones(self.num_eps))
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
                    trace_mode: str = "dense",
                    metrics_sink=None,
                    sink_interval: Optional[int] = None) -> PipelineTrace:
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
                                   trace_mode=trace_mode,
                                   metrics_sink=metrics_sink,
                                   sink_interval=sink_interval,
                                   former=former,
                                   lengths=lengths)
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
              trace_mode: str = "dense",
              metrics_sink=None,
              sink_interval: Optional[int] = None) -> PipelineTrace:
        """Serve ``queries`` under ``slowdown_schedule(q) -> per-EP
        slowdown factors``; see :meth:`_serve_impl`.  (The JAX engine
        routes this through its ``repro.api`` RunSpec surface, ROADMAP
        item 6e; the port calls :meth:`_serve_impl` directly.)"""
        return self._serve_impl(
            queries, slowdown_schedule, workload=workload,
            workload_kwargs=workload_kwargs, max_batch=max_batch,
            batching=batching, buckets=buckets,
            explore_in_batch=explore_in_batch, trace_mode=trace_mode,
            metrics_sink=metrics_sink, sink_interval=sink_interval)
