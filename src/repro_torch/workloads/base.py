"""Workload & executor protocols for the unified run loop.

A :class:`Workload` describes *when queries arrive*; a
:class:`QueryExecutor` describes *how one query runs* (database lookups
in the simulator, real JAX execution in the live engine).  The one
:func:`~repro_torch.workloads.runner.run_pipeline` event loop combines them
with the shared :class:`~repro_torch.schedulers.runtime.RebalanceRuntime`, so
the simulator and the serving engine execute scheduling policies —
and report metrics — through identical code.

Time is whatever unit the executor's stage times are in: wall-clock
seconds for the live engine, database time units for the simulator.
Open-loop rates are expressed in queries per that unit.

The port's copy of the JAX package's ``workloads/base.py``; only import paths
differ.  ``tests/test_torch_workloads.py`` holds it equal to
the original.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Protocol, runtime_checkable

import numpy as np

if TYPE_CHECKING:  # annotation-only: keeps workloads import-cycle-free
    from repro_torch.core.pipeline_state import StageTimeSource
    from repro_torch.schedulers.runtime import RuntimeStep


@runtime_checkable
class Workload(Protocol):
    """An arrival process: closed-loop or a seeded open-loop generator."""

    #: False = closed loop: each query arrives the instant the pipeline
    #: can take it (no queueing).  True = open loop: arrivals are
    #: exogenous and queries queue when the pipeline falls behind.
    open_loop: bool

    def inter_arrivals(self, num_queries: int) -> Optional[np.ndarray]:
        """Gap before each query (same unit as the executor's times).

        Returns ``None`` for closed-loop workloads.  Must be
        deterministic: calling twice yields the identical array.
        """
        ...


@dataclasses.dataclass
class QueryRecord:
    """What one executed query reports back to the run loop."""

    #: Time the query spent in service (pipelined or serial latency);
    #: excludes any arrival-queue wait, which the run loop accounts.
    service_latency: float
    #: Pipeline capability while serving this query: 1 / bottleneck
    #: stage time.  Determines how soon the pipeline frees up for the
    #: next query when running pipelined.
    throughput: float
    #: Fraction of the bottleneck stage's time spent in collectives;
    #: 0.0 on unsharded runs (docs/SHARDING.md).
    collective_frac: float = 0.0


@dataclasses.dataclass
class BatchRecord:
    """What one executed *chunk* of queries reports back to the run loop.

    The batch-granular analogue of :class:`QueryRecord`: per-query
    arrays, index-aligned with the chunk.  Chunks are always
    environment-steady (one configuration, one interference state), so
    in practice every entry is the same value — but executors that
    attribute measured time non-uniformly may vary them, as long as the
    implied completion times stay non-decreasing (the run loop's
    vectorized ledger relies on that monotonicity).
    """

    #: Per-query time in service (excludes arrival-queue wait).
    service_latencies: np.ndarray
    #: Per-query pipeline capability.  ``1 / throughput`` is how long
    #: the query holds the admission head; a real stacked batch reports
    #: ``batch_size / bottleneck_stage_time`` for each member so the
    #: whole batch occupies the head for one bottleneck beat.
    throughputs: np.ndarray
    #: Per-query bottleneck collective share; ``None`` on unsharded
    #: runs (docs/SHARDING.md).
    collective_fracs: Optional[np.ndarray] = None

    def __post_init__(self):
        self.service_latencies = np.asarray(self.service_latencies, float)
        self.throughputs = np.asarray(self.throughputs, float)
        if self.service_latencies.shape != self.throughputs.shape:
            raise ValueError("BatchRecord arrays must be index-aligned")
        if self.collective_fracs is not None:
            self.collective_fracs = np.asarray(self.collective_fracs, float)


@dataclasses.dataclass
class DispatchRecord:
    """What one *formed dispatch* (a batch, possibly grown mid-flight by
    stage-boundary joins) reports back to the run loop.

    All offsets are relative to the dispatch start ``t0`` chosen by the
    run loop's ledger.  Every member completes together when the batch
    drains: ``completion_i = t0 + drain``; member ``i`` entered service
    at ``t0 + start_offsets[i]`` (0 for members present at dispatch,
    the join-boundary clock for continuous joiners), so its service
    latency is ``drain - start_offsets[i]`` and its queue delay is
    ``t0 + start_offsets[i] - arrival_i``.

    ``throughput`` is the dispatch-level service rate: formed dispatch
    is group-synchronous (the next dispatch launches only after this
    one retires), so ``1 / throughput`` is how long the dispatch holds
    the admission head — its full drain — and each of the ``n`` members
    reports ``n * throughput`` (n queries retired per drain).
    """

    #: Per-member service start offset from ``t0`` (non-decreasing).
    start_offsets: np.ndarray
    #: Batch completion offset from ``t0`` (all members finish here).
    drain: float
    #: Dispatch-level service rate (1 / full drain).
    throughput: float
    #: Total padded tokens executed (bucket-edge lengths x members,
    #: plus any batch-dimension padding rows); 0 when the run carries
    #: no length information.
    padded_tokens: float = 0.0
    #: Total useful tokens (actual query lengths); 0 when unknown.
    actual_tokens: float = 0.0
    #: Bottleneck collective share of the dispatch; 0.0 on unsharded
    #: runs (docs/SHARDING.md).
    collective_frac: float = 0.0

    def __post_init__(self):
        self.start_offsets = np.asarray(self.start_offsets, float)
        if self.start_offsets.ndim != 1 or len(self.start_offsets) == 0:
            raise ValueError("DispatchRecord needs >= 1 member")


class QueryExecutor(Protocol):
    """One query's environment + execution, driver-specific.

    Optionally an executor may also provide ``reference_throughput(q)
    -> float`` — the resource-constrained optimum under query ``q``'s
    interference (the simulator's DP oracle); the run loop records it
    into ``PipelineTrace.rc_throughputs`` when present.

    Executors that can service several queries at once opt into the
    run loop's batch-granular fast path by additionally providing:

    * ``batch_mode`` — ``"vector"`` (chunks are a pure computational
      speedup; per-query semantics unchanged, e.g. the simulator's
      array lookups) or ``"batch"`` (chunks are *real* batches whose
      members share one execution, e.g. the live engine stacking token
      arrays).  ``None`` / absent keeps the scalar path.
    * ``execute_many(q0, steps) -> BatchRecord`` — run queries
      ``q0 .. q0+len(steps)-1``; all steps are steady and share one
      configuration.
    * ``steady_horizon(q) -> int`` — how many queries starting at ``q``
      the environment is guaranteed constant for (same interference
      state); chunks never cross this boundary.
    * ``max_chunk`` (optional int) — executor-preferred chunk cap
      (e.g. the live engine's ``max_batch``).

    Executors that support **continuous batching** (a
    :class:`~repro_torch.workloads.batching.BatchFormer` attached to the run)
    additionally provide ``begin_dispatch(q0, step) -> builder``, where
    the builder exposes:

    * ``add(q)`` — stack query ``q`` into the batch before it launches.
    * ``next_boundary() -> Optional[float]`` — advance the batch one
      pipeline-stage; returns the boundary's clock offset from the
      dispatch start, or ``None`` once the batch has drained.
    * ``join(q)`` — fold query ``q`` into the in-flight batch at the
      current boundary (the builder catches it up through the already-
      executed stages and accounts the delay honestly).
    * ``finish() -> DispatchRecord`` — drain and report.

    The run loop drives the builder (it owns arrivals and admission);
    the builder owns execution — analytic stage arithmetic in the
    simulator, physical ``run_stages`` calls in the live engine.
    """

    def begin_query(self, q: int) -> Optional[StageTimeSource]:
        """Advance the environment to query ``q`` (interference events /
        slowdown schedules) and return the time source the scheduler
        runtime should be polled with — or ``None`` if the policy cannot
        be consulted yet (live engine before its first measurement), in
        which case the query runs steady on the committed config."""
        ...

    def execute(self, q: int, step: RuntimeStep) -> QueryRecord:
        """Run query ``q`` with ``step.config`` and report timings."""
        ...
