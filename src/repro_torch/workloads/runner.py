"""The one traffic-driven event loop shared by simulator and live engine.

``run_pipeline`` owns the per-query tick that ``simulate()`` and
``ServingEngine.serve()`` used to hand-roll separately: advance the
environment (interference events / slowdown schedules) via the
executor, poll the shared :class:`RebalanceRuntime` for the
configuration the query must run with, execute the query through the
driver's :class:`~repro_torch.workloads.base.QueryExecutor`, and keep the
arrival-queue ledger that turns a :class:`~repro_torch.workloads.base.Workload`
into per-query queueing delays and offered-vs-achieved load.

Queueing model: the pipeline admits one query per bottleneck beat.  A
pipelined query holds the admission head for ``1 / throughput`` (the
bottleneck stage time) and completes ``service_latency`` after it
starts; a serial (exploration-trial) query drains the pipeline and
holds the head for its full serial latency.  Closed-loop workloads
arrive exactly when the head frees up — zero queue delay, bit-identical
to the pre-workloads drivers.  Open-loop workloads arrive on their own
clock; when arrivals outpace admission, queries wait and
``latency = queue_delay + service_latency``.

Batch-granular fast path (docs/WORKLOADS.md "Batching & the fast
path"): executors that provide ``execute_many`` are driven in *chunks*
whenever the runtime is steady — no exploration phase in flight and no
detector transition pending.  A chunk never crosses a
rebalance-relevant boundary: an interference-event edge (the
executor's ``steady_horizon``), a detector trigger, a configuration
change, or the chunk cap.  Two flavors share the code:

* ``batch_mode = "vector"`` — the chunk is a pure computational
  speedup (the simulator): the scheduler is polled once per
  environment-steady segment (valid when the policy advertises
  ``steady_detect_stable``) and the whole arrival/queue/completion
  ledger is computed with vectorized numpy instead of the scalar tick.
* ``batch_mode = "batch"`` — the chunk is a *real* batch (the live
  engine): the scheduler is still polled per query, but queries that
  have already arrived are stacked and executed together, so a burst
  pays one set of stage dispatches instead of one per query.

Incremental driving (``repro_torch.cluster``): the loop's state — admission
ledger, per-query arrays, rebalance-counter snapshots — lives in
:class:`PipelineRunner`, which also supports being fed one query at a
time via :meth:`PipelineRunner.step`.  A multi-replica
:class:`~repro_torch.cluster.Cluster` owns one runner per replica and routes
each fleet arrival to one of them; ``run_pipeline`` itself is the
single-pipeline driver over the same runner.

Admission control (``repro_torch.control``, docs/CONTROL.md): an
:class:`~repro_torch.control.AdmissionPolicy` may shed arrivals the pipeline
cannot serve within its SLO.  A shed query never executes, never polls
the scheduler, and never advances the admission ledger; its arrival
time is recorded so the finished trace reports offered load, shed rate
and SLO attainment on *admitted* goodput.  Decisions are made at the
head of the loop with the actual ledger; inside a steady chunk a
predicted ledger (the runtime's estimated beat) decides where to cut —
exact for the simulator, whose steady chunks have constant beats.
Policies declaring ``admits_all`` (the ``none`` built-in) skip every
check, keeping closed-loop traces bit-identical to running without a
control plane.

Formed dispatch (``repro_torch.workloads.batching``, docs/WORKLOADS.md
"Continuous batching & length buckets"): when a
:class:`~repro_torch.workloads.batching.BatchFormer` is attached, queries are
served as *dispatches* — contiguous arrival-order runs sharing one
length bucket.  ``drain`` mode stacks the queued backlog at the
dispatch instant; ``continuous`` mode additionally folds arrivals in at
every pipeline-stage boundary via the executor's ``begin_dispatch``
builder.  Admission decisions happen only at dispatch *heads*: a query
that can join an in-flight batch is by construction being served
promptly, and keeping joiners shed-free is also what makes the chunked
and scalar paths take identical join/shed decisions (the vectorized
solo-stretch fast path proves a run of queries join-free from arrival
gaps alone, then admits them with the same predicted ledger the scalar
loop would).  With no former attached every batching branch is bypassed
— pre-former runs are bit-identical.

The port's copy of the JAX package's ``workloads/runner.py``; only import
paths differ.  ``tests/test_torch_workloads.py`` holds it equal to the original.
"""
from __future__ import annotations

import heapq
import inspect
from typing import TYPE_CHECKING, List, Optional, Tuple, Union

import numpy as np

from repro_torch.control.base import AdmissionView
from repro_torch.telemetry.streaming import StreamingCollector, StreamingTrace
from repro_torch.util.errors import DispatchTimeoutError, TransientQueryError
from repro_torch.workloads.base import QueryExecutor, Workload
from repro_torch.workloads.lengths import resolve_lengths
from repro_torch.workloads.registry import make_workload
from repro_torch.workloads.trace import PipelineTrace

if TYPE_CHECKING:  # annotation-only: keeps workloads <-> schedulers acyclic
    from repro_torch.control.base import AdmissionPolicy
    from repro_torch.schedulers.runtime import RebalanceRuntime
    from repro_torch.workloads.batching import BatchFormer

#: Fallback chunk cap when the executor does not prefer one.  Bounds the
#: temporary per-chunk arrays; segments longer than this simply split.
DEFAULT_MAX_CHUNK = 4096


def resolve_workload(workload: Union[str, Workload, None],
                     workload_kwargs: Optional[dict] = None) -> Workload:
    """Name (+ kwargs) or instance -> Workload instance."""
    if workload is None:
        workload = "closed"
    if isinstance(workload, str):
        return make_workload(workload, **(workload_kwargs or {}))
    if workload_kwargs:
        raise ValueError("workload_kwargs only apply to a workload name, "
                         "not an already-constructed instance")
    return workload


def resolve_arrivals(workload: Union[str, Workload, None],
                     workload_kwargs: Optional[dict],
                     num_queries: int) -> Tuple[str, Optional[np.ndarray]]:
    """Resolve a workload and materialize its arrival times.

    The shared prologue of every driver (``run_pipeline``, the
    cluster's fleet loop): returns ``(workload_name, arrival_times)``
    with ``arrival_times = None`` for a closed loop.
    """
    wl = resolve_workload(workload, workload_kwargs)
    wl_name = getattr(wl, "name", type(wl).__name__)
    gaps = wl.inter_arrivals(num_queries) if wl.open_loop else None
    if gaps is None:
        return wl_name, None
    if len(gaps) != num_queries:
        raise ValueError(f"workload {wl_name!r} produced {len(gaps)} "
                         f"inter-arrivals for {num_queries} queries")
    # Cumsum in place when the generator handed us a fresh array it
    # owns: at 10M+ queries the second O(n) float64 buffer is the
    # difference between flat and doubled RSS.  Workloads may legally
    # return views (TraceWorkload tiles a template), so fall back to an
    # out-of-place cumsum unless the array is provably ours to reuse.
    if (isinstance(gaps, np.ndarray) and gaps.dtype == np.float64
            and gaps.flags.owndata and gaps.flags.writeable):
        return wl_name, np.cumsum(gaps, out=gaps)
    return wl_name, np.cumsum(gaps)


class _CompletionLedger:
    """Completion times of admitted-but-unfinished queries.

    Replaces the old never-pruned ``bisect.insort`` list (O(n²) time and
    O(n) memory over a run) with a pruned min-heap: arrivals are
    monotone, so any completion ``<= arrival`` can never be counted by a
    later depth query and is dropped as the run advances — million-query
    runs stay O(n log n) with flat memory (the heap holds only the
    in-system queries, ~pipeline depth).
    """

    def __init__(self):
        self._heap: List[float] = []
        self._idx = np.arange(256)     # grown on demand, reused per chunk

    def depth_at(self, arrival: float) -> int:
        """In-system depth seen by an arrival (completions > arrival)."""
        heap = self._heap
        while heap and heap[0] <= arrival:
            heapq.heappop(heap)
        return len(heap)

    def push(self, completion: float) -> None:
        heapq.heappush(self._heap, completion)

    def depths_bulk(self, arrivals: np.ndarray,
                    completions: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`depth_at` + :meth:`push` for one chunk.

        ``arrivals`` and ``completions`` are the chunk's index-aligned
        ledger arrays; both are non-decreasing (chunks are
        environment-steady).  Depth ``i`` counts prior in-flight
        completions plus chunk members ``j < i`` still in flight.
        """
        if len(completions) > 1:
            dec = completions[:-1] - completions[1:]
            # Executors attribute per-query times with float arithmetic
            # whose rounding can wiggle mathematically-equal completions
            # by an ulp; only a *real* decrease breaks the contract.
            if bool(np.any(dec > 1e-9 * np.abs(completions[:-1]))):
                raise ValueError(
                    "chunk completion times must be non-decreasing")
            # Identity for truly monotone chunks (the simulator's — its
            # bit-exactness is untouched); irons out ulp wiggles so the
            # binary searches below stay well-defined.
            completions = np.maximum.accumulate(completions)
        prior = np.sort(self._heap) if self._heap else np.empty(0)
        depths = (len(prior) - np.searchsorted(prior, arrivals, side="right"))
        # Chunk members j < i with completion_j > arrival_i: completions
        # are monotone, so every counted entry precedes i (min-clip
        # handles the completion == arrival equality edge exactly).
        if len(arrivals) > len(self._idx):
            self._idx = np.arange(len(arrivals))
        idx = self._idx[:len(arrivals)]
        intra_done = np.searchsorted(completions, arrivals, side="right")
        depths = depths + idx - np.minimum(intra_done, idx)
        # Re-arm the heap: everything <= the chunk's last arrival can
        # never be counted again (arrivals are monotone run-wide).
        last = arrivals[-1]
        merged = np.concatenate([prior[prior > last],
                                 completions[completions > last]])
        self._heap = merged.tolist()
        heapq.heapify(self._heap)
        return depths


def _chunk_ledger(arrivals_chunk: Optional[np.ndarray],
                  occupancy: np.ndarray,
                  free_at: float) -> Tuple[np.ndarray, np.ndarray, float]:
    """Vectorized admission for one steady chunk.

    Returns ``(arrival, start, new_free_at)`` replicating the scalar
    recursion ``start_i = max(arrival_i, free_{i-1})``,
    ``free_i = start_i + occupancy_i``.  The closed loop (``arrivals_chunk
    is None``) uses a prepended cumsum so every floating-point addition
    happens in the same order as the scalar tick — bit-identical traces.
    The open loop uses the max-plus closed form
    (``np.maximum.accumulate``), exact up to float re-association.
    """
    if arrivals_chunk is None:
        # arrival_i = ready_i = free_{i-1}; start = arrival.
        c = np.cumsum(np.concatenate(([free_at], occupancy)))
        start = c[:-1]
        return start, start, float(c[-1])
    # start_i = O_i + max(free_at, max_{j<=i}(arrival_j - O_j)) with
    # O the exclusive prefix sum of occupancies.
    excl = np.concatenate(([0.0], np.cumsum(occupancy)[:-1]))
    base = np.maximum.accumulate(arrivals_chunk - excl)
    start = np.maximum(base, free_at) + excl
    return arrivals_chunk, start, float(start[-1] + occupancy[-1])


class PipelineRunner:
    """The event loop's state machine, driveable all-at-once or per query.

    One runner = one pipeline's serving window: it owns the admission
    ledger (``free_at`` / ``drain_at`` / in-system completions), the
    per-query result arrays, and the runtime-counter snapshots that make
    the finished :class:`PipelineTrace` report *this run's* rebalance
    accounting.

    Two driving modes share every line of tick code:

    * :meth:`run` — the single-pipeline driver behind
      :func:`run_pipeline`: consumes a whole arrival array, using the
      batch-granular fast path where the executor supports it.
    * :meth:`step` — feed exactly one query (the next one) with an
      explicit arrival time; used by :class:`repro_torch.cluster.Cluster`,
      which interleaves routing decisions between queries and therefore
      cannot hand the loop the whole arrival stream upfront.

    ``capacity`` sizes the initial result arrays; serving past it grows
    them by doubling (a cluster pre-sizes each replica's runner at its
    *expected* share, not the whole fleet), and :meth:`finish` trims to
    the number actually served.

    ``admission`` is an optional :class:`~repro_torch.control.AdmissionPolicy`
    instance; shed queries are recorded in :attr:`shed_arrivals` and
    the result arrays only ever hold *admitted* queries, so the dense
    array index and the global query index diverge once anything is
    shed (:attr:`num_served` vs. :attr:`num_offered`).
    """

    def __init__(self, executor: QueryExecutor,
                 runtime: RebalanceRuntime,
                 capacity: int,
                 chunking: bool = True,
                 max_chunk: Optional[int] = None,
                 admission: Optional[AdmissionPolicy] = None,
                 trace_mode: str = "dense",
                 telemetry: Optional[StreamingCollector] = None,
                 former: Optional[BatchFormer] = None,
                 lengths: Optional[np.ndarray] = None,
                 padded: Optional[np.ndarray] = None,
                 retry=None,
                 tiers=None):
        if trace_mode not in ("dense", "streaming"):
            raise ValueError(f"unknown trace_mode {trace_mode!r}; "
                             f"expected 'dense' or 'streaming'")
        if trace_mode == "streaming" and telemetry is None:
            telemetry = StreamingCollector(
                slo=float(getattr(admission, "slo", float("inf"))
                          if admission is not None else float("inf")))
        self.executor = executor
        self.runtime = runtime
        self.capacity = max(1, int(capacity))
        self.trace_mode = trace_mode
        self.telemetry = telemetry

        self.admission = admission
        if admission is not None:
            admission.reset()
        # Hot-loop guards, resolved once: policies declaring admits_all
        # skip the shed checks entirely (bit-identity with no policy);
        # observe/bound hooks are optional protocol extensions.
        self._shed_check = (admission is not None
                            and not getattr(admission, "admits_all", False))
        self._observe = (getattr(admission, "observe", None)
                         if admission is not None else None)
        # Policies that understand batch occupancy (adaptive_batch) take
        # an ``occupancy`` keyword; older/custom observe hooks keep the
        # two-argument call.  Resolved once, outside the hot loop.
        self._observe_occ = False
        if self._observe is not None:
            try:
                params = inspect.signature(self._observe).parameters
                self._observe_occ = ("occupancy" in params or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in params.values()))
            except (TypeError, ValueError):
                self._observe_occ = False
        self._chunk_bound = (getattr(admission, "max_chunk_bound", None)
                             if admission is not None else None)
        self.shed_arrivals: List[float] = []
        self.shed_indices: List[int] = []

        # QoS tiers (repro_torch.qos; docs/QOS.md): a TierPlan stamps every
        # query this runner sees (indexed by the global query id) with
        # a priority class, a relative deadline, and an SLO value.
        # None = every tier branch below is dead code — no-tier runs
        # are bit-identical to pre-QoS runs.
        self._tiers = tiers
        if tiers is not None:
            self._tier_ids = tiers.tier_ids
            self._tier_pri = tiers.priorities
            self._tier_deadline = tiers.deadlines
            self._tier_value = tiers.values
            self.shed_tier_counts = np.zeros(len(tiers.tiers),
                                             dtype=np.int64)
        else:
            self._tier_ids = None
            self._tier_pri = None
            self._tier_deadline = None
            self._tier_value = None
            self.shed_tier_counts = None
        self.shed_value = 0.0          # offered value lost to shedding

        # Fault tolerance (repro_torch.faults; docs/FAULTS.md): a RetrySpec
        # arms requeue-on-failure in :meth:`run`; a fault-injecting
        # executor arms the failure accounting even with no budget
        # (every transient failure is then terminal).  Neither present
        # = every guard below is a dead branch — pre-faults runs are
        # bit-identical.
        self._retry = retry
        self._fault_aware = (retry is not None
                             or getattr(executor, "injects_faults", False))
        self.num_failed = 0            # queries that exhausted the budget
        self.num_retried = 0           # retry attempts made
        self.num_hedged = 0            # hedged dispatches won here
        self.wasted_time = 0.0         # cancelled/hedged occupancy charged

        self._rebalances0 = runtime.num_rebalances
        self._trials0 = runtime.total_trials
        self._mitigations0 = len(runtime.mitigation_lengths)
        self._has_reference = hasattr(executor, "reference_throughput")

        # Sharded stage execution (docs/SHARDING.md): the mesh surface
        # exists only when the runtime carries a device assignment —
        # unsharded runs take none of the branches below.
        self._mesh_on = getattr(runtime, "mesh", None) is not None
        self._resizes0 = getattr(runtime, "num_mesh_resizes", 0)

        mode = getattr(executor, "batch_mode", None) if chunking else None
        if mode is not None and not callable(getattr(executor,
                                                     "execute_many", None)):
            mode = None
        if mode not in (None, "vector", "batch"):
            raise ValueError(f"unknown executor batch_mode {mode!r}; "
                             f"expected 'vector', 'batch' or None")
        if mode is not None and not callable(getattr(executor,
                                                     "steady_horizon", None)):
            raise ValueError("a batching executor must provide "
                             "steady_horizon(q); chunks must not cross an "
                             "interference edge")
        self._mode = mode
        cap = (max_chunk if max_chunk is not None
               else getattr(executor, "max_chunk", DEFAULT_MAX_CHUNK))
        self._chunk_cap = max(1, int(cap))

        # Batch formation (docs/WORKLOADS.md "Continuous batching &
        # length buckets").  The former is policy; the executor's
        # begin_dispatch builder is mechanism.  None = every batching
        # branch below is dead code — pre-former runs are untouched.
        self._former = former
        self._lengths = None if lengths is None else np.asarray(lengths)
        self._padded = None if padded is None else np.asarray(padded)
        if former is not None:
            if not callable(getattr(executor, "begin_dispatch", None)):
                raise ValueError(
                    "batching needs an executor providing "
                    "begin_dispatch(q, step); got "
                    f"{type(executor).__name__}")
            if not callable(getattr(executor, "steady_horizon", None)):
                raise ValueError(
                    "batching needs an executor providing "
                    "steady_horizon(q); dispatches must not cross an "
                    "interference edge")
        # Optional (wall, throughput, last_join_offset) oracle enabling
        # the vectorized solo-stretch fast path; without it every query
        # goes through the dispatch loop (correct, just scalar).
        self._profile = (getattr(executor, "dispatch_profile", None)
                         if former is not None else None)
        # "vector" chunks poll the scheduler once per environment-steady
        # segment, which is only equivalent to per-query polling when the
        # policy's steady detect is stable (pure under unchanged
        # conditions).
        self._poll_once = mode == "vector" and runtime.steady_poll_stable()

        # Streaming mode: the result arrays are a bounded recycling
        # scratch, not the run's storage — cap them near the chunk cap
        # and flush to the collector whenever the next chunk might not
        # fit (the +2 leaves room for a chunk's polled-but-unchunkable
        # leftover query).  Dense mode with a collector attached flushes
        # on a fixed cadence without recycling, so sinks still see
        # periodic snapshots at zero behavioural change.
        self._streaming = trace_mode == "streaming"
        self._keep_configs = not self._streaming
        self._last_config: Optional[List[int]] = None
        if self._streaming:
            self.capacity = min(self.capacity,
                                max(8192, 2 * (self._chunk_cap + 2)))
            self.capacity = max(self.capacity, self._chunk_cap + 2)
        self._flush_at = self.capacity - (self._chunk_cap + 2)
        self.num_flushed = 0           # recycled-away rows (streaming)
        self._stream_pos = 0           # first unobserved row (dense+sink)

        n = self.capacity
        self.latencies = np.zeros(n)
        self.service_lat = np.zeros(n)
        self.queue_delay = np.zeros(n)
        self.throughputs = np.zeros(n)
        self.serial_mask = np.zeros(n, dtype=bool)
        self.arrival_t = np.zeros(n)
        self.completion_t = np.zeros(n)
        self.queue_depth = np.zeros(n, dtype=int)
        self.rc_thr = np.zeros(n) if self._has_reference else None
        self.batch_sizes = np.zeros(n)   # dispatch size each row rode in
        self.padded_tok = np.zeros(n)    # padded tokens charged to the row
        self.actual_tok = np.zeros(n)    # useful tokens (actual length)
        if tiers is not None:
            self.tier_row = np.zeros(n)      # tier id the row was stamped
            self.deadline_row = np.zeros(n)  # relative deadline, seconds
            self.value_row = np.zeros(n)     # SLO value of the row
        else:
            self.tier_row = None
            self.deadline_row = None
            self.value_row = None
        if tiers is not None and self.telemetry is not None:
            self.telemetry.configure_tiers(tiers.names)
        self.coll_frac = np.zeros(n) if self._mesh_on else None
        self.configs_trace: List[List[int]] = []
        self.mesh_trace: List[List[int]] = []

        self.free_at = 0.0             # when the admission head frees up
        self.drain_at = 0.0            # when every admitted query completed
        self._pending = _CompletionLedger()  # in-system completions
        self.num_served = 0            # queries executed (admitted) so far
        self.num_offered = 0           # queries offered (incl. shed) so far

    #: Result arrays grown together when the run outlives ``capacity``.
    _ARRAYS = ("latencies", "service_lat", "queue_delay", "throughputs",
               "serial_mask", "arrival_t", "completion_t", "queue_depth",
               "rc_thr", "batch_sizes", "padded_tok", "actual_tok",
               "tier_row", "deadline_row", "value_row", "coll_frac")

    def _ensure_capacity(self, n: int) -> None:
        """Grow the result arrays (doubling) to hold ``n`` queries."""
        if n <= self.capacity:
            return
        new = max(n, 2 * self.capacity)
        for name in self._ARRAYS:
            arr = getattr(self, name)
            if arr is None:
                continue
            grown = np.zeros(new, dtype=arr.dtype)
            grown[:len(arr)] = arr
            setattr(self, name, grown)
        self.capacity = new

    # -- ticks (shared by both driving modes) -------------------------------
    def _scalar_tick(self, gq: int, step, arrival: Optional[float],
                     not_before: Optional[float] = None) -> float:
        """One query through the per-query (compatibility) path.

        ``gq`` is the global query index (what the executor sees);
        results land at the dense index :attr:`num_served`, which the
        tick advances.  ``arrival = None`` means closed-loop: the query
        arrives exactly when the pipeline can take it.  ``not_before``
        floors the start time (retry backoff holds, all-unhealthy
        waits); the extra wait lands in the query's queue delay.
        Returns the completion time.
        """
        s = self.num_served
        rec = self.executor.execute(gq, step)
        self.throughputs[s] = rec.throughput
        self.serial_mask[s] = step.serial
        if self._mesh_on:
            self.coll_frac[s] = rec.collective_frac
        if self._keep_configs:
            self.configs_trace.append(list(step.config))
            if self._mesh_on:
                self.mesh_trace.append(list(step.mesh))
        else:
            self._last_config = list(step.config)
        # A serial trial runs on the drained pipeline, so it cannot
        # start until every in-flight pipelined query has completed.
        ready = (max(self.free_at, self.drain_at) if step.serial
                 else self.free_at)
        if arrival is None:
            arrival = ready
        self.queue_depth[s] = self._pending.depth_at(arrival)
        start = max(arrival, ready)
        if not_before is not None and not_before > start:
            start = not_before
        occupancy = (rec.service_latency if step.serial
                     else (1.0 / rec.throughput if rec.throughput > 0
                           else 0.0))
        self.free_at = start + occupancy
        completion = start + rec.service_latency
        self.drain_at = max(self.drain_at, completion)
        self._pending.push(completion)
        self.arrival_t[s] = arrival
        self.completion_t[s] = completion
        self.queue_delay[s] = start - arrival
        self.service_lat[s] = rec.service_latency
        self.latencies[s] = self.queue_delay[s] + rec.service_latency
        self.batch_sizes[s] = 1.0
        if self._padded is not None:
            self.padded_tok[s] = float(self._padded[gq])
            self.actual_tok[s] = float(self._lengths[gq])
        else:
            self.padded_tok[s] = 0.0
            self.actual_tok[s] = 0.0
        if self._tier_ids is not None:
            self.tier_row[s] = self._tier_ids[gq]
            self.deadline_row[s] = self._tier_deadline[gq]
            self.value_row[s] = self._tier_value[gq]
        self.num_served = s + 1
        return completion

    def _retry_tick(self, gq: int, step, arrival: Optional[float],
                    err: TransientQueryError) -> Optional[float]:
        """Failure handling for the single-pipeline driver.

        Query ``gq``'s first execution attempt raised ``err``.  Charge
        the failure (a timed-out hang occupied the head for the full
        timeout before cancellation), then retry under the budget with
        exponential-backoff start holds.  Returns the completion time
        on eventual success, None when the budget is exhausted (the
        query is counted failed and writes no row).
        """
        retry = self._retry
        attempt = 0
        hold = None
        while True:
            ready = (max(self.free_at, self.drain_at) if step.serial
                     else self.free_at)
            fail_t = ready if arrival is None else max(float(arrival), ready)
            if hold is not None and hold > fail_t:
                fail_t = hold
            if isinstance(err, DispatchTimeoutError):
                self.free_at = fail_t + err.timeout
                self.wasted_time += err.timeout
                fail_t = self.free_at
            if retry is None or attempt >= retry.max_retries:
                self.num_failed += 1
                return None
            hold = fail_t + retry.delay(gq, attempt)
            attempt += 1
            self.num_retried += 1
            try:
                return self._scalar_tick(gq, step, arrival,
                                         not_before=hold)
            except TransientQueryError as e:
                err = e

    def charge_occupancy(self, arrival: Optional[float],
                         occupancy: float) -> float:
        """Occupy the admission head without recording a row — a hedge
        loser's cancelled dispatch (docs/FAULTS.md).  The occupancy is
        charged as wasted work; returns the new ``free_at``."""
        start = (self.free_at if arrival is None
                 else max(self.free_at, float(arrival)))
        self.free_at = start + float(occupancy)
        self.wasted_time += float(occupancy)
        return self.free_at

    def stamp_tier(self, local: int, plan, fleet_q: int) -> None:
        """Stamp local slot ``local`` with fleet query ``fleet_q``'s
        tier draw from the fleet ``plan`` (the cluster's assign path).
        Keyed overwrite like ``on_assign``: a failed dispatch serves no
        row, so a retry re-assigns the same slot.  The runner's local
        plan arrays grow on demand — routing skew may push one replica
        past its pre-sized fleet share."""
        if self._tier_ids is None:
            raise ValueError("stamp_tier needs the runner built with a "
                             "tier plan (tiers=TierPlan.empty(...))")
        if local >= len(self._tier_ids):
            new = max(local + 1, 2 * len(self._tier_ids))
            for name, fill in (("_tier_ids", 0), ("_tier_pri", 0),
                               ("_tier_deadline", np.inf),
                               ("_tier_value", 1.0)):
                arr = getattr(self, name)
                grown = np.full(new, fill, dtype=arr.dtype)
                grown[:len(arr)] = arr
                setattr(self, name, grown)
        self._tier_ids[local] = plan.tier_ids[fleet_q]
        self._tier_pri[local] = plan.priorities[fleet_q]
        self._tier_deadline[local] = plan.deadlines[fleet_q]
        self._tier_value[local] = plan.values[fleet_q]

    def _chunk_tick(self, gq0: int, steps,
                    arr_chunk: Optional[np.ndarray]) -> None:
        """``len(steps)`` steady queries through ``execute_many``.

        ``gq0`` is the chunk's first global query index; ``arr_chunk``
        holds the chunk members' arrival times (``None`` = closed
        loop).  Results land at dense indices ``num_served ..
        num_served + len(steps) - 1``.
        """
        n = len(steps)
        s0 = self.num_served
        sl = slice(s0, s0 + n)
        rec = self.executor.execute_many(gq0, steps)
        if len(rec.throughputs) != n:
            raise ValueError(f"execute_many returned {len(rec.throughputs)} "
                             f"records for a chunk of {n}")
        self.throughputs[sl] = rec.throughputs
        self.serial_mask[sl] = False   # chunks are steady by construction
        if self._mesh_on:
            self.coll_frac[sl] = (rec.collective_fracs
                                  if rec.collective_fracs is not None
                                  else 0.0)
        if not self._keep_configs:
            self._last_config = list(steps[-1].config)
        elif steps[0] is steps[-1]:
            # poll-once chunks replicate one step: share one row object
            # instead of materializing n copies (entries are read-only
            # by convention; the scalar path appends fresh lists).
            self.configs_trace.extend([list(steps[0].config)] * n)
        else:
            self.configs_trace.extend(list(s.config) for s in steps)
        if self._mesh_on and self._keep_configs:
            if steps[0] is steps[-1]:
                self.mesh_trace.extend([list(steps[0].mesh)] * n)
            else:
                self.mesh_trace.extend(list(s.mesh) for s in steps)
        occ = np.where(rec.throughputs > 0, 1.0 / rec.throughputs, 0.0)
        arrival, start, self.free_at = _chunk_ledger(arr_chunk, occ,
                                                     self.free_at)
        completion = start + rec.service_latencies
        self.queue_depth[sl] = self._pending.depths_bulk(arrival, completion)
        self.drain_at = max(self.drain_at, float(completion[-1]))
        self.arrival_t[sl] = arrival
        self.completion_t[sl] = completion
        self.queue_delay[sl] = start - arrival
        self.service_lat[sl] = rec.service_latencies
        self.latencies[sl] = self.queue_delay[sl] + rec.service_latencies
        # "batch" chunks are one physical execution (n-wide occupancy);
        # "vector" chunks are a computational speedup over solo queries.
        self.batch_sizes[sl] = float(n) if self._mode == "batch" else 1.0
        if self._padded is not None:
            self.padded_tok[sl] = self._padded[gq0:gq0 + n]
            self.actual_tok[sl] = self._lengths[gq0:gq0 + n]
        else:
            self.padded_tok[sl] = 0.0
            self.actual_tok[sl] = 0.0
        if self._tier_ids is not None:
            self.tier_row[sl] = self._tier_ids[gq0:gq0 + n]
            self.deadline_row[sl] = self._tier_deadline[gq0:gq0 + n]
            self.value_row[sl] = self._tier_value[gq0:gq0 + n]
        self.num_served = s0 + n

    # -- formed dispatch (repro_torch.workloads.batching; docs/WORKLOADS.md) -------
    def _dispatch_tick(self, q: int, step, arrivals: Optional[np.ndarray],
                       end: int) -> int:
        """Form and execute one dispatch headed by global query ``q``
        (already admitted and polled).  Returns the next global index.

        Formation stacks already-arrived same-bucket queries at the
        dispatch instant; continuous mode additionally joins arrivals
        at every stage boundary the executor's builder reports.
        Joiners are *not* admission-checked (head-only shedding — see
        the module docstring) but are polled, so an exploration trial
        or a config change still cuts the batch: the polled query
        becomes the leftover, executed scalar right after the dispatch
        drains.  A serial head (``explore_in_batch``) skips polling its
        riders entirely — one trial per poll is an explorer invariant —
        and rides the dispatch pipelined instead of draining first.
        """
        executor, runtime, former = self.executor, self.runtime, self._former
        arrival = float(arrivals[q]) if arrivals is not None else None
        t0 = self.free_at if arrival is None else max(arrival, self.free_at)
        serial_head = step.serial
        pw = self._padded
        cap = min(former.max_batch, self._chunk_cap_now())
        # Candidate window: the head's steady segment (a joiner must
        # share the head's environment — its poll is only reusable and
        # the builder's catch-up arithmetic only valid there).  Skip the
        # possibly-costly horizon scan when no candidate can exist.
        if arrivals is None or q + 1 >= end or cap == 1:
            wlimit = q + 1
        elif not former.continuous and arrivals[q + 1] > t0:
            wlimit = q + 1     # drain mode with no backlog: solo by definition
        else:
            wlimit = q + min(end - q,
                             max(1, int(executor.steady_horizon(q))))
        s0 = self.num_served
        self._ensure_capacity(s0 + min(cap, end - q) + 1)
        builder = executor.begin_dispatch(q, step)
        builder.add(q)
        members = [q]
        j = q + 1
        leftover = None
        stop = False
        pri = self._tier_pri
        batch_pri = int(pri[q]) if pri is not None else 0

        def try_fill(ready: float, joining: bool) -> None:
            nonlocal j, leftover, stop, batch_pri
            while (j < wlimit and len(members) < cap
                   and arrivals[j] <= ready):
                # Dispatches are single-bucket — formation and joins
                # alike.  Padding a narrow joiner up to a wide batch is
                # shape-legal but prices the padded row's full compute
                # in every remaining stage (the cost model is linear in
                # padded tokens), which balloons the dispatch for the
                # whole backlog behind it; the bucket cut keeps joins
                # strictly win-win.
                if pw is not None and pw[j] != pw[q]:
                    stop = True
                    return
                # Formation-slot preemption (docs/QOS.md): once the
                # dispatch carries a query of some priority class, a
                # lower-priority candidate may not extend it — batched
                # dispatch is group-synchronous, so every additional
                # member pushes the shared drain (and with it the
                # high-priority member's completion) further out.  The
                # refused candidate is not polled and simply heads the
                # next dispatch.  Higher-priority candidates still
                # join: joining completes at this dispatch's drain,
                # strictly earlier than waiting to head their own.
                if pri is not None and pri[j] < batch_pri:
                    stop = True
                    return
                if not serial_head:
                    src = executor.begin_query(j)
                    if self.rc_thr is not None:
                        self.rc_thr[s0 + len(members)] = \
                            executor.reference_throughput(j)
                    stp = (runtime.poll(src) if src is not None
                           else runtime.steady_step())
                    if (stp.serial or stp.config != step.config
                            or stp.mesh != step.mesh):
                        leftover = (j, stp)
                        stop = True
                        j += 1
                        return
                elif self.rc_thr is not None:
                    # Riders of a trial are not polled; the reference
                    # oracle is env-pure, and the env is steady here.
                    self.rc_thr[s0 + len(members)] = \
                        executor.reference_throughput(j)
                (builder.join if joining else builder.add)(j)
                members.append(j)
                if pri is not None and pri[j] > batch_pri:
                    batch_pri = int(pri[j])
                j += 1

        if arrivals is not None:
            try_fill(t0, joining=False)
            if former.continuous:
                while not stop and j < wlimit and len(members) < cap:
                    b = builder.next_boundary()
                    if b is None:
                        break
                    try_fill(t0 + b, joining=True)
        rec = builder.finish()

        n = len(members)
        sl = slice(s0, s0 + n)
        mem = np.asarray(members)
        arr_m = arrivals[mem] if arrivals is not None else np.full(n, t0)
        starts = t0 + rec.start_offsets
        completion = t0 + float(rec.drain)
        thr = float(rec.throughput)
        # Batched dispatch is group-synchronous: the dispatch holds the
        # admission head for its full drain (thr = 1/drain), and the
        # next dispatch launches only after this one retires; a riding
        # trial deliberately skips the old drain-the-pipeline wait.
        self.free_at = t0 + (1.0 / thr if thr > 0 else 0.0)
        self.drain_at = max(self.drain_at, completion)
        completions = np.full(n, completion)
        self.queue_depth[sl] = self._pending.depths_bulk(arr_m, completions)
        self.throughputs[sl] = n * thr
        self.serial_mask[sl] = False
        self.serial_mask[s0] = serial_head
        if self._mesh_on:
            self.coll_frac[sl] = rec.collective_frac
        if self._keep_configs:
            self.configs_trace.extend([list(step.config)] * n)
            if self._mesh_on:
                self.mesh_trace.extend([list(step.mesh)] * n)
        else:
            self._last_config = list(step.config)
        self.arrival_t[sl] = arr_m
        self.completion_t[sl] = completions
        qd = starts - arr_m
        sv = float(rec.drain) - rec.start_offsets
        self.queue_delay[sl] = qd
        self.service_lat[sl] = sv
        self.latencies[sl] = qd + sv
        self.batch_sizes[sl] = float(n)
        if pw is not None:
            # Every row of the dispatch occupies the head's bucket
            # width (formation members and joiners alike share the
            # head's bucket — dispatches are single-bucket).
            width = float(pw[q])
            pmem = np.full(n, width)
            amem = self._lengths[mem].astype(float)
            # Batch-dimension padding (the live engine rounds rows up to
            # a warm power-of-two) is dispatch-level waste: charge it to
            # the head row.  A relative threshold keeps the analytic
            # builders' token sums (sequential adds vs. np.sum pairwise,
            # ulp apart) from perturbing per-row values.
            extra = float(rec.padded_tokens) - width * n
            if extra > 1e-9 * max(float(rec.padded_tokens), 1.0):
                pmem[0] += extra
            self.padded_tok[sl] = pmem
            self.actual_tok[sl] = amem
        else:
            self.padded_tok[sl] = float(rec.padded_tokens) / n
            self.actual_tok[sl] = float(rec.actual_tokens) / n
        if self._tier_ids is not None:
            self.tier_row[sl] = self._tier_ids[mem]
            self.deadline_row[sl] = self._tier_deadline[mem]
            self.value_row[sl] = self._tier_value[mem]
        self.num_served = s0 + n

        if leftover is not None:
            jq, jstep = leftover
            self._scalar_tick(jq, jstep,
                              float(arrivals[jq]) if arrivals is not None
                              else None)
        if self._observe is not None:
            self._observe_span(s0)
        return j

    def _solo_window(self, q: int, step,
                     arrivals: Optional[np.ndarray], end: int) -> int:
        """Length of the provably join-free run of dispatch heads at ``q``.

        A query is *solo* when its successor arrives after its last
        join opportunity (dispatch start plus the final stage-boundary
        offset; the dispatch instant itself in drain mode).  Solo
        queries are bit-identical to singleton dispatches, so the
        poll-once vector fast path serves the whole run through
        ``execute_many`` instead of one builder per query.  Returns 0
        when the head itself may receive joiners.
        """
        executor = self.executor
        cap = self._chunk_cap_now()
        if arrivals is None:
            # Closed loop: the next query arrives only once the head
            # frees up, never strictly inside a dispatch — all solo.
            return min(end - q, cap,
                       max(1, int(executor.steady_horizon(q))))
        horizon = max(1, int(executor.steady_horizon(q)))
        limit = min(end - q, horizon)
        open_end = True        # successor beyond window cannot join
        if cap < limit:
            limit, open_end = cap, False
        pw = self._padded
        if pw is not None and limit > 1:
            w = pw[q:q + limit]
            diff = np.nonzero(w != w[0])[0]
            if len(diff):
                limit, open_end = int(diff[0]), True
        _, thr, join_off = self._profile(q, step.config)
        if not self._former.continuous:
            join_off = 0.0     # drain mode: joins only at the dispatch instant
        occ = 1.0 / thr if thr > 0 else 0.0
        _, starts, _ = _chunk_ledger(arrivals[q:q + limit],
                                     np.full(limit, occ), self.free_at)
        if limit > 1:
            solo = arrivals[q + 1:q + limit] > starts[:-1] + join_off
            bad = np.nonzero(~solo)[0]
            m = int(bad[0]) if len(bad) else limit
        else:
            m = 1
        if m == limit and not open_end:
            # Window cut by the chunk cap: the successor exists in the
            # same environment and may join the last member — leave
            # that member to the dispatch loop.
            nxt = q + limit
            if (arrivals[nxt] <= starts[-1] + join_off
                    and (pw is None or pw[nxt] == pw[q])):
                m = limit - 1
        if self._shed_check and m > 1:
            # Heads shed exactly as the scalar loop would: the shadow
            # ledger advances by the dispatch occupancy, which for solo
            # stretches is the actual occupancy — prediction is exact.
            m = self._admit_horizon(q, m, arrivals, occ_est=occ)
        return m

    # -- admission control (repro_torch.control; docs/CONTROL.md) ------------------
    def _view(self, gq: int, arrival: Optional[float], wait: float,
              est_service: float, est_latency: float) -> AdmissionView:
        """The admission view for query ``gq`` — one construction path
        for the actual-ledger decision and the chunked pre-pass, so
        tiered decisions are identical on both."""
        if self._tier_ids is None:
            return AdmissionView(query=gq, arrival=arrival, wait=wait,
                                 est_service=est_service,
                                 est_latency=est_latency)
        return AdmissionView(query=gq, arrival=arrival, wait=wait,
                             est_service=est_service,
                             est_latency=est_latency,
                             tier=int(self._tier_ids[gq]),
                             priority=int(self._tier_pri[gq]),
                             deadline=float(self._tier_deadline[gq]),
                             value=float(self._tier_value[gq]))

    def _admit(self, gq: int, arrival: Optional[float]) -> bool:
        """Admit-or-shed decision for global query ``gq``, made with
        the *actual* ledger.  A shed is recorded and never executes."""
        wait = (0.0 if arrival is None
                else max(self.free_at - arrival, 0.0))
        view = self._view(gq, arrival, wait,
                          self.runtime.estimated_bottleneck(),
                          self.runtime.estimated_service_latency())
        if self.admission.admit(view):
            return True
        t = self.free_at if arrival is None else float(arrival)
        if self._tier_ids is not None:
            tid = int(self._tier_ids[gq])
            val = float(self._tier_value[gq])
            self.shed_tier_counts[tid] += 1
            self.shed_value += val
            if self.telemetry is not None:
                self.telemetry.observe_shed(t, tier=tid, value=val)
        elif self.telemetry is not None:
            self.telemetry.observe_shed(t)
        if not self._streaming:
            # Streaming keeps sheds as counters only — these lists are
            # O(shed) and a saturating policy sheds millions.
            self.shed_indices.append(gq)
            self.shed_arrivals.append(t)
        return False

    def _admit_horizon(self, gq0: int, limit: int,
                       arrivals: Optional[np.ndarray],
                       occ_est: Optional[float] = None) -> int:
        """Largest ``n <= limit`` such that queries ``gq0+1 ..
        gq0+n-1`` are all predicted to be admitted (``gq0`` itself was
        already admitted with the actual ledger).

        The prediction advances a shadow of the admission head by the
        runtime's estimated beat per member — exact for the
        simulator's steady chunks, where the estimate *is* the actual
        occupancy.  The first predicted shed cuts the chunk; that
        query is then re-decided (and recorded) by the outer loop
        against the post-chunk actual ledger.

        ``occ_est`` overrides the shadow-ledger advance (the former's
        solo-stretch path passes the dispatch-adjusted occupancy, which
        folds in the batch overhead and padded-length cost model); the
        policy's *view* always carries the raw runtime estimates either
        way, matching what a scalar head decision would see.
        """
        est = self.runtime.estimated_bottleneck()
        est_lat = self.runtime.estimated_service_latency()
        if occ_est is None:
            occ_est = est if np.isfinite(est) and est > 0 else 0.0
        a0 = arrivals[gq0] if arrivals is not None else None
        free_pred = (max(float(a0), self.free_at) + occ_est
                     if a0 is not None else self.free_at + occ_est)
        for j in range(gq0 + 1, gq0 + limit):
            if arrivals is None:
                arrival, wait = None, 0.0
            else:
                arrival = float(arrivals[j])
                wait = max(free_pred - arrival, 0.0)
            view = self._view(j, arrival, wait, est, est_lat)
            if not self.admission.admit(view):
                return j - gq0
            free_pred = (free_pred + occ_est if arrival is None
                         else max(arrival, free_pred) + occ_est)
        return limit

    def _chunk_cap_now(self) -> int:
        """Chunk cap, shrunk by the policy's live bound when present
        (``adaptive_batch``'s SLO-aware ``max_batch`` control)."""
        if self._chunk_bound is None:
            return self._chunk_cap
        return max(1, min(self._chunk_cap, int(self._chunk_bound())))

    def _observe_span(self, s0: int) -> None:
        """Feed the policy's observe hook every query executed since
        dense index ``s0`` (its measured queue delay + service time,
        plus the dispatch occupancy it rode in when the hook takes it)."""
        if self._observe_occ:
            for s in range(s0, self.num_served):
                self._observe(float(self.queue_delay[s]),
                              float(self.service_lat[s]),
                              occupancy=float(self.batch_sizes[s]))
        else:
            for s in range(s0, self.num_served):
                self._observe(float(self.queue_delay[s]),
                              float(self.service_lat[s]))

    # -- telemetry flushing (repro_torch.telemetry; docs/TELEMETRY.md) -------------
    @property
    def total_served(self) -> int:
        """Admitted queries over the whole run, including rows already
        recycled into the collector (= :attr:`num_served` in dense
        mode, where nothing is recycled)."""
        return self.num_flushed + self.num_served

    def _should_flush(self) -> bool:
        if self._streaming:
            return self.num_served >= self._flush_at
        return self.num_served - self._stream_pos >= 1024

    def flush_telemetry(self) -> None:
        """Feed every row since the last flush to the collector; in
        streaming mode the arrays are then recycled (dense indices
        reset — the ledger's *times* carry all cross-flush state)."""
        tel = self.telemetry
        if tel is None:
            return
        s0, s1 = self._stream_pos, self.num_served
        if s1 > s0:
            tier_cols = {}
            if self._tier_ids is not None:
                tier_cols = dict(tier_ids=self.tier_row[s0:s1],
                                 deadlines=self.deadline_row[s0:s1],
                                 values=self.value_row[s0:s1])
            tel.observe_chunk(
                latencies=self.latencies[s0:s1],
                service_latencies=self.service_lat[s0:s1],
                queue_delays=self.queue_delay[s0:s1],
                throughputs=self.throughputs[s0:s1],
                serial_mask=self.serial_mask[s0:s1],
                arrival_times=self.arrival_t[s0:s1],
                completion_times=self.completion_t[s0:s1],
                queue_depths=self.queue_depth[s0:s1],
                batch_sizes=self.batch_sizes[s0:s1],
                padded_tokens=self.padded_tok[s0:s1],
                actual_tokens=self.actual_tok[s0:s1],
                **tier_cols)
        if self._fault_aware:
            tel.note_faults(self.num_failed, self.num_retried,
                            self.num_hedged, self.wasted_time,
                            self.fault_downtime())
        if self._streaming:
            self.num_flushed += s1
            self.num_served = 0
            self._stream_pos = 0
        else:
            self._stream_pos = s1

    # -- incremental driving (one query at a time) --------------------------
    def step(self, arrival: Optional[float] = None,
             not_before: Optional[float] = None) -> float:
        """Serve the next query, arriving at ``arrival`` (None = the
        instant this pipeline can take it — closed loop).

        The per-query semantics are identical to :meth:`run`'s scalar
        path: advance the environment, poll the scheduler runtime,
        execute, account the arrival ledger.  Returns the query's
        completion time, which callers (the cluster's routers) use for
        outstanding-work accounting.

        ``not_before`` floors the start time (the cluster's retry
        backoff and all-unhealthy waits).  With a fault-injecting
        executor this may raise a
        :class:`~repro_torch.util.errors.TransientQueryError`; the ledger is
        untouched in that case (no row, ``num_offered`` unchanged) and
        the *caller* owns the retry/failure decision — the cluster
        catches here so retries can re-route across replicas.
        """
        if self.telemetry is not None and self._should_flush():
            self.flush_telemetry()
        gq = self.num_offered          # global index (= dense when no sheds)
        s = self.num_served
        self._ensure_capacity(s + 1)
        source = self.executor.begin_query(gq)
        if self.rc_thr is not None:
            self.rc_thr[s] = self.executor.reference_throughput(gq)
        step = (self.runtime.poll(source) if source is not None
                else self.runtime.steady_step())
        completion = self._scalar_tick(gq, step, arrival, not_before)
        self.num_offered = gq + 1
        return completion

    def step_many(self, arrivals) -> List[float]:
        """Serve several already-routed queries in one call, grouping
        steady same-config runs through ``execute_many``.

        The cluster's rebatch path (docs/CLUSTER.md): a replica that
        accumulated a routed backlog flushes it here instead of
        query-by-query :meth:`step`, so a burst pays one set of stage
        dispatches.  Arrival times must be non-decreasing and already
        in the past at flush time (a real batch can only stack queries
        that have arrived).  Like :meth:`step`, no admission check is
        made here — the cluster sheds at its own routing layer.
        Returns the per-query completion times in arrival order.

        Fault semantics (docs/FAULTS.md): a
        :class:`~repro_torch.util.errors.TransientQueryError` raised mid-flush
        carries the completed prefix on ``err.partial_completions`` —
        the completions of every query that executed before the failing
        dispatch (those rows are already in the ledger); the failing
        query and the tail behind it remain unserved, and the caller
        decides their fate per ``RetrySpec.batch_policy``.
        """
        arr = np.asarray(arrivals, dtype=float)
        n = len(arr)
        if n == 0:
            return []
        if self._mode is None or n == 1:
            out = []
            try:
                for a in arr:
                    out.append(self.step(float(a)))
            except TransientQueryError as err:
                err.partial_completions = out
                raise
            return out
        executor, runtime = self.executor, self.runtime
        out: List[float] = []
        try:
            self._step_many_body(arr, n, out, executor, runtime)
        except TransientQueryError as err:
            err.partial_completions = out
            raise
        return out

    def _step_many_body(self, arr, n: int, out: List[float],
                        executor, runtime) -> None:
        i = 0
        while i < n:
            if self.telemetry is not None and self._should_flush():
                self.flush_telemetry()
            gq = self.num_offered
            self._ensure_capacity(self.num_served + (n - i) + 1)
            source = executor.begin_query(gq)
            s0 = self.num_served
            if self.rc_thr is not None:
                self.rc_thr[s0] = executor.reference_throughput(gq)
            step = (runtime.poll(source) if source is not None
                    else runtime.steady_step())
            if step.serial:
                out.append(self._scalar_tick(gq, step, float(arr[i])))
                self.num_offered = gq + 1
                i += 1
                continue
            limit = min(n - i, self._chunk_cap_now(),
                        max(1, int(executor.steady_horizon(gq))))
            steps = [step]
            leftover = None
            j = 1
            while j < limit:
                src_j = executor.begin_query(gq + j)
                if self.rc_thr is not None:
                    self.rc_thr[s0 + j] = executor.reference_throughput(gq + j)
                step_j = (runtime.poll(src_j) if src_j is not None
                          else runtime.steady_step())
                if (step_j.serial or step_j.config != step.config
                        or step_j.mesh != step.mesh):
                    leftover = step_j
                    break
                steps.append(step_j)
                j += 1
            k = len(steps)
            self._chunk_tick(gq, steps, arr[i:i + k])
            out.extend(self.completion_t[s0:s0 + k].tolist())
            self.num_offered = gq + k
            i += k
            if leftover is not None:
                # Polled but not chunkable (trial or config change):
                # execute scalar without re-advancing the runtime.
                out.append(self._scalar_tick(gq + k, leftover, float(arr[i])))
                self.num_offered += 1
                i += 1

    # -- full-run driving (the run_pipeline path) ---------------------------
    def run(self, num_queries: int,
            arrivals: Optional[np.ndarray]) -> None:
        """Serve ``num_queries`` offered queries with the given arrival
        times (``None`` = closed loop), using the batch-granular fast
        path where the executor supports it.  ``arrivals`` is indexed
        by the *global* query index; shed queries (admission control)
        consume an index without executing."""
        if not self._streaming:
            # Streaming keeps the arrays at their fixed recycling
            # capacity; growing them to the run length is exactly the
            # O(n) footprint the mode exists to avoid.
            self._ensure_capacity(self.num_served + num_queries)
        executor, runtime = self.executor, self.runtime
        mode = self._mode
        rc_thr = self.rc_thr
        shed_check, observe = self._shed_check, self._observe
        telemetry = self.telemetry
        fault_aware = self._fault_aware

        q = self.num_offered
        end = q + num_queries
        while q < end:
            if telemetry is not None and self._should_flush():
                self.flush_telemetry()
            arrival = arrivals[q] if arrivals is not None else None
            # -- admit or shed, with the actual ledger --------------------
            if shed_check and not self._admit(q, arrival):
                q += 1
                continue
            # -- advance the environment; poll the scheduler runtime ------
            source = executor.begin_query(q)
            s0 = self.num_served
            if rc_thr is not None:
                rc_thr[s0] = executor.reference_throughput(q)
            step = runtime.poll(source) if source is not None \
                else runtime.steady_step()

            # -- formed dispatch (batch former attached) -------------------
            if self._former is not None:
                former = self._former
                if step.serial and not former.explore_in_batch:
                    # Trials drain the pipeline exactly as before unless
                    # the former opts them into riding a dispatch.
                    self._scalar_tick(q, step, arrival)
                    if observe is not None:
                        self._observe_span(s0)
                    q += 1
                    continue
                if (self._poll_once and not step.serial
                        and self._profile is not None):
                    m = self._solo_window(q, step, arrivals, end)
                    if m >= 1:
                        # Join-free run: singleton dispatches, served
                        # vectorized — bit-identical to the scalar loop.
                        if rc_thr is not None:
                            rc_thr[s0:s0 + m] = rc_thr[s0]
                        self._chunk_tick(q, [step] * m,
                                         arrivals[q:q + m]
                                         if arrivals is not None else None)
                        if observe is not None:
                            self._observe_span(s0)
                        q += m
                        continue
                q = self._dispatch_tick(q, step, arrivals, end)
                continue

            if mode is None or step.serial:
                if fault_aware:
                    try:
                        self._scalar_tick(q, step, arrival)
                    except TransientQueryError as err:
                        self._retry_tick(q, step, arrival, err)
                else:
                    self._scalar_tick(q, step, arrival)
                if observe is not None:
                    self._observe_span(s0)
                q += 1
                continue

            if mode == "batch":
                # A real batch only forms from queries already queued at
                # dispatch time; don't pay the steady-horizon scan (up to
                # max_chunk schedule evaluations) when there is no
                # backlog.
                dispatch_t = (max(self.free_at, arrivals[q])
                              if arrivals is not None else self.free_at)
                if (arrivals is None or q + 1 >= end
                        or arrivals[q + 1] > dispatch_t):
                    if fault_aware:
                        try:
                            self._chunk_tick(q, [step],
                                             arrivals[q:q + 1]
                                             if arrivals is not None
                                             else None)
                        except TransientQueryError as err:
                            self._retry_tick(q, step, arrival, err)
                    else:
                        self._chunk_tick(q, [step],
                                         arrivals[q:q + 1]
                                         if arrivals is not None else None)
                    if observe is not None:
                        self._observe_span(s0)
                    q += 1
                    continue

            limit = min(end - q,
                        self._chunk_cap_now(),
                        max(1, int(executor.steady_horizon(q))))
            if shed_check and limit > 1:
                # Cut the chunk at the first *predicted* shed; the cut
                # query is re-decided by the loop head afterwards.
                limit = self._admit_horizon(q, limit, arrivals)

            if self._poll_once:
                # One poll covers the whole environment-steady segment:
                # the policy's detect is pure under unchanged (config,
                # stage times), so queries q+1 .. q+limit-1 would poll
                # identically.
                n = limit
                if rc_thr is not None:
                    rc_thr[s0:s0 + n] = rc_thr[s0]
                if fault_aware:
                    # A faultable chunk is single-query by construction
                    # (the injector's steady_horizon forces 1 inside
                    # fault windows), so the retry path stays scalar.
                    try:
                        self._chunk_tick(q, [step] * n,
                                         arrivals[q:q + n]
                                         if arrivals is not None else None)
                    except TransientQueryError as err:
                        self._retry_tick(q, step, arrival, err)
                else:
                    self._chunk_tick(q, [step] * n,
                                     arrivals[q:q + n]
                                     if arrivals is not None else None)
                if observe is not None:
                    self._observe_span(s0)
                q += n
                continue

            # Per-query polling ("batch" mode, or "vector" with a
            # stateful detector): accumulate steady same-config queries,
            # stopping at the steady horizon, the chunk cap, a detector
            # trigger, a config change, or — for real batches — the
            # arrival backlog (a query that has not arrived by dispatch
            # time cannot join).
            steps = [step]
            leftover = None          # (q, step) polled but not chunk-able
            dispatch_t = (max(self.free_at, arrivals[q])
                          if arrivals is not None else self.free_at)
            j = q + 1
            while j < q + limit:
                if mode == "batch" and (arrivals is None
                                        or arrivals[j] > dispatch_t):
                    break
                src_j = executor.begin_query(j)
                if rc_thr is not None:
                    rc_thr[s0 + len(steps)] = executor.reference_throughput(j)
                step_j = runtime.poll(src_j) if src_j is not None \
                    else runtime.steady_step()
                if (step_j.serial or step_j.config != step.config
                        or step_j.mesh != step.mesh):
                    leftover = (j, step_j)
                    break
                steps.append(step_j)
                j += 1
            if fault_aware:
                try:
                    self._chunk_tick(q, steps,
                                     arrivals[q:q + len(steps)]
                                     if arrivals is not None else None)
                except TransientQueryError as err:
                    self._retry_tick(q, step, arrival, err)
            else:
                self._chunk_tick(q, steps,
                                 arrivals[q:q + len(steps)]
                                 if arrivals is not None else None)
            q += len(steps)
            if leftover is not None:
                # Already polled (the trial/commit is charged to this
                # query); execute it without re-advancing the runtime.
                jq, jstep = leftover
                self._scalar_tick(
                    jq, jstep,
                    arrivals[jq] if arrivals is not None else None)
                q += 1
            if observe is not None:
                self._observe_span(s0)
        self.num_offered = q

    # -- result --------------------------------------------------------------
    def finish(self, scheduler_name: str = "",
               workload_name: str = "closed",
               peak_throughput: float = float("nan")
               ) -> Union[PipelineTrace, StreamingTrace]:
        """Freeze the run into a :class:`PipelineTrace` (arrays trimmed
        to the number of queries actually served; shed queries are
        reported through the trace's shed/goodput surface).  In
        streaming mode the remaining rows are flushed and the result is
        the collector's :class:`StreamingTrace` instead."""
        admission_name = ("none" if self.admission is None
                          else getattr(self.admission, "name",
                                       type(self.admission).__name__))
        slo = float(getattr(self.admission, "slo", float("inf"))
                    if self.admission is not None else float("inf"))
        if self.telemetry is not None:
            self.flush_telemetry()
        downtime = self.fault_downtime()
        if self._streaming:
            return self.telemetry.finish(
                scheduler=scheduler_name, workload=workload_name,
                peak_throughput=peak_throughput, admission=admission_name,
                num_rebalances=self.runtime.num_rebalances
                - self._rebalances0,
                total_trials=self.runtime.total_trials - self._trials0,
                mitigation_lengths=list(
                    self.runtime.mitigation_lengths[self._mitigations0:]),
                final_config=self._last_config,
                num_failed=self.num_failed, num_retried=self.num_retried,
                num_hedged=self.num_hedged, wasted_time=self.wasted_time,
                downtime=downtime)
        if self.telemetry is not None:
            self.telemetry.emit()     # final sink snapshot (dense+sink)
        n = self.num_served
        return PipelineTrace(
            scheduler=scheduler_name,
            latencies=self.latencies[:n],
            throughputs=self.throughputs[:n],
            serial_mask=self.serial_mask[:n],
            configs_trace=self.configs_trace,
            num_rebalances=self.runtime.num_rebalances - self._rebalances0,
            total_trials=self.runtime.total_trials - self._trials0,
            mitigation_lengths=list(
                self.runtime.mitigation_lengths[self._mitigations0:]),
            workload=workload_name,
            service_latencies=self.service_lat[:n],
            queue_delays=self.queue_delay[:n],
            arrival_times=self.arrival_t[:n],
            completion_times=self.completion_t[:n],
            queue_depths=self.queue_depth[:n],
            peak_throughput=peak_throughput,
            rc_throughputs=(self.rc_thr[:n] if self.rc_thr is not None
                            else None),
            admission=admission_name,
            slo_latency=slo,
            shed_arrivals=np.asarray(self.shed_arrivals, dtype=float),
            batch_sizes=self.batch_sizes[:n],
            padded_tokens=self.padded_tok[:n],
            actual_tokens=self.actual_tok[:n],
            num_failed=self.num_failed,
            num_retried=self.num_retried,
            num_hedged=self.num_hedged,
            wasted_time=self.wasted_time,
            downtime=downtime,
            tier_names=(self._tiers.names if self._tiers is not None
                        else None),
            tier_ids=(self.tier_row[:n].astype(np.int64)
                      if self.tier_row is not None else None),
            tier_deadlines=(self.deadline_row[:n]
                            if self.deadline_row is not None else None),
            tier_values=(self.value_row[:n]
                         if self.value_row is not None else None),
            shed_tier_counts=self.shed_tier_counts,
            shed_value=self.shed_value,
            mesh_devices=(int(sum(self.runtime.mesh)) if self._mesh_on
                          else 0),
            mesh_trace=(self.mesh_trace if self._mesh_on else None),
            collective_fracs=(self.coll_frac[:n] if self._mesh_on
                              else None),
            num_mesh_resizes=(self.runtime.num_mesh_resizes
                              - self._resizes0 if self._mesh_on else 0),
        )

    def fault_downtime(self) -> float:
        """Crash downtime the executor's fault plan accumulated over
        this run (0.0 without an injecting executor)."""
        hook = getattr(self.executor, "fault_downtime", None)
        if callable(hook):
            return float(hook(self.num_offered, self.drain_at))
        return 0.0


def _run_pipeline_impl(executor: QueryExecutor,
                 runtime: RebalanceRuntime,
                 num_queries: int,
                 workload: Union[str, Workload, None] = "closed",
                 workload_kwargs: Optional[dict] = None,
                 scheduler_name: str = "",
                 peak_throughput: float = float("nan"),
                 chunking: bool = True,
                 max_chunk: Optional[int] = None,
                 admission: Union[str, object, None] = None,
                 admission_kwargs: Optional[dict] = None,
                 trace_mode: str = "dense",
                 metrics_sink=None,
                 sink_interval: Optional[int] = None,
                 former: Optional[BatchFormer] = None,
                 lengths=None,
                 lengths_kwargs: Optional[dict] = None,
                 faults=None,
                 retries=None,
                 tiers=None,
                 tiers_kwargs: Optional[dict] = None
                 ) -> Union[PipelineTrace, StreamingTrace]:
    """Serve ``num_queries`` arrivals of ``workload`` through one
    scheduler runtime; returns the unified :class:`PipelineTrace`.

    ``runtime`` counters are snapshotted so the trace reports *this
    run's* rebalance accounting even when a runtime is reused across
    serving windows (the live engine's pattern).

    ``chunking=False`` forces the scalar per-query tick even when the
    executor supports ``execute_many`` (benchmark baseline / debugging);
    ``max_chunk`` overrides the executor's preferred chunk cap.

    ``admission`` selects an :class:`~repro_torch.control.AdmissionPolicy`
    (registry name + ``admission_kwargs``, or an instance;
    docs/CONTROL.md).  ``None`` / ``"none"`` admits everything —
    closed-loop results are bit-identical to a run without a control
    plane either way.

    ``trace_mode="streaming"`` (docs/TELEMETRY.md) accumulates metrics
    online at flat memory and returns a
    :class:`~repro_torch.telemetry.StreamingTrace` — same ``summary()`` keys,
    percentiles within sketch tolerance.  ``metrics_sink`` receives
    periodic :class:`~repro_torch.telemetry.MetricsRegistry` snapshots every
    ~``sink_interval`` queries in *either* mode (dense results stay
    bit-identical with a sink attached).

    ``former`` attaches a resolved
    :class:`~repro_torch.workloads.batching.BatchFormer` (drivers build one
    via ``resolve_batching``); the executor must provide the
    ``begin_dispatch`` builder and a ``configure_batching`` hook.
    ``lengths`` / ``lengths_kwargs`` attach a per-query sequence-length
    distribution (sampler name, instance, or explicit array —
    ``repro_torch.workloads.lengths``); without a former lengths are
    accounting-only (token counters in the trace).

    ``tiers`` / ``tiers_kwargs`` stamp every arrival with a QoS tier
    (``repro_torch.qos``, docs/QOS.md): tier-aware admission policies see
    priority/deadline/value on their views, batch formation refuses
    low-priority extensions of high-priority dispatches, and the trace
    grows per-tier latency/attainment/value accounting.  ``None`` =
    tiers unarmed, bit-identical to pre-QoS runs.
    """
    # Deferred import: repro_torch.control registers its builtins on first
    # use; the run loop itself only needs the resolver.
    from repro_torch.control.registry import resolve_admission
    policy = resolve_admission(admission, admission_kwargs)

    tier_plan = None
    if tiers is not None or tiers_kwargs:
        from repro_torch.qos import resolve_tiers
        tier_plan = resolve_tiers(tiers, tiers_kwargs, num_queries)

    # Fault tolerance (repro_torch.faults; docs/FAULTS.md): wrap the executor
    # in a fault injector and arm the runner's retry budget.  Both
    # default off — the wrapped/armed branches are then never taken and
    # pre-faults traces stay bit-identical.
    retry_spec = None
    if faults is not None or retries is not None:
        from repro_torch.faults import (FaultingExecutor, resolve_faults,
                                  resolve_retries)
        retry_spec = resolve_retries(retries)
        plan = resolve_faults(faults)
        if plan is not None:
            executor = FaultingExecutor(
                executor, plan,
                timeout=(retry_spec.timeout if retry_spec is not None
                         else None))

    telemetry = None
    if trace_mode == "streaming" or metrics_sink is not None:
        from repro_torch.telemetry.streaming import DEFAULT_SINK_INTERVAL
        telemetry = StreamingCollector(
            slo=float(getattr(policy, "slo", float("inf"))
                      if policy is not None else float("inf")),
            sink=metrics_sink,
            sink_interval=(sink_interval if sink_interval is not None
                           else DEFAULT_SINK_INTERVAL))

    wl = resolve_workload(workload, workload_kwargs)
    wl_name, arrivals = resolve_arrivals(wl, None, num_queries)
    lengths_arr = resolve_lengths(lengths, lengths_kwargs, num_queries,
                                  workload=wl)
    padded = None
    if former is not None:
        padded = former.padded_lengths(lengths_arr)
        configure = getattr(executor, "configure_batching", None)
        if not callable(configure):
            raise ValueError(
                "batching requires an executor providing "
                "configure_batching(former, lengths, padded); got "
                f"{type(executor).__name__}")
        configure(former, lengths_arr, padded)
    elif lengths_arr is not None:
        # Accounting-only lengths: padded == actual, no cost model.
        padded = lengths_arr
        configure = getattr(executor, "configure_batching", None)
        if callable(configure):
            configure(None, lengths_arr, padded)
    # Executors whose interference timeline is wall-clock anchored
    # (time-indexed events, docs/CLUSTER.md) need each query's arrival
    # time to advance the environment.
    announce = getattr(executor, "set_arrivals", None)
    if callable(announce):
        announce(arrivals)

    runner = PipelineRunner(executor, runtime, num_queries,
                            chunking=chunking, max_chunk=max_chunk,
                            admission=policy, trace_mode=trace_mode,
                            telemetry=telemetry, former=former,
                            lengths=lengths_arr, padded=padded,
                            retry=retry_spec, tiers=tier_plan)
    runner.run(num_queries, arrivals)
    return runner.finish(scheduler_name=scheduler_name,
                         workload_name=wl_name,
                         peak_throughput=peak_throughput)


def run_pipeline(executor: QueryExecutor,
                 runtime: RebalanceRuntime,
                 num_queries: int,
                 workload: Union[str, Workload, None] = "closed",
                 workload_kwargs: Optional[dict] = None,
                 scheduler_name: str = "",
                 peak_throughput: float = float("nan"),
                 chunking: bool = True,
                 max_chunk: Optional[int] = None,
                 admission: Union[str, object, None] = None,
                 admission_kwargs: Optional[dict] = None,
                 trace_mode: str = "dense",
                 metrics_sink=None,
                 sink_interval: Optional[int] = None,
                 former: Optional[BatchFormer] = None,
                 lengths=None,
                 lengths_kwargs: Optional[dict] = None,
                 faults=None,
                 retries=None,
                 tiers=None,
                 tiers_kwargs: Optional[dict] = None
                 ) -> Union[PipelineTrace, StreamingTrace]:
    """Serve ``num_queries`` arrivals through one scheduler runtime.

    Thin wrapper over the unified :class:`repro_torch.api.RunSpec` path (one
    declaration, one dispatcher — docs/API.md); the kwargs here map
    1:1 onto spec fields and new options land on the spec instead of
    this signature.  See :func:`_run_pipeline_impl` for the full
    kwarg-level documentation (unchanged semantics, bit-identical
    traces).
    """
    from repro_torch import api
    spec = api.RunSpec(
        executor=executor, runtime=runtime, num_queries=num_queries,
        peak_throughput=peak_throughput,
        scheduler=api.SchedulerSpec(name=(scheduler_name or "")),
        workload=api.WorkloadSpec(name=workload, kwargs=workload_kwargs),
        admission=api.AdmissionSpec(name=admission,
                                    kwargs=admission_kwargs),
        batching=api.BatchingSpec(chunking=chunking, max_chunk=max_chunk,
                                  former=former, lengths=lengths,
                                  lengths_kwargs=lengths_kwargs),
        faults=api.FaultsSpec(plan=faults),
        retries=api.RetriesSpec(policy=retries),
        tiers=api.TiersSpec(spec=tiers, kwargs=tiers_kwargs),
        telemetry=api.TelemetrySpec(trace_mode=trace_mode,
                                    metrics_sink=metrics_sink,
                                    sink_interval=sink_interval))
    return api.run(spec)
