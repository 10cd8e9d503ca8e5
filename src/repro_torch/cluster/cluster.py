"""The fleet driver: N pipeline replicas behind one routed arrival queue.

A :class:`Cluster` owns one :class:`Replica` per pipeline — each with
its *own* :class:`~repro_torch.schedulers.runtime.RebalanceRuntime` (detector
state, exploration phases), its own executor (interference timeline /
slowdown schedule) and its own admission ledger — plus one
:class:`~repro_torch.cluster.base.Router`.  :meth:`Cluster.run` (or the
functional :func:`run_cluster`) drives the shared arrival queue: the
workload generates *fleet* arrivals, the router picks a replica per
arrival, and the query is served through that replica's
:class:`~repro_torch.workloads.runner.PipelineRunner` — the same event-loop
code ``run_pipeline`` drives for a single pipeline, fed one query at a
time so routing decisions always see up-to-date replica state.

Closed-loop semantics generalize per replica: a query dispatched to
replica ``r`` arrives the instant ``r`` can take it, and the router's
notion of "now" is the earliest admission-head free time across the
fleet — with ``n = 1`` this reduces *bit-identically* to the
single-pipeline closed loop (tests/test_cluster.py).

The port's copy of the JAX package's ``cluster/cluster.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from __future__ import annotations

import dataclasses
import heapq
import inspect
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.cluster.base import ReplicaView, Router
from repro_torch.cluster.registry import resolve_router
from repro_torch.cluster.trace import ClusterTrace
from repro_torch.control.base import AdmissionView
from repro_torch.control.registry import resolve_admission, resolve_autoscaler
from repro_torch.faults.health import OPEN, HealthTracker
from repro_torch.faults.retry import RetrySpec, resolve_retries
from repro_torch.qos import QosRequest, TierPlan, resolve_tiers
from repro_torch.schedulers.runtime import RebalanceRuntime
from repro_torch.util.errors import TransientQueryError
from repro_torch.telemetry.streaming import (
    DEFAULT_SINK_INTERVAL,
    StreamingClusterTrace,
    StreamingCollector,
)
from repro_torch.workloads.base import QueryExecutor, Workload
from repro_torch.workloads.runner import PipelineRunner, resolve_arrivals


def _fleet_snapshot(runners, extra: Optional[StreamingCollector],
                    slo: float, num_active: int) -> dict:
    """Aggregate per-replica collectors into one fleet snapshot for the
    sink: counters sum exactly, sketches merge within tolerance."""
    agg = StreamingCollector(slo=slo)
    for runner in runners:
        runner.flush_telemetry()
        agg.absorb(runner.telemetry)
    if extra is not None:
        agg.absorb(extra)
    reg = agg.registry
    reg.gauge("num_replicas", "fleet size").set(len(runners))
    reg.gauge("active_replicas",
              "replicas in the routed set").set(num_active)
    return reg.snapshot()


@dataclasses.dataclass
class Replica:
    """One pipeline behind the router.

    ``on_assign(fleet_q, local_q, arrival)`` — optional backend hook
    invoked when a fleet query is routed here, *before* it executes:
    the live backend appends the query's token array to the replica's
    local stream, the time-indexed simulator backend appends the
    arrival time to the replica's clock (``arrival`` is ``None`` for a
    closed loop).  ``peak_throughput`` is the replica's
    interference-free reference for SLO accounting (NaN = unknown; the
    live backend stamps it post-run).
    """

    executor: QueryExecutor
    runtime: RebalanceRuntime
    name: str = ""
    peak_throughput: float = float("nan")
    #: Replica pool label (heterogeneous fleets, docs/QOS.md):
    #: ``"small"`` marks a small-model replica the ``downgrade`` router
    #: may send best-effort traffic to under pressure.
    pool: str = "default"
    on_assign: Optional[Callable[[int, int, Optional[float]], None]] = None
    #: optional recovery hook ``on_recover(now)`` — fired once per
    #: breaker open->probe transition, *before* the probe dispatch: the
    #: live backend re-warms its XLA shape buckets off the timed path
    #: (docs/FAULTS.md), the simulator backend needs nothing.
    on_recover: Optional[Callable[[float], None]] = None


class Cluster:
    """N replicas + one router; reusable across serving windows.

    The SLO control plane (``repro_torch.control``, docs/CONTROL.md) hooks in
    at the fleet level: an ``admission`` policy may shed an arrival
    *after* routing (the decision sees the chosen replica's predicted
    wait and service estimate — if the best replica cannot meet the
    SLO, nobody can), and an ``autoscaler`` decides per arrival which
    replicas are active — the router only ever sees the active subset,
    so a drained replica simply stops receiving work and finishes its
    backlog.  Defaults (no admission policy, no autoscaler) leave the
    fleet loop bit-identical to the pre-control-plane cluster.

    ``max_batch > 1`` opts into fleet rebatching: consecutive open-loop
    arrivals routed to the *same* replica are buffered and flushed
    through that replica's :meth:`~repro_torch.workloads.runner.PipelineRunner.
    step_many` — the routed backlog re-forms into batches (one set of
    stage dispatches per streak) instead of executing query-by-query.
    Buffered queries count in every :class:`ReplicaView`'s
    ``outstanding`` so routing stays load-aware, but ledger-derived
    estimates (``backlog``, ``free_at``) trail the unflushed tail by up
    to ``max_batch - 1`` queries.  The default ``max_batch = 1`` is the
    exact pre-rebatching path (every query steps immediately), and a
    closed loop never buffers — its decision clock needs each query's
    completion.

    Note: ``adaptive_batch`` has no effect at the fleet level — the
    rebatch streak length is capped by routing locality and
    ``max_batch``, not by a steered bound.
    """

    def __init__(self, replicas: Sequence[Replica],
                 router: Union[str, Router, None] = "round_robin",
                 router_kwargs: Optional[dict] = None,
                 admission: Union[str, object, None] = None,
                 admission_kwargs: Optional[dict] = None,
                 autoscaler: Union[str, object, None] = None,
                 autoscaler_kwargs: Optional[dict] = None,
                 max_batch: int = 1,
                 retries: Union[RetrySpec, int, dict, None] = None,
                 hedge_after: Optional[float] = None,
                 health_kwargs: Optional[dict] = None,
                 when_all_unhealthy: str = "wait",
                 tiers=None,
                 tiers_kwargs: Optional[dict] = None):
        if len(replicas) < 1:
            raise ValueError("a cluster needs at least one replica")
        if when_all_unhealthy not in ("wait", "shed"):
            raise ValueError(f"when_all_unhealthy must be 'wait' or "
                             f"'shed', got {when_all_unhealthy!r}")
        self.replicas = list(replicas)
        self.max_batch = max(1, int(max_batch))
        # -- fault tolerance (repro_torch.faults; docs/FAULTS.md) ------------------
        self.retries = resolve_retries(retries)
        self.hedge_after = (None if hedge_after is None
                            else float(hedge_after))
        self.health_kwargs = dict(health_kwargs or {})
        self.when_all_unhealthy = when_all_unhealthy
        #: the fleet loop arms its recovery machinery when retries are
        #: configured, hedging is on, or any replica injects faults.
        self.fault_aware = (self.retries is not None
                            or self.hedge_after is not None
                            or any(getattr(rep.executor, "injects_faults",
                                           False) for rep in self.replicas))
        if self.fault_aware and self.retries is None:
            self.retries = RetrySpec()     # default budget (docs/FAULTS.md)
        # Faults + rebatching compose: a failure inside a flushed batch
        # is attributed to a single query (fault-window chunks are
        # single-query by construction) and handled per
        # ``RetrySpec.batch_policy``; with hedging on, whole buffered
        # dispatches are duplicated (docs/FAULTS.md "Hedged batched
        # dispatch") — the loser replica is charged the dispatch's full
        # span as wasted work, so the hedge/rebatch composition keeps
        # honest occupancy accounting.
        # QoS tiers (repro_torch.qos, docs/QOS.md): the spec is resolved into
        # a fleet TierPlan per run (stamping needs the run length).
        self._tiers_spec = tiers
        self._tiers_kwargs = tiers_kwargs
        self.router = resolve_router(router, router_kwargs)
        self.router_name = getattr(self.router, "name",
                                   type(self.router).__name__)
        self.admission = resolve_admission(admission, admission_kwargs)
        self.admission_name = ("none" if self.admission is None
                               else getattr(self.admission, "name",
                                            type(self.admission).__name__))
        # None = autoscaling disabled (all replicas always active) —
        # same behaviour as the "static" built-in, without threading a
        # policy object through the fleet loop at all.
        if autoscaler is None and autoscaler_kwargs:
            raise ValueError("autoscaler_kwargs given but no autoscaler "
                             "selected")
        self.autoscaler = (None if autoscaler is None
                           else resolve_autoscaler(autoscaler,
                                                   autoscaler_kwargs))
        self.autoscaler_name = ("static" if self.autoscaler is None
                                else getattr(self.autoscaler, "name",
                                             type(self.autoscaler).__name__))

    def run(self, num_queries: int,
            workload: Union[str, Workload, None] = "closed",
            workload_kwargs: Optional[dict] = None,
            scheduler_name: str = "",
            trace_mode: str = "dense",
            metrics_sink=None,
            sink_interval: Optional[int] = None
            ) -> Union[ClusterTrace, StreamingClusterTrace]:
        """Serve ``num_queries`` fleet arrivals of ``workload`` through
        the routed replicas; returns a :class:`ClusterTrace`.

        Per arrival: pop completed work from each replica's
        outstanding ledger, build the :class:`ReplicaView` snapshots,
        ask the router, fire the backend's ``on_assign`` hook, and
        serve the query through the chosen replica's runner (advancing
        its environment, polling its scheduler runtime, accounting its
        arrival queue — identical per-query semantics to
        ``run_pipeline``).

        ``trace_mode="streaming"`` (docs/TELEMETRY.md) runs every
        replica at flat memory and returns a
        :class:`~repro_torch.telemetry.StreamingClusterTrace` — same
        ``summary()`` keys, fleet percentiles from merged per-replica
        sketches.  ``metrics_sink`` receives fleet-aggregated snapshots
        every ``sink_interval`` arrivals in either mode.
        """
        if trace_mode not in ("dense", "streaming"):
            raise ValueError(f"unknown trace_mode {trace_mode!r}; "
                             f"expected 'dense' or 'streaming'")
        streaming = trace_mode == "streaming"
        wl_name, arrivals = resolve_arrivals(workload, workload_kwargs,
                                             num_queries)

        adm = self.admission
        slo = float(getattr(adm, "slo", float("inf"))
                    if adm is not None else float("inf"))
        use_telemetry = streaming or metrics_sink is not None
        # Fleet-level sheds never reach a replica, so they get their
        # own collector (merged into the fleet view at read time).
        fleet_extra = StreamingCollector(slo=slo) if use_telemetry else None

        # QoS tiers (docs/QOS.md): one fleet plan indexed by fleet
        # arrival; each replica gets an empty local plan its assigned
        # queries are stamped into (keyed overwrite, like on_assign).
        tier_plan = None
        if self._tiers_spec is not None or self._tiers_kwargs:
            tier_plan = resolve_tiers(self._tiers_spec,
                                      self._tiers_kwargs, num_queries)
        if tier_plan is not None and fleet_extra is not None:
            fleet_extra.configure_tiers(tier_plan.names)
        # Tier-aware routers take the arrival's QoS context through an
        # optional ``request`` keyword, detected once by signature
        # (routers without it are called exactly as before).
        try:
            wants_request = "request" in inspect.signature(
                self.router.route).parameters
        except (TypeError, ValueError):
            wants_request = False
        # Downgrade accounting is read as a per-run delta: the router
        # object persists across serving windows.
        dg_before = dict(getattr(self.router, "downgrade_counts", None)
                         or {})

        # Pre-size each runner at its balanced share; a skewed router
        # just grows that replica's arrays (doubling) as it serves —
        # streaming runners stay at their fixed recycling capacity.
        share = -(-num_queries // len(self.replicas))
        runners = [PipelineRunner(rep.executor, rep.runtime, share,
                                  trace_mode=trace_mode,
                                  telemetry=(StreamingCollector(slo=slo)
                                             if use_telemetry else None),
                                  tiers=(TierPlan.empty(tier_plan.tiers,
                                                        share)
                                         if tier_plan is not None
                                         else None))
                   for rep in self.replicas]
        # Outstanding completions per replica: popped against the
        # (monotone) decision clock to count in-system queries.
        outstanding: List[List[float]] = [[] for _ in self.replicas]
        last_assign = [-1] * len(self.replicas)
        # -- fault tolerance (repro_torch.faults; docs/FAULTS.md) ------------------
        tracker = (HealthTracker(len(runners), **self.health_kwargs)
                   if self.fault_aware else None)
        retry = self.retries
        hedge_after = self.hedge_after
        if tracker is not None:
            # The cluster owns retries (routing across replicas), but
            # the runners still report the fault counters the cluster
            # stamps into them on every telemetry flush.
            for runner in runners:
                runner._fault_aware = True
        # Shed queries keep the sentinel -1 (admission control); the
        # per-arrival ledger is exactly what streaming mode must not
        # materialize.
        if streaming:
            assignments = local_indices = None
        else:
            assignments = np.full(num_queries, -1, dtype=int)
            local_indices = np.full(num_queries, -1, dtype=int)

        shed_check = (adm is not None
                      and not getattr(adm, "admits_all", False))
        observe = getattr(adm, "observe", None) if adm is not None else None
        if adm is not None:
            adm.reset()
        scaler = self.autoscaler
        if scaler is not None:
            scaler.reset()
        shed_arrivals: List[float] = []
        # Fleet-level per-tier shed accounting (replicas never shed —
        # admission happens here, before the runner sees the query).
        shed_tier_counts = (np.zeros(len(tier_plan.tiers), dtype=np.int64)
                            if tier_plan is not None else None)
        shed_value = 0.0
        active_timeline: List[Tuple[int, Tuple[int, ...]]] = []
        cur_active: Optional[List[int]] = None
        active_sum = 0.0
        num_active = len(runners)
        interval = (sink_interval if sink_interval is not None
                    else DEFAULT_SINK_INTERVAL)

        # Fleet rebatching (max_batch > 1): same-replica routing streaks
        # buffer here and flush through step_many as one formed backlog.
        pend: List[float] = []         # buffered arrival times
        pend_q: List[int] = []         # their fleet indices
        pend_r = -1                    # replica the buffer belongs to

        def flush_pending() -> None:
            nonlocal pend_r
            if not pend:
                return
            if tracker is not None:
                flush_faulty()
                return
            runner = runners[pend_r]
            s_before = runner.num_served
            for completion in runner.step_many(pend):
                heapq.heappush(outstanding[pend_r], completion)
            if observe is not None:
                for s in range(s_before, runner.num_served):
                    observe(float(runner.queue_delay[s]),
                            float(runner.service_lat[s]))
            pend.clear()
            pend_q.clear()
            pend_r = -1

        def est_service(v: ReplicaView) -> float:
            est = v.est_latency
            return est if est == est else 0.0

        def assign(i: int, r: int, arrival: Optional[float]) -> None:
            hook = self.replicas[r].on_assign
            if hook is not None:
                hook(i, runners[r].total_served, arrival)
            if tier_plan is not None:
                runners[r].stamp_tier(runners[r].total_served,
                                      tier_plan, i)
            last_assign[r] = i

        def fleet_views(at: float) -> List[ReplicaView]:
            """Fresh fleet-wide views for batch-retry routing (the
            buffered batch was admitted long before the flush, so
            retries route over the whole fleet like serve_one's)."""
            return [ReplicaView(ridx, runner, len(outstanding[ridx]), at,
                                pool=self.replicas[ridx].pool)
                    for ridx, runner in enumerate(runners)]

        def flush_batch(r: int, batch: List[Tuple[int, float]],
                        floor: Optional[float]):
            """Flush ``batch`` of ``(fleet_q, arrival)`` through replica
            ``r``'s vectorized path.  Every member is (re-)stamped into
            its local slot first — retries shift slots, and the keyed
            backend hooks must agree with where the rows land.  Returns
            ``(completions, err)``: the in-order completion times of the
            prefix that executed, and the failing dispatch's error
            (``None`` = the whole batch completed)."""
            runner = runners[r]
            if floor is not None and floor > runner.free_at:
                # Backoff hold: the arrivals are already in the past, so
                # holding the admission head delays every retried start
                # exactly like step(not_before=...) would.
                runner.free_at = floor
            base = runner.total_served
            for off, (fq, a) in enumerate(batch):
                hook = self.replicas[r].on_assign
                if hook is not None:
                    hook(fq, base + off, a)
                if tier_plan is not None:
                    runner.stamp_tier(base + off, tier_plan, fq)
            rewarm(r, max(batch[0][1], floor or 0.0, runner.free_at))
            s_before = runner.num_served
            err = None
            try:
                comps = runner.step_many([a for (_, a) in batch])
            except TransientQueryError as e:
                err = e
                comps = list(getattr(e, "partial_completions", []))
            for c in comps:
                heapq.heappush(outstanding[r], c)
            if observe is not None:
                for s in range(s_before, runner.num_served):
                    observe(float(runner.queue_delay[s]),
                            float(runner.service_lat[s]))
            if not streaming:
                for off, (fq, _a) in enumerate(batch[:len(comps)]):
                    assignments[fq] = r
                    local_indices[fq] = base + off
            return comps, err

        def finalize_single(fq: int, comp: Optional[float],
                            win: int) -> None:
            """Ledger bookkeeping for one batch member that finished
            (or exhausted its budget) on the single-query path."""
            if comp is None:
                if not streaming:
                    assignments[fq] = -2
                    local_indices[fq] = -1
                return
            heapq.heappush(outstanding[win], comp)
            if not streaming:
                assignments[fq] = win
                local_indices[fq] = runners[win].num_served - 1
            if observe is not None:
                s = runners[win].num_served - 1
                observe(float(runners[win].queue_delay[s]),
                        float(runners[win].service_lat[s]))

        def retry_as_single(fq: int, arrival: float, r: int,
                            fail_t: float):
            """Continue a batch member's retry loop as a single after
            its first failure (mirrors serve_one's failure branch:
            backoff, healthy re-route, per-query budget)."""
            if retry.max_retries < 1:
                runners[r].num_failed += 1
                return None, r
            runners[r].num_retried += 1
            hold = fail_t + retry.delay(fq, 0)
            cand = fleet_views(hold)
            pool = [v for v in cand if tracker.healthy(v.index, hold)]
            if not pool:
                if self.when_all_unhealthy == "shed":
                    runners[r].num_failed += 1
                    return None, r
                hold = max(hold, min(tracker.ready_at(v.index)
                                     for v in cand))
                pool = [v for v in cand
                        if tracker.healthy(v.index, hold)]
            nxt = min(pool, key=lambda v: (max(v.free_at, hold), v.index))
            if nxt.index != r:
                r = nxt.index
                assign(fq, r, arrival)
            return serve_one(fq, r, arrival, hold, cand, attempt=1)

        def flush_faulty() -> None:
            """Fault-aware flush of the rebatch buffer: failures are
            attributed to single queries (fault-window chunks are
            single-query by construction) and handled per
            ``RetrySpec.batch_policy`` (docs/FAULTS.md)."""
            nonlocal pend_r
            policy = retry.batch_policy
            r = pend_r
            batch = list(zip(pend_q, pend))
            pend.clear()
            pend_q.clear()
            pend_r = -1
            # Whole-dispatch hedging (docs/FAULTS.md "Hedged batched
            # dispatch"): when the buffered dispatch's predicted wait
            # exceeds ``hedge_after``, duplicate the *whole* batch on
            # the least-loaded healthy peer; the predicted-faster copy
            # executes (first one wins) and the loser is charged the
            # dispatch's span as wasted work — the batched analogue of
            # serve_one's per-query hedge.
            hedge_loser = None
            if (hedge_after is not None and batch
                    and runners[r].free_at - batch[0][1] > hedge_after):
                t0 = batch[0][1]
                cand = fleet_views(t0)
                others = [v for v in cand
                          if v.index != r and tracker.healthy(v.index, t0)]
                if others:
                    vr = next(v for v in cand if v.index == r)
                    alt = min(others, key=lambda v: (max(v.free_at, t0),
                                                     v.index))
                    prim_eta = max(vr.free_at, t0) + est_service(vr)
                    alt_eta = max(alt.free_at, t0) + est_service(alt)
                    if alt_eta < prim_eta:
                        hedge_loser, r = r, alt.index
                    else:
                        hedge_loser = alt.index
            attempt = 0                      # shared budget ("all")
            floor: Optional[float] = None
            while batch:
                t0 = batch[0][1]
                comps, err = flush_batch(r, batch, floor)
                if hedge_loser is not None:
                    if err is None and comps:
                        # The loser would have held its head from its
                        # own start until the winner's drain — charge
                        # that span as wasted (cancelled) occupancy.
                        loser_start = max(runners[hedge_loser].free_at,
                                          t0)
                        charge = max(0.0, comps[-1] - loser_start)
                        if charge > 0.0:
                            runners[hedge_loser].charge_occupancy(t0,
                                                                  charge)
                        runners[r].num_hedged += len(comps)
                    # Hedge abandoned on failure, like serve_one's.
                    hedge_loser = None
                batch = batch[len(comps):]
                if err is None:
                    return
                fq, arrival = batch[0]
                fail_t = max(runners[r].free_at, arrival, floor or 0.0)
                tmo = getattr(err, "timeout", None)
                if tmo is not None and tmo == tmo:
                    runners[r].charge_occupancy(max(fail_t, arrival),
                                                float(tmo))
                    fail_t = runners[r].free_at
                tracker.record_failure(r, fail_t,
                                       until=getattr(err, "until",
                                                     math.nan))
                if policy == "all":
                    # Fail-whole-batch: the failing query and the tail
                    # re-flush together under one attempt budget.
                    if attempt >= retry.max_retries:
                        runners[r].num_failed += len(batch)
                        if not streaming:
                            for fq2, _a in batch:
                                assignments[fq2] = -2
                                local_indices[fq2] = -1
                        return
                    runners[r].num_retried += len(batch)
                    hold = fail_t + retry.delay(fq, attempt)
                    attempt += 1
                    cand = fleet_views(hold)
                    pool = [v for v in cand
                            if tracker.healthy(v.index, hold)]
                    if not pool:
                        if self.when_all_unhealthy == "shed":
                            runners[r].num_failed += len(batch)
                            if not streaming:
                                for fq2, _a in batch:
                                    assignments[fq2] = -2
                                    local_indices[fq2] = -1
                            return
                        hold = max(hold, min(tracker.ready_at(v.index)
                                             for v in cand))
                        pool = [v for v in cand
                                if tracker.healthy(v.index, hold)]
                    r = min(pool, key=lambda v: (max(v.free_at, hold),
                                                 v.index)).index
                    floor = hold
                    continue
                comp, win = retry_as_single(fq, arrival, r, fail_t)
                finalize_single(fq, comp, win)
                batch = batch[1:]
                floor = None
                if policy == "subset":
                    # Only the failing query left the batch; the
                    # untouched tail re-flushes as a batch.
                    continue
                # "resplit": the batch dissolves into singles.
                for fq2, a2 in batch:
                    comp, win = serve_one(fq2, r, a2, None,
                                          fleet_views(a2))
                    finalize_single(fq2, comp, win)
                return

        def rewarm(r: int, clock: float) -> None:
            """Fire the replica's re-warm hook once per open->probe
            transition, before its probe dispatch (off the timed path)."""
            if tracker.take_rewarm(r):
                hook = self.replicas[r].on_recover
                if hook is not None:
                    hook(clock)

        def serve_one(i: int, r: int, arrival: Optional[float],
                      not_before: Optional[float], candidates,
                      attempt: int = 0):
            """Serve fleet query ``i`` starting on replica ``r``,
            retrying transient failures across healthy replicas under
            the retry budget (exponential backoff, least-loaded
            re-route).  Returns ``(completion, winner)`` on success,
            ``(None, r)`` when the budget is exhausted.  ``candidates``
            is the active view list retries/hedges may route over;
            ``attempt`` pre-spends budget a batch member's first
            failure already consumed (docs/FAULTS.md)."""
            hedge_loser = None
            # Tail-latency hedging: when the chosen replica's backlog
            # exceeds ``hedge_after``, duplicate the dispatch on the
            # least-loaded healthy peer; the predicted-faster copy
            # executes (first one wins), the loser is cancelled at the
            # winner's completion and charged as wasted work.
            if (hedge_after is not None and arrival is not None
                    and runners[r].free_at - arrival > hedge_after):
                others = [v for v in candidates
                          if v.index != r
                          and tracker.healthy(v.index, arrival)]
                if others:
                    vr = next(v for v in candidates if v.index == r)
                    alt = min(others, key=lambda v: (max(v.free_at, arrival),
                                                     v.index))
                    prim_eta = max(vr.free_at, arrival) + est_service(vr)
                    alt_eta = max(alt.free_at, arrival) + est_service(alt)
                    if alt_eta < prim_eta:
                        hedge_loser, r = r, alt.index
                        assign(i, r, arrival)
                    else:
                        hedge_loser = alt.index
                        assign(i, hedge_loser, arrival)
            while True:
                rewarm(r, max(arrival or 0.0, not_before or 0.0,
                              runners[r].free_at))
                try:
                    completion = runners[r].step(arrival,
                                                 not_before=not_before)
                except TransientQueryError as err:
                    hedge_loser = None       # hedge abandoned on failure
                    fail_t = max(runners[r].free_at, arrival or 0.0,
                                 not_before or 0.0)
                    tmo = getattr(err, "timeout", None)
                    if tmo is not None and tmo == tmo:
                        # A timed-out hang occupied the head for the
                        # full timeout before cancellation.
                        runners[r].charge_occupancy(
                            max(fail_t, arrival or 0.0), float(tmo))
                        fail_t = runners[r].free_at
                    tracker.record_failure(r, fail_t,
                                           until=getattr(err, "until",
                                                         math.nan))
                    if attempt >= retry.max_retries:
                        runners[r].num_failed += 1
                        return None, r
                    runners[r].num_retried += 1
                    hold = fail_t + retry.delay(i, attempt)
                    attempt += 1
                    pool = [v for v in candidates
                            if tracker.healthy(v.index, hold)]
                    if not pool:
                        if self.when_all_unhealthy == "shed":
                            runners[r].num_failed += 1
                            return None, r
                        hold = max(hold, min(tracker.ready_at(v.index)
                                             for v in candidates))
                        pool = [v for v in candidates
                                if tracker.healthy(v.index, hold)]
                    nxt = min(pool, key=lambda v: (max(v.free_at, hold),
                                                   v.index))
                    if nxt.index != r:
                        r = nxt.index
                        assign(i, r, arrival)
                    not_before = hold
                    continue
                tracker.record_success(r, completion)
                if hedge_loser is not None:
                    loser_start = max(runners[hedge_loser].free_at,
                                      arrival or 0.0)
                    charge = max(0.0, completion - loser_start)
                    if charge > 0.0:
                        runners[hedge_loser].charge_occupancy(arrival,
                                                              charge)
                    runners[r].num_hedged += 1
                return completion, r

        now = 0.0
        for i in range(num_queries):
            if metrics_sink is not None and i and i % interval == 0:
                metrics_sink.emit(_fleet_snapshot(runners, fleet_extra,
                                                  slo, num_active))
            if arrivals is not None:
                arrival: Optional[float] = float(arrivals[i])
                now = arrival
            else:
                arrival = None
                # The closed-loop decision clock advances with the
                # serving fleet: drained replicas (autoscaling) sit at
                # a stale free_at and must not hold it back — and
                # neither must a breaker-open replica (its head stops
                # advancing while it is down, docs/FAULTS.md).
                pool = list(cur_active if cur_active is not None
                            else range(len(runners)))
                if tracker is not None:
                    up = [r for r in pool if tracker.state(r) != OPEN]
                    pool = up or pool
                now = min(runners[r].free_at for r in pool)
            views = []
            for ridx, (runner, heap) in enumerate(zip(runners,
                                                      outstanding)):
                while heap and heap[0] <= now:
                    heapq.heappop(heap)
                since = (i - last_assign[ridx] if last_assign[ridx] >= 0
                         else float("inf"))
                # Buffered (not yet flushed) queries are in-system.
                in_system = len(heap) + (len(pend) if ridx == pend_r
                                         else 0)
                views.append(ReplicaView(ridx, runner, in_system, now,
                                         since_assign=since,
                                         pool=self.replicas[ridx].pool))
            if scaler is not None:
                active = sorted(set(int(r) for r in
                                    scaler.active(i, now, views)))
                if not active or not all(0 <= r < len(runners)
                                         for r in active):
                    raise ValueError(
                        f"autoscaler {self.autoscaler_name!r} returned "
                        f"active set {active} for a fleet of "
                        f"{len(runners)}")
                if active != cur_active:
                    cur_active = active
                    if not streaming:
                        # The change-point list is unbounded in the
                        # worst case; streaming keeps the running mean
                        # (active_sum) instead.
                        active_timeline.append((i, tuple(active)))
                routed_views = [views[r] for r in active]
            else:
                routed_views = views
            candidates = routed_views
            not_before: Optional[float] = None
            # QoS context (docs/QOS.md): the arrival's tier stamp, with
            # the relative deadline anchored at the decision clock so
            # deadline-aware routers compare etas against an absolute
            # time.  ``None`` whenever tiers are off — tier-aware
            # routers then fall through to their untier-ed behaviour.
            if tier_plan is not None:
                tid = int(tier_plan.tier_ids[i])
                rel_dl = float(tier_plan.deadlines[i])
                tval = float(tier_plan.values[i])
                tier_ctx = QosRequest(query=i, tier=tid,
                                      priority=int(
                                          tier_plan.priorities[i]),
                                      deadline=now + rel_dl, value=tval)
            else:
                tier_ctx = None
            if tracker is not None:
                # Health-aware routing: the router only sees replicas
                # whose breaker admits traffic at ``now``.
                healthy = [v for v in routed_views
                           if tracker.healthy(v.index, now)]
                if not healthy:
                    if self.when_all_unhealthy == "shed":
                        if fleet_extra is not None:
                            if tier_ctx is not None:
                                fleet_extra.observe_shed(now, tier=tid,
                                                         value=tval)
                            else:
                                fleet_extra.observe_shed(now)
                        if not streaming:
                            shed_arrivals.append(now)
                        if tier_ctx is not None:
                            shed_tier_counts[tid] += 1
                            shed_value += tval
                        continue
                    # "wait": hold the dispatch until the earliest
                    # breaker expiry — that replica then admits a
                    # half-open probe, so the wait always terminates.
                    floor = min(tracker.ready_at(v.index)
                                for v in routed_views)
                    not_before = floor
                    healthy = [v for v in routed_views
                               if tracker.healthy(v.index, floor)]
                routed_views = healthy
            active_sum += len(routed_views)
            num_active = len(routed_views)
            if wants_request:
                pos = int(self.router.route(i, now, routed_views,
                                            request=tier_ctx))
            else:
                pos = int(self.router.route(i, now, routed_views))
            if not 0 <= pos < len(routed_views):
                raise ValueError(f"router {self.router_name!r} returned "
                                 f"position {pos} for "
                                 f"{len(routed_views)} active replicas")
            r = routed_views[pos].index
            if pend and r != pend_r:
                # The streak broke: flush the previous replica's
                # buffered backlog before this query is considered.
                flush_pending()
            if shed_check:
                # Fleet-level shedding sees the *routed* replica: the
                # router already picked the cheapest dispatch, so if
                # that one cannot meet the SLO, nobody can.
                v = views[r]
                if tier_ctx is not None:
                    view = AdmissionView(
                        query=i, arrival=arrival,
                        wait=0.0 if arrival is None else v.backlog,
                        est_service=v.est_bottleneck,
                        est_latency=v.est_latency,
                        tier=tid, priority=tier_ctx.priority,
                        deadline=rel_dl, value=tval)
                else:
                    view = AdmissionView(
                        query=i, arrival=arrival,
                        wait=0.0 if arrival is None else v.backlog,
                        est_service=v.est_bottleneck,
                        est_latency=v.est_latency)
                if not adm.admit(view):
                    if fleet_extra is not None:
                        if tier_ctx is not None:
                            fleet_extra.observe_shed(now, tier=tid,
                                                     value=tval)
                        else:
                            fleet_extra.observe_shed(now)
                    if not streaming:
                        shed_arrivals.append(now)
                    if tier_ctx is not None:
                        shed_tier_counts[tid] += 1
                        shed_value += tval
                    continue
            # total_served == num_served in dense mode; in streaming it
            # keeps counting across the runner's array recycling, so
            # backends see a stable local query index either way.
            # Buffered queries haven't stepped yet but already own their
            # local slots.
            local = runners[r].total_served + (len(pend) if r == pend_r
                                               else 0)
            hook = self.replicas[r].on_assign
            if hook is not None:
                hook(i, local, arrival)
            if tier_plan is not None:
                runners[r].stamp_tier(local, tier_plan, i)
            last_assign[r] = i
            if not streaming:
                assignments[i] = r
                local_indices[i] = local
            if self.max_batch > 1 and arrival is not None:
                pend.append(float(arrival))
                pend_q.append(i)
                pend_r = r
                if len(pend) >= self.max_batch:
                    flush_pending()
                continue
            if tracker is None:
                completion = runners[r].step(arrival)
            else:
                # Floor every dispatch at the fleet decision clock: a
                # recovering replica's head is stale (it served nothing
                # while down), and its probe must not start in the past.
                nb = now if not_before is None else max(not_before, now)
                completion, r = serve_one(i, r, arrival, nb, candidates)
                if completion is None:
                    # Retry budget exhausted: the query was admitted
                    # but never completed (sentinel -2 in the dense
                    # assignment ledger).
                    if not streaming:
                        assignments[i] = -2
                        local_indices[i] = -1
                    continue
                if not streaming:
                    # Retries/hedging may have re-routed the query.
                    assignments[i] = r
                    local_indices[i] = runners[r].num_served - 1
            heapq.heappush(outstanding[r], completion)
            if observe is not None:
                # The row the step just wrote: num_served - 1 (== local
                # in dense mode; streaming recycles indices, times don't
                # move).
                s = runners[r].num_served - 1
                observe(float(runners[r].queue_delay[s]),
                        float(runners[r].service_lat[s]))

        flush_pending()
        traces = [
            runner.finish(
                scheduler_name=(rep.name or scheduler_name),
                workload_name=wl_name,
                peak_throughput=rep.peak_throughput)
            for rep, runner in zip(self.replicas, runners)]
        if tracker is not None:
            # Per-replica unavailability: the larger of the fault
            # plan's crash windows (stamped by runner.finish) and the
            # breaker's observed open time — the two views of the same
            # outage, never summed (that would double-count).  The
            # breaker lives on the routing decision clock, so outages
            # still open close out at the clock's final reading, not at
            # the (possibly much later) backlog drain.
            breaker_down = tracker.finalize(now)
            for k, t in enumerate(traces):
                if streaming:
                    t.collector.downtime = max(t.collector.downtime,
                                               breaker_down[k])
                else:
                    t.downtime = max(t.downtime, breaker_down[k])
        # Downgrade accounting (docs/QOS.md): per-run delta of the
        # router's counters (the router object persists across serving
        # windows), threaded into whichever trace surface is active.
        downgrade_tier_counts = None
        if tier_plan is not None:
            dg_after = getattr(self.router, "downgrade_counts", None)
            if dg_after is not None:
                downgrade_tier_counts = np.zeros(len(tier_plan.tiers),
                                                 dtype=np.int64)
                for t, c in dg_after.items():
                    delta = int(c) - int(dg_before.get(t, 0))
                    if delta:
                        downgrade_tier_counts[int(t)] += delta
                if fleet_extra is not None:
                    fleet_extra.track_downgrades = True
                    for t in range(len(tier_plan.tiers)):
                        if downgrade_tier_counts[t]:
                            fleet_extra.note_downgrade(
                                t, int(downgrade_tier_counts[t]))
        if metrics_sink is not None:
            metrics_sink.emit(_fleet_snapshot(runners, fleet_extra, slo,
                                              num_active))
        if streaming:
            return StreamingClusterTrace(
                router=self.router_name, workload=wl_name,
                scheduler=scheduler_name, replicas=traces,
                num_queries=num_queries,
                admission=self.admission_name,
                autoscaler=self.autoscaler_name,
                slo_latency=slo, shed_collector=fleet_extra,
                active_sum=active_sum)
        return ClusterTrace(router=self.router_name, workload=wl_name,
                            scheduler=scheduler_name, replicas=traces,
                            assignments=assignments,
                            local_indices=local_indices,
                            admission=self.admission_name,
                            autoscaler=self.autoscaler_name,
                            slo_latency=slo,
                            shed_arrivals=np.asarray(shed_arrivals,
                                                     dtype=float),
                            active_timeline=active_timeline,
                            tier_names=(tier_plan.names
                                        if tier_plan is not None
                                        else None),
                            shed_tier_counts=shed_tier_counts,
                            shed_value=shed_value,
                            downgrade_tier_counts=downgrade_tier_counts)


def _run_cluster_impl(replicas: Sequence[Replica],
                num_queries: int,
                workload: Union[str, Workload, None] = "closed",
                workload_kwargs: Optional[dict] = None,
                router: Union[str, Router, None] = "round_robin",
                router_kwargs: Optional[dict] = None,
                scheduler_name: str = "",
                admission: Union[str, object, None] = None,
                admission_kwargs: Optional[dict] = None,
                autoscaler: Union[str, object, None] = None,
                autoscaler_kwargs: Optional[dict] = None,
                max_batch: int = 1,
                trace_mode: str = "dense",
                metrics_sink=None,
                sink_interval: Optional[int] = None,
                retries: Union[RetrySpec, int, dict, None] = None,
                hedge_after: Optional[float] = None,
                health_kwargs: Optional[dict] = None,
                when_all_unhealthy: str = "wait",
                tiers=None,
                tiers_kwargs: Optional[dict] = None
                ) -> Union[ClusterTrace, StreamingClusterTrace]:
    """Functional driver: build a :class:`Cluster` and serve one window."""
    cluster = Cluster(replicas, router=router, router_kwargs=router_kwargs,
                      admission=admission,
                      admission_kwargs=admission_kwargs,
                      autoscaler=autoscaler,
                      autoscaler_kwargs=autoscaler_kwargs,
                      max_batch=max_batch,
                      retries=retries, hedge_after=hedge_after,
                      health_kwargs=health_kwargs,
                      when_all_unhealthy=when_all_unhealthy,
                      tiers=tiers, tiers_kwargs=tiers_kwargs)
    return cluster.run(num_queries, workload=workload,
                       workload_kwargs=workload_kwargs,
                       scheduler_name=scheduler_name,
                       trace_mode=trace_mode, metrics_sink=metrics_sink,
                       sink_interval=sink_interval)


def run_cluster(replicas: Sequence[Replica],
                num_queries: int,
                workload: Union[str, Workload, None] = "closed",
                workload_kwargs: Optional[dict] = None,
                router: Union[str, Router, None] = "round_robin",
                router_kwargs: Optional[dict] = None,
                scheduler_name: str = "",
                admission: Union[str, object, None] = None,
                admission_kwargs: Optional[dict] = None,
                autoscaler: Union[str, object, None] = None,
                autoscaler_kwargs: Optional[dict] = None,
                max_batch: int = 1,
                trace_mode: str = "dense",
                metrics_sink=None,
                sink_interval: Optional[int] = None,
                retries: Union[RetrySpec, int, dict, None] = None,
                hedge_after: Optional[float] = None,
                health_kwargs: Optional[dict] = None,
                when_all_unhealthy: str = "wait",
                tiers=None,
                tiers_kwargs: Optional[dict] = None
                ) -> Union[ClusterTrace, StreamingClusterTrace]:
    """Serve one fleet window over pre-built :class:`Replica`\\ s.

    Thin wrapper over the unified :class:`repro_torch.api.RunSpec` path (one
    declaration, one dispatcher — docs/API.md); the kwargs here map
    1:1 onto spec fields and new options land on the spec instead of
    this signature.  See :func:`_run_cluster_impl` for the full
    kwarg-level documentation.
    """
    from repro_torch import api
    spec = api.RunSpec(
        replicas=replicas, num_queries=num_queries,
        scheduler=api.SchedulerSpec(name=(scheduler_name or "")),
        workload=api.WorkloadSpec(name=workload, kwargs=workload_kwargs),
        admission=api.AdmissionSpec(name=admission,
                                    kwargs=admission_kwargs),
        faults=api.FaultsSpec(hedge_after=hedge_after,
                              health_kwargs=health_kwargs,
                              when_all_unhealthy=when_all_unhealthy),
        retries=api.RetriesSpec(policy=retries),
        tiers=api.TiersSpec(spec=tiers, kwargs=tiers_kwargs),
        telemetry=api.TelemetrySpec(trace_mode=trace_mode,
                                    metrics_sink=metrics_sink,
                                    sink_interval=sink_interval),
        cluster=api.ClusterSpec(num_replicas=len(replicas),
                                router=router,
                                router_kwargs=router_kwargs,
                                autoscaler=autoscaler,
                                autoscaler_kwargs=autoscaler_kwargs,
                                max_batch=max_batch))
    return api.run(spec)
