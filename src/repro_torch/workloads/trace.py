"""The one per-run result type shared by simulator and live engine.

:class:`PipelineTrace` replaces the duplicated (and diverging) halves of
the old ``SimResult`` / ``ServeMetrics``: per-query arrays, rebalance
accounting, and the full metric surface (percentile latency, steady
throughput, SLO violations, queueing delay, offered vs. achieved load)
are computed identically whether the queries ran against the database
simulator or real JAX execution.  ``SimResult`` and ``ServeMetrics``
remain importable as deprecated aliases of this class.

Latency decomposition (open-loop workloads): ``latencies = queue_delays
+ service_latencies``.  Closed-loop runs have zero queue delay, so
``latencies`` is bit-identical to the pre-workloads per-query latency.

The port's copy of the JAX package's ``workloads/trace.py``; only import paths
differ.  ``tests/test_torch_workloads.py`` holds it equal to
the original.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.telemetry.sketch import _percentile_sorted


@dataclasses.dataclass
class PipelineTrace:
    scheduler: str
    latencies: np.ndarray          # per query: queue delay + service time
    throughputs: np.ndarray        # per query: 1 / bottleneck stage time
    serial_mask: np.ndarray        # True where query was processed serially
    configs_trace: List[List[int]]
    num_rebalances: int
    total_trials: int
    mitigation_lengths: List[int]  # trials consumed per rebalancing phase
    workload: str = "closed"
    service_latencies: Optional[np.ndarray] = None  # = latencies when closed
    queue_delays: Optional[np.ndarray] = None       # zeros when closed
    arrival_times: Optional[np.ndarray] = None
    completion_times: Optional[np.ndarray] = None
    # In-system depth (queued + in-flight through the pipeline) seen at
    # each query's arrival; a saturated closed loop sits at ~num_stages.
    queue_depths: Optional[np.ndarray] = None
    peak_throughput: float = float("nan")  # interference-free optimum
    rc_throughputs: Optional[np.ndarray] = None  # per-query DP optimum
    # -- admission control / load shedding (repro.control) ------------------
    #: Name of the admission policy the run was served under.
    admission: str = "none"
    #: Latency objective (driver time units) the admission policy
    #: enforced; +inf when no objective was enforced (SLO attainment is
    #: then trivially 1 and goodput counts every admitted completion).
    slo_latency: float = float("inf")
    #: Arrival times of shed queries (empty = nothing shed).  The
    #: per-query arrays above only ever hold *admitted* queries.
    shed_arrivals: Optional[np.ndarray] = None
    # -- batch occupancy / padding accounting (docs/WORKLOADS.md) ------------
    #: Size of the dispatch each query rode in (1.0 for solo queries;
    #: ``None`` on traces built before batching existed — read as all-1).
    batch_sizes: Optional[np.ndarray] = None
    #: Padded tokens charged to each query (bucket-edge length, plus any
    #: batch-dimension padding charged to the dispatch head); zeros when
    #: the run carried no length information.
    padded_tokens: Optional[np.ndarray] = None
    #: Useful tokens per query (actual sequence length).
    actual_tokens: Optional[np.ndarray] = None
    # -- fault tolerance (repro.faults; docs/FAULTS.md) ----------------------
    #: Admitted queries that exhausted their retry budget (the
    #: per-query arrays never hold failed queries — they complete
    #: nothing).  ``availability = admitted-and-completed / admitted``.
    num_failed: int = 0
    #: Retry attempts made across the run (a query retried twice
    #: counts 2).
    num_retried: int = 0
    #: Dispatches that were hedged on a second replica (counted on the
    #: winning replica's trace).
    num_hedged: int = 0
    #: Occupancy charged for work that produced no completion: timed-out
    #: hangs and cancelled hedge losers (driver time units).
    wasted_time: float = 0.0
    #: Time this pipeline was crash-down (fault-plan clock units) plus,
    #: on cluster traces, breaker-open time stamped by the fleet loop.
    downtime: float = 0.0
    # -- QoS tiers (repro.qos; docs/QOS.md) ----------------------------------
    #: Tier names, index-aligned with :attr:`tier_ids`; ``None`` when
    #: the run had no tiers configured (every per-tier surface below is
    #: then absent and summaries carry no per-tier keys).
    tier_names: Optional[Tuple[str, ...]] = None
    #: Tier index of each admitted query.
    tier_ids: Optional[np.ndarray] = None
    #: Relative deadline (seconds from arrival) of each admitted query.
    tier_deadlines: Optional[np.ndarray] = None
    #: SLO value of each admitted query.
    tier_values: Optional[np.ndarray] = None
    #: Shed queries per tier (admission never ran them).
    shed_tier_counts: Optional[np.ndarray] = None
    #: Offered value lost to shedding (sum of shed queries' values).
    shed_value: float = 0.0
    #: Queries per tier the router downgraded to a small-model replica
    #: (cluster runs under the ``downgrade`` policy; docs/QOS.md).
    downgrade_tier_counts: Optional[np.ndarray] = None
    # -- sharded stage execution (repro.core.mesh; docs/SHARDING.md) ----------------
    #: Total devices in the stage mesh; 0 = unsharded run (every mesh
    #: surface below is then absent and summaries carry no mesh keys).
    mesh_devices: int = 0
    #: Committed device assignment (devices per stage) after each
    #: rebalance, aligned with :attr:`configs_trace`; ``None`` unsharded.
    mesh_trace: Optional[List[List[int]]] = None
    #: Per-query fraction of the bottleneck stage's time spent in
    #: collectives; ``None`` unsharded.
    collective_fracs: Optional[np.ndarray] = None
    #: Times the committed assignment changed during the run.
    num_mesh_resizes: int = 0

    def __post_init__(self):
        n = len(self.latencies)
        if self.service_latencies is None:
            self.service_latencies = np.array(self.latencies, copy=True)
        if self.queue_delays is None:
            self.queue_delays = np.zeros(n)
        if self.queue_depths is None:
            self.queue_depths = np.zeros(n, dtype=int)
        if self.shed_arrivals is None:
            self.shed_arrivals = np.empty(0)
        else:
            self.shed_arrivals = np.asarray(self.shed_arrivals, dtype=float)
        if self.batch_sizes is None:
            self.batch_sizes = np.ones(n)
        if self.padded_tokens is None:
            self.padded_tokens = np.zeros(n)
        if self.actual_tokens is None:
            self.actual_tokens = np.zeros(n)
        if self.tier_names is not None:
            if (self.tier_ids is None or self.tier_deadlines is None
                    or self.tier_values is None):
                raise ValueError("a tiered trace needs tier_ids, "
                                 "tier_deadlines and tier_values")
            if self.shed_tier_counts is None:
                self.shed_tier_counts = np.zeros(len(self.tier_names),
                                                 dtype=np.int64)
        # Percentile reads share one sort per field (summary() alone
        # makes three; rows() adds more) — sorted once, cached here.
        self._sorted_cache: Dict[str, np.ndarray] = {}

    # -- percentiles (one sort per field, reused for every read) -------------
    def percentile(self, pct: float, field: str = "latencies") -> float:
        """Percentile of a per-query array field, from a cached sort.

        Bit-identical to ``np.percentile(getattr(self, field), pct)``
        (linear interpolation), but the O(n log n) sort happens once
        per field per trace instead of once per read.  NaN-safe: an
        empty trace (admission shed everything) reads as NaN instead
        of raising.
        """
        cached = self._sorted_cache.get(field)
        if cached is None:
            cached = np.sort(np.asarray(getattr(self, field)))
            self._sorted_cache[field] = cached
        return _percentile_sorted(cached, pct)

    # -- compat surface (old ServeMetrics field names) ----------------------
    @property
    def configs(self) -> List[List[int]]:
        """Alias of :attr:`configs_trace` (old ``ServeMetrics`` name)."""
        return self.configs_trace

    @property
    def stage_time_max(self) -> np.ndarray:
        """Per-query bottleneck stage time (old ``ServeMetrics`` field)."""
        return 1.0 / np.maximum(self.throughputs, 1e-12)

    # -- rebalance accounting ------------------------------------------------
    @property
    def rebalance_fraction(self) -> float:
        if not len(self.serial_mask):
            return float("nan")
        return float(np.mean(self.serial_mask))

    @property
    def steady_throughput(self) -> float:
        """Mean throughput over pipelined (non-exploration) queries — the
        pipeline's operating rate, which is what the paper's Fig. 6
        reports (exploration overhead is Fig. 8's separate metric)."""
        pipe = self.throughputs[~self.serial_mask]
        if len(pipe):
            return float(pipe.mean())
        if len(self.throughputs):
            return float(self.throughputs.mean())
        return float("nan")

    # -- latency -----------------------------------------------------------
    def tail_latency(self, pct: float = 99.0) -> float:
        return self.percentile(pct)

    @property
    def mean_queue_delay(self) -> float:
        if not len(self.queue_delays):
            return float("nan")
        return float(np.mean(self.queue_delays))

    # -- SLO --------------------------------------------------------------
    def slo_violations(self, slo_level: float,
                       reference: str = "peak") -> float:
        """Fraction of queries with throughput below slo_level × reference.

        NaN for an empty trace (nothing was admitted, so the fraction
        is undefined)."""
        if not len(self.throughputs):
            return float("nan")
        if reference == "peak":
            target = slo_level * self.peak_throughput
            return float(np.mean(self.throughputs < target))
        elif reference == "resource_constrained":
            if self.rc_throughputs is None:
                raise ValueError(
                    "this trace has no resource-constrained reference "
                    "(the executor provided no reference_throughput)")
            target = slo_level * self.rc_throughputs
            return float(np.mean(self.throughputs < target))
        raise ValueError(reference)

    # -- admission / shed accounting (docs/CONTROL.md) ----------------------
    @property
    def num_admitted(self) -> int:
        """Queries that entered (and ran through) the pipeline."""
        return len(self.latencies)

    @property
    def num_shed(self) -> int:
        """Queries the admission policy turned away."""
        return len(self.shed_arrivals)

    @property
    def num_offered(self) -> int:
        """All arrivals, admitted plus shed."""
        return self.num_admitted + self.num_shed

    @property
    def shed_rate(self) -> float:
        """Fraction of offered queries that were shed."""
        return self.num_shed / self.num_offered if self.num_offered else 0.0

    # -- fault accounting (repro.faults; docs/FAULTS.md) ---------------------
    @property
    def availability(self) -> float:
        """Completed ÷ admitted.  1.0 for a fault-free run; admitted
        queries that exhausted their retry budget lower it.  Shed
        queries are an admission decision, not a failure — they do not
        count against availability."""
        admitted = self.num_admitted + self.num_failed
        if not admitted:
            return float("nan")
        return self.num_admitted / admitted

    @property
    def wasted_work_frac(self) -> float:
        """Fraction of total pipeline occupancy that produced no
        completion (timed-out hangs, cancelled hedge losers)."""
        if self.wasted_time <= 0.0:
            return 0.0
        useful = float(np.sum(np.where(self.throughputs > 0,
                                       1.0 / np.maximum(self.throughputs,
                                                        1e-12), 0.0)))
        total = useful + self.wasted_time
        return self.wasted_time / total if total > 0 else 0.0

    @property
    def slo_attainment(self) -> float:
        """Fraction of *admitted* queries with latency within the
        admission policy's SLO (trivially 1.0 when no finite SLO was
        enforced; NaN for an empty trace)."""
        if not self.num_admitted:
            return float("nan")
        if not np.isfinite(self.slo_latency):
            return 1.0
        return float(np.mean(self.latencies <= self.slo_latency))

    @property
    def goodput_qps(self) -> float:
        """Completion rate of admitted queries that met the SLO — the
        control plane's figure of merit (InferLine's goodput).  Equals
        :attr:`achieved_load` when no SLO was enforced."""
        if not np.isfinite(self.slo_latency):
            return self.achieved_load
        if self.completion_times is None or len(self.completion_times) < 2:
            return float("nan")
        span = float(np.max(self.completion_times))
        if span <= 0:
            return float("inf")
        return float(np.sum(self.latencies <= self.slo_latency)) / span

    # -- batch occupancy / padding (docs/WORKLOADS.md) -----------------------
    @property
    def mean_batch_occupancy(self) -> float:
        """Mean dispatch size queries rode in (1.0 = everything solo)."""
        if not len(self.batch_sizes):
            return float("nan")
        return float(np.mean(self.batch_sizes))

    @property
    def padded_token_frac(self) -> float:
        """Fraction of executed tokens that were padding waste
        (``1 - actual/padded``); 0.0 when the run carried no length
        information (both totals are then zero)."""
        total = float(np.sum(self.padded_tokens))
        if total <= 0.0:
            return 0.0
        return 1.0 - float(np.sum(self.actual_tokens)) / total

    # -- QoS tiers (repro.qos; docs/QOS.md) ----------------------------------
    @property
    def deadline_met_mask(self) -> np.ndarray:
        """Per-admitted-query "completed within its deadline" mask
        (all-True rows for tiers without a deadline)."""
        if self.tier_deadlines is None:
            raise ValueError("this trace has no tiers configured")
        return self.latencies <= self.tier_deadlines

    @property
    def offered_value(self) -> float:
        """Total SLO value offered to the run: admitted plus shed."""
        if self.tier_values is None:
            return float("nan")
        return float(np.sum(self.tier_values)) + float(self.shed_value)

    @property
    def realized_value(self) -> float:
        """SLO value actually earned: the summed value of admitted
        queries that completed within their deadlines.  The QoS figure
        of merit — what value-aware shedding maximizes under overload
        (a shed or late query earns nothing)."""
        if self.tier_values is None:
            return float("nan")
        return float(np.sum(self.tier_values[self.deadline_met_mask]))

    def tier_summary(self) -> Dict[str, float]:
        """Per-tier metric keys (docs/QOS.md): served/shed counts,
        p50/p99 latency, deadline attainment (met ÷ offered — shed
        queries count against the tier), downgrades when a downgrade
        router ran, plus the fleet-level offered/realized value.
        Empty when the run had no tiers configured."""
        if self.tier_names is None:
            return {}
        nan = float("nan")
        out = {"offered_value": self.offered_value,
               "realized_value": self.realized_value}
        met_mask = self.deadline_met_mask
        for i, name in enumerate(self.tier_names):
            m = self.tier_ids == i
            cnt = int(np.count_nonzero(m))
            shed = int(self.shed_tier_counts[i])
            offered = cnt + shed
            lat = np.sort(self.latencies[m])
            out[f"tier_{name}_num"] = float(cnt)
            out[f"tier_{name}_shed"] = float(shed)
            out[f"tier_{name}_p50_latency_s"] = _percentile_sorted(lat, 50)
            out[f"tier_{name}_p99_latency_s"] = _percentile_sorted(lat, 99)
            out[f"tier_{name}_deadline_attainment"] = (
                int(np.count_nonzero(met_mask & m)) / offered
                if offered else nan)
            if self.downgrade_tier_counts is not None:
                out[f"tier_{name}_downgraded"] = float(
                    self.downgrade_tier_counts[i])
        return out

    # -- sharded stage execution (docs/SHARDING.md) ---------------------------
    @property
    def mean_collective_frac(self) -> float:
        """Mean bottleneck-stage collective share across queries (NaN
        on an unsharded or empty trace)."""
        if self.collective_fracs is None or not len(self.collective_fracs):
            return float("nan")
        return float(np.mean(self.collective_fracs))

    # -- offered vs. achieved load ------------------------------------------
    @property
    def offered_load(self) -> float:
        """Arrival rate over the run (queries / time unit), counting
        shed queries — offered load is what arrived, not what ran."""
        if self.arrival_times is None or len(self.arrival_times) < 2:
            return float("nan")
        span = float(self.arrival_times[-1])
        if self.num_shed:
            span = max(span, float(np.max(self.shed_arrivals)))
        return self.num_offered / span if span > 0 else float("inf")

    @property
    def achieved_load(self) -> float:
        """Completion rate over the run (queries / time unit)."""
        if self.completion_times is None or len(self.completion_times) < 2:
            return float("nan")
        span = float(np.max(self.completion_times))
        return (len(self.completion_times) / span if span > 0
                else float("inf"))

    def load_profile(self, num_windows: int = 20
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-window offered vs. achieved rates.

        Returns ``(window_starts, offered_qps, achieved_qps)`` over
        ``num_windows`` equal windows spanning the run; shows where an
        open-loop burst outran the pipeline (offered > achieved) and the
        later drain (achieved > offered).
        """
        if self.arrival_times is None or self.completion_times is None:
            raise ValueError("no arrival ledger on this trace")
        end = float(max(np.max(self.completion_times),
                        self.arrival_times[-1]))
        edges = np.linspace(0.0, end if end > 0 else 1.0, num_windows + 1)
        width = edges[1] - edges[0]
        offered = np.histogram(self.arrival_times, bins=edges)[0] / width
        achieved = np.histogram(self.completion_times, bins=edges)[0] / width
        return edges[:-1], offered, achieved

    # -- the one summary dict ------------------------------------------------
    #: SLO level summary() reports violations at (throughput >= 90% of
    #: the interference-free peak; paper Fig. 9's mid-range level).
    SUMMARY_SLO_LEVEL = 0.9

    def summary(self) -> Dict[str, float]:
        """Flat metric dict — identical keys for sim and live runs.

        NaN-safe on an empty trace (zero admitted queries): every
        per-query statistic reads as NaN; counts and shed accounting
        stay exact.  Percentile keys share one cached sort per field
        (:meth:`percentile`) instead of re-sorting per read.
        """
        n = self.num_admitted
        nan = float("nan")
        peak_known = np.isfinite(self.peak_throughput)
        out = {
            "mean_latency_s": float(self.latencies.mean()) if n else nan,
            "p50_latency_s": self.percentile(50),
            "p99_latency_s": self.tail_latency(99),
            "mean_service_latency_s": (float(self.service_latencies.mean())
                                       if n else nan),
            "mean_queue_delay_s": self.mean_queue_delay,
            "p99_queue_delay_s": self.percentile(99, "queue_delays"),
            "mean_throughput_qps": (float(self.throughputs.mean())
                                    if n else nan),
            "steady_throughput_qps": self.steady_throughput,
            "peak_throughput_qps": float(self.peak_throughput),
            "offered_load_qps": self.offered_load,
            "achieved_load_qps": self.achieved_load,
            "slo_violations": (self.slo_violations(self.SUMMARY_SLO_LEVEL)
                               if peak_known else float("nan")),
            "rebalances": self.num_rebalances,
            "serial_frac": self.rebalance_fraction,
            # -- admission control / goodput (docs/CONTROL.md) -------------
            "num_shed": float(self.num_shed),
            "shed_rate": self.shed_rate,
            "goodput_qps": self.goodput_qps,
            "slo_attainment": self.slo_attainment,
            "slo_latency_s": float(self.slo_latency),
            # -- batch occupancy / padding (docs/WORKLOADS.md) --------------
            "mean_batch_occupancy": self.mean_batch_occupancy,
            "p99_batch_occupancy": self.percentile(99, "batch_sizes"),
            "padded_token_frac": self.padded_token_frac,
            # -- fault tolerance (repro.faults; docs/FAULTS.md) -------------
            "num_failed": float(self.num_failed),
            "num_retried": float(self.num_retried),
            "num_hedged": float(self.num_hedged),
            "availability": self.availability,
            "wasted_work_frac": self.wasted_work_frac,
            "downtime_s": float(self.downtime),
        }
        # Per-tier keys appear only on tiered runs, so no-tier
        # summaries are byte-identical to pre-QoS summaries.
        if self.tier_names is not None:
            out.update(self.tier_summary())
        # Mesh keys appear only on sharded runs (same gating rule).
        if self.mesh_devices > 0:
            out["mesh_devices"] = float(self.mesh_devices)
            out["num_mesh_resizes"] = float(self.num_mesh_resizes)
            out["mean_collective_frac"] = self.mean_collective_frac
            out["p99_collective_frac"] = (
                self.percentile(99, "collective_fracs")
                if self.collective_fracs is not None else nan)
        return out
