"""Fleet-level result type, built on the per-replica PipelineTrace.

A :class:`ClusterTrace` holds one
:class:`~repro_torch.workloads.trace.PipelineTrace` per replica plus the
assignment ledger (which replica served each fleet arrival, in arrival
order).  Fleet metrics come from the :attr:`fleet` trace — the
per-replica arrays gathered back into fleet arrival order and run
through the *same* PipelineTrace metric code — so p50/p99, queueing
delay and offered/achieved load mean exactly what they mean for a
single pipeline.  Only the SLO reference differs: each query's
throughput is compared against *its own replica's* interference-free
peak (fleets may be heterogeneous).

The port's copy of the JAX package's ``cluster/trace.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.workloads.trace import PipelineTrace


@dataclasses.dataclass
class ClusterTrace:
    router: str
    workload: str
    scheduler: str
    #: One finished trace per replica (local query order).
    replicas: List[PipelineTrace]
    #: Fleet arrival order -> replica index that served the query
    #: (``-1`` = shed by the admission policy, docs/CONTROL.md;
    #: ``-2`` = admitted but failed after exhausting its retry budget,
    #: docs/FAULTS.md — no per-query row exists for either).
    assignments: np.ndarray
    #: Fleet arrival order -> index within that replica's trace
    #: (``-1`` for shed queries).
    local_indices: np.ndarray
    # -- control plane (repro_torch.control) ---------------------------------------
    #: Admission policy the fleet was served under.
    admission: str = "none"
    #: Autoscaler sizing the active replica set.
    autoscaler: str = "static"
    #: Latency objective the admission policy enforced (+inf = none).
    slo_latency: float = float("inf")
    #: Fleet arrival times of shed queries.
    shed_arrivals: Optional[np.ndarray] = None
    #: Change points of the active replica set: ``(fleet query index,
    #: active indices)`` — empty when no autoscaler ran (all active).
    active_timeline: Optional[List[Tuple[int, Tuple[int, ...]]]] = None
    # -- QoS tiers (repro_torch.qos, docs/QOS.md) ----------------------------------
    #: Tier names in tier-id order (``None`` = run had no tiers).
    tier_names: Optional[List[str]] = None
    #: Fleet-level sheds per tier (replicas never shed; admission
    #: happens at the fleet layer before any runner sees the query).
    shed_tier_counts: Optional[np.ndarray] = None
    #: Total SLO value of the shed arrivals.
    shed_value: float = 0.0
    #: Per-tier downgrade counts (``downgrade`` router, heterogeneous
    #: fleets); ``None`` when the router keeps no downgrade ledger.
    downgrade_tier_counts: Optional[np.ndarray] = None

    def __post_init__(self):
        self.assignments = np.asarray(self.assignments, dtype=int)
        self.local_indices = np.asarray(self.local_indices, dtype=int)
        if self.shed_arrivals is None:
            self.shed_arrivals = np.empty(0)
        else:
            self.shed_arrivals = np.asarray(self.shed_arrivals, dtype=float)
        if self.active_timeline is None:
            self.active_timeline = []

    # -- shape ---------------------------------------------------------------
    @property
    def num_replicas(self) -> int:
        return len(self.replicas)

    @property
    def num_queries(self) -> int:
        """All offered fleet arrivals, admitted plus shed."""
        return len(self.assignments)

    @property
    def admitted_mask(self) -> np.ndarray:
        """True where the fleet arrival was admitted (served)."""
        return self.assignments >= 0

    @property
    def num_admitted(self) -> int:
        return int(np.count_nonzero(self.admitted_mask))

    @property
    def num_shed(self) -> int:
        return len(self.shed_arrivals)

    @property
    def shed_rate(self) -> float:
        """Fraction of offered fleet arrivals that were shed."""
        return self.num_shed / self.num_queries if self.num_queries else 0.0

    @property
    def active_counts(self) -> np.ndarray:
        """Active replicas at each fleet arrival (all, without an
        autoscaler) — the active-replica timeline as a dense array."""
        counts = np.full(self.num_queries, self.num_replicas, dtype=int)
        for start, active in self.active_timeline:
            counts[start:] = len(active)
        return counts

    @property
    def replica_counts(self) -> np.ndarray:
        """Queries served per replica."""
        return np.bincount(self.assignments[self.admitted_mask],
                           minlength=self.num_replicas)

    # -- fleet-order gathers --------------------------------------------------
    def gather(self, field: str) -> np.ndarray:
        """Per-replica per-query array ``field`` gathered into fleet
        arrival order over the *admitted* queries."""
        ref = getattr(self.replicas[0], field)
        out = np.empty(self.num_queries, dtype=np.asarray(ref).dtype)
        for r, t in enumerate(self.replicas):
            out[self.assignments == r] = getattr(t, field)
        return out[self.admitted_mask]

    @property
    def fleet(self) -> PipelineTrace:
        """The fleet as one PipelineTrace (computed on access so
        post-run stamping of replica peaks is picked up).

        ``peak_throughput`` is only meaningful for ``n = 1`` (where the
        fleet *is* the replica); multi-replica SLO accounting goes
        through :meth:`slo_violations`, which compares each query
        against its own replica's peak.
        """
        configs: List[Optional[list]] = [None] * self.num_queries
        for r, t in enumerate(self.replicas):
            for pos, cfg in zip(np.flatnonzero(self.assignments == r),
                                t.configs_trace):
                configs[pos] = cfg
        configs = [c for c, ok in zip(configs, self.admitted_mask) if ok]
        rc = None
        if all(t.rc_throughputs is not None for t in self.replicas):
            rc = self.gather("rc_throughputs")
        if self.num_replicas == 1:
            peak = self.replicas[0].peak_throughput
        else:
            # Served-share-weighted mean of the known per-replica peaks:
            # the interference-free rate the fleet's actual dispatch mix
            # would sustain.  A plain mean misreads heterogeneous fleets
            # (docs/QOS.md) — a small-model replica serving 5% of the
            # traffic must not drag the reference down as if it served
            # half.  NaN when no serving replica has a known peak.
            acc = w = 0.0
            for t, cnt in zip(self.replicas, self.replica_counts):
                if cnt and np.isfinite(t.peak_throughput):
                    acc += float(cnt) * t.peak_throughput
                    w += float(cnt)
            peak = acc / w if w else float("nan")
        tier_cols: Dict[str, object] = {}
        if self.tier_names is not None:
            tier_cols = dict(
                tier_names=list(self.tier_names),
                tier_ids=self.gather("tier_ids"),
                tier_deadlines=self.gather("tier_deadlines"),
                tier_values=self.gather("tier_values"),
                shed_tier_counts=self.shed_tier_counts,
                shed_value=self.shed_value,
                downgrade_tier_counts=self.downgrade_tier_counts,
            )
        return PipelineTrace(
            scheduler=self.scheduler,
            latencies=self.gather("latencies"),
            throughputs=self.gather("throughputs"),
            serial_mask=self.gather("serial_mask"),
            configs_trace=configs,
            num_rebalances=sum(t.num_rebalances for t in self.replicas),
            total_trials=sum(t.total_trials for t in self.replicas),
            mitigation_lengths=[m for t in self.replicas
                                for m in t.mitigation_lengths],
            workload=self.workload,
            service_latencies=self.gather("service_latencies"),
            queue_delays=self.gather("queue_delays"),
            arrival_times=self.gather("arrival_times"),
            completion_times=self.gather("completion_times"),
            queue_depths=self.gather("queue_depths"),
            peak_throughput=peak,
            rc_throughputs=rc,
            admission=self.admission,
            slo_latency=self.slo_latency,
            shed_arrivals=self.shed_arrivals,
            num_failed=sum(t.num_failed for t in self.replicas),
            num_retried=sum(t.num_retried for t in self.replicas),
            num_hedged=sum(t.num_hedged for t in self.replicas),
            wasted_time=sum(t.wasted_time for t in self.replicas),
            downtime=sum(t.downtime for t in self.replicas),
            **tier_cols,
        )

    # -- fleet metrics (one metric implementation: PipelineTrace's) ----------
    def tail_latency(self, pct: float = 99.0) -> float:
        return self.fleet.tail_latency(pct)

    @property
    def mean_queue_delay(self) -> float:
        return self.fleet.mean_queue_delay

    @property
    def offered_load(self) -> float:
        """Fleet arrival rate over the run."""
        return self.fleet.offered_load

    @property
    def achieved_load(self) -> float:
        """Fleet completion rate over the run."""
        return self.fleet.achieved_load

    def slo_violations(self, slo_level: float) -> float:
        """Fraction of admitted queries with throughput below
        ``slo_level`` x *their replica's* interference-free peak."""
        peaks = np.array([t.peak_throughput for t in self.replicas])[
            self.assignments[self.admitted_mask]]
        return float(np.mean(self.gather("throughputs")
                             < slo_level * peaks))

    # -- the one summary dict ------------------------------------------------
    def summary(self) -> Dict[str, float]:
        """Flat metric dict: the PipelineTrace surface computed at the
        fleet level plus the cluster-only columns."""
        fleet = self.fleet
        s = fleet.summary()
        peak_known = all(np.isfinite(t.peak_throughput)
                         for t in self.replicas)
        s["slo_violations"] = (
            self.slo_violations(PipelineTrace.SUMMARY_SLO_LEVEL)
            if peak_known else float("nan"))
        s["num_replicas"] = self.num_replicas
        s["router"] = self.router
        s["min_replica_share"] = (float(self.replica_counts.min())
                                  / max(self.num_admitted, 1))
        s["max_replica_share"] = (float(self.replica_counts.max())
                                  / max(self.num_admitted, 1))
        # -- control plane (docs/CONTROL.md) -----------------------------
        s["admission"] = self.admission
        s["autoscaler"] = self.autoscaler
        s["num_shed"] = float(self.num_shed)
        s["shed_rate"] = self.shed_rate
        s["mean_active_replicas"] = (float(self.active_counts.mean())
                                     if self.num_queries
                                     else float(self.num_replicas))
        return s

    def rows(self) -> List[Dict]:
        """Per-replica + fleet metric rows (CSV-ready, one schema)."""
        out = []
        for r, t in enumerate(self.replicas):
            row = {"scope": f"replica{r}", "router": self.router,
                   "workload": self.workload, "scheduler": t.scheduler,
                   "queries": int(self.replica_counts[r])}
            if len(t.latencies):
                row.update(
                    p50_latency=t.percentile(50),
                    p99_latency=t.tail_latency(99),
                    mean_queue_delay=t.mean_queue_delay,
                    steady_throughput=t.steady_throughput,
                    rebalances=t.num_rebalances,
                    total_trials=t.total_trials,
                )
            else:   # a replica the router never picked
                row.update(p50_latency=float("nan"),
                           p99_latency=float("nan"),
                           mean_queue_delay=float("nan"),
                           steady_throughput=float("nan"),
                           rebalances=t.num_rebalances,
                           total_trials=t.total_trials)
            out.append(row)
        s = self.summary()
        out.append({"scope": "fleet", "router": self.router,
                    "workload": self.workload, "scheduler": self.scheduler,
                    "queries": self.num_queries,
                    "p50_latency": s["p50_latency_s"],
                    "p99_latency": s["p99_latency_s"],
                    "mean_queue_delay": s["mean_queue_delay_s"],
                    "steady_throughput": s["steady_throughput_qps"],
                    "rebalances": s["rebalances"],
                    "total_trials": sum(t.total_trials
                                        for t in self.replicas)})
        return out
