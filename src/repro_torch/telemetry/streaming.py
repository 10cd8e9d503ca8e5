"""Streaming trace types: the dense metric surface at flat memory.

:class:`StreamingCollector` is the online accumulator the run loops
feed instead of dense per-query arrays when ``trace_mode="streaming"``:
quantile sketches for latency / queue delay / throughput, exact
counters for everything countable (admitted, shed, serial, SLO-met,
sums for means), a :class:`~repro_torch.telemetry.rollup.WindowedRollup` for
the load profile, and a :class:`~repro_torch.telemetry.metrics.MetricsRegistry`
view for export.  Emission to a :class:`~repro_torch.telemetry.sink.MetricsSink`
happens inside :meth:`StreamingCollector.observe_chunk` on a
query-count cadence, so snapshots are deterministic per (workload,
seed).

:class:`StreamingTrace` / :class:`StreamingClusterTrace` expose the
same ``summary()`` / ``tail_latency`` / shed-accounting surface as
:class:`~repro_torch.workloads.trace.PipelineTrace` and
:class:`~repro.cluster.trace.ClusterTrace` — identical keys, values
exact where a counter suffices (means, attainment, goodput, loads,
shed rates) and within sketch tolerance where a percentile is involved
(docs/TELEMETRY.md "Streaming vs. dense").

This module deliberately imports nothing from the rest of ``repro`` —
the run loops depend on telemetry, never the reverse.

The port's copy of the JAX package's ``telemetry/streaming.py``; only import paths
differ.  ``tests/test_torch_workloads.py`` holds it equal to
the original.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .metrics import MetricsRegistry
from .rollup import DEFAULT_MAX_WINDOWS, WindowedRollup
from .sketch import DEFAULT_COMPRESSION, QuantileSketch

#: Mirrors ``PipelineTrace.SUMMARY_SLO_LEVEL`` (kept local: telemetry
#: must not import the trace types it substitutes for).
SUMMARY_SLO_LEVEL = 0.9

#: Default sink cadence: one snapshot per this many observed queries.
DEFAULT_SINK_INTERVAL = 10_000


class _TierStats:
    """Per-QoS-tier accumulator (docs/QOS.md): a latency sketch plus
    exact counters for served/met/shed/downgraded and offered vs.
    realized SLO value.  One per tier, keyed by tier index."""

    __slots__ = ("name", "latency", "count", "met", "shed",
                 "value_offered", "value_realized", "downgraded")

    def __init__(self, name: str, compression: int = DEFAULT_COMPRESSION):
        self.name = name
        self.latency = QuantileSketch(compression)
        self.count = 0             # queries served in this tier
        self.met = 0               # served within their deadline
        self.shed = 0              # turned away by admission
        self.value_offered = 0.0   # summed value, served + shed
        self.value_realized = 0.0  # summed value of deadline-met queries
        self.downgraded = 0        # routed to a small-model replica


class StreamingCollector:
    """Online accumulator for one pipeline's run.

    The runner feeds it flushed spans of its (bounded, recycled) result
    arrays via :meth:`observe_chunk` and shed arrivals via
    :meth:`observe_shed`; :meth:`finish` freezes it into a
    :class:`StreamingTrace`.  Collectors fold together with
    :meth:`absorb` — per-replica collectors aggregate into fleet
    metrics with counter-exact / sketch-tolerant semantics.
    """

    def __init__(self, slo: float = float("inf"),
                 sink=None,
                 sink_interval: int = DEFAULT_SINK_INTERVAL,
                 compression: int = DEFAULT_COMPRESSION,
                 max_windows: int = DEFAULT_MAX_WINDOWS,
                 namespace: str = "repro",
                 latency_buckets=None):
        self.slo = float(slo)
        self.latency_buckets = latency_buckets
        self.latency = QuantileSketch(compression)
        self.queue_delay = QuantileSketch(compression)
        self.throughput = QuantileSketch(compression)
        self.occupancy = QuantileSketch(compression)  # dispatch sizes
        self.rollup = WindowedRollup(max_windows=max_windows)
        self.num_admitted = 0
        self.num_shed = 0
        self.num_serial = 0
        self.num_slo_met = 0
        self.service_sum = 0.0
        self.steady_thr_sum = 0.0        # throughput sum over pipelined rows
        self.padded_tok_sum = 0.0        # padded tokens executed
        self.actual_tok_sum = 0.0        # useful tokens executed
        self.max_arrival = 0.0
        self.max_completion = 0.0
        self.max_shed_arrival = 0.0
        self.last_queue_depth = 0.0
        self.max_queue_depth = 0.0
        # -- fault tolerance (repro.faults; docs/FAULTS.md) ------------------
        self.num_failed = 0            # admitted queries that never completed
        self.num_retried = 0           # retry attempts made
        self.num_hedged = 0            # hedged dispatches won
        self.wasted_time = 0.0         # cancelled/timed-out occupancy
        self.downtime = 0.0            # crash + breaker-open time
        self.busy_sum = 0.0            # useful occupancy (sum of 1/thr)
        # -- QoS tiers (docs/QOS.md) -----------------------------------------
        self.tier_stats: Optional[List[_TierStats]] = None
        self.track_downgrades = False
        self._compression = compression
        self.sink = sink
        self.sink_interval = max(1, int(sink_interval))
        self.num_emits = 0
        self._since_emit = 0
        self._registry = MetricsRegistry(namespace)
        self._init_registry()

    def configure_tiers(self, names) -> None:
        """Arm per-tier accounting for the given tier names (idempotent
        when re-configured with the same names; tier columns fed to
        :meth:`observe_chunk` / :meth:`observe_shed` require this)."""
        names = tuple(names)
        if self.tier_stats is not None:
            if tuple(t.name for t in self.tier_stats) != names:
                raise ValueError(
                    f"collector already configured with tiers "
                    f"{tuple(t.name for t in self.tier_stats)}, got {names}")
            return
        self.tier_stats = [_TierStats(n, self._compression) for n in names]

    def _init_registry(self) -> None:
        reg = self._registry
        reg.counter("queries_offered_total", "arrivals, admitted plus shed")
        reg.counter("queries_admitted_total", "queries served")
        reg.counter("queries_shed_total", "queries the admission policy "
                                          "turned away")
        reg.counter("queries_serial_total", "exploration-trial queries")
        reg.counter("queries_slo_met_total", "admitted queries within the "
                                             "latency SLO")
        # Summaries share the collector's sketches, so the registry view
        # is always current without copying.
        reg.summary("latency_seconds", "per-query latency").sketch = \
            self.latency
        reg.summary("queue_delay_seconds", "per-query queueing delay"
                    ).sketch = self.queue_delay
        reg.summary("throughput_qps", "per-query pipeline throughput"
                    ).sketch = self.throughput
        reg.summary("batch_occupancy", "dispatch size each query rode in"
                    ).sketch = self.occupancy
        reg.counter("tokens_padded_total", "padded tokens executed "
                                           "(bucket-edge lengths)")
        reg.counter("tokens_actual_total", "useful tokens executed")
        reg.gauge("padded_token_frac", "fraction of executed tokens that "
                                       "were padding waste")
        reg.gauge("queue_depth", "in-system depth at the last arrival")
        reg.gauge("slo_attainment", "fraction of admitted queries within "
                                    "the SLO")
        reg.gauge("shed_rate", "fraction of offered queries shed")
        reg.gauge("offered_qps", "arrival rate so far")
        reg.gauge("achieved_qps", "completion rate so far")
        reg.gauge("goodput_qps", "SLO-met completion rate so far")
        # -- fault tolerance (docs/FAULTS.md) --------------------------------
        reg.counter("queries_failed_total", "admitted queries that "
                                            "exhausted their retry budget")
        reg.counter("queries_retried_total", "retry attempts made")
        reg.counter("queries_hedged_total", "hedged dispatches won")
        reg.counter("wasted_seconds_total", "occupancy charged for work "
                                            "that produced no completion")
        reg.counter("downtime_seconds_total", "replica crash/breaker-open "
                                              "time")
        reg.gauge("availability", "completed / admitted so far")
        # Optional fixed-bucket mirror of the latency summary: external
        # tooling aggregates _bucket series by addition, no sketch merge.
        if self.latency_buckets is not None:
            self._lat_hist = reg.histogram(
                "latency_seconds_hist", "per-query latency (fixed-bucket "
                "histogram mirror)", buckets=self.latency_buckets)
        else:
            self._lat_hist = None

    # -- ingest --------------------------------------------------------------
    def observe_chunk(self, latencies: np.ndarray,
                      service_latencies: np.ndarray,
                      queue_delays: np.ndarray,
                      throughputs: np.ndarray,
                      serial_mask: np.ndarray,
                      arrival_times: np.ndarray,
                      completion_times: np.ndarray,
                      queue_depths: np.ndarray,
                      batch_sizes: Optional[np.ndarray] = None,
                      padded_tokens: Optional[np.ndarray] = None,
                      actual_tokens: Optional[np.ndarray] = None,
                      tier_ids: Optional[np.ndarray] = None,
                      deadlines: Optional[np.ndarray] = None,
                      values: Optional[np.ndarray] = None) -> None:
        """Fold one span of index-aligned per-query rows (the runner's
        flushed arrays; the caller recycles them afterwards).  The
        batching columns are optional — a feeder without them reads as
        all-solo dispatch (occupancy 1) with no token accounting.  The
        QoS columns (tier index, relative deadline, value per query)
        require a prior :meth:`configure_tiers`."""
        n = len(latencies)
        if n == 0:
            return
        self.latency.add(latencies)
        if self._lat_hist is not None:
            self._lat_hist.observe(latencies)
        self.queue_delay.add(queue_delays)
        self.throughput.add(throughputs)
        self.busy_sum += float(np.sum(np.where(
            throughputs > 0, 1.0 / np.maximum(throughputs, 1e-12), 0.0)))
        self.occupancy.add(batch_sizes if batch_sizes is not None
                           else np.ones(n))
        if padded_tokens is not None:
            self.padded_tok_sum += float(padded_tokens.sum())
        if actual_tokens is not None:
            self.actual_tok_sum += float(actual_tokens.sum())
        self.num_admitted += n
        serial = int(np.count_nonzero(serial_mask))
        self.num_serial += serial
        if serial < n:
            self.steady_thr_sum += float(throughputs[~serial_mask].sum())
        self.service_sum += float(service_latencies.sum())
        if math.isfinite(self.slo):
            self.num_slo_met += int(
                np.count_nonzero(latencies <= self.slo))
        else:
            self.num_slo_met += n
        self.max_arrival = max(self.max_arrival, float(arrival_times[-1]))
        self.max_completion = max(self.max_completion,
                                  float(completion_times.max()))
        self.last_queue_depth = float(queue_depths[-1])
        self.max_queue_depth = max(self.max_queue_depth,
                                   float(queue_depths.max()))
        self.rollup.observe_arrivals(arrival_times)
        self.rollup.observe_completions(completion_times, latencies)
        if tier_ids is not None:
            if self.tier_stats is None:
                raise ValueError(
                    "tier columns require configure_tiers() first")
            met_mask = latencies <= deadlines
            for i, ts in enumerate(self.tier_stats):
                m = tier_ids == i
                k = int(np.count_nonzero(m))
                if not k:
                    continue
                ts.latency.add(latencies[m])
                ts.count += k
                ts.met += int(np.count_nonzero(met_mask & m))
                ts.value_offered += float(values[m].sum())
                ts.value_realized += float(values[m & met_mask].sum())
        self._tick_sink(n)

    def observe_shed(self, arrivals, tier: Optional[int] = None,
                     value: float = 1.0) -> None:
        """Record shed arrival time(s) — counters and rollup only, no
        per-query storage.  With ``tier`` the shed also counts against
        that tier's offered value (``value`` is per shed arrival)."""
        times = np.atleast_1d(np.asarray(arrivals, dtype=np.float64))
        if times.size == 0:
            return
        self.num_shed += times.size
        self.max_shed_arrival = max(self.max_shed_arrival,
                                    float(times.max()))
        self.rollup.observe_shed(times)
        if tier is not None:
            if self.tier_stats is None:
                raise ValueError(
                    "tiered sheds require configure_tiers() first")
            ts = self.tier_stats[int(tier)]
            ts.shed += times.size
            ts.value_offered += float(value) * times.size
        self._tick_sink(times.size)

    def note_downgrade(self, tier: int, n: int = 1) -> None:
        """Count ``n`` queries of ``tier`` routed to a small-model
        replica instead of shed (the ``downgrade`` router)."""
        if self.tier_stats is None:
            raise ValueError("downgrades require configure_tiers() first")
        self.track_downgrades = True
        self.tier_stats[int(tier)].downgraded += int(n)

    def _tick_sink(self, n: int) -> None:
        if self.sink is None:
            return
        self._since_emit += n
        if self._since_emit >= self.sink_interval:
            self._since_emit = 0
            self.emit()

    def absorb(self, other: "StreamingCollector") -> "StreamingCollector":
        """Fold another collector's state into this one (fleet
        aggregation); ``other`` is not modified."""
        self.latency.merge(other.latency)
        self.queue_delay.merge(other.queue_delay)
        self.throughput.merge(other.throughput)
        self.occupancy.merge(other.occupancy)
        self.rollup.merge(other.rollup)
        self.num_admitted += other.num_admitted
        self.num_shed += other.num_shed
        self.num_serial += other.num_serial
        self.num_slo_met += other.num_slo_met
        self.service_sum += other.service_sum
        self.steady_thr_sum += other.steady_thr_sum
        self.padded_tok_sum += other.padded_tok_sum
        self.actual_tok_sum += other.actual_tok_sum
        self.max_arrival = max(self.max_arrival, other.max_arrival)
        self.max_completion = max(self.max_completion, other.max_completion)
        self.max_shed_arrival = max(self.max_shed_arrival,
                                    other.max_shed_arrival)
        self.last_queue_depth = other.last_queue_depth
        self.max_queue_depth = max(self.max_queue_depth,
                                   other.max_queue_depth)
        self.num_failed += other.num_failed
        self.num_retried += other.num_retried
        self.num_hedged += other.num_hedged
        self.wasted_time += other.wasted_time
        self.downtime += other.downtime
        self.busy_sum += other.busy_sum
        if self._lat_hist is not None and other._lat_hist is not None:
            self._lat_hist.merge_from(other._lat_hist)
        if other.tier_stats is not None:
            self.configure_tiers([t.name for t in other.tier_stats])
            for mine, theirs in zip(self.tier_stats, other.tier_stats):
                mine.latency.merge(theirs.latency)
                mine.count += theirs.count
                mine.met += theirs.met
                mine.shed += theirs.shed
                mine.value_offered += theirs.value_offered
                mine.value_realized += theirs.value_realized
                mine.downgraded += theirs.downgraded
            self.track_downgrades = (self.track_downgrades
                                     or other.track_downgrades)
        return self

    # -- derived rates --------------------------------------------------------
    @property
    def num_offered(self) -> int:
        return self.num_admitted + self.num_shed

    @property
    def offered_qps(self) -> float:
        # Mirrors the dense definition, including its guard: the span
        # is anchored on *admitted* arrivals, so fewer than two of them
        # reads as NaN even when sheds were recorded.
        if self.num_admitted < 2:
            return math.nan
        span = max(self.max_arrival, self.max_shed_arrival)
        return self.num_offered / span if span > 0 else math.inf

    @property
    def achieved_qps(self) -> float:
        if self.num_admitted < 2:
            return math.nan
        return (self.num_admitted / self.max_completion
                if self.max_completion > 0 else math.inf)

    @property
    def goodput_qps(self) -> float:
        if not math.isfinite(self.slo):
            return self.achieved_qps
        if self.num_admitted < 2:
            return math.nan
        return (self.num_slo_met / self.max_completion
                if self.max_completion > 0 else math.inf)

    @property
    def slo_attainment(self) -> float:
        if not self.num_admitted:
            return math.nan
        if not math.isfinite(self.slo):
            return 1.0
        return self.num_slo_met / self.num_admitted

    @property
    def shed_rate(self) -> float:
        return self.num_shed / self.num_offered if self.num_offered else 0.0

    @property
    def padded_token_frac(self) -> float:
        """Fraction of executed tokens that were padding waste; 0.0
        when the run carried no length information."""
        if self.padded_tok_sum <= 0.0:
            return 0.0
        return 1.0 - self.actual_tok_sum / self.padded_tok_sum

    # -- fault accounting (repro.faults; docs/FAULTS.md) ---------------------
    def note_faults(self, num_failed: int = 0, num_retried: int = 0,
                    num_hedged: int = 0, wasted_time: float = 0.0,
                    downtime: float = 0.0) -> None:
        """Set the run's fault counters to their current absolute
        values (the runner is the source of truth; called on every
        telemetry flush and at :meth:`finish`)."""
        self.num_failed = int(num_failed)
        self.num_retried = int(num_retried)
        self.num_hedged = int(num_hedged)
        self.wasted_time = float(wasted_time)
        self.downtime = float(downtime)

    @property
    def availability(self) -> float:
        """Completed ÷ admitted (sheds excluded — they are an
        admission decision, not a failure)."""
        admitted = self.num_admitted + self.num_failed
        if not admitted:
            return math.nan
        return self.num_admitted / admitted

    @property
    def wasted_work_frac(self) -> float:
        if self.wasted_time <= 0.0:
            return 0.0
        total = self.busy_sum + self.wasted_time
        return self.wasted_time / total if total > 0 else 0.0

    # -- export --------------------------------------------------------------
    def _refresh_registry(self) -> None:
        reg = self._registry
        # Counters are set by value, not by increment: the collector's
        # integer fields are the source of truth and the registry is a
        # read-only view of them (same package; not an external API).
        reg.counter("queries_offered_total")._value = float(self.num_offered)
        reg.counter("queries_admitted_total")._value = float(
            self.num_admitted)
        reg.counter("queries_shed_total")._value = float(self.num_shed)
        reg.counter("queries_serial_total")._value = float(self.num_serial)
        reg.counter("queries_slo_met_total")._value = float(self.num_slo_met)
        reg.counter("tokens_padded_total")._value = self.padded_tok_sum
        reg.counter("tokens_actual_total")._value = self.actual_tok_sum
        reg.gauge("padded_token_frac").set(self.padded_token_frac)
        reg.gauge("queue_depth").set(self.last_queue_depth)
        reg.gauge("slo_attainment").set(self.slo_attainment)
        reg.gauge("shed_rate").set(self.shed_rate)
        reg.gauge("offered_qps").set(self.offered_qps)
        reg.gauge("achieved_qps").set(self.achieved_qps)
        reg.gauge("goodput_qps").set(self.goodput_qps)
        reg.counter("queries_failed_total")._value = float(self.num_failed)
        reg.counter("queries_retried_total")._value = float(self.num_retried)
        reg.counter("queries_hedged_total")._value = float(self.num_hedged)
        reg.counter("wasted_seconds_total")._value = self.wasted_time
        reg.counter("downtime_seconds_total")._value = self.downtime
        reg.gauge("availability").set(self.availability)

    @property
    def registry(self) -> MetricsRegistry:
        """The live metrics view (refreshed on access)."""
        self._refresh_registry()
        return self._registry

    def snapshot(self) -> Dict[str, object]:
        return self.registry.snapshot()

    def prometheus(self) -> str:
        return self.registry.prometheus()

    def emit(self) -> None:
        """Push one snapshot to the sink (no-op without one)."""
        if self.sink is not None:
            self.sink.emit(self.snapshot())
            self.num_emits += 1

    # -- freeze --------------------------------------------------------------
    def finish(self, scheduler: str = "", workload: str = "closed",
               peak_throughput: float = float("nan"),
               admission: str = "none",
               num_rebalances: int = 0, total_trials: int = 0,
               mitigation_lengths: Optional[List[int]] = None,
               final_config: Optional[List[int]] = None,
               num_failed: int = 0, num_retried: int = 0,
               num_hedged: int = 0, wasted_time: float = 0.0,
               downtime: float = 0.0) -> "StreamingTrace":
        """Final sink emission + freeze into a :class:`StreamingTrace`."""
        if num_failed or num_retried or num_hedged or wasted_time or downtime:
            self.note_faults(num_failed, num_retried, num_hedged,
                             wasted_time, downtime)
        self.emit()
        return StreamingTrace(
            scheduler=scheduler, workload=workload, collector=self,
            num_rebalances=num_rebalances, total_trials=total_trials,
            mitigation_lengths=list(mitigation_lengths or []),
            admission=admission, slo_latency=self.slo,
            peak_throughput=peak_throughput, final_config=final_config)


@dataclasses.dataclass
class StreamingTrace:
    """Flat-memory counterpart of
    :class:`~repro_torch.workloads.trace.PipelineTrace`: the same ``summary()``
    keys and shed/goodput surface, computed from a
    :class:`StreamingCollector` instead of dense per-query arrays.

    Exact where counters suffice (means, attainment, goodput, offered /
    achieved load, shed accounting); within sketch tolerance for
    percentiles and ``slo_violations``.  Per-query arrays do not exist:
    code that needs them must run ``trace_mode="dense"``.
    """

    scheduler: str
    workload: str
    collector: StreamingCollector
    num_rebalances: int = 0
    total_trials: int = 0
    mitigation_lengths: List[int] = dataclasses.field(default_factory=list)
    admission: str = "none"
    slo_latency: float = float("inf")
    peak_throughput: float = float("nan")  # stamped post-run by live engine
    final_config: Optional[List[int]] = None

    trace_mode = "streaming"
    SUMMARY_SLO_LEVEL = SUMMARY_SLO_LEVEL

    _SKETCH_FIELDS = {"latencies": "latency", "queue_delays": "queue_delay",
                      "throughputs": "throughput",
                      "batch_sizes": "occupancy"}

    # -- shape / shed accounting --------------------------------------------
    @property
    def num_admitted(self) -> int:
        return self.collector.num_admitted

    @property
    def num_shed(self) -> int:
        return self.collector.num_shed

    @property
    def num_offered(self) -> int:
        return self.collector.num_offered

    @property
    def shed_rate(self) -> float:
        return self.collector.shed_rate

    @property
    def configs(self) -> List[List[int]]:
        """Only the final configuration survives streaming (dense mode
        keeps the full per-query trace)."""
        return [] if self.final_config is None else [self.final_config]

    @property
    def configs_trace(self) -> List[List[int]]:
        return self.configs

    # -- latency / throughput -------------------------------------------------
    def percentile(self, pct: float, field: str = "latencies") -> float:
        """Sketch percentile of a per-query field (``latencies``,
        ``queue_delays`` or ``throughputs``)."""
        try:
            sketch = getattr(self.collector, self._SKETCH_FIELDS[field])
        except KeyError:
            raise ValueError(f"no streaming sketch for field {field!r}; "
                             f"expected one of "
                             f"{sorted(self._SKETCH_FIELDS)}") from None
        return sketch.percentile(pct)

    def tail_latency(self, pct: float = 99.0) -> float:
        return self.collector.latency.percentile(pct)

    @property
    def mean_queue_delay(self) -> float:
        return self.collector.queue_delay.mean

    @property
    def rebalance_fraction(self) -> float:
        c = self.collector
        return (c.num_serial / c.num_admitted if c.num_admitted
                else math.nan)

    @property
    def steady_throughput(self) -> float:
        c = self.collector
        pipelined = c.num_admitted - c.num_serial
        if pipelined:
            return c.steady_thr_sum / pipelined
        return c.throughput.mean

    # -- SLO ------------------------------------------------------------------
    def slo_violations(self, slo_level: float,
                       reference: str = "peak") -> float:
        """Fraction of queries with throughput below ``slo_level`` ×
        reference, via the throughput sketch's CDF."""
        if reference == "peak":
            if not math.isfinite(self.peak_throughput):
                return math.nan
            return self.collector.throughput.cdf(
                slo_level * self.peak_throughput)
        if reference == "resource_constrained":
            raise ValueError(
                "streaming traces carry no per-query resource-constrained "
                "reference; run trace_mode='dense' for rc accounting")
        raise ValueError(reference)

    @property
    def slo_attainment(self) -> float:
        return self.collector.slo_attainment

    @property
    def goodput_qps(self) -> float:
        return self.collector.goodput_qps

    # -- load -----------------------------------------------------------------
    @property
    def offered_load(self) -> float:
        return self.collector.offered_qps

    @property
    def achieved_load(self) -> float:
        return self.collector.achieved_qps

    def load_profile(self, num_windows: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-window offered vs. achieved rates from the rollup.

        Resolution is the rollup's retention, not ``num_windows`` (the
        argument is accepted for drop-in compatibility with the dense
        trace and ignored).
        """
        return self.collector.rollup.rates()

    # -- export ---------------------------------------------------------------
    @property
    def registry(self) -> MetricsRegistry:
        return self.collector.registry

    def snapshot(self) -> Dict[str, object]:
        return self.collector.snapshot()

    def prometheus(self) -> str:
        return self.collector.prometheus()

    # -- the one summary dict -------------------------------------------------
    def summary(self) -> Dict[str, float]:
        """Same keys as ``PipelineTrace.summary()``."""
        c = self.collector
        n = c.num_admitted
        peak_known = math.isfinite(self.peak_throughput)
        out = {
            "mean_latency_s": c.latency.mean,
            "p50_latency_s": c.latency.percentile(50),
            "p99_latency_s": c.latency.percentile(99),
            "mean_service_latency_s": (c.service_sum / n if n
                                       else math.nan),
            "mean_queue_delay_s": c.queue_delay.mean,
            "p99_queue_delay_s": c.queue_delay.percentile(99),
            "mean_throughput_qps": c.throughput.mean,
            "steady_throughput_qps": self.steady_throughput,
            "peak_throughput_qps": float(self.peak_throughput),
            "offered_load_qps": c.offered_qps,
            "achieved_load_qps": c.achieved_qps,
            "slo_violations": (self.slo_violations(self.SUMMARY_SLO_LEVEL)
                               if peak_known and n else math.nan),
            "rebalances": self.num_rebalances,
            "serial_frac": self.rebalance_fraction,
            "num_shed": float(c.num_shed),
            "shed_rate": c.shed_rate,
            "goodput_qps": c.goodput_qps,
            "slo_attainment": c.slo_attainment,
            "slo_latency_s": float(self.slo_latency),
            # -- batch occupancy / padding (docs/WORKLOADS.md) --------------
            "mean_batch_occupancy": c.occupancy.mean,
            "p99_batch_occupancy": c.occupancy.percentile(99),
            "padded_token_frac": c.padded_token_frac,
            # -- fault tolerance (docs/FAULTS.md) ----------------------------
            "num_failed": float(c.num_failed),
            "num_retried": float(c.num_retried),
            "num_hedged": float(c.num_hedged),
            "availability": c.availability,
            "wasted_work_frac": c.wasted_work_frac,
            "downtime_s": float(c.downtime),
        }
        if c.tier_stats is not None:
            out.update(self.tier_summary())
        return out

    def tier_summary(self) -> Dict[str, float]:
        """Per-QoS-tier keys (docs/QOS.md), matching the dense
        ``PipelineTrace.tier_summary()`` key set; empty when the run
        had no tiers configured."""
        c = self.collector
        if c.tier_stats is None:
            return {}
        out = {
            "offered_value": sum(t.value_offered for t in c.tier_stats),
            "realized_value": sum(t.value_realized for t in c.tier_stats),
        }
        for t in c.tier_stats:
            offered = t.count + t.shed
            out[f"tier_{t.name}_num"] = float(t.count)
            out[f"tier_{t.name}_shed"] = float(t.shed)
            out[f"tier_{t.name}_p50_latency_s"] = t.latency.percentile(50)
            out[f"tier_{t.name}_p99_latency_s"] = t.latency.percentile(99)
            out[f"tier_{t.name}_deadline_attainment"] = (
                t.met / offered if offered else math.nan)
            if c.track_downgrades:
                out[f"tier_{t.name}_downgraded"] = float(t.downgraded)
        return out

    @classmethod
    def merged(cls, traces: Iterable["StreamingTrace"],
               scheduler: str = "", workload: str = "closed",
               admission: str = "none",
               slo_latency: float = float("inf"),
               peak_throughput: float = float("nan"),
               extra_collector: Optional[StreamingCollector] = None
               ) -> "StreamingTrace":
        """Fold per-replica streaming traces into one fleet trace
        (counter-exact; percentiles within sketch tolerance).
        ``extra_collector`` carries fleet-level-only state — cluster
        sheds that never reached a replica."""
        traces = list(traces)
        coll = StreamingCollector(slo=slo_latency)
        for t in traces:
            coll.absorb(t.collector)
        if extra_collector is not None:
            coll.absorb(extra_collector)
        return cls(
            scheduler=scheduler, workload=workload, collector=coll,
            num_rebalances=sum(t.num_rebalances for t in traces),
            total_trials=sum(t.total_trials for t in traces),
            mitigation_lengths=[m for t in traces
                                for m in t.mitigation_lengths],
            admission=admission, slo_latency=slo_latency,
            peak_throughput=peak_throughput)


@dataclasses.dataclass
class StreamingClusterTrace:
    """Flat-memory counterpart of
    :class:`~repro.cluster.trace.ClusterTrace`: per-replica
    :class:`StreamingTrace` objects plus fleet-level shed/autoscaler
    accounting.  The per-arrival assignment ledger does not exist in
    streaming mode — per-replica shares and the active-replica mean are
    tracked as running counters instead.
    """

    router: str
    workload: str
    scheduler: str
    replicas: List[StreamingTrace]
    #: Offered fleet arrivals (admitted + shed).
    num_queries: int
    admission: str = "none"
    autoscaler: str = "static"
    slo_latency: float = float("inf")
    #: Fleet-level shed accounting (sheds never reach a replica).
    shed_collector: Optional[StreamingCollector] = None
    #: Sum over arrivals of the active-replica count.
    active_sum: float = 0.0

    trace_mode = "streaming"

    # -- shape ---------------------------------------------------------------
    @property
    def num_replicas(self) -> int:
        return len(self.replicas)

    @property
    def num_admitted(self) -> int:
        return sum(t.num_admitted for t in self.replicas)

    @property
    def num_shed(self) -> int:
        return (self.shed_collector.num_shed
                if self.shed_collector is not None else 0)

    @property
    def shed_rate(self) -> float:
        return self.num_shed / self.num_queries if self.num_queries else 0.0

    @property
    def replica_counts(self) -> np.ndarray:
        """Queries served per replica."""
        return np.array([t.num_admitted for t in self.replicas], dtype=int)

    @property
    def mean_active_replicas(self) -> float:
        if not self.num_queries:
            return float(self.num_replicas)
        return self.active_sum / self.num_queries

    # -- fleet metrics --------------------------------------------------------
    @property
    def fleet(self) -> StreamingTrace:
        """The fleet as one StreamingTrace (merged on access, so
        post-run stamping of replica peaks is picked up).

        A heterogeneous fleet has no single interference-free peak, so
        for n > 1 the fleet reference is the served-share-weighted mean
        of the per-replica peaks: the expected peak of the replica a
        uniformly chosen *served* query ran on.  Per-replica SLO
        accounting (:meth:`slo_violations`) still uses each replica's
        own peak exactly."""
        if self.num_replicas == 1:
            peak = self.replicas[0].peak_throughput
        else:
            acc = w = 0.0
            for t in self.replicas:
                if t.num_admitted and math.isfinite(t.peak_throughput):
                    acc += t.num_admitted * t.peak_throughput
                    w += t.num_admitted
            peak = acc / w if w else float("nan")
        return StreamingTrace.merged(
            self.replicas, scheduler=self.scheduler,
            workload=self.workload, admission=self.admission,
            slo_latency=self.slo_latency, peak_throughput=peak,
            extra_collector=self.shed_collector)

    def tail_latency(self, pct: float = 99.0) -> float:
        return self.fleet.tail_latency(pct)

    @property
    def mean_queue_delay(self) -> float:
        return self.fleet.mean_queue_delay

    @property
    def offered_load(self) -> float:
        return self.fleet.offered_load

    @property
    def achieved_load(self) -> float:
        return self.fleet.achieved_load

    def slo_violations(self, slo_level: float) -> float:
        """Admitted-query fraction below ``slo_level`` × *their
        replica's* peak: per-replica sketch CDFs, weighted by served
        share (matches the dense definition within sketch tolerance)."""
        total = self.num_admitted
        if not total:
            return math.nan
        below = 0.0
        for t in self.replicas:
            if not t.num_admitted:
                continue
            below += t.num_admitted * t.collector.throughput.cdf(
                slo_level * t.peak_throughput)
        return below / total

    # -- the one summary dict -------------------------------------------------
    def summary(self) -> Dict[str, float]:
        """Same keys as ``ClusterTrace.summary()``."""
        s = self.fleet.summary()
        peak_known = all(math.isfinite(t.peak_throughput)
                         for t in self.replicas)
        s["slo_violations"] = (
            self.slo_violations(StreamingTrace.SUMMARY_SLO_LEVEL)
            if peak_known else float("nan"))
        s["num_replicas"] = self.num_replicas
        s["router"] = self.router
        counts = self.replica_counts
        s["min_replica_share"] = (float(counts.min())
                                  / max(self.num_admitted, 1))
        s["max_replica_share"] = (float(counts.max())
                                  / max(self.num_admitted, 1))
        s["admission"] = self.admission
        s["autoscaler"] = self.autoscaler
        s["num_shed"] = float(self.num_shed)
        s["shed_rate"] = self.shed_rate
        s["mean_active_replicas"] = self.mean_active_replicas
        return s

    def rows(self) -> List[Dict]:
        """Per-replica + fleet metric rows (same schema as the dense
        ``ClusterTrace.rows()``)."""
        out = []
        for r, t in enumerate(self.replicas):
            row = {"scope": f"replica{r}", "router": self.router,
                   "workload": self.workload, "scheduler": t.scheduler,
                   "queries": int(t.num_admitted)}
            if t.num_admitted:
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
