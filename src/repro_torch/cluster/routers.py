"""Built-in routers: round_robin, least_outstanding, odin_aware, edf,
downgrade.

All three are deterministic (ties break toward the lowest replica
index) so per-replica assignment sequences are reproducible from
``(workload, seed, router)`` — see ``tests/test_cluster.py``.

Routers return a *position* into the views they were handed, not a
fleet replica index: with an :class:`~repro_torch.control.Autoscaler` active
the views cover only the active subset of the fleet (docs/CONTROL.md),
and the cluster maps the position back through ``views[pos].index``.
Without an autoscaler the views span the whole fleet in index order,
so position and index coincide.

* ``round_robin`` — classic stateful cycle; the fleet baseline every
  serving system starts from.  Blind to replica state, so a degraded
  replica keeps receiving its 1/N share.
* ``least_outstanding`` — cluster-level least-loaded scheduling (the
  LLS idea one level up): dispatch to the replica with the fewest
  in-system queries.  Reactive — it only diverts once the degraded
  replica has visibly queued up.
* ``odin_aware`` — interference-aware routing (Strait's thesis applied
  to ODIN's signals): cost each replica by the wait + service a query
  dispatched now would see, inflating replicas whose
  :class:`~repro_torch.schedulers.base.InterferenceDetector` currently
  reports an active bottleneck shift and replicas mid-exploration
  (serial trials drain the pipeline).  Proactive — it diverts the
  moment a detector fires, before a backlog forms.
* ``edf`` — ``odin_aware`` plus an earliest-deadline-first / value-
  density term (docs/QOS.md): a replica whose projected completion
  misses the arrival's deadline pays its value-weighted lateness, so
  high-value near-deadline traffic jumps to the replica that can
  still make it.  Tier-blind arrivals fall through to plain
  ``odin_aware``.
* ``downgrade`` — heterogeneous-fleet QoS routing (docs/QOS.md):
  best-effort traffic routes to the ``"small"`` replica pool when the
  full-model pool is under pressure, instead of shedding; higher
  tiers keep the full-model pool.  Falls through to ``odin_aware``
  within whichever pool is chosen.

The port's copy of the JAX package's ``cluster/routers.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from __future__ import annotations

import math
from typing import Sequence

from repro_torch.cluster.base import ReplicaView
from repro_torch.cluster.registry import register_router


@register_router("round_robin")
class RoundRobinRouter:
    """Cycle through replicas in index order."""

    def __init__(self):
        self._next = 0

    def route(self, q: int, now: float,
              views: Sequence[ReplicaView]) -> int:
        r = self._next % len(views)
        self._next = r + 1
        return r

    def reset(self) -> None:
        self._next = 0


@register_router("least_outstanding")
class LeastOutstandingRouter:
    """Fewest in-system queries wins (cluster-level LLS)."""

    def route(self, q: int, now: float,
              views: Sequence[ReplicaView]) -> int:
        best = 0
        for p in range(1, len(views)):
            if views[p].outstanding < views[best].outstanding:
                best = p
        return best

    def reset(self) -> None:
        pass


@register_router("odin_aware")
class OdinAwareRouter:
    """Route by expected completion, penalizing detected interference.

    Per replica the cost is ``backlog + est_bottleneck`` — the
    admission-head wait a query dispatched now would see plus one
    service beat on the committed configuration (both from the
    estimates ODIN's runtime already maintains; an interfered replica's
    estimated beat is inflated by the interference itself, so the base
    cost alone already steers away from degraded replicas).  Two
    multiplicative penalties sharpen "route away":

    * a replica whose detector currently sees a positive bottleneck
      shift pays ``1 + interference_weight * shift`` — continuous in
      the shift (measured-time jitter of a few percent perturbs the
      cost a few percent instead of toggling a hard avoid/admit cliff),
      yet decisive for real interference, where the shift is large;
    * a replica mid-exploration pays ``explore_penalty`` — its queries
      run serially on a drained pipeline until the phase commits.

    **Freshness gating**: a replica's detector/exploration state only
    advances while it serves queries, so both penalties apply only when
    the signal is fresh (the replica served within the last
    ``freshness_window`` fleet queries).  Without the gate a noisy
    measurement on the live engine starves the replica: penalized →
    never routed to → state never refreshed → penalized forever, and
    the fleet collapses onto its neighbours.  The (stale) estimated
    beat still carries the degradation signal after the gate closes.

    ``probe_interval > 0`` additionally routes a query to any replica
    idle that long, refreshing its estimates (how a recovered replica
    re-enters rotation at light load, at the price of occasionally
    sampling a still-degraded one).  Default off: the stale-estimate
    cost ordering re-admits replicas as soon as the fleet backlog
    exceeds their last-known beat.

    Replicas with no estimate yet (live engine before its first
    measurement) cost only their backlog, so cold replicas are seeded
    in index order rather than starved.
    """

    def __init__(self, interference_weight: float = 4.0,
                 explore_penalty: float = 2.0,
                 freshness_window: int = 8,
                 probe_interval: int = 0):
        self.interference_weight = float(interference_weight)
        self.explore_penalty = float(explore_penalty)
        self.freshness_window = int(freshness_window)
        self.probe_interval = int(probe_interval)

    def route(self, q: int, now: float,
              views: Sequence[ReplicaView]) -> int:
        if self.probe_interval > 0:
            stalest = max(range(len(views)),
                          key=lambda p: (views[p].since_assign,
                                         -views[p].index))
            if views[stalest].since_assign > self.probe_interval:
                return stalest
        best, best_cost = 0, self._cost(views[0])
        for p in range(1, len(views)):
            c = self._cost(views[p])
            if c < best_cost:
                best, best_cost = p, c
        return best

    def _cost(self, v: ReplicaView) -> float:
        service = v.est_bottleneck
        if not math.isfinite(service):
            service = 0.0
        cost = v.backlog + service
        if v.since_assign <= self.freshness_window:
            cost *= 1.0 + self.interference_weight * v.interference_score
            if v.exploring:
                cost *= self.explore_penalty
        return cost

    def reset(self) -> None:
        pass


@register_router("edf")
class EdfRouter(OdinAwareRouter):
    """``odin_aware`` + an EDF / value-density lateness term.

    For a tiered arrival (``request`` carries its absolute deadline
    and SLO value, docs/QOS.md) each replica's cost grows by
    ``value_weight x value x max(0, eta - deadline)`` where ``eta``
    is the projected completion on that replica (now + backlog + one
    estimated service latency).  Replicas that can still make the
    deadline pay nothing extra — the interference-aware base cost
    decides between them exactly as ``odin_aware`` would — while a
    high-value query facing lateness is pushed hard toward whichever
    replica minimizes its value-weighted tardiness (earliest-deadline-
    first pressure, expressed as routing cost rather than queue
    reordering, so group-synchronous dispatch semantics are
    untouched).  Arrivals without a finite deadline — and runs with no
    tiers configured at all — fall through to plain ``odin_aware``.
    """

    def __init__(self, value_weight: float = 1.0, **kwargs):
        super().__init__(**kwargs)
        if value_weight < 0:
            raise ValueError(f"value_weight must be >= 0, "
                             f"got {value_weight}")
        self.value_weight = float(value_weight)

    def route(self, q: int, now: float, views: Sequence[ReplicaView],
              request=None) -> int:
        if request is None or not math.isfinite(request.deadline):
            return super().route(q, now, views)
        best, best_cost = 0, self._edf_cost(views[0], now, request)
        for p in range(1, len(views)):
            c = self._edf_cost(views[p], now, request)
            if c < best_cost:
                best, best_cost = p, c
        return best

    def _edf_cost(self, v: ReplicaView, now: float, request) -> float:
        est = v.est_latency
        if not math.isfinite(est):
            est = v.est_bottleneck
        if not math.isfinite(est):
            est = 0.0
        eta = now + v.backlog + est
        lateness = max(0.0, eta - request.deadline)
        return (self._cost(v)
                + self.value_weight * request.value * lateness)


@register_router("downgrade")
class DowngradeRouter(OdinAwareRouter):
    """Best-effort traffic downgrades to small-model replicas under
    pressure instead of shedding (docs/QOS.md).

    The fleet partitions into pools by :attr:`ReplicaView.pool`:
    ``"small"`` replicas serve a cheaper model (heterogeneous fleets);
    everything else is the full-model pool.  Arrivals with priority
    above ``priority_max`` always route within the full-model pool
    (when one is in the view set).  An arrival at or below
    ``priority_max`` routes to the small pool when the full-model
    pool's cheapest backlog exceeds ``pressure`` (time units) — the
    answer quality degrades, the deadline survives, and the full
    models keep their headroom for the traffic that values it.  Each
    downgrade is counted per tier in :attr:`downgrade_counts`, which
    the cluster folds into the run's per-tier accounting.

    Within the chosen pool the decision is plain ``odin_aware`` cost;
    untier-ed runs (``request`` always ``None``) never downgrade.
    """

    def __init__(self, pressure: float = 0.0, priority_max: int = 0,
                 **kwargs):
        super().__init__(**kwargs)
        if pressure < 0:
            raise ValueError(f"pressure must be >= 0, got {pressure}")
        self.pressure = float(pressure)
        self.priority_max = int(priority_max)
        self.downgrade_counts: dict = {}

    def route(self, q: int, now: float, views: Sequence[ReplicaView],
              request=None) -> int:
        small = [p for p in range(len(views))
                 if views[p].pool == "small"]
        full = [p for p in range(len(views))
                if views[p].pool != "small"]
        if request is not None and small and full:
            if request.priority > self.priority_max:
                return self._cheapest(views, full)
            if min(views[p].backlog for p in full) > self.pressure:
                pos = self._cheapest(views, small)
                self.downgrade_counts[request.tier] = (
                    self.downgrade_counts.get(request.tier, 0) + 1)
                return pos
        pool = full or list(range(len(views)))
        return self._cheapest(views, pool)

    def _cheapest(self, views: Sequence[ReplicaView],
                  positions: Sequence[int]) -> int:
        best = positions[0]
        best_cost = self._cost(views[best])
        for p in positions[1:]:
            c = self._cost(views[p])
            if c < best_cost:
                best, best_cost = p, c
        return best

    def reset(self) -> None:
        self.downgrade_counts = {}
