"""Built-in autoscalers: static, load_profile.

* ``static`` — the fleet you built is the fleet you run: all replicas
  (or a fixed prefix) stay active for the whole window.  The default,
  and bit-identical to pre-control-plane cluster runs.
* ``load_profile`` — sizes the active set off the rolling offered load
  (the same offered-vs-achieved signal ``ClusterTrace.load_profile``
  reports post-hoc, measured online): the estimated arrival rate times
  the estimated per-query service beat, divided by a target
  utilization, is the number of replicas the fleet needs.  Backlog
  growth (offered outrunning achieved) forces a scale-out even when
  the rate estimate lags a burst, and — Strait's argument —
  a replica whose detector currently reports interference is treated
  as lost capacity: the autoscaler scales *out* around it (and prefers
  draining it) instead of letting the router keep feeding it.

Autoscalers are deterministic: same views, same state, same answer —
cluster runs stay reproducible from
``(workload, seed, scheduler, router, autoscaler)`` alone.

The port's copy of the JAX package's ``control/autoscalers.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from __future__ import annotations

import math
from collections import deque
from typing import List, Optional, Sequence

from repro_torch.control.registry import register_autoscaler


@register_autoscaler("static")
class StaticAutoscaler:
    """All replicas (or the first ``n_active``) active, always."""

    def __init__(self, n_active: Optional[int] = None):
        if n_active is not None and n_active < 1:
            raise ValueError(f"n_active must be >= 1, got {n_active}")
        self.n_active = n_active

    def active(self, q: int, now: float, views) -> Sequence[int]:
        n = len(views)
        k = n if self.n_active is None else min(self.n_active, n)
        return range(k)

    def reset(self) -> None:
        pass


@register_autoscaler("load_profile")
class LoadProfileAutoscaler:
    """Activate/drain replicas off the rolling offered-load profile.

    Per fleet arrival (recomputed every ``interval`` arrivals):

    1. *Offered rate* — arrivals in the rolling ``window`` divided by
       their time span.
    2. *Demand* — ``ceil(rate * beat / target_util)`` replicas, with
       ``beat`` the median estimated service beat across replicas
       (each replica's ``RebalanceRuntime.estimated_bottleneck()``).
    3. *Achieved pressure* — if the mean in-system backlog per active
       replica exceeds ``backlog_per_replica``, offered load has been
       outrunning achieved throughput regardless of what the rate
       estimate says: demand at least one more replica.  The default
       (16) sits above the in-system depth an SLO-shedding admission
       policy steadily allows, so the pressure valve only fires on
       genuinely runaway queues.
    4. *Interference* — while the fleet is at (or beyond) its demand,
       every active replica whose detector currently reports
       interference (and whose signal is fresh, i.e. it served within
       ``freshness_window`` fleet arrivals) adds one to the demand:
       scale out around degraded capacity instead of routing into it.
       When over-provisioned the bump is skipped — the membership
       ranking below drains the interfered replica instead.

    The demand is clamped to ``[min_active, num_replicas]`` and the
    membership is chosen deterministically — currently-active,
    non-interfered replicas first (stability), then clean inactive
    ones (scale-out targets), then interfered ones last (drain
    preference) — so drained replicas simply stop receiving new work
    and finish what they have.

    Closed-loop runs have no exogenous arrival clock; the measured
    "offered" rate then equals the fleet's own service rate, so the
    autoscaler converges on keeping every replica active (i.e. it
    degenerates to ``static``, which tests pin).
    """

    def __init__(
        self,
        window: int = 64,
        interval: int = 16,
        target_util: float = 0.75,
        min_active: int = 1,
        backlog_per_replica: float = 16.0,
        freshness_window: int = 8,
    ):
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        if interval < 1:
            raise ValueError(f"interval must be >= 1, got {interval}")
        if not 0.0 < target_util <= 1.0:
            raise ValueError(f"target_util must be in (0, 1], got {target_util}")
        if min_active < 1:
            raise ValueError(f"min_active must be >= 1, got {min_active}")
        self.window = int(window)
        self.interval = int(interval)
        self.target_util = float(target_util)
        self.min_active = int(min_active)
        self.backlog_per_replica = float(backlog_per_replica)
        self.freshness_window = int(freshness_window)
        self._arrivals: deque = deque(maxlen=self.window)
        self._active: Optional[List[int]] = None
        self._since_update = 0

    def active(self, q: int, now: float, views) -> Sequence[int]:
        n = len(views)
        if self._active is None:
            self._active = list(range(n))
        self._arrivals.append(now)
        self._since_update += 1
        if self._since_update < self.interval:
            return self._active
        self._since_update = 0

        demand = self._demand(views)
        if demand is None:
            return self._active
        demand = max(self.min_active, min(demand, n))
        active_set = set(self._active)

        def rank(v):
            interfered = (
                v.since_assign <= self.freshness_window
                and v.interference_active
            )
            return (interfered, v.index not in active_set, v.index)

        chosen = sorted(sorted(views, key=rank)[:demand], key=lambda v: v.index)
        self._active = [v.index for v in chosen]
        return self._active

    def _demand(self, views) -> Optional[int]:
        """Replicas the current load profile needs; None = no signal."""
        if len(self._arrivals) < 2:
            return None
        span = self._arrivals[-1] - self._arrivals[0]
        if span <= 0.0:
            return None
        rate = (len(self._arrivals) - 1) / span
        beats = sorted(
            v.est_bottleneck
            for v in views
            if math.isfinite(v.est_bottleneck) and v.est_bottleneck > 0
        )
        if not beats:
            return None
        beat = beats[len(beats) // 2]
        demand = math.ceil(rate * beat / self.target_util)

        active_views = [v for v in views if v.index in set(self._active)]
        backlog = sum(v.outstanding for v in active_views)
        if backlog > self.backlog_per_replica * len(active_views):
            demand = max(demand, len(active_views) + 1)
        # Scale *out* around interfered capacity only while the load
        # actually needs it; when over-provisioned the right move is
        # draining the interfered replica (the membership ranking
        # already prefers that), not keeping spares active.
        if demand >= len(active_views):
            demand += sum(
                1
                for v in active_views
                if v.since_assign <= self.freshness_window and v.interference_active
            )
        return demand

    def reset(self) -> None:
        self._arrivals.clear()
        self._active = None
        self._since_update = 0
