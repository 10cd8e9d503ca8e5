"""Built-in admission policies: none, queue_cap, slo_shed, value_shed,
adaptive_batch.

All decisions are pure functions of the :class:`AdmissionView` and the
policy's own (deterministic) state, so a run is reproducible from
``(workload, seed, scheduler, admission)`` alone.

* ``none`` — admit everything; declared ``admits_all`` so the run loop
  skips the admission checks entirely and closed-loop traces stay
  bit-identical to a run with no control plane at all.
* ``queue_cap`` — classic bounded-queue shedding: shed when the
  predicted backlog (in queries) has reached ``cap``.  The blunt
  baseline every serving system ships first.
* ``slo_shed`` — SLO-aware shedding (InferLine-style): shed when the
  predicted queueing delay plus the runtime's estimated end-to-end
  service latency would already breach the latency objective.  A query
  that cannot meet its SLO only delays the ones behind it.
* ``value_shed`` — expected-value shedding over QoS tiers
  (docs/QOS.md): admit iff ``value x predicted attainment >= theta``,
  so high-value traffic survives deeper overload than best-effort
  traffic instead of everyone shedding at the same queue depth.
* ``adaptive_batch`` — never sheds; instead shrinks the run loop's
  batch/chunk bound as the observed p99 queueing delay approaches the
  SLO and grows it back while the tail is comfortable (batching
  amortizes dispatch overhead but adds head-of-line wait under load).

Closed loops never shed under ``queue_cap`` / ``slo_shed``: the
predicted wait is zero by construction, so every decision reduces to
"is one service beat within the objective" — true for any feasible SLO
(tests/test_control.py pins the bit-identity with ``none``).

The port's copy of the JAX package's ``control/policies.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from __future__ import annotations

import math
from collections import deque

import numpy as np

from repro_torch.control.base import AdmissionView
from repro_torch.control.registry import register_admission


@register_admission("none")
class AdmitAll:
    """Admit every arrival (the default; control plane disabled)."""

    admits_all = True

    def admit(self, view: AdmissionView) -> bool:
        return True

    def reset(self) -> None:
        pass


@register_admission("queue_cap")
class QueueCapAdmission:
    """Shed when the predicted backlog reaches ``cap`` queries.

    The backlog is estimated as predicted wait / estimated service
    beat (:attr:`AdmissionView.queue_length`), so the same decision is
    computable in the scalar tick and in the vectorized ledger's
    chunk admission pre-pass.  While the beat is still unknown (live
    engine before its first measurement) everything is admitted.
    """

    admits_all = False

    def __init__(self, cap: int = 64):
        if cap < 1:
            raise ValueError(f"queue_cap needs cap >= 1, got {cap}")
        self.cap = int(cap)

    def admit(self, view: AdmissionView) -> bool:
        return view.queue_length < self.cap

    def reset(self) -> None:
        pass


@register_admission("slo_shed")
class SloShedAdmission:
    """Shed when the predicted latency would breach the SLO.

    Admits iff ``wait + margin * est_latency <= slo``: the query's
    predicted queueing delay plus (a safety multiple of) the estimated
    end-to-end service latency must fit inside the latency objective.
    ``margin > 1`` sheds earlier, buying headroom against estimate
    noise on the live engine (measured times jitter query to query);
    it is a multiple of the service estimate, so the knob is
    model-independent.

    With exact estimates (the simulator's steady chunks) every
    admitted query's latency is ``<= slo`` by construction, which is
    what the control-smoke CI gate pins: p99-of-admitted meets the SLO
    under an overload where ``none`` blows through it.
    """

    admits_all = False

    def __init__(self, slo: float, margin: float = 1.0):
        if not slo > 0.0:
            raise ValueError(f"slo_shed needs slo > 0, got {slo}")
        if margin < 0.0:
            raise ValueError(f"margin must be >= 0, got {margin}")
        self.slo = float(slo)
        self.margin = float(margin)

    def admit(self, view: AdmissionView) -> bool:
        est = view.est_latency
        if not math.isfinite(est):
            est = view.est_service
        if not math.isfinite(est):
            est = 0.0
        return view.wait + self.margin * est <= self.slo

    def reset(self) -> None:
        pass


@register_admission("value_shed")
class ValueShedAdmission:
    """Shed by *expected value*, not binary feasibility (docs/QOS.md).

    Estimates the probability the arrival would still meet its
    deadline if admitted now, as a linear ramp in the predicted wait:
    attainment is 1 while ``wait + est_latency <= deadline``, 0 once
    the wait alone has consumed the deadline, and
    ``(deadline - wait) / est_latency`` in between.  The query is
    admitted iff ``value x attainment >= theta``.

    Against tier-blind ``slo_shed`` the difference is exactly the
    QoS premise: a value-10 query is still worth serving at a 10%
    attainment estimate (expected value 1.0 >= theta), while a
    value-1 best-effort query sheds as soon as its odds dip below
    ``theta`` — under overload the cheap traffic clears the queue for
    the valuable traffic instead of starving it blindly.

    Queries without a deadline (``view.deadline`` infinite) fall back
    to the constructor ``slo`` if one is given, else their attainment
    estimate is 1 and they are admitted whenever ``value >= theta``.
    Pure function of the view, so the chunked admission pre-pass and
    the scalar tick decide identically.
    """

    admits_all = False

    def __init__(self, theta: float = 0.5, slo: float = 0.0):
        if not theta > 0.0:
            raise ValueError(f"value_shed needs theta > 0, got {theta}")
        if slo < 0.0:
            raise ValueError(f"slo must be >= 0, got {slo}")
        self.theta = float(theta)
        self.slo = float(slo)

    def expected_value(self, view: AdmissionView) -> float:
        """``value x estimated attainment`` for this arrival."""
        deadline = view.deadline
        if not math.isfinite(deadline) and self.slo > 0.0:
            deadline = self.slo
        if not math.isfinite(deadline):
            return view.value
        est = view.est_latency
        if not math.isfinite(est):
            est = view.est_service
        if not math.isfinite(est) or est <= 0.0:
            attain = 1.0 if view.wait <= deadline else 0.0
        else:
            attain = min(1.0, max(0.0, (deadline - view.wait) / est))
        return view.value * attain

    def admit(self, view: AdmissionView) -> bool:
        return self.expected_value(view) >= self.theta

    def reset(self) -> None:
        pass


@register_admission("adaptive_batch")
class AdaptiveBatchAdmission:
    """SLO-aware ``max_batch`` control: admit everything, steer batching.

    Maintains a rolling window of observed queueing delays; every
    ``interval`` observations the window's p99 is compared against the
    SLO: above ``high * slo`` the batch bound halves (head-of-line
    wait inside big batches is eating the budget), below ``low * slo``
    it doubles (amortization is free).  The bound always stays within
    ``[min_batch, max_batch]`` (property-tested across bursty seeds).

    The run loop also reports each query's dispatch *occupancy* (how
    many queries rode its batch — the formed-dispatch paths fill this
    in; scalar paths report 1).  Occupancy is batch-awareness for the
    widen branch: when the rolling mean shows dispatches saturating the
    current bound while the SLO has headroom, the bound provably binds
    and re-opens at double speed (x4 per interval instead of x2).
    Shrink decisions are occupancy-blind — overload must collapse the
    bound whether or not batches were forming.

    Declared ``admits_all``: the run loop skips shed checks and only
    consults :meth:`max_chunk_bound` / :meth:`observe`, so closed-loop
    results stay bit-identical (closed loops have zero queue delay and
    the bound is a pure computational cap for the simulator's chunks).
    """

    admits_all = True

    def __init__(
        self,
        slo: float,
        min_batch: int = 1,
        max_batch: int = 32,
        window: int = 64,
        interval: int = 16,
        low: float = 0.5,
        high: float = 0.9,
    ):
        if not slo > 0.0:
            raise ValueError(f"adaptive_batch needs slo > 0, got {slo}")
        if not 1 <= min_batch <= max_batch:
            raise ValueError(
                f"need 1 <= min_batch <= max_batch, got "
                f"[{min_batch}, {max_batch}]"
            )
        if not 0.0 <= low < high:
            raise ValueError(f"need 0 <= low < high, got [{low}, {high}]")
        self.slo = float(slo)
        self.min_batch = int(min_batch)
        self.max_batch = int(max_batch)
        self.window = max(1, int(window))
        self.interval = max(1, int(interval))
        self.low = float(low)
        self.high = float(high)
        self._delays: deque = deque(maxlen=self.window)
        self._occ: deque = deque(maxlen=self.window)
        self._since_update = 0
        self._bound = self.max_batch

    def admit(self, view: AdmissionView) -> bool:
        return True

    def max_chunk_bound(self) -> int:
        """Current batch/chunk bound, in ``[min_batch, max_batch]``."""
        return self._bound

    def observe(self, queue_delay: float, service_latency: float,
                occupancy: float = 1.0) -> None:
        self._delays.append(queue_delay)
        self._occ.append(occupancy)
        self._since_update += 1
        if self._since_update < self.interval:
            return
        self._since_update = 0
        p99 = float(np.percentile(np.asarray(self._delays), 99))
        if p99 > self.high * self.slo:
            self._bound = max(self.min_batch, self._bound // 2)
        elif p99 < self.low * self.slo:
            occ = float(np.mean(np.asarray(self._occ)))
            step = 4 if occ >= 0.75 * self._bound else 2
            self._bound = min(self.max_batch, self._bound * step)

    def reset(self) -> None:
        self._delays.clear()
        self._occ.clear()
        self._since_update = 0
        self._bound = self.max_batch
