"""Per-replica health tracking: a circuit breaker for the router.

The :class:`~repro_torch.cluster.Cluster` keeps one :class:`HealthTracker`
over its fleet.  Replicas start *closed* (healthy).  ``failure_streak``
consecutive dispatch failures — or a single
:class:`~repro_torch.util.errors.ReplicaUnavailableError` with a known
recovery time — *open* the breaker: routers stop seeing the replica
until the cooldown expires.  The first dispatch after expiry is a
*half-open* probe; its success closes the breaker (and fires the
replica's re-warm hook first, off the timed path), its failure
re-opens it for another cooldown.

Everything is driven by the serving loop's deterministic clock, so
breaker transitions — and therefore routing — are bit-identical across
runs.

The port's copy of the JAX package's ``faults/health.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from __future__ import annotations

from typing import List

_INF = float("inf")

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class HealthTracker:
    """Circuit breaker over ``num_replicas`` replicas.

    ``failure_threshold`` — consecutive failures that open the breaker.
    ``cooldown`` — seconds (serving clock) an open breaker holds before
    allowing a half-open probe.
    """

    def __init__(self, num_replicas: int, failure_threshold: int = 3,
                 cooldown: float = 1.0):
        if num_replicas < 1:
            raise ValueError("need at least one replica")
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if cooldown < 0:
            raise ValueError("cooldown must be >= 0")
        self.failure_threshold = int(failure_threshold)
        self.cooldown = float(cooldown)
        n = int(num_replicas)
        self._state: List[str] = [CLOSED] * n
        self._streak = [0] * n
        self._open_until = [-_INF] * n
        self._down_since = [0.0] * n
        #: set when a replica re-opens for probing: the serving loop
        #: fires ``Replica.on_recover`` (re-warm) before the probe.
        self._needs_rewarm = [False] * n
        self.downtime = [0.0] * n      # accumulated open time per replica

    @property
    def num_replicas(self) -> int:
        return len(self._state)

    def state(self, r: int) -> str:
        return self._state[r]

    def healthy(self, r: int, now: float) -> bool:
        """May replica ``r`` take traffic at ``now``?  Transitions an
        expired open breaker to half-open (probe allowed)."""
        st = self._state[r]
        if st == CLOSED:
            return True
        if st == OPEN:
            if now < self._open_until[r]:
                return False
            self._state[r] = HALF_OPEN
            self._needs_rewarm[r] = True
            return True
        return True                    # half-open: probe in flight

    def ready_at(self, r: int) -> float:
        """Earliest clock at which ``r`` could take a probe (now-ish
        for closed/half-open replicas)."""
        return self._open_until[r] if self._state[r] == OPEN else -_INF

    def take_rewarm(self, r: int) -> bool:
        """True exactly once per open->probe transition: the caller
        should re-warm the replica before its probe dispatch."""
        if self._needs_rewarm[r]:
            self._needs_rewarm[r] = False
            return True
        return False

    def record_success(self, r: int, now: float) -> None:
        if self._state[r] != CLOSED:
            self.downtime[r] += max(0.0, now - self._down_since[r])
        self._state[r] = CLOSED
        self._streak[r] = 0
        self._needs_rewarm[r] = False

    def record_failure(self, r: int, now: float,
                       until: float = float("nan")) -> None:
        """One dispatch failure on ``r`` at ``now``.  ``until`` — a
        known recovery time (crash faults report theirs); the breaker
        holds until ``max(now + cooldown, until)`` when finite."""
        self._streak[r] += 1
        was_up = self._state[r] == CLOSED
        opens = (self._state[r] == HALF_OPEN           # failed probe
                 or self._streak[r] >= self.failure_threshold
                 or until == until)                    # known-down (non-NaN)
        if not opens:
            return
        hold = now + self.cooldown
        if until == until:             # finite recovery time known
            hold = max(hold, until)
        if was_up or self._state[r] == HALF_OPEN:
            if was_up:
                self._down_since[r] = now
            # A failed probe extends the *same* outage: down_since keeps
            # the original open instant.
        self._state[r] = OPEN
        self._open_until[r] = max(self._open_until[r], hold)
        self._needs_rewarm[r] = False

    def finalize(self, now: float) -> List[float]:
        """Close out still-open outages at ``now`` (end of a serving
        window); returns the per-replica downtime list."""
        for r in range(len(self._state)):
            if self._state[r] != CLOSED:
                self.downtime[r] += max(0.0, now - self._down_since[r])
                self._down_since[r] = now
        return self.downtime


__all__ = ["HealthTracker", "CLOSED", "OPEN", "HALF_OPEN"]
