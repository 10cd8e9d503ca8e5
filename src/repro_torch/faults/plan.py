"""Deterministic fault plans: what breaks, where, and when.

A :class:`FaultPlan` generalizes the interference timeline
(:mod:`repro_torch.core.events`) into a *fault* timeline.  Interference is a
soft fault — a stage slows down and the scheduler rebalances around it;
a fault plan adds the hard kinds a production fleet sees:

``crash``
    The replica is down for the whole window (its recovery delay *is*
    the window duration); dispatches raise
    :class:`~repro_torch.util.errors.ReplicaUnavailableError` and the replica
    restarts cold at the window end (see ``Replica.on_recover`` /
    ``warm_buckets`` for the re-warm hook).
``hang``
    Dispatches starting inside the window stall for ``stall`` seconds
    of extra occupancy.  With a per-dispatch timeout configured
    (:class:`~repro_torch.faults.RetrySpec`), a stall exceeding the timeout
    raises :class:`~repro_torch.util.errors.DispatchTimeoutError` instead and
    the timeout is charged as wasted work.
``slowdown``
    Multiplicative stage-time inflation (``factor``) beyond the
    interference model — service latency scales up, throughput down.
``flaky``
    Each execution attempt inside the window raises
    :class:`~repro_torch.util.errors.TransientQueryError` with probability
    ``p``, drawn deterministically from ``(seed, replica, query,
    attempt)`` so retries re-draw but reruns are bit-identical.

Windows are half-open ``[start, start + duration)`` on the same clock
axis the interference timeline uses: the query index by default, or
the arrival wall-clock when ``time_indexed=True`` (docs/CLUSTER.md).
Like :func:`~repro_torch.core.events.events_for_replica`, ``replica=None``
hits every replica and :meth:`FaultPlan.for_replica` selects one
replica's slice of a fleet plan.

The port's copy of the JAX package's ``faults/plan.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

FAULT_KINDS = ("crash", "hang", "slowdown", "flaky")


@dataclass(frozen=True)
class FaultEvent:
    """One fault window.  ``start``/``duration`` are on the plan's
    clock axis; ``replica=None`` applies to every replica."""
    kind: str
    start: float
    duration: float
    replica: Optional[int] = None
    factor: float = 2.0        # slowdown: stage-time multiplier
    p: float = 0.5             # flaky: per-attempt failure probability
    stall: float = 0.0         # hang: extra seconds per dispatch

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.duration <= 0:
            raise ValueError(f"fault duration must be > 0, "
                             f"got {self.duration}")
        if self.kind == "slowdown" and self.factor <= 0:
            raise ValueError("slowdown factor must be > 0")
        if self.kind == "flaky" and not 0.0 <= self.p <= 1.0:
            raise ValueError("flaky probability must be in [0, 1]")
        if self.kind == "hang" and self.stall < 0:
            raise ValueError("hang stall must be >= 0")

    @property
    def end(self) -> float:
        return self.start + self.duration

    def active_at(self, clock: float) -> bool:
        return self.start <= clock < self.end


@dataclass
class FaultPlan:
    """A seeded, deterministic set of fault windows.

    ``time_indexed`` selects the clock axis (arrival seconds vs. query
    index), mirroring :class:`~repro_torch.core.events.EventTimeline`.
    """
    events: List[FaultEvent] = field(default_factory=list)
    seed: int = 0
    time_indexed: bool = False

    def __post_init__(self):
        self.events = sorted(self.events, key=lambda e: (e.start, e.end))

    def __bool__(self) -> bool:
        return bool(self.events)

    def for_replica(self, replica: int) -> "FaultPlan":
        """The slice of this plan one replica experiences (fleet-wide
        events with ``replica=None`` included)."""
        return FaultPlan(events=[e for e in self.events
                                 if e.replica is None
                                 or e.replica == replica],
                         seed=self.seed, time_indexed=self.time_indexed)

    def downtime_until(self, clock_end: float) -> float:
        """Total crash downtime accumulated by ``clock_end`` (clipped
        window overlap, in the plan's clock units)."""
        total = 0.0
        for e in self.events:
            if e.kind == "crash":
                total += max(0.0, min(e.end, clock_end) - e.start)
        return total


def parse_fault_spec(spec: str, seed: int = 0,
                     time_indexed: bool = False) -> FaultPlan:
    """Parse a compact CLI fault spec into a :class:`FaultPlan`.

    Grammar (comma-separated windows)::

        kind@start+duration[:key=value...]

    with keys ``r`` (replica), ``f`` (slowdown factor), ``p`` (flaky
    probability), ``s`` (hang stall seconds).  Examples::

        crash@200+100:r=0
        flaky@0+1000:p=0.05,slowdown@300+50:f=2.5
        hang@400+20:s=0.5:r=1
    """
    events = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        head = fields[0]
        try:
            kind, when = head.split("@")
            start_s, dur_s = when.split("+")
            ev = dict(kind=kind.strip(), start=float(start_s),
                      duration=float(dur_s))
        except ValueError:
            raise ValueError(
                f"bad fault window {part!r}; expected "
                "'kind@start+duration[:key=value...]'") from None
        for kv in fields[1:]:
            try:
                k, v = kv.split("=")
            except ValueError:
                raise ValueError(f"bad fault option {kv!r} in {part!r}; "
                                 "expected 'key=value'") from None
            k = k.strip()
            if k == "r":
                ev["replica"] = int(v)
            elif k == "f":
                ev["factor"] = float(v)
            elif k == "p":
                ev["p"] = float(v)
            elif k == "s":
                ev["stall"] = float(v)
            else:
                raise ValueError(f"unknown fault option {k!r} in {part!r}; "
                                 "expected r/f/p/s")
        events.append(FaultEvent(**ev))
    return FaultPlan(events=events, seed=seed, time_indexed=time_indexed)


def periodic_crashes(horizon: float, period: float, duration: float,
                     num_replicas: int = 1, start: Optional[float] = None,
                     seed: int = 0,
                     time_indexed: bool = False) -> FaultPlan:
    """Replica-churn plan: every ``period`` clock units one replica
    (rotating round-robin) crashes for ``duration``.  The soak
    scenario's churn generator — fully deterministic."""
    events = []
    t = period if start is None else start
    r = 0
    while t < horizon:
        events.append(FaultEvent("crash", start=t, duration=duration,
                                 replica=r % num_replicas))
        r += 1
        t += period
    return FaultPlan(events=events, seed=seed, time_indexed=time_indexed)


def resolve_faults(faults, seed: int = 0,
                   time_indexed: bool = False) -> Optional[FaultPlan]:
    """None / spec string / event list / FaultPlan -> FaultPlan."""
    if faults is None:
        return None
    if isinstance(faults, FaultPlan):
        return faults
    if isinstance(faults, str):
        return parse_fault_spec(faults, seed=seed, time_indexed=time_indexed)
    if isinstance(faults, (list, tuple)):
        events = []
        for e in faults:
            if isinstance(e, FaultEvent):
                events.append(e)
            elif isinstance(e, str):
                events.extend(parse_fault_spec(e).events)
            else:
                events.append(FaultEvent(*e))
        return FaultPlan(events=events, seed=seed,
                         time_indexed=time_indexed)
    raise TypeError(f"cannot resolve a fault plan from "
                    f"{type(faults).__name__}")


__all__ = ["FAULT_KINDS", "FaultEvent", "FaultPlan", "parse_fault_spec",
           "periodic_crashes", "resolve_faults"]
