"""Interference-event schedule + the per-query event advancer.

The simulator injects interference as :class:`InterferenceEvent`\\ s — a
scenario lands on one EP at a query index and lasts for a number of
queries (paper §4.2: one event every ``freq_period`` queries, lasting
``duration``).  With the paper's high-pressure settings (e.g. ``freq=2,
dur=100``) many events overlap on the same EP at once; an EP can only be
in *one* scenario, so the advancer must pick.

The old loop resolved overlaps by dict-overwrite order — whichever event
happened to come last in the list silently won.  :class:`EventTimeline`
makes the rule explicit and deterministic: **the highest-severity
scenario wins** (co-located stressors don't cancel each other; the
worst one dominates the EP).  Severity defaults to the scenario index
and can be supplied from the database's measured slowdowns
(:meth:`~repro_torch.core.database.LayerDatabase.scenario_severities`); exact
severity ties break toward the higher scenario index.

Two event axes (both served by the same timeline):

* **query-indexed** (default) — ``start`` / ``duration`` count queries,
  the paper's §4.2 methodology and the natural axis for closed-loop
  runs, where query index *is* the clock.
* **time-indexed** (``EventTimeline(..., time_indexed=True)``) —
  ``start`` / ``duration`` are wall-clock times in the driver's time
  unit, and ``scenarios_at`` / ``next_change`` take a *time*, not a
  query index.  Open-loop runs advance the environment by each query's
  arrival time, so an event means "the stressor ran from t0 for Δt"
  regardless of how many queries happened to land inside — which is
  what lets replica-scoped events in a cluster hit one replica on the
  shared fleet clock (docs/CLUSTER.md).

Replica scoping: ``InterferenceEvent.replica`` targets one replica of a
:class:`~repro_torch.cluster.Cluster` (``None`` — the default — applies to
every replica, and is what single-pipeline runs use).  The
:func:`events_for_replica` helper selects one replica's view of a
fleet-level event list.

The port's copy of the JAX package's ``core/events.py``; only import paths
differ.  ``tests/test_torch_simulator.py`` holds it equal to the original.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, List, Optional, Sequence, Union

import numpy as np


@dataclasses.dataclass
class InterferenceEvent:
    #: Query index at which the event begins — or a wall-clock time when
    #: the owning timeline is ``time_indexed``.
    start: float
    #: Length in queries (or in time units when ``time_indexed``).
    duration: float
    ep: int
    scenario: int   # column in the database (>= 1)
    #: Cluster replica this event targets; ``None`` = every replica
    #: (and is the only sensible value for single-pipeline runs).
    replica: Optional[int] = None
    #: Interference class: ``"ep"`` (the default — a compute stressor
    #: landing on one EP, the paper's model) or ``"mesh"`` — contention
    #: on the *collectives* of a sharded run (docs/SHARDING.md): while
    #: active, every stage's collective time is inflated by ``factor``.
    #: Mesh events ignore ``ep``/``scenario`` (use 0 for both).
    kind: str = "ep"
    #: Collective-time inflation while a ``kind="mesh"`` event is
    #: active (>= 1.0); ignored for ``kind="ep"`` events.
    factor: float = 2.0

    @property
    def end(self) -> float:
        return self.start + self.duration


def events_for_replica(events: Sequence[InterferenceEvent],
                       replica: int) -> List[InterferenceEvent]:
    """One replica's view of a fleet event list: events targeting it
    plus fleet-wide (``replica=None``) events."""
    return [ev for ev in events
            if ev.replica is None or ev.replica == replica]


def generate_events(num_queries: int, num_eps: int, num_scenarios: int,
                    freq_period: int, duration: int,
                    seed: int = 0) -> List[InterferenceEvent]:
    """One event every ``freq_period`` queries on a random EP/scenario."""
    rng = np.random.default_rng(seed)
    events = []
    for start in range(freq_period, num_queries, freq_period):
        events.append(InterferenceEvent(
            start=start, duration=duration,
            ep=int(rng.integers(num_eps)),
            scenario=int(rng.integers(1, num_scenarios + 1))))
    return events


SeveritySpec = Union[None, Sequence[float], Callable[[int], float]]


class EventTimeline:
    """Per-query scenario advancer with a deterministic overlap rule.

    ``severity`` ranks scenarios when several events cover one EP at the
    same query: ``None`` ranks by scenario index, a sequence is indexed
    ``severity[scenario - 1]`` (scenario 0 is always "clean"), a
    callable is ``severity(scenario)``.  The winner is the max of
    ``(severity, scenario)`` — the tuple's second element makes exact
    severity ties deterministic.

    ``time_indexed=True`` reinterprets every event's ``start`` /
    ``duration`` as wall-clock values: ``scenarios_at`` and
    ``next_change`` then take a time (the driver passes each query's
    arrival time) instead of a query index, and ``next_change`` returns
    ``float('inf')`` past the last edge.
    """

    def __init__(self, events: Sequence[InterferenceEvent], num_eps: int,
                 severity: SeveritySpec = None,
                 time_indexed: bool = False):
        self.events = list(events)
        self.num_eps = num_eps
        self.time_indexed = bool(time_indexed)
        if severity is None:
            self._rank = lambda scenario: float(scenario)
        elif callable(severity):
            self._rank = severity
        else:
            table = np.asarray(severity, dtype=float)
            self._rank = lambda scenario: float(table[scenario - 1])
        # Sorted distinct event edges: the per-EP scenario vector is
        # piecewise-constant between consecutive edges, which is what
        # lets the run loop chunk environment-steady query ranges.
        # (Computed once; mutate ``events`` via a new EventTimeline.)
        self._edges = sorted({b for ev in self.events
                              for b in (ev.start, ev.end)})

    def next_change(self, q: float) -> float:
        """First query index (or time, when ``time_indexed``) ``> q``
        where the scenario vector can change (an event starts or ends);
        a large sentinel (``inf`` on the time axis) when no further edge
        exists.  ``scenarios_at`` is constant over
        ``[q, next_change(q))``."""
        i = bisect.bisect_right(self._edges, q)
        if i < len(self._edges):
            return self._edges[i]
        if self.time_indexed:
            return float("inf")
        return int(np.iinfo(np.int64).max)

    def scenarios_at(self, q: float) -> List[int]:
        """Per-EP scenario vector at query index — or time, when
        ``time_indexed`` — ``q`` (0 = no interference)."""
        best: List[Optional[tuple]] = [None] * self.num_eps
        for ev in self.events:
            if ev.kind == "ep" and ev.start <= q < ev.end:
                key = (self._rank(ev.scenario), ev.scenario)
                if best[ev.ep] is None or key > best[ev.ep][0]:
                    best[ev.ep] = (key, ev.scenario)
        return [0 if b is None else b[1] for b in best]

    def coll_factor_at(self, q: float) -> float:
        """Collective-time inflation at ``q``: the max ``factor`` over
        the active ``kind="mesh"`` events (worst stressor dominates,
        the same overlap rule ``scenarios_at`` uses), 1.0 when none is
        active.  Mesh-event edges participate in :meth:`next_change`,
        so chunked runs never span a factor change."""
        factor = 1.0
        for ev in self.events:
            if ev.kind == "mesh" and ev.start <= q < ev.end:
                factor = max(factor, float(ev.factor))
        return factor
