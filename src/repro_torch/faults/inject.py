"""Fault injection: wrap any :class:`~repro_torch.workloads.base.QueryExecutor`.

:class:`FaultingExecutor` sits between the event loop and the real
executor (simulator or live engine) and realizes a
:class:`~repro_torch.faults.plan.FaultPlan` deterministically:

* ``crash`` / ``flaky`` / timed-out ``hang`` raise the typed errors
  from :mod:`repro_torch.util.errors` *before* the inner executor runs — the
  runner's retry machinery (or the cluster's) requeues or fails the
  query.
* ``slowdown`` and sub-timeout ``hang`` inflate the inner record's
  service latency / occupancy in place.

Chunk safety: the wrapper's ``steady_horizon`` cuts every chunk at
fault-window edges and forces single-query execution *inside* windows,
so the batch-granular fast path never spans a query whose outcome
differs from the scalar tick — chunked == scalar bit-identity holds
with faults active (gated by ``tests/test_faults.py``).

Formed-dispatch batching (``BatchFormer``) does not compose with fault
injection — a multi-member dispatch has no per-query failure boundary;
``configure_batching`` refuses a former explicitly.

The port's copy of the JAX package's ``faults/inject.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.faults.plan import FaultPlan
from repro_torch.util.errors import (DispatchTimeoutError, ReplicaUnavailableError,
                               TransientQueryError)
from repro_torch.workloads.base import BatchRecord, QueryRecord

#: Domain-separation salt for the flaky draw stream (distinct from the
#: retry-jitter salt in :mod:`repro_torch.faults.retry`).
_FLAKY_SALT = 0x1f1a

_BIG = 2 ** 62   # finite "no fault ahead" horizon (int() safe)


class FaultInjector:
    """One replica's runtime view of a fault plan.

    Stateless apart from the per-query failed-attempt counts that feed
    the flaky draw (cleared on success), so reruns are bit-identical.
    """

    def __init__(self, plan: FaultPlan, replica: int = 0,
                 timeout: Optional[float] = None):
        self.plan = plan
        self.replica = int(replica)
        self.timeout = timeout
        self.events = [e for e in plan.events
                       if e.replica is None or e.replica == self.replica]
        self._attempts = {}

    def _active(self, clock: float) -> List:
        out = []
        for e in self.events:          # sorted by start
            if e.start > clock:
                break
            if clock < e.end:
                out.append(e)
        return out

    def in_window(self, clock: float) -> bool:
        for e in self.events:
            if e.start > clock:
                return False
            if clock < e.end:
                return True
        return False

    def next_start(self, clock: float) -> float:
        for e in self.events:
            if e.start > clock:
                return e.start
        return float("inf")

    def slowdown(self, clock: float) -> float:
        f = 1.0
        for e in self._active(clock):
            if e.kind == "slowdown":
                f *= e.factor
        return f

    def stall(self, clock: float) -> float:
        s = 0.0
        for e in self._active(clock):
            if e.kind == "hang":
                s += e.stall
        return s

    def check(self, q: int, clock: float) -> Optional[TransientQueryError]:
        """The typed failure query ``q`` hits at ``clock``, or None.

        Checked before the inner executor runs; flaky draws consume
        one ``(seed, replica, q, attempt)`` stream entry per *failed*
        attempt so a retry re-draws while a rerun replays."""
        active = self._active(clock)
        p_keep = 1.0
        stall = 0.0
        for e in active:
            if e.kind == "crash":
                until = e.end if self.plan.time_indexed else float("nan")
                return ReplicaUnavailableError(self.replica, until=until)
            if e.kind == "flaky":
                p_keep *= 1.0 - e.p
            elif e.kind == "hang":
                stall += e.stall
        if p_keep < 1.0:
            attempt = self._attempts.get(q, 0)
            u = np.random.default_rng(
                (self.plan.seed, _FLAKY_SALT, self.replica,
                 int(q), attempt)).random()
            if u < 1.0 - p_keep:
                self._attempts[q] = attempt + 1
                return TransientQueryError(
                    f"flaky fault failed query {q} (attempt {attempt})")
        if (self.timeout is not None and stall > self.timeout):
            return DispatchTimeoutError(self.timeout, self.replica)
        return None

    def clear(self, q: int) -> None:
        self._attempts.pop(q, None)

    def spans_fault(self, c0: float, c1: float) -> bool:
        """Any window overlapping the closed clock span ``[c0, c1]``?"""
        for e in self.events:
            if e.start > c1:
                return False
            if c0 < e.end:
                return True
        return False


class FaultingExecutor:
    """Fault-injecting wrapper around a query executor.

    Transparent when the plan is empty; raises/inflates per the plan
    otherwise.  Unknown attributes forward to the inner executor, so
    optional protocol extensions (``reference_throughput``,
    ``max_chunk``, ...) survive wrapping.
    """

    #: duck-typed marker: the runner arms its failure handling when the
    #: executor injects faults even without a RetrySpec (budget 0).
    injects_faults = True

    def __init__(self, inner, plan: FaultPlan, replica: int = 0,
                 timeout: Optional[float] = None):
        self.inner = inner
        self.injector = FaultInjector(plan, replica=replica,
                                      timeout=timeout)
        self._time_indexed = plan.time_indexed
        self._arrivals = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    # -- clock ----------------------------------------------------------------
    def _clock(self, q: int) -> float:
        if not self._time_indexed:
            return float(q)
        if self._arrivals is None:
            raise ValueError(
                "a time-indexed fault plan needs arrival times; "
                "open-loop workloads provide them (set_arrivals)")
        return float(self._arrivals[q])

    def set_arrivals(self, arrivals) -> None:
        self._arrivals = arrivals
        fwd = getattr(self.inner, "set_arrivals", None)
        if callable(fwd):
            fwd(arrivals)

    # -- protocol -------------------------------------------------------------
    @property
    def batch_mode(self):
        mode = getattr(self.inner, "batch_mode", None)
        if mode is None:
            return None
        if not callable(getattr(self.inner, "execute_many", None)):
            return None
        if not callable(getattr(self.inner, "steady_horizon", None)):
            return None
        return mode

    def begin_query(self, q: int):
        return self.inner.begin_query(q)

    def steady_horizon(self, q: int) -> int:
        has = getattr(self.inner, "steady_horizon", None)
        inner_h = int(has(q)) if callable(has) else _BIG
        inj = self.injector
        if not inj.events:
            return inner_h
        clock = self._clock(q)
        if inj.in_window(clock):
            return 1                   # in-window queries run scalar
        ns = inj.next_start(clock)
        if ns == float("inf"):
            return inner_h
        if self._time_indexed:
            # Number of queries arriving strictly before the window.
            idx = int(np.searchsorted(np.asarray(self._arrivals), ns,
                                      side="left"))
            fh = max(1, idx - q)
        else:
            fh = max(1, int(ns) - q)
        return min(inner_h, fh)

    def execute(self, q: int, step) -> QueryRecord:
        inj = self.injector
        clock = self._clock(q)
        err = inj.check(q, clock)
        if err is not None:
            raise err
        rec = self.inner.execute(q, step)
        f = inj.slowdown(clock)
        stall = inj.stall(clock)
        if f != 1.0 or stall != 0.0:
            sl = rec.service_latency * f + stall
            thr = rec.throughput
            if thr > 0.0:
                thr = 1.0 / (f / thr + stall)
            rec = QueryRecord(service_latency=sl, throughput=thr)
        inj.clear(q)
        return rec

    def execute_many(self, q0: int, steps) -> BatchRecord:
        n = len(steps)
        inj = self.injector
        if inj.events:
            c0, c1 = self._clock(q0), self._clock(q0 + n - 1)
            if inj.spans_fault(c0, c1):
                if n > 1:
                    raise RuntimeError(
                        "fault window inside a chunk; steady_horizon "
                        "should have cut here")
                rec = self.execute(q0, steps[0])
                return BatchRecord(
                    service_latencies=np.asarray([rec.service_latency]),
                    throughputs=np.asarray([rec.throughput]))
        return self.inner.execute_many(q0, steps)

    def configure_batching(self, former, lengths, padded) -> None:
        if former is not None:
            raise NotImplementedError(
                "fault injection does not compose with formed-dispatch "
                "batching (a multi-member dispatch has no per-query "
                "failure boundary); drop faults= or batching=")
        fwd = getattr(self.inner, "configure_batching", None)
        if callable(fwd):
            fwd(former, lengths, padded)

    # -- accounting -----------------------------------------------------------
    def fault_downtime(self, q_end: int, t_end: float) -> float:
        """Crash downtime accumulated by the end of the run, in the
        plan's clock units (queries or seconds)."""
        clock_end = float(t_end) if self._time_indexed else float(q_end)
        total = 0.0
        for e in self.injector.events:   # this replica's events only
            if e.kind == "crash":
                total += max(0.0, min(e.end, clock_end) - e.start)
        return total


__all__ = ["FaultInjector", "FaultingExecutor"]
