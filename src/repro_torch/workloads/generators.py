"""Built-in arrival processes: closed, poisson, bursty, diurnal, ramp, trace.

All open-loop generators are seeded and deterministic — calling
``inter_arrivals`` twice returns the identical array, so a run can be
reproduced from ``(workload name, kwargs, seed)`` alone.  Rates are in
queries per time unit of the driver (wall-clock seconds for the live
engine, database units for the simulator).

* ``closed`` — today's back-to-back behaviour and the default: each
  query arrives the instant the pipeline frees up; no queueing, results
  bit-compatible with the pre-workloads drivers.
* ``poisson`` — open-loop memoryless arrivals at ``rate`` (the classic
  serving-benchmark process; e.g. Clockwork's SLO evaluations).
* ``bursty`` — a 2-state Markov-modulated Poisson process (MMPP):
  exponentially-distributed ON phases at ``burst_rate`` alternate with
  OFF phases at ``base_rate`` (MArk-style flash crowds).
* ``diurnal`` — inhomogeneous Poisson with a sinusoidal rate (the
  day/night swing production traces show); the traffic to demo a
  cluster router riding load swings (docs/CLUSTER.md).
* ``ramp`` — inhomogeneous Poisson whose rate climbs linearly from
  ``start_rate`` to ``end_rate`` over ``ramp_time`` then holds (load
  tests / launch ramps; finds the latency knee as load approaches
  capacity).
* ``trace`` — replays a recorded inter-arrival array (cycled if the run
  is longer than the trace).

The inhomogeneous generators (``diurnal``, ``ramp``) sample by
*thinning* (Lewis & Shedler): candidates arrive at the envelope rate
``rate_max`` and survive with probability ``rate(t) / rate_max`` —
exact for any bounded rate function, and vectorized in candidate
batches.

The port's copy of the JAX package's ``workloads/generators.py``; only import paths
differ.  ``tests/test_torch_workloads.py`` holds it equal to
the original.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.workloads.registry import register_workload


def _thinned_arrivals(num_queries: int, rate_fn: Callable[[np.ndarray],
                                                          np.ndarray],
                      rate_max: float, rng: np.random.Generator
                      ) -> np.ndarray:
    """Inter-arrival gaps of an inhomogeneous Poisson process.

    ``rate_fn`` maps an array of times to instantaneous rates in
    ``[0, rate_max]``.  Candidates are drawn in batches at ``rate_max``
    and thinned; draws happen in a fixed order, so the output is a
    pure function of the rng seed.
    """
    out = np.empty(num_queries)
    count = 0
    t = 0.0
    batch = max(256, num_queries)
    while count < num_queries:
        gaps = rng.exponential(1.0 / rate_max, size=batch)
        times = t + np.cumsum(gaps)
        keep = rng.random(batch) * rate_max < rate_fn(times)
        accepted = times[keep]
        take = min(len(accepted), num_queries - count)
        out[count:count + take] = accepted[:take]
        count += take
        # Resume after the last *candidate*, accepted or not — unless
        # the run is already full, in which case the tail is unused.
        t = float(times[-1])
    return np.diff(out, prepend=0.0)


@register_workload("closed")
class ClosedLoopWorkload:
    """Closed loop: the next query arrives exactly when the pipeline can
    take it.  This is the paper's §4 methodology (a saturated stream of
    back-to-back queries) and the behaviour of the pre-workloads
    ``simulate()`` / ``ServingEngine.serve()``."""

    open_loop = False

    def inter_arrivals(self, num_queries: int) -> Optional[np.ndarray]:
        return None


@register_workload("poisson")
class PoissonWorkload:
    """Open-loop Poisson arrivals: i.i.d. exponential inter-arrivals."""

    open_loop = True

    def __init__(self, rate: float, seed: int = 0):
        if rate <= 0:
            raise ValueError(f"poisson rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.seed = int(seed)

    def inter_arrivals(self, num_queries: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.exponential(1.0 / self.rate, size=num_queries)


@register_workload("bursty")
class BurstyWorkload:
    """2-state MMPP: Poisson at ``burst_rate`` during exponentially long
    ON phases (mean ``mean_burst``), at ``base_rate`` during OFF phases
    (mean ``mean_gap``).  ``base_rate=0`` gives pure on/off traffic.

    Long-run mean rate = (mean_burst * burst_rate + mean_gap *
    base_rate) / (mean_burst + mean_gap).
    """

    open_loop = True

    def __init__(self, burst_rate: float, base_rate: float = 0.0,
                 mean_burst: float = 1.0, mean_gap: float = 1.0,
                 seed: int = 0):
        if burst_rate <= 0:
            raise ValueError(f"burst_rate must be > 0, got {burst_rate}")
        if base_rate < 0:
            raise ValueError(f"base_rate must be >= 0, got {base_rate}")
        if mean_burst <= 0 or mean_gap <= 0:
            raise ValueError("phase durations must be > 0")
        self.burst_rate = float(burst_rate)
        self.base_rate = float(base_rate)
        self.mean_burst = float(mean_burst)
        self.mean_gap = float(mean_gap)
        self.seed = int(seed)

    def inter_arrivals(self, num_queries: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        arrivals = np.empty(num_queries)
        count = 0
        t = 0.0
        on = True        # start inside a burst so short runs see one
        while count < num_queries:
            mean_len = self.mean_burst if on else self.mean_gap
            rate = self.burst_rate if on else self.base_rate
            phase_end = t + rng.exponential(mean_len)
            if rate > 0:
                while count < num_queries:
                    gap = rng.exponential(1.0 / rate)
                    if t + gap >= phase_end:
                        break
                    t += gap
                    arrivals[count] = t
                    count += 1
            t = phase_end
            on = not on
        return np.diff(arrivals, prepend=0.0)


@register_workload("diurnal")
class DiurnalWorkload:
    """Sinusoidal-rate inhomogeneous Poisson: ``rate(t) = mean_rate *
    (1 + amplitude * sin(2π t / period + phase))``.

    ``amplitude`` in ``[0, 1)`` keeps the rate strictly positive
    (``amplitude=0`` degenerates to plain Poisson); ``period`` is the
    full day/night cycle in the driver's time unit; ``phase`` (radians)
    picks where in the cycle the run starts (default 0 = mid-climb
    toward the peak).
    """

    open_loop = True

    def __init__(self, mean_rate: float, period: float,
                 amplitude: float = 0.5, phase: float = 0.0,
                 seed: int = 0):
        if mean_rate <= 0:
            raise ValueError(f"mean_rate must be > 0, got {mean_rate}")
        if period <= 0:
            raise ValueError(f"period must be > 0, got {period}")
        if not 0.0 <= amplitude < 1.0:
            raise ValueError(f"amplitude must be in [0, 1), "
                             f"got {amplitude}")
        self.mean_rate = float(mean_rate)
        self.period = float(period)
        self.amplitude = float(amplitude)
        self.phase = float(phase)
        self.seed = int(seed)

    def rate_at(self, t):
        """Instantaneous arrival rate at time(s) ``t``."""
        return self.mean_rate * (
            1.0 + self.amplitude * np.sin(
                2.0 * math.pi * np.asarray(t) / self.period + self.phase))

    def inter_arrivals(self, num_queries: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        rate_max = self.mean_rate * (1.0 + self.amplitude)
        return _thinned_arrivals(num_queries, self.rate_at, rate_max, rng)


@register_workload("ramp")
class RampWorkload:
    """Linear-ramp inhomogeneous Poisson: the rate climbs from
    ``start_rate`` to ``end_rate`` over ``ramp_time`` and holds there
    (ramp-down works too — ``end_rate < start_rate``)."""

    open_loop = True

    def __init__(self, start_rate: float, end_rate: float,
                 ramp_time: float, seed: int = 0):
        if start_rate < 0 or end_rate < 0:
            raise ValueError("rates must be >= 0")
        if max(start_rate, end_rate) <= 0:
            raise ValueError("at least one of start_rate/end_rate must "
                             "be > 0")
        if ramp_time <= 0:
            raise ValueError(f"ramp_time must be > 0, got {ramp_time}")
        self.start_rate = float(start_rate)
        self.end_rate = float(end_rate)
        self.ramp_time = float(ramp_time)
        self.seed = int(seed)

    def rate_at(self, t):
        """Instantaneous arrival rate at time(s) ``t``."""
        frac = np.clip(np.asarray(t) / self.ramp_time, 0.0, 1.0)
        return self.start_rate + (self.end_rate - self.start_rate) * frac

    def inter_arrivals(self, num_queries: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        rate_max = max(self.start_rate, self.end_rate)
        return _thinned_arrivals(num_queries, self.rate_at, rate_max, rng)


@register_workload("trace")
class TraceWorkload:
    """Replays a recorded inter-arrival array (e.g. from production
    logs), cycling it when the run outlasts the trace."""

    open_loop = True

    def __init__(self, inter_arrivals: Sequence[float]):
        gaps = np.asarray(inter_arrivals, dtype=float)
        if gaps.ndim != 1 or len(gaps) == 0:
            raise ValueError("inter_arrivals must be a non-empty 1-D array")
        if np.any(gaps < 0):
            raise ValueError("inter_arrivals must be non-negative")
        self.gaps = gaps

    def inter_arrivals(self, num_queries: int) -> np.ndarray:
        reps = -(-num_queries // len(self.gaps))      # ceil division
        return np.tile(self.gaps, reps)[:num_queries]
