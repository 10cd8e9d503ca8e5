"""Windowed rollups: dense timelines at constant memory.

Dense traces answer "what did load look like over time" by histogramming
the full per-query arrival/completion arrays after the run
(:meth:`repro_torch.workloads.PipelineTrace.load_profile`).  Streaming mode
has no such arrays, so :class:`WindowedRollup` maintains the same
profile online: fixed-width time buckets holding arrival / completion /
shed counts and latency aggregates, with bounded retention.

Retention policies once the run outgrows ``max_windows`` buckets:

* ``"collapse"`` (default) — double the bucket width and pairwise-merge,
  so the rollup always covers the *whole* run in at most ``max_windows``
  buckets at progressively coarser resolution.  This is what
  :meth:`StreamingTrace.load_profile` needs: a full-run profile.
* ``"ring"`` — keep the most recent ``max_windows`` buckets and drop the
  oldest, for live dashboards that only care about the recent past.

All counters are plain float64 arrays of length ``max_windows`` — flat
memory regardless of run length.

The port's copy of the JAX package's ``telemetry/rollup.py``; only import paths
differ.  ``tests/test_torch_workloads.py`` holds it equal to
the original.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

DEFAULT_MAX_WINDOWS = 256


class WindowedRollup:
    """Time-bucketed arrival/completion/latency aggregates.

    Parameters
    ----------
    width:
        Bucket width in driver time units.  ``None`` (default) defers
        the choice to the first observation batch: the width is picked
        so the batch's span fills ~1/8 of the window budget, which lets
        short runs keep fine resolution while long runs start coarse.
    max_windows:
        Retention budget (number of buckets).
    retention:
        ``"collapse"`` or ``"ring"`` (see module docstring).
    """

    __slots__ = ("width", "max_windows", "retention", "start",
                 "arrivals", "completions", "shed",
                 "latency_sum", "latency_max", "_num")

    def __init__(self, width: float = None,
                 max_windows: int = DEFAULT_MAX_WINDOWS,
                 retention: str = "collapse"):
        if max_windows < 2:
            raise ValueError(f"max_windows must be >= 2, got {max_windows}")
        if retention not in ("collapse", "ring"):
            raise ValueError(f"unknown retention {retention!r}")
        if width is not None and width <= 0:
            raise ValueError(f"width must be positive, got {width}")
        self.width = None if width is None else float(width)
        self.max_windows = int(max_windows)
        self.retention = retention
        self.start = 0.0                  # time of bucket 0's left edge
        self.arrivals = np.zeros(max_windows)
        self.completions = np.zeros(max_windows)
        self.shed = np.zeros(max_windows)
        self.latency_sum = np.zeros(max_windows)
        self.latency_max = np.zeros(max_windows)
        self._num = 0                     # occupied buckets

    # -- ingest --------------------------------------------------------------
    def observe_arrivals(self, times: np.ndarray) -> None:
        self._scatter(times, self.arrivals)

    def observe_completions(self, times: np.ndarray,
                            latencies: np.ndarray = None) -> None:
        idx = self._scatter(times, self.completions)
        if latencies is not None and idx is not None:
            lat = np.asarray(latencies, dtype=np.float64)
            np.add.at(self.latency_sum, idx, lat)
            np.maximum.at(self.latency_max, idx, lat)

    def observe_shed(self, times: np.ndarray) -> None:
        self._scatter(times, self.shed)

    def _scatter(self, times, target: np.ndarray):
        times = np.atleast_1d(np.asarray(times, dtype=np.float64))
        if times.size == 0:
            return None
        hi = float(times.max())
        if self.width is None:
            span = max(hi - self.start, 1e-12)
            self.width = span / max(self.max_windows // 8, 1)
        self._cover(hi)
        idx = self._index(times)
        np.add.at(target, idx, 1.0)
        return idx

    def _index(self, times: np.ndarray) -> np.ndarray:
        idx = np.floor((times - self.start) / self.width).astype(np.int64)
        # Ring mode can be asked about times older than its horizon;
        # clamp them into the oldest retained bucket rather than raise.
        return np.clip(idx, 0, self.max_windows - 1)

    def _cover(self, t: float) -> None:
        """Grow retention until time ``t`` lands inside the window set."""
        needed = int(np.floor((t - self.start) / self.width)) + 1
        while needed > self.max_windows:
            if self.retention == "collapse":
                self._collapse()
            else:
                self._shift(needed - self.max_windows)
            needed = int(np.floor((t - self.start) / self.width)) + 1
        self._num = max(self._num, needed)

    def _collapse(self) -> None:
        """Double bucket width; pairwise-merge so coverage doubles."""
        half = self.max_windows // 2
        for arr in (self.arrivals, self.completions, self.shed,
                    self.latency_sum):
            arr[:half] = arr[0::2] + arr[1::2]
            arr[half:] = 0.0
        lm = self.latency_max
        lm[:half] = np.maximum(lm[0::2], lm[1::2])
        lm[half:] = 0.0
        self.width *= 2.0
        self._num = (self._num + 1) // 2

    def _shift(self, k: int) -> None:
        """Ring retention: drop the ``k`` oldest buckets."""
        k = min(k, self.max_windows)
        for arr in (self.arrivals, self.completions, self.shed,
                    self.latency_sum, self.latency_max):
            arr[:-k] = arr[k:]
            arr[-k:] = 0.0
        self.start += k * self.width
        self._num = max(self._num - k, 0)

    # -- merge ---------------------------------------------------------------
    def merge(self, other: "WindowedRollup") -> "WindowedRollup":
        """Fold ``other``'s buckets into this rollup.

        Buckets are rebinned by midpoint when widths differ — an
        approximation consistent with the rollup's own resolution
        (counts are conserved exactly; placement error is bounded by
        one bucket width).
        """
        if other.width is None or other._num == 0:
            return self
        if self.width is None:
            self.width = other.width
            self.start = other.start
        mids = (other.start
                + (np.arange(other.max_windows) + 0.5) * other.width)
        occupied = (other.arrivals + other.completions + other.shed) > 0
        mids = mids[occupied]
        if mids.size == 0:
            return self
        self._cover(float(mids.max()))
        idx = self._index(mids)
        np.add.at(self.arrivals, idx, other.arrivals[occupied])
        np.add.at(self.completions, idx, other.completions[occupied])
        np.add.at(self.shed, idx, other.shed[occupied])
        np.add.at(self.latency_sum, idx, other.latency_sum[occupied])
        np.maximum.at(self.latency_max, idx, other.latency_max[occupied])
        return self

    # -- reads ---------------------------------------------------------------
    @property
    def num_windows(self) -> int:
        """Occupied bucket count."""
        return self._num

    def edges(self) -> np.ndarray:
        """Left edges of the occupied buckets."""
        w = self.width if self.width is not None else 1.0
        return self.start + np.arange(self._num) * w

    def rates(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(window_starts, offered_qps, achieved_qps)`` over occupied
        buckets — the streaming analogue of
        :meth:`PipelineTrace.load_profile` (offered counts shed
        arrivals, matching the dense definition)."""
        n = self._num
        if n == 0 or self.width is None:
            z = np.empty(0)
            return z, z.copy(), z.copy()
        offered = (self.arrivals[:n] + self.shed[:n]) / self.width
        achieved = self.completions[:n] / self.width
        return self.edges(), offered, achieved

    def __repr__(self) -> str:
        return (f"WindowedRollup(windows={self._num}/{self.max_windows}, "
                f"width={self.width}, retention={self.retention!r})")
