"""Constant-memory metric primitives and the registry/exporter layer.

Four metric kinds, mirroring the Prometheus data model:

* :class:`Counter` — monotone float count (queries served, shed, ...).
* :class:`Gauge` — last-written value (queue depth, active replicas).
* :class:`Summary` — a :class:`~repro_torch.telemetry.sketch.QuantileSketch`
  exposed with Prometheus summary semantics (quantile series plus
  ``_sum`` / ``_count``).
* :class:`Histogram` — fixed-bucket counts with cumulative
  ``_bucket{le=...}`` exposition; aggregates across hosts by plain
  addition, no sketch merge required.

:class:`MetricsRegistry` is the get-or-create namespace for them, with
two exposition formats:

* :meth:`MetricsRegistry.prometheus` — the Prometheus text exposition
  format (``# HELP`` / ``# TYPE`` headers, ``quantile=`` labels), ready
  to serve from a ``/metrics`` endpoint or write to a ``.prom`` file.
* :meth:`MetricsRegistry.snapshot` / :meth:`MetricsRegistry.to_json` —
  a plain-dict / JSON form for programmatic consumers and the
  :class:`~repro_torch.telemetry.sink.MetricsSink` hook.

Registries merge (:meth:`MetricsRegistry.merge`) by summing counters,
taking the last gauge write, and folding summary sketches — so
per-replica registries roll up into fleet registries losslessly for
counters and within sketch tolerance for quantiles.

The port's copy of the JAX package's ``telemetry/metrics.py``; only import paths
differ.  ``tests/test_torch_workloads.py`` holds it equal to
the original.
"""

from __future__ import annotations

import json
import math
import re
from typing import Dict, Optional, Tuple

import numpy as np

from .sketch import QuantileSketch

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")

#: Quantiles a Summary exposes in snapshots and Prometheus text.
SUMMARY_QUANTILES = (0.5, 0.9, 0.99)


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "help", "_value")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Last-written instantaneous value."""

    __slots__ = ("name", "help", "_value")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self._value = math.nan

    def set(self, value: float) -> None:
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self._value = (0.0 if math.isnan(self._value)
                       else self._value) + amount

    @property
    def value(self) -> float:
        return self._value


class Summary:
    """Quantile sketch with Prometheus summary exposition."""

    __slots__ = ("name", "help", "sketch")
    kind = "summary"

    def __init__(self, name: str, help: str = "",
                 sketch: Optional[QuantileSketch] = None):
        self.name = _check_name(name)
        self.help = help
        self.sketch = sketch if sketch is not None else QuantileSketch()

    def observe(self, values) -> None:
        self.sketch.add(values)

    def quantile(self, q: float) -> float:
        return self.sketch.quantile(q)

    @property
    def count(self) -> int:
        return self.sketch.n

    @property
    def sum(self) -> float:
        return self.sketch.sum


class Histogram:
    """Fixed-bucket counts with Prometheus histogram exposition.

    Unlike a :class:`Summary` (whose t-digest sketch needs the custom
    merge in this package), fixed buckets aggregate across hosts with
    plain addition — any Prometheus-compatible backend can sum the
    ``_bucket`` series.  ``buckets`` are the finite upper bounds; the
    implicit ``+Inf`` bucket is always present.  Exposition is
    cumulative (``{le="x"}``), per the Prometheus data model.
    """

    __slots__ = ("name", "help", "buckets", "_counts", "_sum")
    kind = "histogram"

    #: Default latency-style buckets (seconds), roughly log-spaced.
    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                       1.0, 2.5, 5.0, 10.0)

    def __init__(self, name: str, help: str = "", buckets=None):
        self.name = _check_name(name)
        self.help = help
        b = tuple(float(x) for x in
                  (buckets if buckets is not None else self.DEFAULT_BUCKETS))
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError("histogram buckets must be strictly "
                             "increasing and non-empty")
        if any(math.isinf(x) for x in b):
            raise ValueError("the +Inf bucket is implicit; pass finite "
                             "upper bounds only")
        self.buckets = b
        self._counts = [0] * (len(b) + 1)   # last = +Inf overflow
        self._sum = 0.0

    def observe(self, values) -> None:
        """Fold one value or an array of values into the buckets."""
        arr = np.atleast_1d(np.asarray(values, dtype=float))
        if arr.size == 0:
            return
        idx = np.searchsorted(np.asarray(self.buckets), arr, side="left")
        for i, c in zip(*np.unique(idx, return_counts=True)):
            self._counts[int(i)] += int(c)
        self._sum += float(arr.sum())

    @property
    def count(self) -> int:
        return sum(self._counts)

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> Dict[str, int]:
        """``{le: cumulative count}`` including the ``+Inf`` bucket."""
        out: Dict[str, int] = {}
        running = 0
        for le, c in zip(self.buckets, self._counts):
            running += c
            out[f"{le:g}"] = running
        out["+Inf"] = running + self._counts[-1]
        return out

    def merge_from(self, other: "Histogram") -> None:
        if other.buckets != self.buckets:
            raise ValueError(
                f"cannot merge histogram {self.name!r}: bucket bounds "
                f"differ ({self.buckets} vs {other.buckets})")
        for i, c in enumerate(other._counts):
            self._counts[i] += c
        self._sum += other._sum


class MetricsRegistry:
    """Namespace of metrics with get-or-create accessors and export."""

    def __init__(self, namespace: str = ""):
        if namespace:
            _check_name(namespace)
        self.namespace = namespace
        self._metrics: Dict[str, object] = {}

    # -- get-or-create -------------------------------------------------------
    def _get(self, cls, name: str, help: str):
        metric = self._metrics.get(name)
        if metric is None:
            metric = cls(name, help)
            self._metrics[name] = metric
        elif not isinstance(metric, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(metric).__name__}, not {cls.__name__}")
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def summary(self, name: str, help: str = "") -> Summary:
        return self._get(Summary, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=None) -> Histogram:
        metric = self._metrics.get(name)
        if metric is None:
            metric = Histogram(name, help, buckets=buckets)
            self._metrics[name] = metric
        elif not isinstance(metric, Histogram):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(metric).__name__}, not Histogram")
        return metric

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __iter__(self):
        return iter(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    # -- merge ---------------------------------------------------------------
    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        """Fold ``other`` into this registry: counters add, gauges take
        ``other``'s value when set, summaries merge sketches."""
        for metric in other:
            if isinstance(metric, Counter):
                self.counter(metric.name, metric.help).inc(metric.value)
            elif isinstance(metric, Gauge):
                if not math.isnan(metric.value):
                    self.gauge(metric.name, metric.help).set(metric.value)
            elif isinstance(metric, Summary):
                mine = self.summary(metric.name, metric.help)
                mine.sketch.merge(metric.sketch)
            elif isinstance(metric, Histogram):
                self.histogram(metric.name, metric.help,
                               buckets=metric.buckets).merge_from(metric)
        return self

    # -- export --------------------------------------------------------------
    def _full_name(self, name: str) -> str:
        return f"{self.namespace}_{name}" if self.namespace else name

    def snapshot(self) -> Dict[str, object]:
        """Plain-dict form of every metric — the sink payload."""
        out: Dict[str, object] = {}
        for metric in self:
            name = self._full_name(metric.name)
            if isinstance(metric, Summary):
                out[name] = {
                    "count": metric.count,
                    "sum": metric.sum,
                    "quantiles": {f"{q:g}": metric.quantile(q)
                                  for q in SUMMARY_QUANTILES},
                }
            elif isinstance(metric, Histogram):
                out[name] = {
                    "count": metric.count,
                    "sum": metric.sum,
                    "buckets": metric.cumulative(),
                }
            else:
                out[name] = metric.value
        return out

    def to_json(self, **dumps_kwargs) -> str:
        return json.dumps(self.snapshot(), **dumps_kwargs)

    def prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines = []
        for metric in self:
            name = self._full_name(metric.name)
            if metric.help:
                lines.append(f"# HELP {name} {metric.help}")
            lines.append(f"# TYPE {name} {metric.kind}")
            if isinstance(metric, Summary):
                for q in SUMMARY_QUANTILES:
                    lines.append(f'{name}{{quantile="{q:g}"}} '
                                 f"{_fmt(metric.quantile(q))}")
                lines.append(f"{name}_sum {_fmt(metric.sum)}")
                lines.append(f"{name}_count {metric.count}")
            elif isinstance(metric, Histogram):
                for le, c in metric.cumulative().items():
                    lines.append(f'{name}_bucket{{le="{le}"}} {c}')
                lines.append(f"{name}_sum {_fmt(metric.sum)}")
                lines.append(f"{name}_count {metric.count}")
            else:
                lines.append(f"{name} {_fmt(metric.value)}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(value: float) -> str:
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    return repr(float(value))


def render_export(registry: MetricsRegistry, fmt: str) -> str:
    """Render a registry in ``fmt`` ∈ {"prometheus", "json"}."""
    if fmt == "prometheus":
        return registry.prometheus()
    if fmt == "json":
        return registry.to_json(indent=2, sort_keys=True) + "\n"
    raise ValueError(f"unknown export format {fmt!r}")


def export_path_format(path: str) -> Tuple[str, str]:
    """Infer export format from a file extension: ``.prom``/``.txt`` →
    prometheus, anything else → json.  Returns ``(path, fmt)``."""
    lower = path.lower()
    if lower.endswith((".prom", ".txt")):
        return path, "prometheus"
    return path, "json"
