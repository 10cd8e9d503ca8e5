"""MetricsSink: the periodic snapshot hook for live observability.

A sink receives metric snapshots *during* a run — the operator-facing
signal dense traces cannot provide.  ``PipelineRunner``,
``ServingEngine.serve``, and the cluster backends accept
``metrics_sink=`` and call :meth:`MetricsSink.emit` roughly every
``sink_interval`` served queries (plus once at run end), passing the
current :meth:`MetricsRegistry.snapshot` dict.

Emission cadence is measured in *queries*, not wall time, so runs stay
deterministic: the same workload and seed produce the same sequence of
snapshots.

Built-ins cover the common cases; anything with an
``emit(snapshot: dict) -> None`` method satisfies the protocol
(structural typing — no subclassing required).

The port's copy of the JAX package's ``telemetry/sink.py``; only import paths
differ.  ``tests/test_torch_workloads.py`` holds it equal to
the original.
"""

from __future__ import annotations

import json
import sys
from typing import Callable, Dict, List, Optional, Protocol, runtime_checkable


@runtime_checkable
class MetricsSink(Protocol):
    """Anything that can receive periodic metric snapshots."""

    def emit(self, snapshot: Dict[str, object]) -> None:
        """Receive one snapshot.  Must not mutate it."""
        ...


class MemorySink:
    """Collects snapshots in a list — tests and notebook plotting."""

    def __init__(self):
        self.snapshots: List[Dict[str, object]] = []

    def emit(self, snapshot: Dict[str, object]) -> None:
        self.snapshots.append(snapshot)

    def __len__(self) -> int:
        return len(self.snapshots)

    @property
    def last(self) -> Optional[Dict[str, object]]:
        return self.snapshots[-1] if self.snapshots else None


class CallbackSink:
    """Adapts a plain callable into a sink."""

    def __init__(self, fn: Callable[[Dict[str, object]], None]):
        self._fn = fn

    def emit(self, snapshot: Dict[str, object]) -> None:
        self._fn(snapshot)


class ThresholdRule:
    """One alerting rule evaluated against every snapshot.

    ``metric`` names a snapshot entry (full registry name); for Summary
    metrics, ``quantile`` selects a quantile subkey (e.g. ``"0.99"``).
    ``above=True`` fires when the value exceeds ``threshold``; with
    ``above=False`` the comparison flips.  ``clear`` is the hysteresis
    bound the value must re-cross before the rule can fire again —
    defaulting to ``threshold`` itself (no hysteresis band).  A rule
    with ``clear`` strictly inside the firing region raises: it could
    never reset.
    """

    def __init__(self, metric: str, threshold: float,
                 quantile: Optional[str] = None, above: bool = True,
                 clear: Optional[float] = None):
        self.metric = metric
        self.quantile = quantile
        self.threshold = float(threshold)
        self.above = bool(above)
        self.clear = self.threshold if clear is None else float(clear)
        if (self.clear > self.threshold) == self.above and \
                self.clear != self.threshold:
            side = "above" if self.above else "below"
            raise ValueError(
                f"rule on {metric!r}: clear={self.clear:g} is {side} "
                f"threshold={self.threshold:g} — the rule would fire "
                "and never reset")
        self.firing = False

    @property
    def key(self) -> str:
        return (self.metric if self.quantile is None
                else f"{self.metric}{{q={self.quantile}}}")

    def extract(self, snapshot: Dict[str, object]):
        val = snapshot.get(self.metric)
        if isinstance(val, dict):
            if self.quantile is None:
                return None
            val = val.get("quantiles", {}).get(self.quantile)
        elif self.quantile is not None:
            return None
        if val is None:
            return None
        val = float(val)
        return None if val != val else val      # NaN -> no signal

    def breached(self, value: float) -> bool:
        return value > self.threshold if self.above \
            else value < self.threshold

    def cleared(self, value: float) -> bool:
        return value <= self.clear if self.above else value >= self.clear


class ThresholdSink:
    """Fires callbacks when metrics cross thresholds — with hysteresis.

    Wraps the snapshot stream in edge-triggered alerting: each
    :class:`ThresholdRule` fires its callback once when the watched
    value enters the breach region, then stays silent until the value
    re-crosses the rule's ``clear`` bound (hysteresis — a value
    oscillating around the threshold produces one incident, not one
    per snapshot).  Every firing is appended to :attr:`incidents` as
    ``{"rule", "metric", "value", "threshold", "snapshot_index"}``, so
    headless runs (benchmarks, soak tests) can assert on alert history
    without a callback at all.

    >>> sink = ThresholdSink()
    >>> sink.add_rule("repro_latency_seconds", 0.5, quantile="0.99",
    ...               clear=0.4, callback=page_operator)
    >>> # ... run with metrics_sink=sink ...
    >>> len(sink.incidents)
    """

    def __init__(self, on_incident: Optional[Callable] = None):
        self.rules: List[ThresholdRule] = []
        self._callbacks: List[Optional[Callable]] = []
        self._on_incident = on_incident
        self.incidents: List[Dict[str, object]] = []
        self._seen = 0

    def add_rule(self, metric: str, threshold: float,
                 quantile: Optional[str] = None, above: bool = True,
                 clear: Optional[float] = None,
                 callback: Optional[Callable] = None) -> ThresholdRule:
        rule = ThresholdRule(metric, threshold, quantile=quantile,
                             above=above, clear=clear)
        self.rules.append(rule)
        self._callbacks.append(callback)
        return rule

    def emit(self, snapshot: Dict[str, object]) -> None:
        idx = self._seen
        self._seen += 1
        for rule, cb in zip(self.rules, self._callbacks):
            value = rule.extract(snapshot)
            if value is None:
                continue
            if rule.firing:
                if rule.cleared(value):
                    rule.firing = False
                continue
            if rule.breached(value):
                rule.firing = True
                incident = {"rule": rule.key, "metric": rule.metric,
                            "value": value,
                            "threshold": rule.threshold,
                            "snapshot_index": idx}
                self.incidents.append(incident)
                if cb is not None:
                    cb(incident)
                if self._on_incident is not None:
                    self._on_incident(incident)


class JsonLinesSink:
    """Appends one JSON object per snapshot to a stream or file.

    >>> sink = JsonLinesSink("metrics.jsonl")   # or JsonLinesSink()
    >>> # ... run with metrics_sink=sink ...
    >>> sink.close()
    """

    def __init__(self, path_or_stream=None):
        if path_or_stream is None:
            self._stream = sys.stdout
            self._owns = False
        elif hasattr(path_or_stream, "write"):
            self._stream = path_or_stream
            self._owns = False
        else:
            self._stream = open(path_or_stream, "a")
            self._owns = True

    def emit(self, snapshot: Dict[str, object]) -> None:
        self._stream.write(json.dumps(snapshot) + "\n")
        self._stream.flush()

    def close(self) -> None:
        if self._owns:
            self._stream.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
