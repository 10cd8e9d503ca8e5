"""repro_torch.telemetry: streaming observability (docs/TELEMETRY.md).

Constant-memory online metrics for 10M+-query runs: mergeable quantile
sketches (:class:`QuantileSketch`), windowed rollups
(:class:`WindowedRollup`), a Prometheus/JSON metrics registry
(:class:`MetricsRegistry`), periodic snapshot sinks
(:class:`MetricsSink` and friends), and the ``trace_mode="streaming"``
result types (:class:`StreamingTrace`, :class:`StreamingClusterTrace`)
that expose the dense ``summary()`` surface at flat memory.

This package imports nothing from the rest of ``repro``: the run loops
depend on telemetry, never the reverse.

The port's copy of the JAX package's ``telemetry/__init__.py``; only import paths
differ.  ``tests/test_torch_workloads.py`` holds it equal to
the original.
"""

from repro_torch.telemetry.metrics import (
    SUMMARY_QUANTILES,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Summary,
    export_path_format,
    render_export,
)
from repro_torch.telemetry.rollup import DEFAULT_MAX_WINDOWS, WindowedRollup
from repro_torch.telemetry.sink import (
    CallbackSink,
    JsonLinesSink,
    MemorySink,
    MetricsSink,
    ThresholdRule,
    ThresholdSink,
)
from repro_torch.telemetry.sketch import (
    DEFAULT_BUFFER,
    DEFAULT_COMPRESSION,
    QuantileSketch,
)
from repro_torch.telemetry.streaming import (
    DEFAULT_SINK_INTERVAL,
    StreamingClusterTrace,
    StreamingCollector,
    StreamingTrace,
)

__all__ = [
    "QuantileSketch",
    "DEFAULT_COMPRESSION",
    "DEFAULT_BUFFER",
    "WindowedRollup",
    "DEFAULT_MAX_WINDOWS",
    "Counter",
    "Gauge",
    "Histogram",
    "Summary",
    "MetricsRegistry",
    "SUMMARY_QUANTILES",
    "render_export",
    "export_path_format",
    "MetricsSink",
    "MemorySink",
    "CallbackSink",
    "JsonLinesSink",
    "ThresholdRule",
    "ThresholdSink",
    "StreamingCollector",
    "StreamingTrace",
    "StreamingClusterTrace",
    "DEFAULT_SINK_INTERVAL",
]
