"""Fault injection and recovery machinery (docs/FAULTS.md).

The fault model generalizes the interference timeline into hard
failures — ``crash`` / ``hang`` / ``slowdown`` / ``flaky`` — realized
deterministically by :class:`FaultingExecutor` over any query
executor (simulator or live engine).  Recovery lives in the serving
loops: :func:`~repro_torch.workloads.run_pipeline` retries transient
failures under a :class:`RetrySpec` budget; the fleet layer
(:func:`~repro_torch.cluster.run_cluster`) adds health-aware routing via
:class:`HealthTracker` circuit breakers, tail-latency hedging, and
graceful re-warm on recovery.

The port's copy of the JAX package's ``faults/__init__.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from repro_torch.faults.health import HealthTracker  # noqa: F401
from repro_torch.faults.inject import FaultingExecutor, FaultInjector  # noqa: F401
from repro_torch.faults.plan import (  # noqa: F401
    FAULT_KINDS,
    FaultEvent,
    FaultPlan,
    parse_fault_spec,
    periodic_crashes,
    resolve_faults,
)
from repro_torch.faults.retry import RetrySpec, resolve_retries  # noqa: F401

__all__ = [
    "FAULT_KINDS",
    "FaultEvent",
    "FaultPlan",
    "FaultingExecutor",
    "FaultInjector",
    "HealthTracker",
    "RetrySpec",
    "parse_fault_spec",
    "periodic_crashes",
    "resolve_faults",
    "resolve_retries",
]
