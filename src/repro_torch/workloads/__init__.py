"""Traffic workloads + the unified run loop (see docs/WORKLOADS.md).

A :class:`Workload` (arrival process) plus a :class:`QueryExecutor`
(driver-specific query execution) feed :func:`run_pipeline`, the one
traffic-driven event loop shared by the database simulator and the live
JAX serving engine; every run yields the unified :class:`PipelineTrace`
metric surface.

The port's copy of the JAX package's ``workloads/__init__.py``; only import paths
differ.  ``tests/test_torch_workloads.py`` holds it equal to
the original.
"""
from repro_torch.workloads.base import (  # noqa: F401
    BatchRecord,
    DispatchRecord,
    QueryExecutor,
    QueryRecord,
    Workload,
)
from repro_torch.workloads.batching import (  # noqa: F401
    BatchFormer,
    LengthBuckets,
    resolve_batching,
    resolve_buckets,
)
from repro_torch.workloads.generators import (  # noqa: F401
    BurstyWorkload,
    ClosedLoopWorkload,
    DiurnalWorkload,
    PoissonWorkload,
    RampWorkload,
    TraceWorkload,
)
from repro_torch.workloads.lengths import (  # noqa: F401
    available_lengths,
    make_lengths,
    register_lengths,
    resolve_lengths,
    with_lengths,
)
from repro_torch.workloads.registry import (  # noqa: F401
    available_workloads,
    make_workload,
    register_workload,
    unregister_workload,
    workload_class,
)
from repro_torch.workloads.runner import (  # noqa: F401
    DEFAULT_MAX_CHUNK,
    PipelineRunner,
    resolve_workload,
    run_pipeline,
)
from repro_torch.workloads.trace import PipelineTrace  # noqa: F401
