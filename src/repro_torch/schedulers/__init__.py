"""Pluggable scheduler-policy subsystem (see docs/SCHEDULERS.md).

Policies implement :class:`SchedulerPolicy`, are constructed by name via
:func:`make_scheduler`, and are executed by the :class:`RebalanceRuntime`
shared by the simulator and the live serving engine.

The port's copy of the JAX package's ``schedulers/__init__.py``; only import
paths differ.  ``tests/test_torch_control.py`` holds it equal to the
original.
"""
from repro_torch.schedulers.base import (  # noqa: F401
    Explorer,
    InterferenceDetector,
    SchedulerPolicy,
    bottleneck_time,
)
from repro_torch.schedulers.defaults import (  # noqa: F401
    DEFAULT_ALPHA,
    DEFAULT_REL_THRESHOLD,
    MEASURED_DETECTOR_MODE,
    resolve_rel_threshold,
)
from repro_torch.schedulers.registry import (  # noqa: F401
    available_schedulers,
    make_scheduler,
    register_scheduler,
    scheduler_class,
    unregister_scheduler,
)
from repro_torch.schedulers.runtime import (  # noqa: F401
    RebalanceRuntime,
    RuntimeStep,
)
from repro_torch.schedulers.policies import (  # noqa: F401
    HybridExplorer,
    HybridPolicy,
    LLSPolicy,
    OdinPolicy,
    OracleExplorer,
    OraclePolicy,
    StaticPolicy,
)
