"""Scheduler policies and the rebalance runtime (copies of the JAX
package's ``repro.schedulers`` parts that closed-loop serving uses)."""
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
from repro_torch.schedulers.policies import (  # noqa: F401
    SCHEDULERS,
    LLSPolicy,
    OdinPolicy,
    StaticPolicy,
    make_scheduler,
)
from repro_torch.schedulers.runtime import (  # noqa: F401
    RebalanceRuntime,
    RuntimeStep,
)
