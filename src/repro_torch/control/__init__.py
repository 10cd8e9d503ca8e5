"""SLO control plane: admission control, load shedding, autoscaling.

The fifth pluggable axis (after schedulers, workloads, batching and
routing): an :class:`AdmissionPolicy` decides per arrival whether a
query enters the pipeline at all (``none`` / ``queue_cap`` /
``slo_shed`` / ``adaptive_batch``), and an :class:`Autoscaler` decides
per fleet arrival which cluster replicas are active (``static`` /
``load_profile``).  Both thread through the one run loop — simulator,
live engine and cluster report the identical shed/goodput surface.
See docs/CONTROL.md.

The port's copy of the JAX package's ``control/__init__.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from repro_torch.control.base import (  # noqa: F401
    AdmissionPolicy,
    AdmissionView,
    Autoscaler,
)
from repro_torch.control.autoscalers import (  # noqa: F401
    LoadProfileAutoscaler,
    StaticAutoscaler,
)
from repro_torch.control.policies import (  # noqa: F401
    AdaptiveBatchAdmission,
    AdmitAll,
    QueueCapAdmission,
    SloShedAdmission,
)
from repro_torch.control.registry import (  # noqa: F401
    admission_class,
    autoscaler_class,
    available_admission_policies,
    available_autoscalers,
    make_admission,
    make_autoscaler,
    register_admission,
    register_autoscaler,
    resolve_admission,
    resolve_autoscaler,
    unregister_admission,
    unregister_autoscaler,
)
