"""QoS tiers: priorities, per-request deadlines, SLO value (docs/QOS.md).

The port's copy of the JAX package's ``qos/__init__.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from repro_torch.qos.tiers import (
    FixedDeadlines,
    QosRequest,
    QosTier,
    TierAssigner,
    TierPlan,
    UniformDeadlines,
    available_deadlines,
    available_tiers,
    get_tier,
    make_deadlines,
    register_deadlines,
    register_tier,
    resolve_tiers,
    unregister_tier,
)

__all__ = [
    "FixedDeadlines",
    "QosRequest",
    "QosTier",
    "TierAssigner",
    "TierPlan",
    "UniformDeadlines",
    "available_deadlines",
    "available_tiers",
    "get_tier",
    "make_deadlines",
    "register_deadlines",
    "register_tier",
    "resolve_tiers",
    "unregister_tier",
]
