"""String-keyed scheduler registry.

Every mitigation policy is constructed through ``make_scheduler(name,
**kwargs)`` — the simulator, the live engine, benchmarks and CLI drivers
share one construction path and contain no per-scheduler dispatch.

Registration is a decorator::

    @register_scheduler("my-policy")
    class MyPolicy:
        def detect(self, config, source): ...
        def make_explorer(self, config): ...
        def finish(self, config, source): ...
        def reset(self): ...

Callers pass a superset of keyword arguments (``alpha`` means nothing to
LLS, ``solver`` means nothing to ODIN); ``make_scheduler`` filters them
against the policy's ``__init__`` signature so one call site can build
any registered policy.  *Required* parameters a caller omits still raise
(e.g. ``oracle`` without a ``solver``).

The mechanism itself is :class:`repro_torch.util.Registry`, shared with the
workload-generator registry (``repro_torch.workloads.registry``).

The port's copy of the JAX package's ``schedulers/registry.py``; only import
paths differ.  ``tests/test_torch_control.py`` holds it equal to the
original.
"""
from __future__ import annotations

from typing import Callable, List, Type

from repro_torch.util.registry import Registry

# Importing the policies module runs its @register_scheduler decorators;
# lazy so registry.py itself stays import-cycle-free.
_REGISTRY = Registry("scheduler", builtins_module="repro_torch.schedulers.policies")


def register_scheduler(name: str, **defaults) -> Callable[[Type], Type]:
    """Class decorator registering a SchedulerPolicy under ``name``.

    ``defaults`` are keyword arguments merged (at lower priority) into
    every ``make_scheduler(name, ...)`` call — useful for registering one
    class under several tunings.
    """
    return _REGISTRY.register(name, **defaults)


def unregister_scheduler(name: str) -> None:
    """Remove a registration (tests / plugin reload)."""
    _REGISTRY.unregister(name)


def available_schedulers() -> List[str]:
    """Sorted names of every registered policy."""
    return _REGISTRY.available()


def scheduler_class(name: str) -> Type:
    return _REGISTRY.cls(name)


def make_scheduler(name: str, **kwargs):
    """Construct the policy registered under ``name``.

    Keyword arguments the policy's ``__init__`` does not accept are
    dropped (callers pass one superset for all policies); missing
    *required* arguments still raise ``TypeError``.
    """
    return _REGISTRY.make(name, **kwargs)
