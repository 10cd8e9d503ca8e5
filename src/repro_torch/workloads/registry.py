"""String-keyed workload registry (mirrors the JAX package's ``schedulers.registry``).

Workload generators register under a name and are constructed through
``make_workload(name, **kwargs)``; the simulator, the live engine and
benchmark sweeps share one construction path.  Like the scheduler
registry, kwargs are filtered per class (``rate`` means nothing to
``closed``) while missing *required* arguments still raise (``trace``
without ``inter_arrivals``).

The port's copy of the JAX package's ``workloads/registry.py``; only import paths
differ.  ``tests/test_torch_workloads.py`` holds it equal to
the original.
"""
from __future__ import annotations

from typing import Callable, List, Type

from repro_torch.util.registry import Registry

# Importing the generators module runs its @register_workload
# decorators; lazy so registry.py itself stays import-cycle-free.
_REGISTRY = Registry("workload", builtins_module="repro_torch.workloads.generators")


def register_workload(name: str, **defaults) -> Callable[[Type], Type]:
    """Class decorator registering a Workload under ``name``."""
    return _REGISTRY.register(name, **defaults)


def unregister_workload(name: str) -> None:
    """Remove a registration (tests / plugin reload)."""
    _REGISTRY.unregister(name)


def available_workloads() -> List[str]:
    """Sorted names of every registered workload."""
    return _REGISTRY.available()


def workload_class(name: str) -> Type:
    return _REGISTRY.cls(name)


def make_workload(name: str, **kwargs):
    """Construct the workload registered under ``name``."""
    return _REGISTRY.make(name, **kwargs)
