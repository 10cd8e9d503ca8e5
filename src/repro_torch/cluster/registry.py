"""String-keyed router registry (mirrors ``schedulers``/``workloads``).

Routers register under a name and are constructed through
``make_router(name, **kwargs)``; kwargs are filtered against each
class's ``__init__`` so one superset of knobs constructs any router
(``interference_weight`` means nothing to ``round_robin``).

The port's copy of the JAX package's ``cluster/registry.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from __future__ import annotations

from typing import Callable, List, Type, Union

from repro_torch.util.registry import Registry

# Importing the routers module runs its @register_router decorators;
# lazy so registry.py itself stays import-cycle-free.
_REGISTRY = Registry("router", builtins_module="repro_torch.cluster.routers")


def register_router(name: str, **defaults) -> Callable[[Type], Type]:
    """Class decorator registering a Router under ``name``."""
    return _REGISTRY.register(name, **defaults)


def unregister_router(name: str) -> None:
    """Remove a registration (tests / plugin reload)."""
    _REGISTRY.unregister(name)


def available_routers() -> List[str]:
    """Sorted names of every registered router."""
    return _REGISTRY.available()


def router_class(name: str) -> Type:
    return _REGISTRY.cls(name)


def make_router(name: str, **kwargs):
    """Construct the router registered under ``name``."""
    return _REGISTRY.make(name, **kwargs)


def resolve_router(router: Union[str, object, None],
                   router_kwargs=None):
    """Name (+ kwargs) or instance -> Router instance."""
    if router is None:
        router = "round_robin"
    if isinstance(router, str):
        return make_router(router, **(router_kwargs or {}))
    if router_kwargs:
        raise ValueError("router_kwargs only apply to a router name, "
                         "not an already-constructed instance")
    return router
