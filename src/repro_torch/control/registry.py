"""String-keyed registries for admission policies and autoscalers.

Mirrors ``repro_torch.schedulers`` / ``repro_torch.workloads`` / ``repro_torch.cluster``:
implementations register under a name, callers construct by name with
one superset of keyword arguments filtered against each class's
``__init__`` (``cap`` means nothing to ``slo_shed``).

The port's copy of the JAX package's ``control/registry.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Type, Union

from repro_torch.util.registry import Registry

# Importing the builtins modules runs their @register_* decorators;
# lazy so registry.py itself stays import-cycle-free.
_ADMISSION = Registry("admission policy", builtins_module="repro_torch.control.policies")
_AUTOSCALER = Registry("autoscaler", builtins_module="repro_torch.control.autoscalers")


def register_admission(name: str, **defaults) -> Callable[[Type], Type]:
    """Class decorator registering an AdmissionPolicy under ``name``."""
    return _ADMISSION.register(name, **defaults)


def unregister_admission(name: str) -> None:
    """Remove a registration (tests / plugin reload)."""
    _ADMISSION.unregister(name)


def available_admission_policies() -> List[str]:
    """Sorted names of every registered admission policy."""
    return _ADMISSION.available()


def admission_class(name: str) -> Type:
    return _ADMISSION.cls(name)


def make_admission(name: str, **kwargs):
    """Construct the admission policy registered under ``name``."""
    return _ADMISSION.make(name, **kwargs)


def resolve_admission(
    admission: Union[str, object, None], admission_kwargs: Optional[dict] = None
):
    """Name (+ kwargs) or instance -> AdmissionPolicy instance.

    ``None`` resolves to ``None`` (control plane disabled) — distinct
    from the registered ``"none"`` policy only in that no policy object
    is threaded through the run loop at all.
    """
    if admission is None:
        if admission_kwargs:
            raise ValueError("admission_kwargs given but no admission policy selected")
        return None
    if isinstance(admission, str):
        return make_admission(admission, **(admission_kwargs or {}))
    if admission_kwargs:
        raise ValueError(
            "admission_kwargs only apply to an admission-policy name, "
            "not an already-constructed instance"
        )
    return admission


def register_autoscaler(name: str, **defaults) -> Callable[[Type], Type]:
    """Class decorator registering an Autoscaler under ``name``."""
    return _AUTOSCALER.register(name, **defaults)


def unregister_autoscaler(name: str) -> None:
    """Remove a registration (tests / plugin reload)."""
    _AUTOSCALER.unregister(name)


def available_autoscalers() -> List[str]:
    """Sorted names of every registered autoscaler."""
    return _AUTOSCALER.available()


def autoscaler_class(name: str) -> Type:
    return _AUTOSCALER.cls(name)


def make_autoscaler(name: str, **kwargs):
    """Construct the autoscaler registered under ``name``."""
    return _AUTOSCALER.make(name, **kwargs)


def resolve_autoscaler(
    autoscaler: Union[str, object, None], autoscaler_kwargs: Optional[dict] = None
):
    """Name (+ kwargs) or instance -> Autoscaler instance."""
    if autoscaler is None:
        autoscaler = "static"
    if isinstance(autoscaler, str):
        return make_autoscaler(autoscaler, **(autoscaler_kwargs or {}))
    if autoscaler_kwargs:
        raise ValueError(
            "autoscaler_kwargs only apply to an autoscaler name, "
            "not an already-constructed instance"
        )
    return autoscaler
