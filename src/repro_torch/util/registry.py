"""Generic string-keyed class registry.

One mechanism backs every pluggable family in the repo (scheduler
policies, workload generators): classes register under a name via a
decorator, callers construct by name with one superset of keyword
arguments which is filtered against each class's ``__init__`` signature.
The JAX package's ``schedulers.registry`` and
``repro_torch.workloads.registry`` are thin domain wrappers around this
class.

The port's copy of the JAX package's ``util/registry.py``; only import paths
differ.  ``tests/test_torch_workloads.py`` holds it equal to
the original.
"""
from __future__ import annotations

import importlib
import inspect
from typing import Callable, Dict, List, Optional, Tuple, Type


class Registry:
    """Name -> (class, default kwargs) registry for one plugin family.

    ``kind`` names the family in error messages ("scheduler",
    "workload").  ``builtins_module`` is imported lazily on first use so
    the module holding the ``@register`` decorators can itself import
    the registry without a cycle.
    """

    def __init__(self, kind: str, builtins_module: Optional[str] = None):
        self.kind = kind
        self._builtins_module = builtins_module
        self._entries: Dict[str, Tuple[Type, dict]] = {}

    def _ensure_builtins(self) -> None:
        if self._builtins_module is not None:
            # Clear only after success: a failed import must re-raise its
            # real error on the next call, not leave the registry
            # silently empty.
            importlib.import_module(self._builtins_module)
            self._builtins_module = None

    def register(self, name: str, **defaults) -> Callable[[Type], Type]:
        """Class decorator registering ``cls`` under ``name``.

        ``defaults`` are keyword arguments merged (at lower priority)
        into every ``make(name, ...)`` call — useful for registering one
        class under several tunings.
        """
        def deco(cls: Type) -> Type:
            if name in self._entries:
                raise ValueError(
                    f"{self.kind} {name!r} already registered "
                    f"({self._entries[name][0].__qualname__})")
            self._entries[name] = (cls, dict(defaults))
            # Stamp the registered name unless the class itself (not a
            # base) already declares one.
            if not cls.__dict__.get("name"):
                cls.name = name
            return cls
        return deco

    def unregister(self, name: str) -> None:
        """Remove a registration (tests / plugin reload)."""
        self._entries.pop(name, None)

    def available(self) -> List[str]:
        """Sorted names of every registered class."""
        self._ensure_builtins()
        return sorted(self._entries)

    def cls(self, name: str) -> Type:
        self._ensure_builtins()
        try:
            return self._entries[name][0]
        except KeyError:
            raise ValueError(
                f"unknown {self.kind} {name!r}; available: "
                f"{self.available()}") from None

    def make(self, name: str, **kwargs):
        """Construct the class registered under ``name``.

        Keyword arguments the class's ``__init__`` does not accept are
        dropped (callers pass one superset for the whole family);
        missing *required* arguments still raise ``TypeError``.
        """
        self._ensure_builtins()
        if name not in self._entries:
            raise ValueError(
                f"unknown {self.kind} {name!r}; available: "
                f"{self.available()}")
        cls, defaults = self._entries[name]
        merged = {**defaults, **kwargs}
        if cls.__init__ is object.__init__:
            merged = {}
        else:
            sig = inspect.signature(cls.__init__)
            params = sig.parameters.values()
            if not any(p.kind is inspect.Parameter.VAR_KEYWORD
                       for p in params):
                accepted = {p.name for p in params}
                merged = {k: v for k, v in merged.items() if k in accepted}
        return cls(**merged)
