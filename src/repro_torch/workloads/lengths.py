"""Per-query sequence-length distributions (docs/WORKLOADS.md).

Arrival processes say *when* queries show up; length samplers say *how
big* each one is.  Real traffic mixes short and long prompts, and the
mix is what makes batching policy interesting: one straggler length
pads everyone unless dispatch groups by length bucket
(``repro_torch.workloads.batching``).

All samplers are seeded and deterministic — calling ``sample`` twice
returns the identical integer array, so a run is reproducible from
``(sampler name, kwargs, seed)`` alone, mirroring the arrival
generators.

* ``fixed`` — every query at one length (the pre-lengths behaviour).
* ``uniform`` — integer-uniform lengths in ``[lo, hi]``.
* ``bimodal`` — short/long mixture: length ``long`` with probability
  ``p_long``, else ``short`` (the classic chat-vs-document split).
* ``trace`` — replays a recorded per-query length array, cycled when
  the run outlasts the trace.

``resolve_lengths`` is the one construction path drivers use: it
accepts a sampler name, a sampler instance, an explicit array, or
``None`` (in which case a workload carrying its own ``query_lengths``
hook — see :func:`with_lengths` — is consulted).

The port's copy of the JAX package's ``workloads/lengths.py``; only import paths
differ.  ``tests/test_torch_workloads.py`` holds it equal to
the original.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Type

import numpy as np

_LENGTHS: Dict[str, Type] = {}


def register_lengths(name: str) -> Callable[[Type], Type]:
    """Class decorator registering a length sampler under ``name``."""
    def deco(cls: Type) -> Type:
        if name in _LENGTHS:
            raise ValueError(f"length sampler {name!r} already registered")
        _LENGTHS[name] = cls
        return cls
    return deco


def available_lengths() -> List[str]:
    """Sorted names of every registered length sampler."""
    return sorted(_LENGTHS)


def make_lengths(name: str, **kwargs):
    """Construct the length sampler registered under ``name``."""
    if name not in _LENGTHS:
        raise ValueError(f"unknown length sampler {name!r}; "
                         f"available: {available_lengths()}")
    return _LENGTHS[name](**kwargs)


@register_lengths("fixed")
class FixedLengths:
    """Every query at one sequence length."""

    def __init__(self, length: int):
        if length < 1:
            raise ValueError(f"length must be >= 1, got {length}")
        self.length = int(length)

    def sample(self, num_queries: int) -> np.ndarray:
        return np.full(num_queries, self.length, dtype=np.int64)


@register_lengths("uniform")
class UniformLengths:
    """Integer-uniform lengths in ``[lo, hi]`` inclusive."""

    def __init__(self, lo: int, hi: int, seed: int = 0):
        if lo < 1 or hi < lo:
            raise ValueError(f"need 1 <= lo <= hi, got [{lo}, {hi}]")
        self.lo, self.hi, self.seed = int(lo), int(hi), int(seed)

    def sample(self, num_queries: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.integers(self.lo, self.hi + 1, size=num_queries,
                            dtype=np.int64)


@register_lengths("bimodal")
class BimodalLengths:
    """Short/long mixture: ``long`` with probability ``p_long``, else
    ``short`` — chat turns vs. pasted documents."""

    def __init__(self, short: int, long: int, p_long: float = 0.2,
                 seed: int = 0):
        if short < 1 or long < short:
            raise ValueError(f"need 1 <= short <= long, "
                             f"got short={short} long={long}")
        if not 0.0 <= p_long <= 1.0:
            raise ValueError(f"p_long must be in [0, 1], got {p_long}")
        self.short, self.long = int(short), int(long)
        self.p_long, self.seed = float(p_long), int(seed)

    def sample(self, num_queries: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        is_long = rng.random(num_queries) < self.p_long
        return np.where(is_long, self.long, self.short).astype(np.int64)


@register_lengths("trace")
class TraceLengths:
    """Replays a recorded per-query length array (e.g. from production
    logs), cycling it when the run outlasts the trace."""

    def __init__(self, lengths: Sequence[int]):
        arr = np.asarray(lengths, dtype=np.int64)
        if arr.ndim != 1 or len(arr) == 0:
            raise ValueError("lengths must be a non-empty 1-D array")
        if np.any(arr < 1):
            raise ValueError("lengths must be >= 1")
        self.lengths = arr

    def sample(self, num_queries: int) -> np.ndarray:
        reps = -(-num_queries // len(self.lengths))     # ceil division
        return np.tile(self.lengths, reps)[:num_queries]


class _LengthsWorkload:
    """A workload wrapper carrying a per-query length distribution."""

    def __init__(self, workload, sampler):
        self._workload = workload
        self._sampler = sampler
        self.open_loop = workload.open_loop

    def inter_arrivals(self, num_queries: int):
        return self._workload.inter_arrivals(num_queries)

    def query_lengths(self, num_queries: int) -> np.ndarray:
        return self._sampler.sample(num_queries)


def with_lengths(workload, sampler):
    """Attach a length sampler to any arrival workload.

    The returned workload forwards ``open_loop`` / ``inter_arrivals``
    and additionally answers ``query_lengths(n)`` — the optional hook
    ``resolve_lengths`` consults when the driver passes no explicit
    lengths.
    """
    if isinstance(sampler, str):
        sampler = make_lengths(sampler)
    return _LengthsWorkload(workload, sampler)


def resolve_lengths(lengths, lengths_kwargs, num_queries: int,
                    workload=None) -> Optional[np.ndarray]:
    """One construction path for per-query lengths.

    ``lengths`` may be a sampler name (``lengths_kwargs`` forwarded), a
    sampler instance (anything with ``sample``), an explicit per-query
    array (cycled if shorter than the run), or ``None`` — in which case
    a workload providing ``query_lengths`` is consulted, and otherwise
    no lengths are attached (every query at the driver's nominal
    length, the pre-lengths behaviour).
    """
    if lengths is None:
        if workload is not None and hasattr(workload, "query_lengths"):
            lengths = workload.query_lengths(num_queries)
        else:
            return None
    if isinstance(lengths, str):
        lengths = make_lengths(lengths, **(lengths_kwargs or {}))
    if hasattr(lengths, "sample"):
        lengths = lengths.sample(num_queries)
    arr = np.asarray(lengths, dtype=np.int64)
    if arr.ndim != 1 or len(arr) == 0:
        raise ValueError("lengths must resolve to a non-empty 1-D array")
    if np.any(arr < 1):
        raise ValueError("query lengths must be >= 1")
    if len(arr) < num_queries:
        reps = -(-num_queries // len(arr))
        arr = np.tile(arr, reps)
    return arr[:num_queries]
