"""Retry budgets: exponential backoff with deterministic jitter.

One :class:`RetrySpec` parameterizes the whole recovery surface —
per-query retry budget, backoff schedule, and the per-dispatch timeout
that converts ``hang`` faults into retryable
:class:`~repro_torch.util.errors.DispatchTimeoutError` failures.  Jitter is
drawn from ``(seed, query, attempt)`` so two runs of the same plan
produce bit-identical schedules while distinct queries still
de-synchronize their retries.

The port's copy of the JAX package's ``faults/retry.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

#: Domain-separation salt for the jitter stream (keeps it independent
#: of the flaky-fault draw stream, which salts differently).
_JITTER_SALT = 0x9e77


@dataclass(frozen=True)
class RetrySpec:
    """Budget + schedule for requeue-on-failure.

    ``delay(q, attempt)`` returns the backoff before retry
    ``attempt`` (0-based) of query ``q``:
    ``backoff * multiplier**attempt * (1 + jitter * u)`` with ``u``
    uniform in ``[0, 1)`` drawn deterministically from
    ``(seed, q, attempt)``.

    ``timeout`` is the per-dispatch stall bound: a ``hang`` fault whose
    stall exceeds it fails the dispatch (charging ``timeout`` as wasted
    occupancy) instead of inflating its latency.  ``None`` disables
    timeouts — hangs then surface as latency.

    ``batch_policy`` governs what a failure inside a *rebatched* fleet
    flush (``max_batch > 1``, docs/CLUSTER.md) takes down with it.
    Queries already completed before the failing dispatch always keep
    their rows; the policy decides the fate of the failing query and
    the buffered tail behind it:

    * ``"resplit"`` (default) — the batch dissolves: the failing query
      and the untouched tail each retry through the single-query path
      (per-query budget, backoff, healthy re-route).
    * ``"subset"`` — only the failing query leaves the batch (it
      retries as a single); the untouched tail re-flushes as a batch.
    * ``"all"`` — fail-whole-batch: the failing query and the tail
      share one attempt budget and re-flush together on a healthy
      replica after the backoff; exhausting the budget fails them all.
    """
    max_retries: int = 3
    backoff: float = 0.05
    multiplier: float = 2.0
    jitter: float = 0.0
    seed: int = 0
    timeout: Optional[float] = None
    batch_policy: str = "resplit"

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff < 0 or self.multiplier <= 0 or self.jitter < 0:
            raise ValueError("backoff >= 0, multiplier > 0, jitter >= 0 "
                             "required")
        if self.timeout is not None and self.timeout <= 0:
            raise ValueError("timeout must be > 0 (or None)")
        if self.batch_policy not in ("all", "subset", "resplit"):
            raise ValueError(f"batch_policy must be 'all', 'subset' or "
                             f"'resplit', got {self.batch_policy!r}")

    def delay(self, query: int, attempt: int) -> float:
        base = self.backoff * self.multiplier ** attempt
        if self.jitter <= 0.0 or base <= 0.0:
            return base
        u = np.random.default_rng(
            (self.seed, _JITTER_SALT, int(query), int(attempt))).random()
        return base * (1.0 + self.jitter * u)


def resolve_retries(retries) -> Optional[RetrySpec]:
    """None / int budget / kwargs dict / RetrySpec -> RetrySpec."""
    if retries is None:
        return None
    if isinstance(retries, RetrySpec):
        return retries
    if isinstance(retries, bool):
        raise TypeError("retries must be an int budget, a kwargs dict or "
                        "a RetrySpec, not a bool")
    if isinstance(retries, int):
        return RetrySpec(max_retries=retries)
    if isinstance(retries, dict):
        return RetrySpec(**retries)
    raise TypeError(f"cannot resolve a RetrySpec from "
                    f"{type(retries).__name__}")


__all__ = ["RetrySpec", "resolve_retries"]
