"""Typed error hierarchy for the serving stack.

Retry logic (:mod:`repro_torch.faults`) dispatches on the transient /
permanent split: anything deriving from :class:`TransientQueryError`
may be requeued against the per-query retry budget, everything else
propagates.  The hierarchy is deliberately small — fault kinds map
onto it one-to-one:

``flaky``   -> :class:`TransientQueryError`
``crash``   -> :class:`ReplicaUnavailableError` (replica down)
``hang``    -> :class:`DispatchTimeoutError` (stall > timeout)

:class:`MixedSequenceLengthError` (a batch-formation contract
violation, see docs/WORKLOADS.md) lives here too but is *permanent* —
retrying the same malformed batch can never succeed.

The port's copy of the JAX package's ``util/errors.py``.  The run loop
(``repro_torch.workloads.runner``) raises and catches these;
``tests/test_torch_workloads.py`` holds the copy equal to the original.
"""
from __future__ import annotations

from typing import Sequence

__all__ = [
    "QueryError",
    "TransientQueryError",
    "ReplicaUnavailableError",
    "DispatchTimeoutError",
    "MixedSequenceLengthError",
    "is_transient",
]


class QueryError(RuntimeError):
    """Base for all typed serving errors."""


class TransientQueryError(QueryError):
    """A query failed in a way that may succeed on retry.

    Raised by the ``flaky`` fault kind and subclassed by every other
    retryable failure.  Carries no replica state — the retry machinery
    decides where (and whether) to requeue.
    """


class ReplicaUnavailableError(TransientQueryError):
    """The routed replica is down (``crash`` fault window).

    Transient: the replica restarts at the end of its recovery delay,
    and other replicas may be healthy right now.
    """

    def __init__(self, replica: int = -1, until: float = float("nan")):
        self.replica = int(replica)
        self.until = float(until)
        super().__init__(f"replica {self.replica} unavailable "
                         f"until t={self.until:g}")


class DispatchTimeoutError(TransientQueryError):
    """A dispatch exceeded the per-dispatch timeout (``hang`` fault).

    The timed-out dispatch is charged as wasted occupancy on the
    replica that hung; the query itself becomes retryable.
    """

    def __init__(self, timeout: float = float("nan"),
                 replica: int = -1):
        self.timeout = float(timeout)
        self.replica = int(replica)
        super().__init__(f"dispatch exceeded timeout "
                         f"{self.timeout:g}s on replica {self.replica}")


class MixedSequenceLengthError(ValueError, QueryError):
    """A formed batch mixed padded sequence lengths (permanent).

    A :class:`ValueError` too, as in the JAX package, whose callers
    caught the older ``pipeline.executor.MixedSequenceLengthError``.
    """

    def __init__(self, lengths: Sequence[int]):
        self.lengths = [int(x) for x in lengths]
        super().__init__(
            "run_batch requires equal padded sequence lengths; got "
            f"{sorted(set(self.lengths))} — bucket queries by length "
            "before batching")


def is_transient(err: BaseException) -> bool:
    """True iff ``err`` may be retried under a retry budget."""
    return isinstance(err, TransientQueryError)
