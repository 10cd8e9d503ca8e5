"""Batch formation policy: drain vs. continuous, length buckets.

``serve(max_batch=N)``'s original stacked dispatch is *drain-and-refill*
batching: stack whatever has already arrived, run the whole batch to
completion, only then look at the queue again.  Under bursty arrivals
the queries that land just after a dispatch wait out the entire drain.

A :class:`BatchFormer` makes the policy explicit and adds **continuous
batching**: new arrivals are folded into the in-flight batch at
pipeline-stage boundaries (a joiner is caught up through the stages the
batch already passed, then rides along), so queue delay stops scaling
with the full drain time.  **Length buckets** make mixed-length traffic
batchable: each query is padded up to a small set of bucket edges
(powers of two by default), dispatch groups *contiguous same-bucket
runs* — arrival order is never reordered, which is what keeps the run
loop's vectorized completion ledger exact — and the executor pre-warms
exactly the bucket shapes.

The former is pure policy: it owns no clock and runs no queries.  The
run loop (``repro_torch.workloads.runner``) consults it for membership
decisions; executors implement the actual joining via their
``begin_dispatch`` builders (analytic in the simulator, physical
``run_stages`` execution in the live engine).

The port's copy of the JAX package's ``workloads/batching.py``; only import paths
differ.  ``tests/test_torch_workloads.py`` holds it equal to
the original.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

BATCHING_MODES = ("drain", "continuous")


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1).

    Also defined by ``repro_torch.pipeline.executor`` — duplicated two lines
    here so the simulator never has to import the jax executor stack.
    """
    return 1 << (max(int(n), 1) - 1).bit_length()


class LengthBuckets:
    """A sorted set of sequence-length bucket edges.

    Every query is padded up to the smallest edge >= its length;
    batches only mix queries inside one bucket, so one straggler length
    never pads the whole batch to its size.  Fewer buckets = fewer
    compiled shapes but more padding waste; more buckets = tighter
    padding but batches fragment (docs/PERFORMANCE.md).
    """

    def __init__(self, edges: Sequence[int]):
        arr = np.unique(np.asarray(edges, dtype=np.int64))
        if len(arr) == 0:
            raise ValueError("LengthBuckets needs at least one edge")
        if arr[0] < 1:
            raise ValueError(f"bucket edges must be >= 1, got {list(arr)}")
        self.edges = arr

    @classmethod
    def pow2(cls, lo: int, hi: int) -> "LengthBuckets":
        """Powers-of-two edges covering ``[lo, hi]``."""
        if lo < 1 or hi < lo:
            raise ValueError(f"need 1 <= lo <= hi, got [{lo}, {hi}]")
        edges, e = [], next_pow2(lo)
        while e < hi:
            edges.append(e)
            e *= 2
        edges.append(e)
        return cls(edges)

    @classmethod
    def single(cls, seq: int) -> "LengthBuckets":
        """One bucket: every query padded to ``seq``."""
        return cls([seq])

    def pad(self, length: int) -> int:
        """Smallest bucket edge >= ``length``."""
        i = int(np.searchsorted(self.edges, length))
        if i == len(self.edges):
            raise ValueError(f"length {length} exceeds largest bucket "
                             f"edge {int(self.edges[-1])}")
        return int(self.edges[i])

    def pad_many(self, lengths: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`pad` over a length array."""
        idx = np.searchsorted(self.edges, lengths)
        if np.any(idx == len(self.edges)):
            worst = int(np.max(lengths))
            raise ValueError(f"length {worst} exceeds largest bucket "
                             f"edge {int(self.edges[-1])}")
        return self.edges[idx]

    def __repr__(self):
        return f"LengthBuckets({list(map(int, self.edges))})"


@dataclasses.dataclass
class BatchFormer:
    """Batch formation policy consumed by the run loop.

    ``mode="drain"`` stacks queued arrivals only at dispatch instants
    (the explicit spelling of the original ``max_batch`` behaviour,
    plus buckets); ``mode="continuous"`` additionally admits arrivals
    at every pipeline-stage boundary of the in-flight batch.

    ``explore_in_batch`` lets ODIN exploration trials ride a formed
    batch pipelined instead of draining the pipeline for a serial
    trial — the trial config serves the whole dispatch, the measurement
    the explorer consumes is unchanged.
    """

    mode: str = "continuous"
    max_batch: int = 8
    buckets: Optional[LengthBuckets] = None
    explore_in_batch: bool = False

    def __post_init__(self):
        if self.mode not in BATCHING_MODES:
            raise ValueError(f"batching mode must be one of "
                             f"{BATCHING_MODES}, got {self.mode!r}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, "
                             f"got {self.max_batch}")

    @property
    def continuous(self) -> bool:
        return self.mode == "continuous"

    def padded_lengths(self, lengths: Optional[np.ndarray]
                       ) -> Optional[np.ndarray]:
        """Per-query padded (bucket-edge) lengths, or ``None`` when the
        run carries no length information (every query then shares one
        implicit bucket)."""
        if lengths is None:
            return None
        lengths = np.asarray(lengths, dtype=np.int64)
        if self.buckets is None:
            return lengths
        return self.buckets.pad_many(lengths)


def resolve_buckets(buckets, seq: Optional[int] = None
                    ) -> Optional[LengthBuckets]:
    """Accept a :class:`LengthBuckets`, an edge list, a ``"pow2:lo:hi"``
    spec, ``"single"`` (one bucket at ``seq``), or ``None``."""
    if buckets is None or isinstance(buckets, LengthBuckets):
        return buckets
    if isinstance(buckets, str):
        if buckets == "single":
            if seq is None:
                raise ValueError("buckets='single' needs a sequence "
                                 "length to pad to")
            return LengthBuckets.single(seq)
        if buckets.startswith("pow2:"):
            parts = buckets.split(":")
            if len(parts) != 3:
                raise ValueError(f"pow2 bucket spec must be "
                                 f"'pow2:lo:hi', got {buckets!r}")
            return LengthBuckets.pow2(int(parts[1]), int(parts[2]))
        return LengthBuckets([int(p) for p in buckets.split(",")])
    return LengthBuckets(buckets)


def resolve_batching(batching, max_batch: int = 8, buckets=None,
                     explore_in_batch: bool = False,
                     seq: Optional[int] = None) -> Optional[BatchFormer]:
    """One construction path for the batch former.

    ``batching`` may be ``None`` / ``"none"`` (no former — the exact
    pre-batching code path), a mode name (``"drain"`` /
    ``"continuous"``), or a ready :class:`BatchFormer`.
    """
    if batching is None or batching == "none":
        return None
    if isinstance(batching, BatchFormer):
        return batching
    return BatchFormer(mode=batching, max_batch=max_batch,
                       buckets=resolve_buckets(buckets, seq=seq),
                       explore_in_batch=explore_in_batch)


Batching = Union[None, str, BatchFormer]
