"""Typed serving errors: the part of the JAX package's
``util/errors.py`` that the port's serving path raises."""
from __future__ import annotations

from typing import Sequence

__all__ = ["QueryError", "MixedSequenceLengthError"]


class QueryError(RuntimeError):
    """Base for all typed serving errors."""


class MixedSequenceLengthError(ValueError, QueryError):
    """A stacked batch mixed sequence lengths (permanent: retrying the
    same batch can never succeed)."""

    def __init__(self, lengths: Sequence[int]):
        self.lengths = [int(x) for x in lengths]
        super().__init__(
            "run_batch requires equal padded sequence lengths; got "
            f"{sorted(set(self.lengths))} — bucket queries by length "
            "before batching")
