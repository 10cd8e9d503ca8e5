"""Optional activation-sharding constraints for the block stack.

Mirrors the JAX package's ``models/sharding_ctx.py``.  There, a
``PartitionSpec`` set here pins the activations at every block entry
(``blocks.block_forward``) to the intended sharding through
``jax.lax.with_sharding_constraint``.  No process of the port holds less
than the whole activation, so here the constraint is checked and recorded,
never applied: :func:`constrain` returns its input itself, and keeps the
per-device shard shape the spec gives it on the mesh (``last_shard_shape``)
and the number of constrained calls (``constrained``).

The constraint is a process-global setting (set by the launcher around a
run, never by library code), so the model code stays mesh-agnostic when it
is unset.  A spec is a tuple with one entry per leading tensor dim (fewer
entries leave the trailing dims whole), each entry ``None``, a mesh axis
name or a tuple of them.  As when XLA lowers JAX's constraint:

* an axis the mesh lacks, an axis named twice, or more entries than the
  activation has dims raise ``ValueError``;
* a dim that its axes do not divide is still sharded, padded up: each
  device holds ``ceil(dim / product of the axes)`` of it.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

_ACTIVATION: Optional[tuple] = None     # (spec, mesh)
constrained = 0                          # calls of constrain with a spec set
last_shard_shape: Optional[Tuple[int, ...]] = None


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def set_activation_spec(spec, mesh=None) -> None:
    """Set (or with ``None`` clear) the spec that :func:`constrain` checks
    on ``mesh`` (anything with ``shape``, a mapping of axis sizes, and
    ``axis_names``, such as a ``launch.mesh.StageMesh``).  A spec without
    a mesh raises ``RuntimeError``, as JAX's constraint does outside a
    mesh context."""
    global _ACTIVATION
    if spec is None:
        _ACTIVATION = None
        return
    if mesh is None:
        raise RuntimeError("an activation spec needs the mesh it names "
                           "axes of")
    spec = tuple(spec)
    named = [a for entry in spec for a in _axes(entry)]
    missing = [a for a in named if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"axes {missing} of {spec} are not in the mesh "
                         f"{tuple(mesh.axis_names)}")
    if len(set(named)) != len(named):
        raise ValueError(f"{spec} names a mesh axis twice")
    _ACTIVATION = (spec, mesh)


@contextlib.contextmanager
def activation_spec(spec, mesh=None):
    """:func:`set_activation_spec` for the ``with`` block, cleared after it
    even when it raises."""
    set_activation_spec(spec, mesh)
    try:
        yield
    finally:
        set_activation_spec(None)


def shard_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """The per-device shape of a ``shape`` tensor under ``spec`` on
    ``mesh``: each sharded dim split over the product of its axes, padded
    up where they do not divide it."""
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise ValueError(f"{spec} has {len(spec)} entries for a tensor of "
                         f"{len(shape)} dims {tuple(shape)}")
    out = list(shape)
    for d, entry in enumerate(spec):
        n = math.prod(mesh.shape[a] for a in _axes(entry))
        out[d] = -(-out[d] // n)
    return tuple(out)


def constrain(x):
    """Check the configured constraint on a ``[B, S, d]`` activation and
    return ``x`` itself; with no spec set, only return it."""
    global constrained, last_shard_shape
    if _ACTIVATION is None:
        return x
    spec, mesh = _ACTIVATION
    last_shard_shape = shard_shape(x.shape, spec, mesh)
    constrained += 1
    return x
