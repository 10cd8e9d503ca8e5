"""Collective profiler: rank the collectives a run executed by payload
bytes, plus the per-layer collective *cost model* the sharded serving
path consumes (:func:`layer_coll_costs` -> ``MeshSpec.coll_costs``).

The port's counterpart of the JAX package's ``launch/coll_profile.py``.
Where the JAX version walks a compiled module's HLO, this one reads a
:class:`~repro_torch.launch.roofline.CollectiveRecord` of the
``torch.distributed`` traffic a run executed (``PipelineFn.collectives``
of the SPMD pipeline).  :func:`layer_coll_costs` without a record is the
JAX function's analytic path, unchanged.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.launch.roofline import CollectiveRecord


def layer_coll_costs(cfg, batch: int = 1, seq: int = 128,
                     bandwidth: float = 4.0e10,
                     dtype_bytes: int = 4,
                     record: Optional[CollectiveRecord] = None) -> np.ndarray:
    """Per-layer collective cost profile (seconds) for mesh-sliced stages.

    A stage holding ``m > 1`` devices data-parallelizes its blocks and
    re-materializes the activations at each layer hand-off with a ring
    all-gather; the per-layer payload is the activation tile,
    ``batch x seq x d_model x dtype_bytes`` bytes, moved at ``bandwidth``
    bytes/s.  The ring factor ``(m - 1) / m`` and any contention
    inflation are applied downstream by
    :func:`repro_torch.core.mesh.mesh_stage_times` -- this profile is the
    *clean single-hop* cost only, so one profile serves every
    (assignment, interference) combination.

    ``record`` (the collectives a run executed) refines the estimate: the
    summed bytes of :func:`top_collectives` are spread evenly over the
    layers, replacing the analytic payload.  The result feeds
    ``MeshSpec(coll_costs=...)`` directly.
    """
    L = int(cfg.num_blocks)
    if record is not None:
        rows = top_collectives(record, k=10 ** 6)
        total_bytes = float(sum(b for b, _ in rows))
        if total_bytes > 0.0:
            return np.full(L, total_bytes / L / float(bandwidth))
    payload = float(batch) * float(seq) * float(cfg.d_model) * dtype_bytes
    return np.full(L, payload / float(bandwidth))


def top_collectives(record: CollectiveRecord,
                    k: int = 15) -> List[Tuple[float, str]]:
    """The record's (bytes, "kind op") rows, largest first, each summed
    over the calls that moved it."""
    rows = sorted(((float(b), f"{kind:20s} {op}")
                   for (kind, op), b in record.rows.items()), reverse=True)
    return rows[:k]
