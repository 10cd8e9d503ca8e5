"""Device-mesh slices per pipeline stage: the sharded cost model.

A pipeline *configuration* ``C`` (layers per stage) now composes with a
*mesh assignment* ``A`` — contiguous device ranges per stage, one slice
of a ``jax.sharding.Mesh`` each (docs/SHARDING.md).  Stage ``i`` with
``m_i = A[i]`` devices data-parallelizes its compute and pays a
collective (ring all-gather of its activations) to re-materialize the
hand-off:

    t_i(C, A) = compute_i(C) / m_i + coll_i(C) * ring(m_i) * f

where ``ring(m) = (m - 1) / m`` (the classic ring-collective factor —
zero for a single device), ``coll_i`` sums the per-layer collective
costs of the stage's layers (profiled via
:func:`repro_torch.launch.coll_profile.layer_coll_costs`, or a flat
per-layer constant), and ``f`` is the *collective contention* factor a
``kind="mesh"`` :class:`~repro_torch.core.events.InterferenceEvent` inflates
(1.0 when quiet).

Bit-identity invariant: an *unarmed* mesh (``mesh=None``) takes none of
the sharded code paths — traces are bit-identical to a pre-mesh build.
With ``m_i = 1`` everywhere the cost model itself is also float-exact
(``compute_i / 1.0 + 0.0``), but an *armed* all-ones mesh still swaps
the explorer's action space (``MeshOdinExplorer`` ranks candidate moves
instead of following Algorithm 1's heuristic order), so traces may
diverge once a rebalancing phase runs.  Every consumer (simulator, DP
oracle, explorer, live ``MeasuredTimeSource``) goes through
:func:`mesh_stage_times`, so the cost model has one home.

The port's copy of the JAX package's ``core/mesh.py``; only import paths
differ.  ``tests/test_torch_simulator.py`` holds it equal to the original.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np


def ring_factor(m: int) -> float:
    """Ring-collective scaling: ``(m - 1) / m`` for ``m > 1``, else 0
    (a single-device stage runs no collective)."""
    m = int(m)
    return (m - 1) / m if m > 1 else 0.0


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Sharding options for one pipeline (sim or live).

    ``devices`` — total devices the stages share (each stage owns a
    contiguous slice, every stage at least one device).
    ``coll_cost`` — flat per-layer collective cost in the run's time
    unit; ``coll_costs`` overrides it with a per-layer profile (e.g.
    from :func:`repro_torch.launch.coll_profile.layer_coll_costs`).
    """
    devices: int
    coll_cost: float = 0.0
    coll_costs: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if int(self.devices) < 1:
            raise ValueError(f"mesh devices must be >= 1, got "
                             f"{self.devices}")
        object.__setattr__(self, "devices", int(self.devices))
        if self.coll_costs is not None:
            object.__setattr__(
                self, "coll_costs",
                tuple(float(c) for c in self.coll_costs))

    def layer_costs(self, num_layers: int) -> np.ndarray:
        """Per-layer collective costs, validated against the model."""
        if self.coll_costs is not None:
            if len(self.coll_costs) != num_layers:
                raise ValueError(
                    f"mesh coll_costs names {len(self.coll_costs)} "
                    f"layers, model has {num_layers}")
            return np.asarray(self.coll_costs, dtype=np.float64)
        return np.full(num_layers, float(self.coll_cost))

    def coll_prefix(self, num_layers: int) -> np.ndarray:
        """Prefix sums of the per-layer collective costs (``P[j]`` =
        sum over layers ``[0, j)``), the shape the DP oracle consumes."""
        out = np.zeros(num_layers + 1)
        out[1:] = np.cumsum(self.layer_costs(num_layers))
        return out

    def to_dict(self) -> dict:
        d = {"devices": self.devices, "coll_cost": self.coll_cost}
        if self.coll_costs is not None:
            d["coll_costs"] = list(self.coll_costs)
        return d


def resolve_mesh(mesh: Union[None, int, dict, MeshSpec]) -> Optional[MeshSpec]:
    """Coerce the spec forms: ``None`` (unarmed), a device count, a
    kwargs dict, or a :class:`MeshSpec`."""
    if mesh is None:
        return None
    if isinstance(mesh, MeshSpec):
        return mesh
    if isinstance(mesh, int):
        return MeshSpec(devices=mesh)
    if isinstance(mesh, dict):
        d = dict(mesh)
        if "coll_costs" in d and d["coll_costs"] is not None:
            d["coll_costs"] = tuple(d["coll_costs"])
        return MeshSpec(**d)
    raise TypeError(f"mesh must be None, an int device count, a dict or "
                    f"a MeshSpec, got {type(mesh).__name__}")


def balanced_assignment(devices: int, num_stages: int) -> List[int]:
    """Even device split (mirrors ``balanced_config``); every stage
    gets at least one device."""
    if devices < num_stages:
        raise ValueError(f"{devices} devices cannot give each of "
                         f"{num_stages} stages a slice")
    base, rem = divmod(devices, num_stages)
    return [base + (1 if i < rem else 0) for i in range(num_stages)]


def validate_assignment(assignment: Sequence[int], devices: int) -> None:
    if any(int(m) < 1 for m in assignment):
        raise ValueError(f"every stage needs >= 1 device: {assignment}")
    if sum(int(m) for m in assignment) != devices:
        raise ValueError(f"assignment {list(assignment)} uses "
                         f"{sum(assignment)} devices, mesh has {devices}")


def assignments(devices: int, num_stages: int) -> Iterator[Tuple[int, ...]]:
    """All compositions of ``devices`` into ``num_stages`` positive
    parts — the (boundary, slice) oracle's slice axis.  C(D-1, S-1)
    tuples (35 for D=8, S=4), in lexicographic order (deterministic)."""
    for cuts in itertools.combinations(range(1, devices), num_stages - 1):
        bounds = (0,) + cuts + (devices,)
        yield tuple(bounds[i + 1] - bounds[i]
                    for i in range(num_stages))


def stage_collectives(layer_costs: np.ndarray,
                      config: Sequence[int]) -> np.ndarray:
    """Per-stage summed collective cost for a configuration (the
    analogue of ``LayerDatabase.stage_times`` for the collective
    column)."""
    out = np.zeros(len(config))
    lo = 0
    for i, cnt in enumerate(config):
        out[i] = layer_costs[lo:lo + cnt].sum()
        lo += cnt
    return out


def mesh_stage_times(compute: np.ndarray, config: Sequence[int],
                     assignment: Sequence[int], spec: MeshSpec,
                     coll_factor: float = 1.0,
                     layer_costs: Optional[np.ndarray] = None
                     ) -> np.ndarray:
    """Apply the sharded cost model to unsharded per-stage compute
    times: ``compute_i / m_i + coll_i * ring(m_i) * coll_factor``.
    ``layer_costs`` lets hot callers pass the cached per-layer profile
    instead of re-resolving it from the spec each query."""
    m = np.asarray(assignment, dtype=np.float64)
    ring = np.where(m > 1.0, (m - 1.0) / m, 0.0)
    if layer_costs is None:
        layer_costs = spec.layer_costs(int(sum(config)))
    coll = stage_collectives(layer_costs, config)
    return compute / np.maximum(m, 1.0) + coll * ring * float(coll_factor)


def collective_frac(compute: np.ndarray, config: Sequence[int],
                    assignment: Sequence[int], spec: MeshSpec,
                    coll_factor: float = 1.0,
                    layer_costs: Optional[np.ndarray] = None) -> float:
    """Fraction of the bottleneck stage's time spent in collectives
    (the per-query ``collective_frac`` trace column)."""
    if layer_costs is None:
        layer_costs = spec.layer_costs(int(sum(config)))
    total = mesh_stage_times(compute, config, assignment, spec,
                             coll_factor, layer_costs=layer_costs)
    i = int(np.argmax(total))
    if total[i] <= 0.0:
        return 0.0
    ring = ring_factor(int(assignment[i]))
    coll = (stage_collectives(layer_costs, config)[i]
            * ring * float(coll_factor))
    return float(coll / total[i])
