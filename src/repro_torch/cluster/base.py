"""Router protocol + the per-replica view routers decide over.

A :class:`Router` is the cluster's third pluggable axis, mirroring
``repro_torch.schedulers`` (mitigation policy) and ``repro_torch.workloads``
(arrival process): given the fleet's next arrival and a read-only
:class:`ReplicaView` per replica, it picks the replica the query is
dispatched to.  Routers must be **deterministic** — a pure function of
their own state and the views — so a run is reproducible from
``(workload, seed, router)`` alone, and so the ``cluster(n=1)``
reduction is trace-identical to a plain :func:`~repro_torch.workloads.run_pipeline`.

The view exposes exactly the signals ODIN's per-pipeline machinery
already maintains (PR 1-3): the admission ledger (outstanding work /
backlog), the :class:`~repro_torch.schedulers.runtime.RebalanceRuntime`'s
exploration state, and the policy's
:class:`~repro_torch.schedulers.base.InterferenceDetector` probed
side-effect-free (``detector.shift``) together with the runtime's
stage-time estimates — which is what lets the ``odin_aware`` router
route *away* from replicas whose detectors currently report
interference without consuming any detector observations.

The port's copy of the JAX package's ``cluster/base.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Protocol, Sequence, runtime_checkable

if TYPE_CHECKING:  # annotation-only
    from repro_torch.workloads.runner import PipelineRunner


class ReplicaView:
    """Read-only snapshot of one replica at a routing decision.

    ``outstanding`` (queries in-system at the decision time) is computed
    by the cluster's ledger; every other signal is probed lazily from
    the replica's runner/runtime, so routers that ignore a field
    (``round_robin`` ignores all of them) never pay for it.
    """

    __slots__ = ("index", "outstanding", "now", "since_assign", "pool",
                 "_runner")

    def __init__(self, index: int, runner: "PipelineRunner",
                 outstanding: int, now: float,
                 since_assign: float = float("inf"),
                 pool: str = "default"):
        self.index = index
        self.outstanding = outstanding
        self.now = now
        #: Replica pool label (heterogeneous fleets, docs/QOS.md):
        #: ``"small"`` marks small-model replicas the ``downgrade``
        #: router may send best-effort traffic to under pressure.
        self.pool = pool
        #: Fleet queries since this replica last served one (``inf`` if
        #: never).  Detector/estimate signals only advance when the
        #: replica serves, so this is the *staleness* of every probed
        #: field below — routers must not treat a long-starved
        #: replica's last reading as current (docs/CLUSTER.md).
        self.since_assign = since_assign
        self._runner = runner

    @property
    def free_at(self) -> float:
        """When this replica's admission head frees up."""
        return self._runner.free_at

    @property
    def backlog(self) -> float:
        """Admission-head wait a query dispatched now would see."""
        return max(self._runner.free_at - self.now, 0.0)

    @property
    def exploring(self) -> bool:
        """True while the replica is mid-rebalance (serial trials —
        the pipeline is drained between queries)."""
        return self._runner.runtime.exploring

    @property
    def interference_score(self) -> float:
        """Positive relative bottleneck degradation the replica's
        detector currently sees (0.0 when quiet / no detector)."""
        return self._runner.runtime.interference_score()

    @property
    def interference_active(self) -> bool:
        """True when the detector's shift exceeds its threshold."""
        return self._runner.runtime.interference_active()

    @property
    def est_bottleneck(self) -> float:
        """Estimated per-query service beat (bottleneck stage time) on
        the replica's committed config; NaN before any poll."""
        return self._runner.runtime.estimated_bottleneck()

    @property
    def est_latency(self) -> float:
        """Estimated end-to-end (pipelined) latency of one query on
        the replica's committed config; NaN before any poll.  What
        fleet-level admission policies compare against an SLO
        (docs/CONTROL.md)."""
        return self._runner.runtime.estimated_service_latency()


@runtime_checkable
class Router(Protocol):
    """Picks the replica each fleet arrival is dispatched to."""

    def route(self, q: int, now: float,
              views: Sequence[ReplicaView]) -> int:
        """Position into ``views`` for fleet query ``q`` at ``now``.

        Must be deterministic given the router's state and the views,
        and must return a position in ``range(len(views))``.  The
        views may cover only the fleet's *active* subset (autoscaling,
        docs/CONTROL.md); the cluster resolves the position to a fleet
        replica via ``views[pos].index``.

        Tier-aware routers (``edf``, ``downgrade``; docs/QOS.md) may
        additionally accept a ``request`` keyword — the cluster
        detects the parameter by signature and passes the arrival's
        :class:`~repro_torch.qos.QosRequest` when tiers are armed, ``None``
        otherwise; routers without the parameter are called exactly as
        before.
        """
        ...

    def reset(self) -> None:
        """Drop routing state (fresh serving window)."""
        ...
