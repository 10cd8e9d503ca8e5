"""Admission-control & autoscaler protocols (the SLO control plane).

ODIN's rebalancing keeps a pipeline as fast as the interference allows,
but it cannot make offered load fit capacity: when an open-loop
workload outruns the (rebalanced) pipeline, the arrival queue grows
without bound and every latency percentile is lost.  The control plane
is the layer around the scheduler that closes that loop — InferLine's
thesis (provision/control around the planner) combined with Strait's
(interference signals should shape admission, not just placement):

* An :class:`AdmissionPolicy` decides, per arrival, whether the query
  enters the pipeline at all.  Shed queries never execute, never poll
  the scheduler, and are reported separately so SLO attainment is
  measured on *admitted goodput*.
* An :class:`Autoscaler` decides, per fleet arrival, which replicas of
  a :class:`~repro.cluster.Cluster` are active — routers only ever see
  the active set, so draining a replica simply stops feeding it.

Both are pluggable through string-keyed registries mirroring
``repro_torch.schedulers`` / ``repro_torch.workloads`` / ``repro.cluster``
(:mod:`repro.control.registry`).  See docs/CONTROL.md.

The port's copy of the JAX package's ``control/base.py``; only import paths
differ, and the fleet's ``ReplicaView``
annotation.  ``tests/test_torch_workloads.py`` holds it equal to
the original.
"""
from __future__ import annotations

import dataclasses
from typing import (
    TYPE_CHECKING,
    Optional,
    Protocol,
    Sequence,
    runtime_checkable,
)

if TYPE_CHECKING:
    # The fleet's ReplicaView waits for the port's fleet slice (ROADMAP
    # item 6f); the annotation below stays a name.
    ReplicaView = object


@dataclasses.dataclass(frozen=True)
class AdmissionView:
    """What an admission decision sees, before the query executes.

    Built by the run loop (single pipeline) or the cluster (from the
    routed replica's view) from state the schedulers subsystem already
    maintains — the admission-head ledger and the runtime's estimated
    bottleneck.  Everything is an *estimate at decision time*: a shed
    query never executes, so its true service time is never known.
    """

    #: Global (fleet) index of the arriving query.
    query: int
    #: Arrival time in driver units; ``None`` for a closed loop, where
    #: queries arrive exactly when the pipeline can take them and the
    #: predicted wait is zero by construction.
    arrival: Optional[float]
    #: Predicted admission-head wait (queueing delay) the query would
    #: see if admitted now.  Zero for closed loops.
    wait: float
    #: Estimated per-query service beat on the committed configuration
    #: (the runtime's ``estimated_bottleneck()``) — the rate at which
    #: the admission head drains; NaN before the scheduler has been
    #: polled at least once.
    est_service: float
    #: Estimated end-to-end latency of one query on the committed
    #: configuration (the runtime's ``estimated_service_latency()``:
    #: occupied stages x bottleneck beat); NaN before the first poll.
    est_latency: float = float("nan")
    #: QoS tier index of the arrival (``repro.qos``); ``None`` when the
    #: run has no tiers configured.  The remaining QoS fields default
    #: to "one anonymous tier of unit value with no deadline", so
    #: tier-blind policies and pre-QoS call sites are unaffected.
    tier: Optional[int] = None
    #: Priority class (higher preempts lower at batch formation).
    priority: int = 0
    #: Relative deadline in seconds from arrival (``inf`` = none).
    deadline: float = float("inf")
    #: SLO value: what completing this query within deadline is worth.
    value: float = 1.0

    @property
    def queue_length(self) -> float:
        """Predicted backlog in *queries*: the wait divided by the
        estimated service beat (0.0 while the beat is unknown)."""
        if not self.est_service > 0.0:  # NaN or zero -> unknown
            return 0.0
        return self.wait / self.est_service


@runtime_checkable
class AdmissionPolicy(Protocol):
    """Per-arrival admit/shed decision.

    Implementations may additionally expose:

    * ``admits_all: bool`` — class-level declaration that ``admit``
      always returns True.  The run loop then skips the shed checks
      entirely, keeping closed-loop traces bit-identical to running
      with no policy at all (the ``none`` built-in).
    * ``observe(queue_delay, service_latency)`` — called once per
      *executed* query with its measured queueing delay and service
      time; how feedback controllers (``adaptive_batch``) track the
      tail they are steering.
    * ``max_chunk_bound() -> int`` — a live upper bound on the run
      loop's chunk/batch size; consulted at every chunk formation.
    * ``slo: float`` — the latency objective (driver time units) the
      policy enforces; stamped onto the finished trace so SLO
      attainment is computed against the same target.

    ``admit`` must be a pure function of the view (plus constructor
    state): the run loop's chunked fast path calls it with *predicted*
    views to find chunk cut points and re-decides the cut query
    against the actual ledger, so a policy whose answer depends on how
    often it was asked (a call-counting rate limiter, say) would
    diverge between the chunked and scalar paths.  Track history
    through ``observe`` — called exactly once per executed query —
    instead.
    """

    def admit(self, view: AdmissionView) -> bool:
        """True to admit the arrival, False to shed it."""
        ...

    def reset(self) -> None:
        """Drop online state (fresh serving window)."""
        ...


@runtime_checkable
class Autoscaler(Protocol):
    """Decides which replicas of a fleet are active, per arrival.

    ``views`` always covers the *whole* fleet (the autoscaler must see
    drained replicas to re-activate them); the returned indices select
    the subset routers may dispatch to.  Implementations must be
    deterministic given their state and the views, and must return at
    least one index.
    """

    def active(self, q: int, now: float, views: Sequence[ReplicaView]) -> Sequence[int]:
        """Fleet indices of the replicas active for arrival ``q``."""
        ...

    def reset(self) -> None:
        """Drop scaling state (fresh serving window)."""
        ...
