"""Multi-replica fleet serving with interference-aware routing.

The cluster is the repo's fourth pluggable axis (after schedulers,
workloads and batching): a :class:`Cluster` owns N pipeline replicas —
each with its own :class:`~repro_torch.schedulers.runtime.RebalanceRuntime`,
detector state, interference timeline and executor — and a
:class:`Router` picks the replica every fleet arrival is dispatched
to.  Built-ins: ``round_robin``, ``least_outstanding`` (cluster-level
LLS) and ``odin_aware`` (routes away from replicas whose ODIN
detectors currently report interference).  See docs/CLUSTER.md.

Backends: :func:`simulate_cluster` (database simulator, replica-scoped
``InterferenceEvent``\\ s) and :func:`serve_cluster` (live
:class:`~repro_torch.serving.ServingEngine` replicas; imported lazily so the
simulator path stays free of torch).

The port's copy of the JAX package's ``cluster/__init__.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from repro_torch.cluster.base import ReplicaView, Router  # noqa: F401
from repro_torch.cluster.cluster import (  # noqa: F401
    Cluster,
    Replica,
    run_cluster,
)
from repro_torch.cluster.registry import (  # noqa: F401
    available_routers,
    make_router,
    register_router,
    resolve_router,
    router_class,
    unregister_router,
)
from repro_torch.cluster.sim import simulate_cluster  # noqa: F401
from repro_torch.cluster.trace import ClusterTrace  # noqa: F401


def __getattr__(name):
    """Lazy: ``serve_cluster`` pulls in torch via the serving engine;
    simulator-only users shouldn't pay that import."""
    if name == "serve_cluster":
        from repro_torch.cluster.live import serve_cluster
        return serve_cluster
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
