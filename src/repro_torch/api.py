"""One unified run declaration: :class:`RunSpec` + :func:`run`.

The repo grew six entry points that each accumulated ~20 near-identical
keyword arguments: :func:`repro_torch.core.simulate`,
:func:`repro_torch.workloads.run_pipeline`,
:meth:`repro_torch.serving.ServingEngine.serve`,
:func:`repro_torch.cluster.run_cluster`, :func:`repro_torch.cluster.simulate_cluster`
and :func:`repro_torch.cluster.serve_cluster`.  ``RunSpec`` factors the shared
surface into frozen sub-specs (workload / admission / batching / faults /
retries / tiers / telemetry / scheduler / mesh — each carrying exactly
the values the existing ``resolve_*`` coercions accept), and
:func:`run` dispatches one declaration to the right driver.  The six
legacy entry points are now thin wrappers that build a ``RunSpec`` and
call :func:`run`, so the spec path and the kwarg path are the *same*
path — bit-identical by construction (tests/test_sharding.py).

New options land in the spec instead of growing six signatures: the
mesh-sliced stage options (docs/SHARDING.md) exist only here
(``RunSpec(mesh=...)``) and on the :class:`~repro_torch.serving.ServingEngine`
constructor for live runs.

Targets are *handles* — a database, an engine, token arrays, callables.
``to_dict()`` serializes everything that isn't a handle (CLI/CI
round-trips); ``from_dict(d, **handles)`` re-attaches them:

    spec = RunSpec(db=db, num_eps=4, num_queries=2000,
                   scheduler=SchedulerSpec(name="odin", alpha=10),
                   workload=WorkloadSpec(name="poisson",
                                         kwargs={"rate": 0.01, "seed": 0}),
                   mesh=MeshSpec(devices=8, coll_cost=0.5))
    trace = run(spec)
    rerun = run(RunSpec.from_dict(spec.to_dict(), db=db))

Dispatch rules (first match wins — docs/API.md):

* ``db`` + ``cluster`` set (any replica count) → fleet simulation
* ``db`` set                                → single-pipeline simulation
* ``replicas`` set (built :class:`Replica`\\ s) → fleet driver
* ``engines`` set                           → live fleet serving
* ``engine`` set                            → live single-engine serving
* ``executor`` + ``runtime`` set            → the raw run loop

The port's copy of the JAX package's ``api.py``; only import paths
differ, and the fleet targets (``db`` with a ``cluster``, ``replicas``,
``engines``) raise ``NotImplementedError`` until the fleet drivers are
copied (ROADMAP.md Queue 1 item 6f), as admission, faults, retries and
tiers do in the port's run loop.  ``tests/test_torch_api.py`` holds the
rest equal to the original.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple, Union

from repro_torch.core.events import InterferenceEvent
from repro_torch.core.mesh import MeshSpec, resolve_mesh

__all__ = [
    "AdmissionSpec", "BatchingSpec", "ClusterSpec", "FaultsSpec",
    "MeshSpec", "RetriesSpec", "RunSpec", "SchedulerSpec",
    "TelemetrySpec", "TiersSpec", "WorkloadSpec", "run",
]


def _asdict_clean(obj) -> dict:
    """Sub-spec → dict with default-valued and handle fields dropped."""
    out = {}
    for f in dataclasses.fields(obj):
        if f.metadata.get("handle"):
            continue
        v = getattr(obj, f.name)
        default = (f.default if f.default is not dataclasses.MISSING
                   else None)
        if v != default:
            out[f.name] = v
    return out


@dataclasses.dataclass(frozen=True)
class SchedulerSpec:
    """Scheduling policy (``repro_torch.schedulers`` registry name or a
    constructed :class:`~repro_torch.schedulers.base.SchedulerPolicy`)."""
    name: Any = "odin"
    alpha: int = 10
    rel_threshold: Optional[float] = None
    initial_config: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.initial_config is not None:
            object.__setattr__(self, "initial_config",
                               tuple(int(c) for c in self.initial_config))


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Arrival process (``repro_torch.workloads`` registry name / instance)."""
    name: Any = "closed"
    kwargs: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class AdmissionSpec:
    """Admission policy (``repro_torch.control`` registry name / instance)."""
    name: Any = None
    kwargs: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class BatchingSpec:
    """Chunking, batched dispatch and length buckets
    (docs/WORKLOADS.md).  ``former`` is a pre-built
    :class:`~repro_torch.workloads.batching.BatchFormer` handle (the raw
    run-loop path); everything else is declarative."""
    mode: Any = None                   # None | "drain" | "continuous"
    max_batch: Optional[int] = None    # None = target's own default
    buckets: Any = None
    explore_in_batch: bool = False
    chunking: bool = True
    max_chunk: Optional[int] = None
    lengths: Any = None
    lengths_kwargs: Optional[dict] = None
    batch_overhead: float = 0.0
    length_ref: Optional[float] = None
    former: Any = dataclasses.field(default=None, compare=False,
                                    metadata={"handle": True})


@dataclasses.dataclass(frozen=True)
class FaultsSpec:
    """Fault injection + recovery routing (docs/FAULTS.md)."""
    plan: Any = None                   # FaultPlan | spec string | None
    hedge_after: Optional[float] = None
    health_kwargs: Optional[dict] = None
    when_all_unhealthy: str = "wait"


@dataclasses.dataclass(frozen=True)
class RetriesSpec:
    """Retry budget (``resolve_retries``: RetrySpec | int | dict)."""
    policy: Any = None


@dataclasses.dataclass(frozen=True)
class TiersSpec:
    """QoS tier stamping (``resolve_tiers``; docs/QOS.md)."""
    spec: Any = None
    kwargs: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class TelemetrySpec:
    """Trace surface selection (docs/TELEMETRY.md).  ``metrics_sink``
    is a live object (handle) — excluded from ``to_dict``."""
    trace_mode: str = "dense"
    sink_interval: Optional[int] = None
    metrics_sink: Any = dataclasses.field(default=None, compare=False,
                                          metadata={"handle": True})


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Fleet shape + routing (docs/CLUSTER.md).  ``databases`` is a
    per-replica :class:`~repro_torch.core.LayerDatabase` handle list
    (heterogeneous sim fleets)."""
    num_replicas: int = 1
    router: Any = "round_robin"
    router_kwargs: Optional[dict] = None
    autoscaler: Any = None
    autoscaler_kwargs: Optional[dict] = None
    max_batch: int = 1
    pools: Optional[Tuple[str, ...]] = None
    databases: Any = dataclasses.field(default=None, compare=False,
                                       metadata={"handle": True})

    def __post_init__(self):
        if self.pools is not None:
            object.__setattr__(self, "pools", tuple(self.pools))


_SUBSPECS = {
    "scheduler": SchedulerSpec,
    "workload": WorkloadSpec,
    "admission": AdmissionSpec,
    "batching": BatchingSpec,
    "faults": FaultsSpec,
    "retries": RetriesSpec,
    "tiers": TiersSpec,
    "telemetry": TelemetrySpec,
    "cluster": ClusterSpec,
}

#: RunSpec fields that are live objects, never serialized.
_HANDLES = ("db", "engine", "engines", "replicas", "executor", "runtime",
            "queries", "schedule")


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """One serving run, declaratively.  See the module docstring for
    dispatch rules and docs/API.md for the kwargs → spec migration
    table.  Sub-spec fields also accept plain dicts (coerced on
    construction), so ``RunSpec(db=db, scheduler={"name": "lls"})``
    round-trips through ``to_dict``/``from_dict`` unchanged."""

    # -- target handles (exactly one dispatch group) ----------------------
    db: Any = None                     # LayerDatabase → simulator
    engine: Any = None                 # ServingEngine → live serving
    engines: Any = None                # Sequence[ServingEngine] → fleet
    replicas: Any = None               # Sequence[Replica] → fleet driver
    executor: Any = None               # QueryExecutor → raw run loop
    runtime: Any = None                # RebalanceRuntime (with executor)
    queries: Any = None                # token arrays (live targets)
    schedule: Any = None               # slowdown schedule(s) (live)

    # -- run shape --------------------------------------------------------
    num_eps: int = 4
    num_queries: Optional[int] = None  # None = len(queries) (live)
    seed: int = 0
    peak_throughput: float = float("nan")   # raw run-loop reference

    # -- interference (simulator targets) ---------------------------------
    events: Any = None                 # Sequence[InterferenceEvent]|None
    freq_period: int = 10
    duration: int = 10
    events_time_indexed: bool = False

    # -- sub-specs --------------------------------------------------------
    scheduler: SchedulerSpec = SchedulerSpec()
    workload: WorkloadSpec = WorkloadSpec()
    admission: AdmissionSpec = AdmissionSpec()
    batching: BatchingSpec = BatchingSpec()
    faults: FaultsSpec = FaultsSpec()
    retries: RetriesSpec = RetriesSpec()
    tiers: TiersSpec = TiersSpec()
    telemetry: TelemetrySpec = TelemetrySpec()
    #: ``None`` = single-pipeline target.  Any :class:`ClusterSpec` —
    #: including ``num_replicas=1`` — selects the fleet drivers and a
    #: :class:`~repro_torch.cluster.ClusterTrace` result (an n=1 fleet is the
    #: bit-identical reduction, tests/test_cluster.py, but a *fleet*
    #: nonetheless).
    cluster: Optional[ClusterSpec] = None
    #: Mesh-sliced stages (docs/SHARDING.md): ``None`` (unsharded — the
    #: bit-identical default), a device count, a kwargs dict, or a
    #: :class:`~repro_torch.core.mesh.MeshSpec`.  Simulator targets only; live
    #: engines take their mesh at construction
    #: (``ServingEngine(mesh=...)``).
    mesh: Union[None, int, dict, MeshSpec] = None

    def __post_init__(self):
        for name, cls in _SUBSPECS.items():
            v = getattr(self, name)
            if v is None and name == "cluster":
                continue
            if isinstance(v, dict):
                object.__setattr__(self, name, cls(**v))
            elif not isinstance(v, cls):
                raise TypeError(f"RunSpec.{name} must be a {cls.__name__}"
                                f" or a dict, got {type(v).__name__}")
        object.__setattr__(self, "mesh", resolve_mesh(self.mesh))
        if self.events is not None:
            object.__setattr__(self, "events", tuple(
                ev if isinstance(ev, InterferenceEvent)
                else InterferenceEvent(**ev)
                for ev in self.events))

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-ready dict of every non-handle, non-default field.
        Handles (``db``, ``engine``, ``queries``, sinks, formers, ...)
        are dropped — re-supply them to :meth:`from_dict`."""
        out: dict = {}
        for f in dataclasses.fields(self):
            if f.name in _HANDLES:
                continue
            v = getattr(self, f.name)
            if f.name in _SUBSPECS:
                if v is None:
                    continue
                d = _asdict_clean(v)
                if d or f.name == "cluster":
                    out[f.name] = d
            elif f.name == "mesh":
                if v is not None:
                    out["mesh"] = v.to_dict()
            elif f.name == "events":
                if v is not None:
                    out["events"] = [dataclasses.asdict(ev) for ev in v]
            elif f.name == "peak_throughput":
                if v == v:          # NaN-safe default check
                    out[f.name] = v
            elif v != f.default:
                out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: dict, **handles) -> "RunSpec":
        """Rebuild a spec from :meth:`to_dict` output; keyword
        arguments re-attach the live handles (``db=...``,
        ``engine=...``, ``queries=...``, ...)."""
        return cls(**{**d, **handles})

    def replace(self, **changes) -> "RunSpec":
        """Functional update (``dataclasses.replace``)."""
        return dataclasses.replace(self, **changes)


def _count(spec: RunSpec) -> int:
    if spec.num_queries is not None:
        return int(spec.num_queries)
    if spec.queries is not None:
        return len(spec.queries)
    raise ValueError("RunSpec needs num_queries (or queries to count)")


def run(spec: RunSpec):
    """Execute one :class:`RunSpec`; returns the target's trace surface
    (:class:`~repro_torch.workloads.PipelineTrace`,
    :class:`~repro_torch.cluster.ClusterTrace` or a streaming variant).
    Imports lazily so declaring specs never pulls in JAX."""
    if not isinstance(spec, RunSpec):
        raise TypeError(f"run() takes a RunSpec, got "
                        f"{type(spec).__name__}")
    sch, wl, adm = spec.scheduler, spec.workload, spec.admission
    bat, tel, cl = spec.batching, spec.telemetry, spec.cluster
    common = dict(workload=wl.name, workload_kwargs=wl.kwargs,
                  admission=adm.name, admission_kwargs=adm.kwargs,
                  trace_mode=tel.trace_mode,
                  metrics_sink=tel.metrics_sink,
                  sink_interval=tel.sink_interval,
                  faults=spec.faults.plan, retries=spec.retries.policy,
                  tiers=spec.tiers.spec, tiers_kwargs=spec.tiers.kwargs)

    if spec.db is not None:
        if cl is not None:
            if spec.mesh is not None:
                raise NotImplementedError(
                    "mesh-sliced stages are single-pipeline this "
                    "release (ROADMAP: cluster mesh)")
            _fleet_not_ported("a db target with a ClusterSpec")
        from repro_torch.core.simulator import _simulate_impl
        if spec.faults.hedge_after is not None:
            raise ValueError("hedging needs a fleet target "
                             "(set RunSpec.cluster)")
        return _simulate_impl(
            spec.db, spec.num_eps, scheduler=sch.name, alpha=sch.alpha,
            rel_threshold=sch.rel_threshold,
            initial_config=(list(sch.initial_config)
                            if sch.initial_config is not None
                            else None),
            num_queries=_count(spec), freq_period=spec.freq_period,
            duration=spec.duration, seed=spec.seed, events=spec.events,
            events_time_indexed=spec.events_time_indexed,
            chunking=bat.chunking, max_chunk=bat.max_chunk,
            batching=bat.mode,
            max_batch=(8 if bat.max_batch is None else bat.max_batch),
            buckets=bat.buckets, explore_in_batch=bat.explore_in_batch,
            lengths=bat.lengths, lengths_kwargs=bat.lengths_kwargs,
            batch_overhead=bat.batch_overhead,
            length_ref=bat.length_ref, mesh=spec.mesh, **common)

    if spec.mesh is not None:
        raise ValueError("RunSpec.mesh configures simulator targets; "
                         "live engines take their mesh at construction "
                         "(ServingEngine(mesh=...), docs/SHARDING.md)")

    if spec.replicas is not None:
        if spec.faults.plan is not None:
            raise ValueError("with a replicas target, fault plans are "
                             "attached per-Replica (Replica(faults=...)),"
                             " not on the RunSpec")
        _fleet_not_ported("a replicas target")

    if spec.engines is not None:
        _fleet_not_ported("an engines target")

    if spec.engine is not None:
        for bad, msg in ((spec.faults.hedge_after, "hedging"),
                         (cl, "a ClusterSpec")):
            if bad is not None:
                raise ValueError(f"{msg} needs a fleet target "
                                 "(engines=..., not engine=...)")
        return spec.engine._serve_impl(
            spec.queries, spec.schedule,
            max_batch=(1 if bat.max_batch is None else bat.max_batch),
            batching=bat.mode, buckets=bat.buckets,
            explore_in_batch=bat.explore_in_batch, **common)

    if spec.executor is not None and spec.runtime is not None:
        from repro_torch.workloads.runner import _run_pipeline_impl
        return _run_pipeline_impl(
            spec.executor, spec.runtime, _count(spec),
            scheduler_name=_name_of(sch.name),
            peak_throughput=spec.peak_throughput,
            chunking=bat.chunking, max_chunk=bat.max_chunk,
            former=bat.former, lengths=bat.lengths,
            lengths_kwargs=bat.lengths_kwargs, **common)

    raise ValueError(
        "RunSpec names no target: set db (simulate), engine/engines "
        "(live), replicas (fleet driver), or executor + runtime "
        "(raw run loop)")


def _fleet_not_ported(target: str) -> None:
    raise NotImplementedError(
        f"{target} needs the fleet drivers, which the port has not copied "
        f"yet (ROADMAP.md Queue 1 item 6f)")


def _name_of(scheduler) -> str:
    """Trace label for the scheduler field of handle-target specs."""
    if isinstance(scheduler, str):
        return scheduler
    return getattr(scheduler, "name", type(scheduler).__name__)
