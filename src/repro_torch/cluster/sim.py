"""Database-simulator fleet backend: ``simulate_cluster``.

The cluster analogue of :func:`repro_torch.core.simulator.simulate`: every
replica gets its own :class:`DatabaseQueryExecutor` (its *own* view of
the fleet event list — replica-scoped events via
``InterferenceEvent.replica`` — and its own scenario state), its own
scheduler policy + :class:`RebalanceRuntime`, and the shared DP-oracle
cache for resource-constrained references.  Replica-scoped interference
is therefore a first-class scenario: an event with ``replica=2`` hits
replica 2's pipeline and nothing else, and the router's job is to see
it (via replica 2's detector) and steer the fleet around it.

Event anchoring: query-indexed events count each *replica's local*
queries (natural for closed-loop fleets); ``events_time_indexed=True``
anchors the windows on the fleet arrival clock instead — the stressor
runs wall-clock intervals, replicas serving different query counts see
the same episode — which requires an open-loop workload.

The port's copy of the JAX package's ``cluster/sim.py``; only import
paths differ.  ``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

from repro_torch.cluster.cluster import Replica, _run_cluster_impl
from repro_torch.cluster.trace import ClusterTrace
from repro_torch.core.database import LayerDatabase
from repro_torch.core.events import InterferenceEvent, events_for_replica
from repro_torch.core.exhaustive import optimal_partition
from repro_torch.core.pipeline_state import balanced_config, throughput
from repro_torch.core.simulator import DatabaseQueryExecutor, SimTimeSource
from repro_torch.schedulers.registry import make_scheduler
from repro_torch.schedulers.runtime import RebalanceRuntime
from repro_torch.workloads.base import Workload
from repro_torch.workloads.runner import resolve_workload


def _simulate_cluster_impl(db: LayerDatabase,
                     num_eps: int,
                     num_replicas: int,
                     scheduler: str = "odin",
                     router: Union[str, object, None] = "round_robin",
                     alpha: int = 10,
                     num_queries: int = 4000,
                     events: Optional[Sequence[InterferenceEvent]] = None,
                     rel_threshold: Optional[float] = None,
                     initial_config: Optional[List[int]] = None,
                     workload: Union[str, Workload, None] = "closed",
                     workload_kwargs: Optional[dict] = None,
                     events_time_indexed: bool = False,
                     router_kwargs: Optional[dict] = None,
                     admission: Union[str, object, None] = None,
                     admission_kwargs: Optional[dict] = None,
                     autoscaler: Union[str, object, None] = None,
                     autoscaler_kwargs: Optional[dict] = None,
                     max_batch: int = 1,
                     trace_mode: str = "dense",
                     metrics_sink=None,
                     sink_interval: Optional[int] = None,
                     faults=None,
                     retries=None,
                     hedge_after: Optional[float] = None,
                     health_kwargs: Optional[dict] = None,
                     when_all_unhealthy: str = "wait",
                     databases: Optional[Sequence[LayerDatabase]] = None,
                     pools: Optional[Sequence[str]] = None,
                     tiers=None,
                     tiers_kwargs: Optional[dict] = None
                     ) -> ClusterTrace:
    """Run one (scheduler, router, workload, events) fleet simulation.

    ``events`` is the *fleet* event list: each
    :class:`InterferenceEvent` hits one replica
    (``replica=<index>``) or all of them (``replica=None``); default —
    no interference, the routing-baseline setting.  ``scheduler`` is a
    registry name constructed *per replica* (each replica needs its own
    detector/explorer state).  The DP-oracle cache is shared across
    replicas (one database); the clean-optimum starting configuration
    and its peak throughput are computed once and stamped on every
    replica, exactly as :func:`~repro_torch.core.simulator.simulate` does for
    a single pipeline.

    ``admission`` / ``autoscaler`` select the fleet's SLO control plane
    (:mod:`repro_torch.control`, docs/CONTROL.md): e.g.
    ``admission="slo_shed", admission_kwargs={"slo": ...}`` sheds
    arrivals no replica could serve within the SLO, and
    ``autoscaler="load_profile"`` activates/drains replicas off the
    rolling offered load.  Defaults leave both off (bit-identical to
    the pre-control-plane fleet).

    ``max_batch > 1`` opts into fleet rebatching (docs/CLUSTER.md):
    same-replica routing streaks of open-loop arrivals flush through
    the replica's vectorized ``step_many`` instead of query-by-query
    steps.  Default 1 is the exact per-query path.

    ``faults`` injects deterministic failures (docs/FAULTS.md): a
    :class:`~repro_torch.faults.FaultPlan`, a spec string such as
    ``"crash@100+50:r=1"``, or a list of either; each replica's
    executor is wrapped with its slice of the plan
    (``FaultEvent.replica`` targets one replica, ``None`` all).
    ``retries`` / ``hedge_after`` / ``health_kwargs`` /
    ``when_all_unhealthy`` configure the fleet's recovery machinery
    (retry budget + backoff, tail-latency hedging, circuit-breaker
    routing).  All default off — bit-identical to a fault-free build.

    Heterogeneous fleets (docs/QOS.md): ``databases`` gives replica
    ``r`` its own :class:`LayerDatabase` (cost model) — each distinct
    database gets its own clean-optimum starting configuration, peak
    throughput and DP-oracle cache, so a fleet can mix full-model and
    small-model replicas.  ``pools`` labels replicas for pool-aware
    routers (``"small"`` marks downgrade targets).  ``tiers`` /
    ``tiers_kwargs`` arm QoS tier stamping over the fleet arrivals
    (:func:`repro_torch.qos.resolve_tiers` forms); all default off.
    """
    if num_replicas < 1:
        raise ValueError("num_replicas must be >= 1")
    if databases is not None:
        databases = list(databases)
        if len(databases) != num_replicas:
            raise ValueError(f"databases must give one LayerDatabase per "
                             f"replica: got {len(databases)} for "
                             f"{num_replicas} replicas")
    else:
        databases = [db] * num_replicas
    if pools is not None:
        pools = [str(p) for p in pools]
        if len(pools) != num_replicas:
            raise ValueError(f"pools must label every replica: got "
                             f"{len(pools)} for {num_replicas} replicas")
    else:
        pools = ["default"] * num_replicas
    plan = None
    if faults is not None:
        from repro_torch.faults import resolve_faults
        plan = resolve_faults(faults, time_indexed=events_time_indexed)
    fleet_events = list(events) if events is not None else []
    # A time-indexed fault plan anchors its windows on the arrival
    # clock, exactly like time-indexed interference events — both need
    # the per-replica arrival feed (and an open-loop workload).
    time_anchored = events_time_indexed or (plan is not None
                                            and plan.time_indexed)
    if time_anchored:
        # Resolve once so the misuse fails here with the same clear
        # error the single-pipeline path gives, not deep in the
        # timeline on the first routed query.
        wl = resolve_workload(workload, workload_kwargs)
        if not wl.open_loop:
            raise ValueError(
                "time-indexed interference events need an open-loop "
                "workload: a closed loop has no arrival clock to anchor "
                "the event windows on")
        workload, workload_kwargs = wl, None

    # One oracle cache + clean-optimum reference *per distinct
    # database*: the optimum only depends on the scenario vector and
    # the database, so homogeneous fleets share everything exactly as
    # before, while a heterogeneous fleet's small-model replicas get
    # their own configurations and peaks.
    per_db: dict = {}

    def _db_state(d: LayerDatabase):
        key = id(d)
        if key not in per_db:
            cfg = (list(initial_config) if initial_config is not None
                   else balanced_config(d.num_layers, num_eps))
            clean = SimTimeSource(d, [0] * num_eps)
            if initial_config is None:
                cfg, _ = optimal_partition(d, [0] * num_eps, num_eps)
            cache: dict = {}

            def _oracle(scen_key, _d=d, _cache=cache):
                if scen_key not in _cache:
                    _cache[scen_key] = optimal_partition(
                        _d, list(scen_key), num_eps)
                return _cache[scen_key]

            per_db[key] = (cfg, throughput(clean.stage_times(cfg)),
                           _oracle)
        return per_db[key]

    replicas = []
    for r in range(num_replicas):
        rdb = databases[r]
        config0, peak, _oracle = _db_state(rdb)
        executor = DatabaseQueryExecutor(
            rdb, num_eps, events_for_replica(fleet_events, r), _oracle,
            time_indexed=events_time_indexed)
        if plan is not None:
            from repro_torch.faults import FaultingExecutor
            from repro_torch.faults.retry import resolve_retries
            spec = resolve_retries(retries)
            executor = FaultingExecutor(
                executor, plan, replica=r,
                timeout=(spec.timeout if spec is not None else None))

        def solver(cfg, src, _ex=executor, _oracle=_oracle) -> List[int]:
            return list(_oracle(tuple(_ex.scenarios))[0])

        policy = make_scheduler(scheduler, alpha=alpha,
                                rel_threshold=rel_threshold, solver=solver)
        runtime = RebalanceRuntime(policy, config0)

        on_assign = None
        if time_anchored:
            clock: List[Optional[float]] = []
            executor.set_arrivals(clock)

            def on_assign(fq, lq, arrival, _clock=clock):
                # Keyed on the local index, not appended: a failed
                # dispatch serves no row, so a retry re-assigns the
                # same slot (docs/FAULTS.md) and must overwrite it.
                if lq < len(_clock):
                    _clock[lq] = arrival
                else:
                    _clock.extend([arrival] * (lq + 1 - len(_clock)))

        replicas.append(Replica(executor=executor, runtime=runtime,
                                peak_throughput=peak,
                                pool=pools[r],
                                on_assign=on_assign))

    return _run_cluster_impl(replicas, num_queries, workload=workload,
                       workload_kwargs=workload_kwargs, router=router,
                       router_kwargs=router_kwargs,
                       scheduler_name=scheduler,
                       admission=admission,
                       admission_kwargs=admission_kwargs,
                       autoscaler=autoscaler,
                       autoscaler_kwargs=autoscaler_kwargs,
                       max_batch=max_batch,
                       trace_mode=trace_mode, metrics_sink=metrics_sink,
                       sink_interval=sink_interval,
                       retries=retries, hedge_after=hedge_after,
                       health_kwargs=health_kwargs,
                       when_all_unhealthy=when_all_unhealthy,
                       tiers=tiers, tiers_kwargs=tiers_kwargs)


def simulate_cluster(db: LayerDatabase,
                     num_eps: int,
                     num_replicas: int,
                     scheduler: str = "odin",
                     router: Union[str, object, None] = "round_robin",
                     alpha: int = 10,
                     num_queries: int = 4000,
                     events: Optional[Sequence[InterferenceEvent]] = None,
                     rel_threshold: Optional[float] = None,
                     initial_config: Optional[List[int]] = None,
                     workload: Union[str, Workload, None] = "closed",
                     workload_kwargs: Optional[dict] = None,
                     events_time_indexed: bool = False,
                     router_kwargs: Optional[dict] = None,
                     admission: Union[str, object, None] = None,
                     admission_kwargs: Optional[dict] = None,
                     autoscaler: Union[str, object, None] = None,
                     autoscaler_kwargs: Optional[dict] = None,
                     max_batch: int = 1,
                     trace_mode: str = "dense",
                     metrics_sink=None,
                     sink_interval: Optional[int] = None,
                     faults=None,
                     retries=None,
                     hedge_after: Optional[float] = None,
                     health_kwargs: Optional[dict] = None,
                     when_all_unhealthy: str = "wait",
                     databases: Optional[Sequence[LayerDatabase]] = None,
                     pools: Optional[Sequence[str]] = None,
                     tiers=None,
                     tiers_kwargs: Optional[dict] = None
                     ) -> ClusterTrace:
    """Run one (scheduler, router, workload, events) fleet simulation.

    Thin wrapper over the unified :class:`repro_torch.api.RunSpec` path (one
    declaration, one dispatcher — docs/API.md); the kwargs here map
    1:1 onto spec fields and new options land on the spec instead of
    this signature.  See :func:`_simulate_cluster_impl` for the full
    kwarg-level documentation.
    """
    from repro_torch import api
    spec = api.RunSpec(
        db=db, num_eps=num_eps, num_queries=num_queries,
        events=events, events_time_indexed=events_time_indexed,
        scheduler=api.SchedulerSpec(name=scheduler, alpha=alpha,
                                    rel_threshold=rel_threshold,
                                    initial_config=initial_config),
        workload=api.WorkloadSpec(name=workload, kwargs=workload_kwargs),
        admission=api.AdmissionSpec(name=admission,
                                    kwargs=admission_kwargs),
        faults=api.FaultsSpec(plan=faults, hedge_after=hedge_after,
                              health_kwargs=health_kwargs,
                              when_all_unhealthy=when_all_unhealthy),
        retries=api.RetriesSpec(policy=retries),
        tiers=api.TiersSpec(spec=tiers, kwargs=tiers_kwargs),
        telemetry=api.TelemetrySpec(trace_mode=trace_mode,
                                    metrics_sink=metrics_sink,
                                    sink_interval=sink_interval),
        cluster=api.ClusterSpec(num_replicas=num_replicas,
                                router=router,
                                router_kwargs=router_kwargs,
                                autoscaler=autoscaler,
                                autoscaler_kwargs=autoscaler_kwargs,
                                max_batch=max_batch,
                                pools=(tuple(pools) if pools is not None
                                       else None),
                                databases=databases))
    return api.run(spec)
