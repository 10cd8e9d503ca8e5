"""Live-engine fleet backend: ``serve_cluster``.

Serves a fleet of :class:`~repro_torch.serving.ServingEngine` replicas —
real PyTorch execution, measured wall-clock stage times, per-replica
EMA estimates and EMA/hysteresis detectors — behind one routed arrival
queue.  Each engine keeps its own scheduler runtime and online
block-time estimates (that *is* the replica's identity); the
pipeline executor can be shared across engines
(``ServingEngine(..., executor=shared)``) since replicas serve the
same model.

Replica-scoped interference is injected exactly like single-engine
serving: one slowdown schedule per replica
(``schedules[r](local_q) -> per-EP factors``), so "interference hits
only replica 2" is simply a schedule that slows replica 2's EPs while
the others return all-ones.

Queries execute sequentially on this host (the replicas emulate a
fleet the way the single engine emulates co-located tenants), but the
arrival/queueing ledger is per replica in the workload's wall-clock
units — the same convention ``ServingEngine.serve`` uses for open-loop
runs.

The port's copy of the JAX package's ``cluster/live.py``; only import
paths and docstrings differ (the engines run PyTorch on the card).
``tests/test_torch_fleet.py`` holds it equal to the original.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

from repro_torch.cluster.cluster import Replica, _run_cluster_impl
from repro_torch.cluster.trace import ClusterTrace
from repro_torch.workloads.base import Workload


def _serve_cluster_impl(engines: Sequence,
                  queries: Sequence,
                  schedules: Union[Callable, Sequence[Callable]],
                  workload: Union[str, Workload, None] = "closed",
                  workload_kwargs: Optional[dict] = None,
                  router: Union[str, object, None] = "round_robin",
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
                  pools: Optional[Sequence[str]] = None,
                  tiers=None,
                  tiers_kwargs: Optional[dict] = None) -> ClusterTrace:
    """Serve fleet ``queries`` through N live engines behind a router.

    ``engines`` — one :class:`~repro_torch.serving.ServingEngine` per
    replica (each owns its runtime/detector/estimates).  ``schedules``
    — per-replica slowdown schedule ``(local_q) -> per-EP factors``, or
    one callable applied to every replica.  The returned trace's
    per-replica peak references are stamped from each engine's online
    clean estimates after the run (NaN for replicas that never served
    a query).

    ``admission`` / ``autoscaler`` select the SLO control plane
    (:mod:`repro_torch.control`, docs/CONTROL.md), identically to
    :func:`~repro_torch.cluster.simulate_cluster` — SLOs are in wall-clock
    seconds here.  Shed queries never touch an engine.

    ``max_batch > 1`` opts into fleet rebatching (docs/CLUSTER.md):
    same-replica routing streaks of open-loop arrivals stack through
    each engine's ``run_batch`` (one set of stage dispatches per
    streak) instead of executing query-by-query.

    ``faults`` / ``retries`` / ``hedge_after`` / ``health_kwargs`` /
    ``when_all_unhealthy`` arm the fleet's fault machinery
    (docs/FAULTS.md): each engine's executor is wrapped with its slice
    of the fault plan, failed dispatches are retried with backoff
    across healthy replicas, and a recovering replica re-warms its
    dispatch shapes (``warm_buckets``) off the timed path before its
    half-open probe.  All default off — fault-free serving is
    unchanged.

    Heterogeneous fleets (docs/QOS.md): ``engines`` may wrap distinct
    :class:`~repro_torch.models.PipelineModel` builds (each engine keeps its
    own executor and warmed-shape caches; all models must accept
    the shared ``queries`` token arrays).  ``pools`` labels replicas
    for pool-aware routers (``"small"`` marks downgrade targets), and
    ``tiers`` / ``tiers_kwargs`` arm QoS tier stamping over the fleet
    arrivals — the stamping runs in the shared fleet loop, so a sim run
    with the same seed sees the identical tier sequence.
    """
    if len(engines) < 1:
        raise ValueError("serve_cluster needs at least one engine")
    if pools is not None:
        pools = [str(p) for p in pools]
        if len(pools) != len(engines):
            raise ValueError(f"pools must label every replica: got "
                             f"{len(pools)} for {len(engines)} engines")
    else:
        pools = ["default"] * len(engines)
    if callable(schedules):
        schedules = [schedules] * len(engines)
    if len(schedules) != len(engines):
        raise ValueError(f"{len(engines)} engines but "
                         f"{len(schedules)} slowdown schedules")
    plan = None
    if faults is not None:
        from repro_torch.faults import resolve_faults
        plan = resolve_faults(faults, time_indexed=True)

    replicas = []
    for r, (eng, schedule) in enumerate(zip(engines, schedules)):
        local_queries: List = []
        executor = eng.query_executor(local_queries, schedule,
                                      max_batch=max_batch)
        clock: List[Optional[float]] = []
        if plan is not None:
            from repro_torch.faults import FaultingExecutor
            from repro_torch.faults.retry import resolve_retries
            spec = resolve_retries(retries)
            executor = FaultingExecutor(
                executor, plan, replica=r,
                timeout=(spec.timeout if spec is not None else None))
            # Fault windows anchor on the workload's arrival clock;
            # the per-replica feed is maintained by on_assign below.
            executor.set_arrivals(clock)

        def on_assign(fleet_q, local_q, arrival, _lq=local_queries,
                      _clock=clock):
            # Keyed on the local index, not appended: a failed
            # dispatch serves no row, so a retry re-assigns the same
            # slot (docs/FAULTS.md) and must overwrite it.
            if local_q < len(_lq):
                _lq[local_q] = queries[fleet_q]
                _clock[local_q] = arrival
            else:
                pad = local_q + 1 - len(_lq)
                _lq.extend([queries[fleet_q]] * pad)
                _clock.extend([arrival] * pad)

        def on_recover(now, _eng=eng, _lq=local_queries):
            # Cold restart: re-warm the engine's dispatch shapes off
            # the timed path before the half-open probe takes traffic.
            seqs = sorted({int(t.shape[-1]) for t in _lq}) or [1]
            _eng.executor.warm_buckets(seqs, max_batch)

        replicas.append(Replica(executor=executor, runtime=eng.runtime,
                                pool=pools[r],
                                on_assign=on_assign,
                                on_recover=on_recover))

    trace = _run_cluster_impl(replicas, len(queries), workload=workload,
                        workload_kwargs=workload_kwargs, router=router,
                        router_kwargs=router_kwargs,
                        scheduler_name=getattr(engines[0], "scheduler", ""),
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
    # Peak references only exist after measurement — stamp post-hoc,
    # exactly like ServingEngine.serve does for a single pipeline.
    for rep_trace, eng in zip(trace.replicas, engines):
        rep_trace.peak_throughput = eng.estimated_peak_throughput()
    return trace


def serve_cluster(engines: Sequence,
                  queries: Sequence,
                  schedules: Union[Callable, Sequence[Callable]],
                  workload: Union[str, Workload, None] = "closed",
                  workload_kwargs: Optional[dict] = None,
                  router: Union[str, object, None] = "round_robin",
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
                  pools: Optional[Sequence[str]] = None,
                  tiers=None,
                  tiers_kwargs: Optional[dict] = None) -> ClusterTrace:
    """Serve fleet ``queries`` through N live engines behind a router.

    Thin wrapper over the unified :class:`repro_torch.api.RunSpec` path (one
    declaration, one dispatcher — docs/API.md); the kwargs here map
    1:1 onto spec fields and new options land on the spec instead of
    this signature.  See :func:`_serve_cluster_impl` for the full
    kwarg-level documentation.
    """
    from repro_torch import api
    spec = api.RunSpec(
        engines=engines, queries=queries, schedule=schedules,
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
        cluster=api.ClusterSpec(num_replicas=len(engines),
                                router=router,
                                router_kwargs=router_kwargs,
                                autoscaler=autoscaler,
                                autoscaler_kwargs=autoscaler_kwargs,
                                max_batch=max_batch,
                                pools=(tuple(pools) if pools is not None
                                       else None)))
    return api.run(spec)
