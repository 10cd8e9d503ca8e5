"""chip_smoke.py's phase 12d on the host: its fleet loop (the plan, the
router and the serve_cluster options of ``chip_smoke.fault_window``) over
stand-in replicas whose service times jitter, and its checks
(``chip_smoke.fault_checks``).  Whatever the service times, replica 0
gets a dispatch of a query that arrived inside its crash window (which
fails on the crash), its breaker opens and is probed after the window,
in both runs (retries 3, then 0).  Nothing here needs
a card; no card phase of chip_smoke runs."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.cluster import cluster as cluster_lib  # noqa: E402
from repro_torch.cluster import serve_cluster  # noqa: E402
from repro_torch.faults.health import HealthTracker  # noqa: E402
from repro_torch.schedulers import make_scheduler  # noqa: E402
from repro_torch.schedulers.runtime import RebalanceRuntime  # noqa: E402
from repro_torch.workloads import QueryRecord  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

#: A probe's service latency (s), about a full-width qwen3-4b query's on
#: the card; the fleet rate is R = FLEET_REPLICAS / SERVICE.
SERVICE = 0.07


class JitterExecutor:
    """A replica's query executor: each dispatch takes SERVICE times a
    factor drawn uniformly from [0.5, 1.5), on the host's virtual clock."""

    def __init__(self, rng):
        self.rng = rng

    def begin_query(self, q):
        return None

    def execute(self, q, step):
        t = SERVICE * float(self.rng.uniform(0.5, 1.5))
        return QueryRecord(service_latency=t, throughput=1.0 / t)


class Warm:
    """The replicas' shared executor: counts ``on_recover``'s re-warms."""

    def __init__(self):
        self.calls = 0

    def warm_buckets(self, seqs, rows):
        self.calls += 1


class StandInEngine:
    scheduler = "none"

    def __init__(self, rng, executor):
        self.rng, self.executor = rng, executor
        self.runtime = RebalanceRuntime(make_scheduler("none"), [1] * 4)

    def query_executor(self, queries, schedule, max_batch=1):
        return JitterExecutor(self.rng)

    def estimated_peak_throughput(self):
        return float("nan")


@pytest.mark.parametrize("seed", range(5))
def test_fault_window_opens_and_probes_replica_0s_breaker(seed, monkeypatch):
    rate = cs.FAULT_LOAD * cs.FLEET_REPLICAS / SERVICE
    n = cs.FAULT_QUERIES
    win = cs.fault_window(rate, SERVICE, n)
    assert win["kwargs"]["router"] == "round_robin"
    queries = [np.zeros((1, 8), dtype=np.int64)] * n
    monkeypatch.setattr(cluster_lib, "HealthTracker", cs.ProbeCounter)
    rng = np.random.default_rng(seed)
    runs = {}
    for retries in (cs.FAULT_RETRIES, 0):
        cs.ProbeCounter.made.clear()
        warm = Warm()
        engines = [StandInEngine(rng, warm) for _ in range(cs.FLEET_REPLICAS)]
        trace = serve_cluster(engines, queries,
                              cs.fleet_schedules(cs.FLEET_REPLICAS),
                              retries=retries, **win["kwargs"])
        (tracker,) = cs.ProbeCounter.made
        s = trace.summary()
        checks, readings = cs.fault_checks(trace, s, tracker, warm.calls,
                                           win["start"], win["dur"])
        assert all(checks.values()), (retries, checks, tracker.opens,
                                      tracker.probes, readings)
        # Replica 0 took at least one query that arrived inside its
        # window, and that dispatch failed on the crash (which reports
        # the window's end as its recovery time).
        crashed = tracker.crash_untils[0]
        assert readings[3] == len(crashed) >= 1
        assert all(u == pytest.approx(win["start"] + win["dur"])
                   for u in crashed)
        assert tracker.opens[0] >= 1 and tracker.probes[0] >= 1
        runs[retries] = s["availability"]
    assert cs.availability_holds(runs[cs.FAULT_RETRIES], runs[0]), runs
    assert cluster_lib.HealthTracker is cs.ProbeCounter
    assert issubclass(cs.ProbeCounter, HealthTracker)
