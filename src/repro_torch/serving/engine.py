"""Live serving engine: scheduler policies against *measured* stage times.

The port's counterpart of the JAX package's ``serving/engine.py`` for the
closed-loop workload: each query runs for real through the
:class:`~repro_torch.pipeline.executor.LocalPipelineExecutor`, its stage
times are measured, an EMA of per-block times feeds a
:class:`~repro_torch.pipeline.executor.MeasuredTimeSource`, and the
detect → explore → commit machine
:class:`~repro_torch.schedulers.runtime.RebalanceRuntime` picks the
configuration of the next query.  Interference is injected as per-EP
slowdown factors that stretch the measured stage times.

The run loop is the engine's own small closed loop (the JAX engine drives
the shared ``repro.workloads`` loop, whose open-loop, batching, admission,
fault and tier paths wait for later slices of the port).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pipeline_state import balanced_config, throughput
from repro_torch.pipeline.executor import (
    LocalPipelineExecutor,
    MeasuredTimeSource,
)
from repro_torch.schedulers.defaults import (
    DEFAULT_ALPHA,
    MEASURED_DETECTOR_MODE,
)
from repro_torch.schedulers.policies import make_scheduler
from repro_torch.schedulers.runtime import RebalanceRuntime


@dataclasses.dataclass
class ServeTrace:
    """Per-query record of one closed-loop serving run.

    ``summary()`` reports a subset of the JAX package's
    ``PipelineTrace.summary()`` keys, under the same names and meanings.
    In a closed loop a query arrives when the pipeline can take it, so it
    never queues: latency equals service latency.
    """

    scheduler: str
    latencies: np.ndarray          # seconds, per query
    throughputs: np.ndarray        # 1 / bottleneck stage time, per query
    serial_mask: np.ndarray        # True = exploration-trial query
    configs: List[List[int]]       # stage config each query ran with
    num_rebalances: int
    total_trials: int
    mitigation_lengths: List[int]
    peak_throughput: float = float("nan")

    @property
    def service_latencies(self) -> np.ndarray:
        return self.latencies

    def summary(self) -> Dict[str, float]:
        n = len(self.latencies)
        nan = float("nan")
        return {
            "mean_latency_s": float(self.latencies.mean()) if n else nan,
            "p50_latency_s": (float(np.percentile(self.latencies, 50))
                              if n else nan),
            "p99_latency_s": (float(np.percentile(self.latencies, 99))
                              if n else nan),
            "mean_service_latency_s": (float(self.service_latencies.mean())
                                       if n else nan),
            "mean_throughput_qps": (float(self.throughputs.mean())
                                    if n else nan),
            "peak_throughput_qps": float(self.peak_throughput),
            "rebalances": self.num_rebalances,
            "serial_frac": float(np.mean(self.serial_mask)) if n else nan,
        }


# Weight of the newest measurement in the per-block clean-time EMA.
ESTIMATE_BETA = 0.5


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: Dict, num_eps: int,
                 scheduler: str = "odin", alpha: int = DEFAULT_ALPHA,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.executor = LocalPipelineExecutor(cfg, params, device)
        self.num_eps = num_eps
        self.scheduler = scheduler
        self.policy = make_scheduler(scheduler, alpha=alpha,
                                     detector=MEASURED_DETECTOR_MODE)
        self._initial_config = balanced_config(cfg.num_blocks, num_eps)
        self.runtime = RebalanceRuntime(self.policy, self._initial_config)
        # EMA of measured per-block times feeds the scheduler's trial
        # evaluations between real executions.
        self._block_times: Optional[np.ndarray] = None

    def _measured_source(self, slowdowns) -> MeasuredTimeSource:
        """The scheduler's time source over the current estimates."""
        return MeasuredTimeSource(self._block_times, slowdowns)

    @property
    def config(self) -> List[int]:
        """Current committed stage configuration."""
        return list(self.runtime.config)

    def reset_policy(self) -> None:
        """Fresh serving window: abandon any in-flight phase, re-arm
        detection, and restart from the balanced initial configuration.
        Block-time estimates are kept (they describe the model)."""
        self.runtime.reset(self._initial_config)

    def estimated_peak_throughput(self) -> float:
        """Interference-free throughput of the starting configuration from
        the clean per-block estimates; NaN until a query was measured."""
        if self._block_times is None:
            return float("nan")
        clean = MeasuredTimeSource(self._block_times, np.ones(self.num_eps))
        return throughput(clean.stage_times(self._initial_config))

    def _update_block_estimates(self, config: Sequence[int],
                                stage_times: np.ndarray,
                                slowdowns: Sequence[float]) -> None:
        """Refresh per-block clean-time estimates from a measured query:
        each stage's de-slowed per-block time spread over its blocks, one
        fused EMA update.  The first measurement seeds the estimates."""
        counts = np.asarray(config, dtype=np.int64)
        per_stage = (np.asarray(stage_times, float)
                     / np.maximum(np.asarray(slowdowns, float), 1e-9)
                     / np.maximum(counts, 1))
        per_block = np.repeat(per_stage, counts)
        if self._block_times is None:
            self._block_times = per_block.copy()
            return
        b = ESTIMATE_BETA
        self._block_times[:] = (1.0 - b) * self._block_times + b * per_block

    def query_executor(self, queries: Sequence[torch.Tensor],
                       slowdown_schedule) -> "_LiveQueryExecutor":
        """This engine's per-query executor half (begin, then execute)."""
        return _LiveQueryExecutor(self, queries, slowdown_schedule)

    def serve(self, queries: Sequence[torch.Tensor],
              slowdown_schedule) -> ServeTrace:
        """Serve ``queries`` back to back (closed loop) under
        ``slowdown_schedule(q) -> per-EP slowdown factors (>= 1.0)``."""
        live = self.query_executor(queries, slowdown_schedule)
        rt = self.runtime
        rebalances0, trials0 = rt.num_rebalances, rt.total_trials
        mitigations0 = len(rt.mitigation_lengths)
        n = len(queries)
        latencies, thr = np.zeros(n), np.zeros(n)
        serial = np.zeros(n, dtype=bool)
        configs = []
        for q in range(n):
            source = live.begin_query(q)
            step = rt.poll(source) if source is not None else rt.steady_step()
            latencies[q], thr[q] = live.execute(q, step.config)
            serial[q] = step.serial
            configs.append(list(step.config))
        return ServeTrace(
            scheduler=self.scheduler, latencies=latencies, throughputs=thr,
            serial_mask=serial, configs=configs,
            num_rebalances=rt.num_rebalances - rebalances0,
            total_trials=rt.total_trials - trials0,
            mitigation_lengths=list(rt.mitigation_lengths[mitigations0:]),
            peak_throughput=self.estimated_peak_throughput())


class _LiveQueryExecutor:
    """Runs each query through the engine's executor and keeps the
    engine's block-time estimates and detector baseline up to date.

    Until the first query has been measured there are no estimates to
    reason over, so :meth:`begin_query` returns ``None`` (the query runs
    steady) and detection is armed after that query runs.
    """

    def __init__(self, engine: ServingEngine,
                 queries: Sequence[torch.Tensor], slowdown_schedule):
        self.engine = engine
        self.queries = queries
        self.schedule = slowdown_schedule
        self._slow: Optional[np.ndarray] = None

    def begin_query(self, q: int) -> Optional[MeasuredTimeSource]:
        self._slow = np.asarray(self.schedule(q), float)
        if self.engine._block_times is None:
            return None
        return self.engine._measured_source(self._slow)

    def execute(self, q: int, config: Sequence[int]) -> tuple:
        """Run query ``q`` on ``config``: (service latency, throughput)."""
        eng = self.engine
        first = eng._block_times is None
        t0 = time.perf_counter()
        _, st = eng.executor.run_query(self.queries[q], config,
                                       slowdowns=self._slow)
        latency = time.perf_counter() - t0
        live = [i for i, c in enumerate(config) if c > 0]
        tmax = float(st[live].max())
        eng._update_block_estimates(config, st, self._slow)
        if first:
            # Arm detection against this query's measured conditions, so
            # interference beginning at the next query is a shift from
            # this baseline rather than the baseline.
            eng.runtime.arm(eng._measured_source(self._slow))
        return latency, 1.0 / max(tmax, 1e-12)
