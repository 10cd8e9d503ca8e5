"""Least-Loaded Scheduling baseline (paper §3.3).

LLS computes per-stage utilization

    v_i = 1 - w_i / (w_i + t_i),   w_i = w_{i-1} + t_{i-1} - t_i,  w_0 = 0

and recursively moves one layer from the most-utilized to the
least-utilized stage until throughput starts decreasing (the last,
degrading move is reverted).  Like ODIN it only consumes observed stage
times.  Each tried move is one serially-processed query; the paper
reports ~1 query per LLS rebalancing phase.

The port's copy of the JAX package's ``core/lls.py``; only import paths
differ.  ``tests/test_torch_control.py`` holds it equal to the original.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.core.odin import RebalanceResult, Trial, _nonempty
from repro_torch.core.pipeline_state import StageTimeSource, throughput, utilization


class LLSExplorer:
    """One greedy move per ``step()`` (one serial query each)."""

    serial = True   # each step costs one serially-processed query

    def __init__(self, config: Sequence[int], max_moves: int = 64):
        self.C = list(config)
        self.max_moves = max_moves
        self.T: Optional[float] = None
        self.trials: List[Trial] = []
        self.done = False

    def step(self, source: StageTimeSource) -> List[int]:
        assert not self.done
        C = self.C
        if self.T is None:
            self.T = throughput(source.stage_times(C))

        times = source.stage_times(C)
        v = utilization(times)
        donors = [i for i in _nonempty(C) if C[i] > 1]
        if not donors or len(self.trials) >= self.max_moves:
            self.done = True
            return list(C)
        # Most/least utilized with *first-index* tie-breaking (numpy argmax
        # semantics).  Ties are common: w_0 = 0 pins v_0 = 1, so stage 0
        # ties with the bottleneck — and the paper's measured overhead of
        # ~1 serially-processed query per LLS phase matches exactly this
        # behaviour (the first move usually fails and LLS stops).
        src = max(donors, key=lambda i: v[i])
        dst = min((i for i in range(len(C)) if i != src),
                  key=lambda i: v[i])
        C[src] -= 1
        C[dst] += 1
        T_new = throughput(source.stage_times(C))
        if T_new <= self.T:
            # "...recursively until the throughput starts decreasing"
            # (paper §3.3): the decrease is *observed*, i.e. the degrading
            # move has already been applied — LLS stops here and keeps it.
            self.T = T_new
            self.trials.append(Trial(list(C), T_new, False))
            self.done = True
        else:
            self.T = T_new
            self.trials.append(Trial(list(C), T_new, True))
        return list(C)

    def result(self) -> RebalanceResult:
        return RebalanceResult(list(self.C), float(self.T or 0.0),
                               list(self.trials))


def lls_rebalance(config: Sequence[int], source: StageTimeSource,
                  max_moves: int = 64) -> RebalanceResult:
    ex = LLSExplorer(config, max_moves)
    while not ex.done:
        ex.step(source)
    return ex.result()


# The online wrapper (shared detection + explorer factory) lives in
# repro_torch.schedulers as LLSPolicy; ``LLSController`` stays importable.


def __getattr__(name: str):
    if name == "LLSController":
        from repro_torch.schedulers.policies import LLSPolicy
        return LLSPolicy
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
