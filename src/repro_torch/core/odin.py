"""ODIN heuristic pipeline-stage rebalancing (paper Algorithm 1).

Faithful transcription, with the two paper heuristics:

1. *Set the direction for moving work* — the first trial sheds one layer
   from both ends of the affected (slowest) stage; the direction is the
   side with the smaller total stage time; the receiving stage is the
   lightest on that side.
2. *Avoiding local optimum* — on a throughput plateau (T_new == T), move
   an extra layer from the affected stage to the lightest stage.

The patience counter ``γ`` bounds consecutive non-improving trials by the
tuning parameter ``α``; on improvement ``γ`` resets and the best-seen
configuration is recorded.

The algorithm is *online*: each loop iteration is one serially-processed
query (paper §4.2, "Exploration overhead": ~4 trials for α=2, ~12 for
α=10).  :class:`OdinExplorer` exposes exactly one iteration per
``step()`` so the simulator (and the live serving loop) can interleave
trials with the evolving interference state; :func:`odin_rebalance` is the
run-to-completion convenience wrapper against a frozen state.

Edge-case policy (the paper's pseudocode leaves these implicit):

* moves that would make a stage count non-positive are skipped; a stage
  reaching 0 layers shortens the pipeline ("removing layers from the
  affected PS may reduce the length of the pipeline by 1") — empty stages
  are skipped when locating the bottleneck and are natural receivers when
  reclaiming resources (§3.1).
* at the pipeline ends only the existing neighbour receives a layer.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.pipeline_state import StageTimeSource, throughput


@dataclasses.dataclass
class Trial:
    config: List[int]
    throughput: float
    improved: bool


@dataclasses.dataclass
class RebalanceResult:
    config: List[int]
    throughput: float
    trials: List[Trial]

    @property
    def num_trials(self) -> int:
        return len(self.trials)


def _nonempty(config: Sequence[int]) -> List[int]:
    return [i for i, c in enumerate(config) if c > 0]


def _affected_index(times: np.ndarray, config: Sequence[int]) -> int:
    """Slowest *non-empty* stage."""
    idx = _nonempty(config)
    return max(idx, key=lambda i: times[i])


def _lightest_in_direction(times: np.ndarray, config: Sequence[int],
                           affected: int, direction: str) -> Optional[int]:
    """Lightest stage strictly on one side of the affected stage.

    Empty stages count as weight 0 — the natural receivers when the
    pipeline previously shrank (resource reclaim, §3.1).
    """
    cand = list(range(0, affected)) if direction == "left" else \
        list(range(affected + 1, len(config)))
    if not cand:
        return None
    return min(cand, key=lambda i: times[i])


class OdinExplorer:
    """One Algorithm-1 iteration per ``step()`` (one serial query each)."""

    serial = True   # each step costs one serially-processed query

    def __init__(self, config: Sequence[int], alpha: int):
        self.C = list(config)
        self.alpha = alpha
        self.gamma = 0
        self.T: Optional[float] = None       # best-so-far throughput
        self.C_opt = list(config)
        self.trials: List[Trial] = []
        self.done = False

    # -- internals -----------------------------------------------------------
    def _move(self, src: int, dst: int) -> bool:
        """Move one layer src -> dst; False if src cannot donate."""
        if self.C[src] <= 1:
            return False
        self.C[src] -= 1
        self.C[dst] += 1
        return True

    def step(self, source: StageTimeSource) -> List[int]:
        """Run one exploration iteration; returns the trial configuration
        the (serial) query is processed with."""
        assert not self.done
        C = self.C
        n = len(C)
        # Refresh the reference throughput against *live* stage times of
        # the best-seen configuration: the algorithm is online and the
        # interference state may change mid-phase — comparing trials to a
        # stale baseline would reject every move after conditions worsen
        # (and the phase would return the original, now-degraded config).
        self.T = throughput(source.stage_times(self.C_opt))

        times = source.stage_times(C)
        affected = _affected_index(times, C)

        if self.gamma == 0 and not self.trials:
            # First trial: shed one layer from both ends of PS_affected
            # (Lines 6-10).
            take = 0
            if affected + 1 < n and C[affected] > take + 1:
                C[affected + 1] += 1
                take += 1
            if affected - 1 >= 0 and C[affected] > take + 1:
                C[affected - 1] += 1
                take += 1
            C[affected] -= take
            times = source.stage_times(C)
            affected = _affected_index(times, C)

        # Direction: side with the smaller total time (Lines 11-17).
        s_left = float(np.sum(times[:affected]))
        s_right = float(np.sum(times[affected + 1:]))
        direction = "left" if s_left < s_right else "right"
        lightest = _lightest_in_direction(times, C, affected, direction)
        if lightest is None:
            direction = "left" if direction == "right" else "right"
            lightest = _lightest_in_direction(times, C, affected, direction)
        if lightest is None:
            # Single-stage pipeline: nothing to move, exploration is done.
            self.done = True
            self.C_opt = list(C)
            return list(C)

        if not self._move(affected, lightest):
            # Affected stage holds a single layer and cannot donate: the
            # configuration is unchanged, so re-measuring it would record
            # a duplicate-config trial as a fresh measurement.  Count a
            # non-improving step (so patience still terminates the phase)
            # without emitting a trial.
            self.gamma += 1
            if self.gamma >= self.alpha:
                self.done = True
            return list(C)
        T_new = throughput(source.stage_times(C))

        if T_new < self.T:
            self.gamma += 1
            self.trials.append(Trial(list(C), T_new, False))
        elif T_new == self.T:
            # Local-optimum escape (Lines 24-27): one extra layer.
            if self._move(affected, lightest):
                T_new = throughput(source.stage_times(C))
                self.gamma += 1
                improved = T_new > self.T
                if improved:
                    self.T = T_new
                    self.C_opt = list(C)
                    self.gamma = 0
                self.trials.append(Trial(list(C), T_new, improved))
            else:
                # Escape move failed (donor down to 1 layer): keep the
                # already-measured single-move trial instead of recording
                # the same configuration again as a fresh measurement.
                self.gamma += 1
                self.trials.append(Trial(list(C), T_new, False))
        else:
            self.gamma = 0
            self.T = T_new
            self.C_opt = list(C)
            self.trials.append(Trial(list(C), T_new, True))

        if self.gamma >= self.alpha:
            self.done = True
        return list(C)

    def result(self) -> RebalanceResult:
        return RebalanceResult(list(self.C_opt), float(self.T or 0.0),
                               list(self.trials))


def odin_rebalance(config: Sequence[int], alpha: int,
                   source: StageTimeSource,
                   max_trials: int = 10_000) -> RebalanceResult:
    """Run Algorithm 1 to completion against a frozen interference state."""
    ex = OdinExplorer(config, alpha)
    for _ in range(max_trials):
        if ex.done:
            break
        ex.step(source)
    return ex.result()
