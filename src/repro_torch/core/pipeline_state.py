"""Pipeline configuration & cost primitives shared by ODIN / LLS / oracle.

A *configuration* ``C`` is a vector of contiguous layer counts per pipeline
stage (paper §3.2).  Stage ``i`` is bound to execution place ``i``
("bind-to-stage"); the interference state of the system is the per-EP
scenario vector ``k`` (index 0 = no interference).  All schedulers consume
stage times through a :class:`StageTimeSource`, so the simulator (database
lookups) and the live PyTorch runtime (measured times) are interchangeable.
"""
from __future__ import annotations

from typing import List, Protocol, Sequence

import numpy as np


class StageTimeSource(Protocol):
    """Anything that can report per-stage execution times for a config."""

    def stage_times(self, config: Sequence[int]) -> np.ndarray:
        """Execution time of each stage under the *current* interference."""
        ...


# ---------------------------------------------------------------------------
# Config helpers
# ---------------------------------------------------------------------------


def boundaries(config: Sequence[int]) -> List[int]:
    """Prefix boundaries: stage i owns layers [b[i], b[i+1])."""
    out = [0]
    for c in config:
        out.append(out[-1] + c)
    return out


def validate_config(config: Sequence[int], num_layers: int) -> None:
    if any(c < 0 for c in config):
        raise ValueError(f"negative stage count in {config}")
    if sum(config) != num_layers:
        raise ValueError(
            f"config {config} covers {sum(config)} layers, expected {num_layers}")


def balanced_config(num_layers: int, num_stages: int) -> List[int]:
    """Even split used as the interference-free starting configuration."""
    base, rem = divmod(num_layers, num_stages)
    return [base + (1 if i < rem else 0) for i in range(num_stages)]


# ---------------------------------------------------------------------------
# Throughput / latency model (paper §3.3)
# ---------------------------------------------------------------------------


def throughput(stage_times: np.ndarray) -> float:
    """T = 1 / max_i t_i  (empty stages contribute no time)."""
    t_max = float(np.max(stage_times)) if len(stage_times) else float("inf")
    if t_max <= 0.0:
        return float("inf")
    return 1.0 / t_max


def waiting_times(stage_times: np.ndarray) -> np.ndarray:
    """w_i = w_{i-1} + t_{i-1} - t_i, w_0 = 0 (clamped at 0).

    The clamp makes w a physical waiting time; the paper's recurrence is
    stated unclamped but only ratios enter the utilization formula.
    """
    w = np.zeros_like(stage_times)
    for i in range(1, len(stage_times)):
        w[i] = max(0.0, w[i - 1] + stage_times[i - 1] - stage_times[i])
    return w


def utilization(stage_times: np.ndarray) -> np.ndarray:
    """v_i = 1 - w_i / (w_i + t_i) with the paper's literal (unclamped)
    recurrence, which telescopes to w_i = t_0 - t_i and hence
    v_i = t_i / t_0: utilization is load relative to stage 0.  The
    slowest stage is the most utilized; empty stages get 0."""
    t0 = stage_times[0] if len(stage_times) else 1.0
    if t0 <= 0:
        nz = stage_times[stage_times > 0]
        t0 = float(nz[0]) if len(nz) else 1.0
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(stage_times > 0, stage_times / t0, 0.0)


def pipelined_latency(stage_times: np.ndarray) -> float:
    """End-to-end latency of one query through the saturated pipeline.

    A bind-to-stage blocking pipeline at steady state advances on the
    bottleneck beat: every occupied stage holds a query for t_max before
    it can hand off downstream, so a query's sojourn is
    N_occupied × t_max.  (The w_i recurrence only models upstream-paced
    stalls and underestimates queueing behind late bottlenecks.)"""
    occ = stage_times[stage_times > 0]
    if len(occ) == 0:
        return 0.0
    return float(len(occ) * np.max(occ))


def serial_latency(stage_times: np.ndarray) -> float:
    """Latency while the pipeline is being rebalanced (queries run serially,
    paper §4.2 'Exploration overhead')."""
    return float(np.sum(stage_times))
