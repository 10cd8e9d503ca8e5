"""Optimal-configuration oracle (the paper's "exhaustive search").

The paper's motivating example notes an exhaustive search over pipeline
configurations took 42.5 minutes.  Because stage time is additive over a
*contiguous* layer range evaluated under that EP's interference scenario,
the optimum is computable exactly in O(N · m²) by dynamic programming on
prefix boundaries — we use it as the "resource-constrained throughput"
reference of §4.3 (Fig. 9) without paying the brute-force cost.  A literal
brute-force enumerator is retained for cross-checking on small instances.

The port's copy of the JAX package's ``core/exhaustive.py``; only import
paths differ.  ``tests/test_torch_simulator.py`` holds it equal to the
original.
"""
from __future__ import annotations

import itertools
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.database import LayerDatabase


@lru_cache(maxsize=8)
def _invalid_mask(m: int) -> np.ndarray:
    """invalid[j, lo] masks cut points past the boundary (lo > j)."""
    return np.triu(np.ones((m + 1, m + 1), dtype=bool), k=1)


def optimal_partition(db: LayerDatabase,
                      scenarios: Sequence[int],
                      num_stages: int) -> Tuple[List[int], float]:
    """Min-bottleneck contiguous partition of m layers onto stages 0..N-1.

    Stage i evaluates its layers under ``scenarios[i]`` (bind-to-stage).
    Empty stages are allowed (the pipeline may shorten under interference).
    Returns (config, throughput).
    """
    m = db.num_layers
    N = num_stages
    # prefix[k][j] = sum of layer times [0, j) under scenario k
    prefix = db.prefix_times()

    INF = float("inf")
    # dp[i][j] = min bottleneck placing first j layers on stages [0, i)
    dp = np.full((N + 1, m + 1), INF)
    choice = np.zeros((N + 1, m + 1), dtype=np.int64)
    dp[0, 0] = 0.0
    invalid = _invalid_mask(m)
    for i in range(1, N + 1):
        pref = prefix[scenarios[i - 1]]
        # cost[j, lo] = max(dp[i-1, lo], time of layers [lo, j) on
        # stage i-1); argmin along lo keeps the first (lowest-lo)
        # minimum, matching a scalar scan's strict `<` tie-breaking.
        cost = np.maximum(dp[i - 1][None, :], pref[:, None] - pref[None, :])
        cost[invalid] = INF
        dp[i] = cost.min(axis=1)
        choice[i] = cost.argmin(axis=1)
    # Backtrack.
    config = [0] * N
    j = m
    for i in range(N, 0, -1):
        lo = int(choice[i, j])
        config[i - 1] = j - lo
        j = lo
    bottleneck = dp[N, m]
    return config, (1.0 / bottleneck if bottleneck > 0 else float("inf"))


def optimal_partition_mesh(db: LayerDatabase,
                           scenarios: Sequence[int],
                           num_stages: int,
                           mesh: "MeshSpec",
                           coll_factor: float = 1.0
                           ) -> Tuple[List[int], Tuple[int, ...], float]:
    """Min-bottleneck (boundary, slice) optimum (docs/SHARDING.md).

    Extends :func:`optimal_partition`'s action space with the mesh
    axis: enumerate every composition of ``mesh.devices`` into
    ``num_stages`` positive slices (C(D-1, S-1) of them), run the same
    boundary DP per composition under the sharded cost model — stage
    time ``(pref[hi] - pref[lo]) / m_i + (cpref[hi] - cpref[lo]) *
    ring(m_i) * coll_factor`` — and keep the global best.  Ties break
    toward the first composition in lexicographic order (deterministic).
    Returns ``(config, assignment, throughput)``.
    """
    from repro_torch.core.mesh import assignments, ring_factor

    m = db.num_layers
    N = num_stages
    prefix = db.prefix_times()
    cpref = mesh.coll_prefix(m)

    INF = float("inf")
    invalid = _invalid_mask(m)
    best = None  # (bottleneck, config, assignment)
    for assign in assignments(mesh.devices, N):
        dp = np.full((N + 1, m + 1), INF)
        choice = np.zeros((N + 1, m + 1), dtype=np.int64)
        dp[0, 0] = 0.0
        for i in range(1, N + 1):
            pref = prefix[scenarios[i - 1]]
            ring = ring_factor(assign[i - 1]) * float(coll_factor)
            stage = ((pref[:, None] - pref[None, :]) / float(assign[i - 1])
                     + (cpref[:, None] - cpref[None, :]) * ring)
            cost = np.maximum(dp[i - 1][None, :], stage)
            cost[invalid] = INF
            dp[i] = cost.min(axis=1)
            choice[i] = cost.argmin(axis=1)
        bottleneck = dp[N, m]
        if best is None or bottleneck < best[0]:
            config = [0] * N
            j = m
            for i in range(N, 0, -1):
                lo = int(choice[i, j])
                config[i - 1] = j - lo
                j = lo
            best = (bottleneck, config, assign)
    bottleneck, config, assign = best
    return (config, assign,
            1.0 / bottleneck if bottleneck > 0 else float("inf"))


def brute_force_partition(db: LayerDatabase,
                          scenarios: Sequence[int],
                          num_stages: int) -> Tuple[List[int], float]:
    """Literal enumeration of all contiguous partitions (small m only)."""
    m = db.num_layers
    N = num_stages
    best_cfg, best_T = None, -1.0
    # boundaries: N-1 cut points in [0, m], non-decreasing
    for cuts in itertools.combinations_with_replacement(range(m + 1), N - 1):
        bounds = (0,) + cuts + (m,)
        if any(b2 < b1 for b1, b2 in zip(bounds, bounds[1:])):
            continue
        times = [db.stage_time(bounds[i], bounds[i + 1], scenarios[i])
                 for i in range(N)]
        t_max = max(t for t in times if t > 0) if any(times) else 0
        if t_max <= 0:
            continue
        T = 1.0 / t_max
        if T > best_T:
            best_T = T
            best_cfg = [bounds[i + 1] - bounds[i] for i in range(N)]
    return best_cfg, best_T
