"""Built-in mitigation policies: odin, lls, oracle, none, hybrid.

Each policy pairs the shared :class:`InterferenceDetector` with an
explorer.  The exploration *algorithms* stay where the paper transcribed
them (``repro_torch.core.odin`` / ``repro_torch.core.lls``); this module is the
policy layer the registry exposes:

* ``odin``   — paper Algorithm 1 (plateau-escaping exploration).
* ``lls``    — Least-Loaded Scheduling baseline (§3.3).
* ``oracle`` — DP optimal partition, applied instantly (zero serial
  queries); the caller supplies the solver (the simulator wires its
  database-backed DP in, a live deployment can plug an estimator).
* ``none``   — static pipeline, never rebalances.
* ``hybrid`` — beyond-paper: LLS's cheap greedy move first; if the phase
  plateaus, escalate to ODIN exploration from the best config so far.

The port's copy of the JAX package's ``schedulers/policies.py``; only import
paths differ.  ``tests/test_torch_control.py`` holds it equal to the
original.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

from repro_torch.core.lls import LLSExplorer
from repro_torch.core.odin import MeshOdinExplorer, OdinExplorer, RebalanceResult
from repro_torch.core.pipeline_state import StageTimeSource, throughput
from repro_torch.schedulers.base import InterferenceDetector
from repro_torch.schedulers.defaults import DEFAULT_ALPHA, resolve_rel_threshold
from repro_torch.schedulers.registry import register_scheduler

DetectorSpec = Union[InterferenceDetector, str, None]


def _make_detector(detector: DetectorSpec,
                   rel_threshold: Optional[float]) -> InterferenceDetector:
    rel_threshold = resolve_rel_threshold(rel_threshold)
    if isinstance(detector, InterferenceDetector):
        return detector
    if isinstance(detector, str):
        return InterferenceDetector(rel_threshold=rel_threshold,
                                    mode=detector)
    return InterferenceDetector(rel_threshold=rel_threshold)


class _DetectorPolicy:
    """Common detect/finish/reset around the shared detector.

    ``rel_threshold=None`` resolves to the repo-wide
    :data:`~repro_torch.schedulers.defaults.DEFAULT_REL_THRESHOLD` so the
    simulator and the live engine agree by construction.
    """

    def __init__(self, rel_threshold: Optional[float] = None,
                 detector: DetectorSpec = None):
        self.detector = _make_detector(detector, rel_threshold)

    @property
    def steady_detect_stable(self) -> bool:
        """Fast-path contract (see ``SchedulerPolicy``): the paper's
        pure ``rel`` rule tolerates one poll per steady segment; the
        stateful EMA mode must observe every query."""
        return self.detector.steady_stable

    def detect(self, config: Sequence[int],
               source: StageTimeSource) -> bool:
        return self.detector.observe(config, source)

    def finish(self, config: Sequence[int],
               source: StageTimeSource) -> None:
        self.detector.rearm(config, source)

    def reset(self) -> None:
        self.detector.reset()


@register_scheduler("odin")
class OdinPolicy(_DetectorPolicy):
    """Paper Algorithm 1 behind the shared detector."""

    def __init__(self, alpha: int = DEFAULT_ALPHA,
                 rel_threshold: Optional[float] = None,
                 detector: DetectorSpec = None):
        super().__init__(rel_threshold, detector)
        self.alpha = alpha

    def make_explorer(self, config: Sequence[int],
                      mesh: Optional[Sequence[int]] = None) -> OdinExplorer:
        if mesh is not None:
            # Sharded run: explore the (boundary, slice) action space
            # (docs/SHARDING.md).
            return MeshOdinExplorer(config, self.alpha, mesh)
        return OdinExplorer(config, self.alpha)


@register_scheduler("lls")
class LLSPolicy(_DetectorPolicy):
    """Least-Loaded Scheduling baseline behind the shared detector."""

    def __init__(self, rel_threshold: Optional[float] = None,
                 max_moves: int = 64,
                 detector: DetectorSpec = None):
        super().__init__(rel_threshold, detector)
        self.max_moves = max_moves

    def make_explorer(self, config: Sequence[int],
                      mesh: Optional[Sequence[int]] = None) -> LLSExplorer:
        # LLS stays a boundary-only baseline: on sharded runs it explores
        # layer moves on the *fixed* committed assignment (the runtime
        # keeps pricing trials with the current slices), which is exactly
        # the boundary-only reference the sharding benchmarks compare
        # ODIN's (boundary, slice) moves against.
        return LLSExplorer(config, self.max_moves)


@register_scheduler("none")
class StaticPolicy:
    """Static pipeline: never rebalances (the paper's 'no mitigation')."""

    steady_detect_stable = True

    def detect(self, config: Sequence[int],
               source: StageTimeSource) -> bool:
        return False

    def make_explorer(self, config: Sequence[int],
                      mesh: Optional[Sequence[int]] = None):
        raise RuntimeError("static policy never explores")

    def finish(self, config: Sequence[int],
               source: StageTimeSource) -> None:
        pass

    def reset(self) -> None:
        pass


class OracleExplorer:
    """Jumps straight to the solver's configuration; costs no queries."""

    serial = False

    def __init__(self, target: Sequence[int],
                 mesh: Optional[Sequence[int]] = None):
        self.target = list(target)
        self.mesh = list(mesh) if mesh is not None else None
        self.done = False

    def step(self, source: StageTimeSource) -> List[int]:
        self.done = True
        return list(self.target)

    def result(self) -> RebalanceResult:
        mesh = list(self.mesh) if self.mesh is not None else None
        return RebalanceResult(list(self.target), 0.0, [], mesh=mesh)


@register_scheduler("oracle")
class OraclePolicy:
    """Optimal-partition oracle as a normal (instant) policy.

    ``solver(config, source) -> config`` returns the best configuration
    for the *current* interference state — the simulator passes its
    DP-over-database solver (paper's exhaustive search, §4.3).  Because
    the optimum is recomputed on every detect, no bottleneck-threshold
    detector is needed: detection is simply "the optimum moved".

    Sharded runs wire a *mesh-aware* solver instead, returning a
    ``(config, assignment)`` pair (``repro_torch.core.exhaustive.
    optimal_partition_mesh``); detection then fires when either the
    boundary optimum or the slice optimum moved, compared against the
    committed assignment the runtime synced onto the time source.
    """

    # Detect recomputes the optimum from (config, current stage times)
    # and commits instantly when it moves, so under an unchanged
    # environment one poll answers for the whole segment.
    steady_detect_stable = True

    def __init__(self, solver: Callable[[Sequence[int], StageTimeSource],
                                        Sequence[int]]):
        self.solver = solver
        self._pending: Optional[tuple] = None   # (config, assignment|None)

    def detect(self, config: Sequence[int],
               source: StageTimeSource) -> bool:
        opt = self.solver(config, source)
        if (isinstance(opt, tuple) and len(opt) == 2
                and isinstance(opt[0], (list, tuple))):
            # Mesh-aware solver: (config, assignment).
            cfg, assign = list(opt[0]), list(opt[1])
            cur = getattr(source, "assignment", None)
            if cfg != list(config) or (cur is not None
                                       and assign != list(cur)):
                self._pending = (cfg, assign)
                return True
            return False
        opt = list(opt)
        if opt != list(config):
            self._pending = (opt, None)
            return True
        return False

    def make_explorer(self, config: Sequence[int],
                      mesh: Optional[Sequence[int]] = None) -> OracleExplorer:
        if self._pending is not None:
            target, assign = self._pending
        else:
            target = list(config)
            assign = list(mesh) if mesh is not None else None
        self._pending = None
        return OracleExplorer(target, mesh=assign)

    def finish(self, config: Sequence[int],
               source: StageTimeSource) -> None:
        pass

    def reset(self) -> None:
        self._pending = None


class HybridExplorer:
    """LLS first move(s); ODIN exploration if the phase plateaus.

    LLS converges in ~1 serial query but gets stuck on the lumpy
    layer-cost profiles where single greedy moves cannot help (the
    motivation for ODIN's plateau escape, §3.3).  The hybrid phase runs
    LLS to its stopping point; if that recovered less than
    ``plateau_margin`` relative throughput, it escalates to ODIN seeded
    with the best configuration seen so far.  Cheap when LLS suffices,
    ODIN-strength when it does not.
    """

    serial = True

    def __init__(self, config: Sequence[int], alpha: int,
                 plateau_margin: float = 0.01, max_moves: int = 64):
        self._config0 = list(config)
        self.alpha = alpha
        self.plateau_margin = plateau_margin
        self._lls = LLSExplorer(config, max_moves)
        self._odin: Optional[OdinExplorer] = None
        self._t0: Optional[float] = None
        # Best (config, throughput) measured during the LLS phase.  LLS
        # itself keeps its observed-degrading last move (paper §3.3);
        # hybrid is free to revert to the best configuration it already
        # measured — committing a config costs nothing.
        self._best: Optional[tuple] = None
        self.done = False

    def step(self, source: StageTimeSource) -> List[int]:
        assert not self.done
        if self._t0 is None:
            self._t0 = throughput(source.stage_times(self._config0))
            self._best = (list(self._config0), self._t0)
        if self._odin is None:
            cfg = self._lls.step(source)
            if self._lls.trials and self._lls.trials[-1].throughput > \
                    self._best[1]:
                tr = self._lls.trials[-1]
                self._best = (list(tr.config), tr.throughput)
            if self._lls.done:
                if self._best[1] > self._t0 * (1.0 + self.plateau_margin):
                    self.done = True
                else:
                    self._odin = OdinExplorer(self._best[0], self.alpha)
            return cfg
        cfg = self._odin.step(source)
        self.done = self._odin.done
        return cfg

    def result(self) -> RebalanceResult:
        lls_res = self._lls.result()
        best_cfg, best_T = self._best if self._best is not None else (
            list(self._config0), 0.0)
        trials = list(lls_res.trials)
        if self._odin is not None:
            odin_res = self._odin.result()
            trials += odin_res.trials
            if odin_res.throughput > best_T:
                best_cfg, best_T = list(odin_res.config), odin_res.throughput
        return RebalanceResult(list(best_cfg), best_T, trials)


@register_scheduler("hybrid")
class HybridPolicy(_DetectorPolicy):
    """Beyond-paper policy: LLS's cheap move, ODIN's escape hatch."""

    def __init__(self, alpha: int = DEFAULT_ALPHA,
                 rel_threshold: Optional[float] = None,
                 plateau_margin: float = 0.01, max_moves: int = 64,
                 detector: DetectorSpec = None):
        super().__init__(rel_threshold, detector)
        self.alpha = alpha
        self.plateau_margin = plateau_margin
        self.max_moves = max_moves

    def make_explorer(self, config: Sequence[int],
                      mesh: Optional[Sequence[int]] = None) -> HybridExplorer:
        # Like LLS, hybrid explores layer moves on the fixed committed
        # assignment (boundary-only on sharded runs).
        return HybridExplorer(config, self.alpha,
                              plateau_margin=self.plateau_margin,
                              max_moves=self.max_moves)
