"""Built-in mitigation policies: odin, lls, none.

Copies of the JAX package's ``schedulers/policies.py`` policies that
closed-loop serving uses; each pairs the shared
:class:`InterferenceDetector` with an explorer from ``repro_torch.core``.
A small name -> class map stands in for the JAX package's registry.
The oracle and hybrid policies are not ported yet (ROADMAP.md).

* ``odin`` — paper Algorithm 1 (plateau-escaping exploration).
* ``lls``  — Least-Loaded Scheduling baseline (§3.3).
* ``none`` — static pipeline, never rebalances.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

from repro_torch.core.lls import LLSExplorer
from repro_torch.core.odin import OdinExplorer
from repro_torch.core.pipeline_state import StageTimeSource
from repro_torch.schedulers.base import InterferenceDetector
from repro_torch.schedulers.defaults import (
    DEFAULT_ALPHA,
    resolve_rel_threshold,
)

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
    """Common detect/finish/reset around the shared detector."""

    def __init__(self, rel_threshold: Optional[float] = None,
                 detector: DetectorSpec = None):
        self.detector = _make_detector(detector, rel_threshold)

    def detect(self, config: Sequence[int],
               source: StageTimeSource) -> bool:
        return self.detector.observe(config, source)

    def finish(self, config: Sequence[int],
               source: StageTimeSource) -> None:
        self.detector.rearm(config, source)

    def reset(self) -> None:
        self.detector.reset()


class OdinPolicy(_DetectorPolicy):
    """Paper Algorithm 1 behind the shared detector."""

    def __init__(self, alpha: int = DEFAULT_ALPHA,
                 rel_threshold: Optional[float] = None,
                 detector: DetectorSpec = None):
        super().__init__(rel_threshold, detector)
        self.alpha = alpha

    def make_explorer(self, config: Sequence[int]) -> OdinExplorer:
        return OdinExplorer(config, self.alpha)


class LLSPolicy(_DetectorPolicy):
    """Least-Loaded Scheduling baseline behind the shared detector."""

    def __init__(self, rel_threshold: Optional[float] = None,
                 max_moves: int = 64,
                 detector: DetectorSpec = None):
        super().__init__(rel_threshold, detector)
        self.max_moves = max_moves

    def make_explorer(self, config: Sequence[int]) -> LLSExplorer:
        return LLSExplorer(config, self.max_moves)


class StaticPolicy:
    """Static pipeline: never rebalances (the paper's 'no mitigation')."""

    def detect(self, config: Sequence[int],
               source: StageTimeSource) -> bool:
        return False

    def make_explorer(self, config: Sequence[int]):
        raise RuntimeError("static policy never explores")

    def finish(self, config: Sequence[int],
               source: StageTimeSource) -> None:
        pass

    def reset(self) -> None:
        pass


#: Policy name -> class (the names of the JAX package's registry).
SCHEDULERS = {"odin": OdinPolicy, "lls": LLSPolicy, "none": StaticPolicy}


def make_scheduler(name: str, alpha: int = DEFAULT_ALPHA,
                   rel_threshold: Optional[float] = None,
                   detector: DetectorSpec = None):
    """Construct the policy called ``name``; each takes the arguments
    that mean something to it."""
    if name == "odin":
        return OdinPolicy(alpha, rel_threshold, detector)
    if name == "lls":
        return LLSPolicy(rel_threshold, detector=detector)
    if name == "none":
        return StaticPolicy()
    raise ValueError(f"unknown scheduler {name!r}; available: "
                     f"{sorted(SCHEDULERS)}")
