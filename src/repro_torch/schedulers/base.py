"""Scheduler-policy protocols + the shared interference detector.

The ODIN paper treats its online rebalancer as one of several
interchangeable mitigation policies (ODIN vs. LLS vs. the exhaustive
oracle, §3.3–§4.2).  This module defines that contract:

* :class:`Explorer` — an in-progress rebalancing phase.  Each ``step()``
  produces the configuration one (serially processed) trial query runs
  with; ``done`` flips when the phase ends and ``result()`` reports the
  committed configuration plus the trial log.  Explorers whose steps do
  *not* cost a serial query (e.g. the DP oracle, which jumps straight to
  the optimum) set ``serial = False``.
* :class:`SchedulerPolicy` — decides *when* to rebalance (``detect``),
  builds the explorer that decides *how* (``make_explorer``), and is told
  when a phase commits (``finish``).  The shared
  :class:`~repro_torch.schedulers.runtime.RebalanceRuntime` owns everything
  in between, so the simulator and the live JAX engine execute policies
  identically.
* :class:`InterferenceDetector` — the paper's §3.1 monitor (bottleneck
  stage time shifted beyond a relative threshold), factored out of the
  old per-controller copies, plus an EMA/hysteresis mode for noisy
  measured times.

The port's copy of the JAX package's ``schedulers/base.py``; only import
paths differ.  ``tests/test_torch_control.py`` holds it equal to the
original.
"""
from __future__ import annotations

from typing import (
    TYPE_CHECKING,
    List,
    Optional,
    Protocol,
    Sequence,
    runtime_checkable,
)

if TYPE_CHECKING:  # annotation-only: keeps repro_torch.core <-> schedulers acyclic
    from repro_torch.core.odin import RebalanceResult
    from repro_torch.core.pipeline_state import StageTimeSource


@runtime_checkable
class Explorer(Protocol):
    """One in-progress rebalancing phase; one ``step()`` per trial."""

    #: Whether each step consumes a serially-processed query (paper §4.2
    #: "Exploration overhead").  Instant policies (oracle) set False.
    serial: bool
    #: True once the phase has committed to a configuration.
    done: bool

    def step(self, source: StageTimeSource) -> List[int]:
        """Advance one trial; returns the configuration it runs with."""
        ...

    def result(self) -> RebalanceResult:
        """Committed configuration + trial log for the finished phase."""
        ...


@runtime_checkable
class SchedulerPolicy(Protocol):
    """A pluggable mitigation policy: decides, the runtime executes.

    Policies may additionally expose ``steady_detect_stable: bool``:
    True declares that ``detect`` has no side effects and returns a
    constant answer while (config, stage times) are unchanged — and
    stays quiet right after ``finish`` re-arms it.  The run loop's
    batch-granular fast path then polls once per environment-steady
    segment instead of once per query.  Absent (or False) keeps
    per-query polling, which is always correct.
    """

    def detect(self, config: Sequence[int], source: StageTimeSource) -> bool:
        """True if a rebalancing phase should start now."""
        ...

    def make_explorer(self, config: Sequence[int],
                      mesh: Optional[Sequence[int]] = None) -> Explorer:
        """Build the explorer that runs the phase from ``config``.

        ``mesh`` is the committed device assignment on sharded runs
        (docs/SHARDING.md) — the runtime passes it only when one is
        armed, so unsharded policies may ignore the kwarg entirely.
        """
        ...

    def finish(self, config: Sequence[int], source: StageTimeSource) -> None:
        """Phase committed to ``config``; re-arm detection state."""
        ...

    def reset(self) -> None:
        """Drop all online state (fresh serving window)."""
        ...


def bottleneck_time(config: Sequence[int], source: StageTimeSource) -> float:
    """Execution time of the slowest *non-empty* stage."""
    times = source.stage_times(config)
    return max(float(times[i]) for i, c in enumerate(config) if c > 0)


class InterferenceDetector:
    """Shared bottleneck-shift detector (paper §3.1).

    ``mode="rel"`` is the paper's rule: trigger when the bottleneck stage
    time moved beyond ``rel_threshold`` relative to the reference recorded
    at the end of the last rebalancing phase (up = interference arrived;
    down = it left).  The first observation records the reference.

    ``mode="ema"`` targets noisy *measured* times (live engine): the
    reference is an exponential moving average of observed bottlenecks and
    a trigger requires ``hysteresis`` consecutive out-of-band
    observations, debouncing one-query timing spikes that would otherwise
    burn a full exploration phase of serial queries.
    """

    MODES = ("rel", "ema")

    def __init__(self, rel_threshold: float = 0.02, mode: str = "rel",
                 ema_beta: float = 0.3, hysteresis: int = 2):
        if mode not in self.MODES:
            raise ValueError(f"unknown detector mode {mode!r}; "
                             f"expected one of {self.MODES}")
        self.rel_threshold = rel_threshold
        self.mode = mode
        self.ema_beta = ema_beta
        self.hysteresis = max(1, int(hysteresis))
        self._ref: Optional[float] = None
        self._streak = 0

    @property
    def steady_stable(self) -> bool:
        """Whether repeated quiet observations are side-effect-free.

        The paper's ``rel`` rule is a pure comparison against the
        post-rebalance reference, so skipping redundant observations in
        an unchanged environment cannot alter any later decision.  The
        EMA mode folds every quiet observation into the reference, so
        it must see each query."""
        return self.mode == "rel"

    @property
    def armed(self) -> bool:
        """Whether a reference bottleneck has been recorded yet."""
        return self._ref is not None

    def shift(self, config: Sequence[int],
              source: StageTimeSource) -> float:
        """Signed relative bottleneck shift vs. the armed reference,
        **without touching detector state** — ``> 0`` means the current
        bottleneck is slower than the post-rebalance reference.

        This is the read-only probe the cluster's interference-aware
        router uses to ask "does this replica's detector currently see
        interference?" between rebalances (docs/CLUSTER.md); ``0.0``
        before the first observation arms the reference.
        """
        if self._ref is None:
            return 0.0
        b = bottleneck_time(config, source)
        return (b - self._ref) / max(self._ref, 1e-12)

    def observe(self, config: Sequence[int],
                source: StageTimeSource) -> bool:
        """One monitoring observation; True if rebalancing should start."""
        b = bottleneck_time(config, source)
        if self._ref is None:
            self._ref = b
            return False
        rel = abs(b - self._ref) / max(self._ref, 1e-12)
        if self.mode == "rel":
            return rel > self.rel_threshold
        # EMA/hysteresis: trigger only on a sustained shift.  Out-of-band
        # observations are NOT folded into the average — a one-query
        # spike must not drag the reference enough that the *return* to
        # normal reads as a second shift.
        if rel > self.rel_threshold:
            self._streak += 1
            if self._streak >= self.hysteresis:
                self._streak = 0
                return True
            return False
        self._streak = 0
        self._ref = (1.0 - self.ema_beta) * self._ref + self.ema_beta * b
        return False

    def rearm(self, config: Sequence[int], source: StageTimeSource) -> None:
        """Record the post-rebalance bottleneck as the new reference."""
        self._ref = bottleneck_time(config, source)
        self._streak = 0

    def reset(self) -> None:
        self._ref = None
        self._streak = 0
