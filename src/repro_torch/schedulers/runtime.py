"""The rebalance state machine: detect → explore → commit.

Copy of the JAX package's ``schedulers/runtime.py`` without its mesh
branches, the read-only probes only fleet routing uses, and the path of
*instant* (``serial = False``) explorers, which arrives with the oracle
policy (ROADMAP.md item 6g).

Per query the driver calls :meth:`RebalanceRuntime.poll` with the current
:class:`~repro_torch.core.pipeline_state.StageTimeSource` and receives the
configuration the query must run with plus whether it is a serial
(exploration-trial) query:

* no phase active, ``policy.detect`` quiet → steady pipelined query;
* ``detect`` fires → a phase starts.  The explorers (ODIN, LLS) consume
  one serial query per ``step()``;
* the explorer finishing commits its result: the runtime adopts the
  configuration, updates trial accounting, and calls ``policy.finish``
  so detection re-arms against the post-rebalance bottleneck.

Accounting matches the paper's: ``num_rebalances`` counts phases that
cost at least one serial query, ``total_trials`` / ``mitigation_lengths``
mirror Fig. 8's exploration overhead.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Optional, Sequence

if TYPE_CHECKING:
    from repro_torch.core.pipeline_state import StageTimeSource
    from repro_torch.schedulers.base import SchedulerPolicy


@dataclasses.dataclass
class RuntimeStep:
    """What one polled query should do."""
    config: List[int]          # configuration to process the query with
    serial: bool               # True = exploration trial (serial query)
    committed: bool = False    # a rebalancing phase committed at this step


class RebalanceRuntime:
    """Detect → explore → commit driver around one SchedulerPolicy."""

    def __init__(self, policy: SchedulerPolicy, config: Sequence[int]):
        self.policy = policy
        self.policy.reset()       # a runtime is a fresh serving window
        self.config = list(config)
        self.explorer = None
        self.num_rebalances = 0
        self.total_trials = 0
        self.mitigation_lengths: List[int] = []
        self._phase_steps = 0     # serial queries consumed by this phase

    @property
    def exploring(self) -> bool:
        """True while a rebalancing phase is in progress."""
        return self.explorer is not None

    def steady_step(self) -> RuntimeStep:
        """A pipelined step on the committed config, without polling.

        For drivers that cannot consult the policy on some query (the
        live engine has no stage-time estimates before the first
        measurement) but still need a :class:`RuntimeStep` to execute.
        """
        return RuntimeStep(list(self.config), serial=False)

    def poll(self, source: StageTimeSource) -> RuntimeStep:
        """Advance the state machine by one query."""
        if self.explorer is None:
            if not self.policy.detect(self.config, source):
                return RuntimeStep(list(self.config), serial=False)
            self.explorer = self.policy.make_explorer(self.config)
            self.num_rebalances += 1

        trial_cfg = self.explorer.step(source)
        self._phase_steps += 1
        committed = False
        if self.explorer.done:
            self._commit(source)
            committed = True
        return RuntimeStep(list(trial_cfg), serial=True, committed=committed)

    def arm(self, source: StageTimeSource) -> None:
        """Prime detection with one observation, starting no phase.

        The live engine has no stage-time estimates until one query has
        been measured, so it calls this once after that query: 'now'
        becomes the detection baseline.  Any trigger is discarded.
        """
        self.policy.detect(self.config, source)

    def reset(self, config: Optional[Sequence[int]] = None) -> None:
        """Abandon any in-flight phase and re-arm the policy."""
        self.explorer = None
        self._phase_steps = 0
        if config is not None:
            self.config = list(config)
        self.policy.reset()

    # -- internals -----------------------------------------------------------
    def _commit(self, source: StageTimeSource) -> None:
        res = self.explorer.result()
        # Charge the serial queries the phase actually consumed, not
        # res.num_trials: explorer steps that could not apply a move log no
        # Trial but still serialized a query.
        self.total_trials += self._phase_steps
        self.mitigation_lengths.append(self._phase_steps)
        self.explorer = None
        self._phase_steps = 0
        self.config = list(res.config)
        self.policy.finish(self.config, source)
