"""The one rebalance state machine shared by simulator and live engine.

Both ``repro_torch.core.simulator.simulate`` and
``repro_torch.serving.ServingEngine.serve`` previously hand-rolled the same
loop (detect → drive the explorer one trial per serially-processed query
→ commit) with drifting details; :class:`RebalanceRuntime` owns it once.

Per query the driver calls :meth:`poll` with the current
:class:`~repro_torch.core.pipeline_state.StageTimeSource` and receives the
configuration the query must run with plus whether it is a serial
(exploration-trial) query:

* no phase active, ``policy.detect`` quiet → steady pipelined query;
* ``detect`` fires → a phase starts.  Serial explorers (ODIN, LLS,
  hybrid) consume one query per ``step()``; *instant* explorers
  (``serial = False``, e.g. the DP oracle) run to completion inside the
  same poll and the query proceeds pipelined on the new configuration —
  which is exactly the old ``if scheduler == "oracle"`` special case,
  now expressed as a normal policy;
* the explorer finishing commits its result: the runtime adopts the
  configuration, updates trial accounting, and calls ``policy.finish``
  so detection re-arms against the post-rebalance bottleneck.

Accounting matches the paper's: ``num_rebalances`` counts phases that
cost at least one serial query (the oracle is free), ``total_trials`` /
``mitigation_lengths`` mirror Fig. 8's exploration overhead.

The port's copy of the JAX package's ``schedulers/runtime.py``; only import
paths differ.  ``tests/test_torch_control.py`` holds it equal to the
original.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Optional, Sequence

if TYPE_CHECKING:  # annotation-only: keeps repro_torch.core <-> schedulers acyclic
    from repro_torch.core.pipeline_state import StageTimeSource
    from repro_torch.schedulers.base import SchedulerPolicy


@dataclasses.dataclass
class RuntimeStep:
    """What one polled query should do."""
    config: List[int]          # configuration to process the query with
    serial: bool               # True = exploration trial (serial query)
    committed: bool = False    # a rebalancing phase committed at this step
    #: Mesh assignment (devices per stage) the query runs with;
    #: ``None`` on unsharded runs (docs/SHARDING.md).
    mesh: Optional[List[int]] = None


class RebalanceRuntime:
    """Detect → explore → commit driver around one SchedulerPolicy."""

    #: Safety bound on instant (serial=False) explorers, which complete
    #: inside a single poll: a plugin explorer that never sets ``done``
    #: raises instead of hanging the serving loop.
    MAX_INSTANT_STEPS = 10_000

    def __init__(self, policy: SchedulerPolicy, config: Sequence[int],
                 mesh: Optional[Sequence[int]] = None):
        self.policy = policy
        self.policy.reset()       # a runtime is a fresh serving window
        self.config = list(config)
        #: Committed mesh assignment (devices per stage); ``None`` on
        #: unsharded runs — every mesh branch below is then dead and
        #: the runtime is bit-identical to the pre-mesh build.
        self.mesh = list(mesh) if mesh is not None else None
        self.num_mesh_resizes = 0
        self.explorer = None
        self.num_rebalances = 0
        self.total_trials = 0
        self.mitigation_lengths: List[int] = []
        self._phase_steps = 0     # serial queries consumed by this phase
        #: Most recent StageTimeSource this runtime was polled/armed
        #: with; what read-only observers (the cluster's routers) probe
        #: for the replica's current estimated stage times.
        self.last_source: Optional[StageTimeSource] = None

    @property
    def exploring(self) -> bool:
        """True while a rebalancing phase is in progress."""
        return self.explorer is not None

    def steady_poll_stable(self) -> bool:
        """True when one steady ``poll`` answers for a whole chunk.

        The run loop's vectorized fast path polls once per
        environment-steady segment instead of once per query.  That is
        equivalent exactly when the policy advertises
        ``steady_detect_stable``: ``detect`` is side-effect-free and
        returns the same answer while (config, stage times) are
        unchanged, including immediately after ``finish`` re-arms it.
        True for the built-in policies on the paper's pure relative
        threshold; False for the EMA/hysteresis detector mode (every
        observation moves the reference) and for unknown plugins.
        """
        return bool(getattr(self.policy, "steady_detect_stable", False))

    def steady_step(self) -> RuntimeStep:
        """A pipelined step on the committed config, without polling.

        For drivers that cannot consult the policy on some query (the
        live engine has no stage-time estimates before the first
        measurement) but still need a :class:`RuntimeStep` to execute.
        """
        return RuntimeStep(list(self.config), serial=False,
                           mesh=self._mesh_copy())

    # -- read-only state exposure (cluster routing; docs/CLUSTER.md) ---------
    def interference_score(self) -> float:
        """Positive relative bottleneck degradation the policy's
        detector currently sees vs. its armed reference — ``0.0`` when
        quiet, when the policy has no detector (static / oracle), or
        before any poll.  Side-effect-free: probing never advances
        detector state.
        """
        det = getattr(self.policy, "detector", None)
        if det is None or self.last_source is None:
            return 0.0
        return max(0.0, det.shift(self.config, self.last_source))

    def interference_active(self) -> bool:
        """True when the detector's current shift exceeds its trigger
        threshold — the replica-level "interference present" signal the
        ``odin_aware`` router keys on."""
        det = getattr(self.policy, "detector", None)
        if det is None or self.last_source is None:
            return False
        return self.interference_score() > det.rel_threshold

    def estimated_bottleneck(self) -> float:
        """Estimated bottleneck stage time of the committed config from
        the most recent polled time source (NaN before any poll) — the
        per-query service-time estimate routers cost replicas with."""
        if self.last_source is None:
            return float("nan")
        from repro_torch.schedulers.base import bottleneck_time
        return bottleneck_time(self.config, self.last_source)

    def estimated_service_latency(self) -> float:
        """Estimated end-to-end (pipelined) latency of one query on the
        committed config from the most recent polled time source (NaN
        before any poll) — occupied stages × bottleneck beat, the
        latency estimate admission policies compare against an SLO
        (docs/CONTROL.md)."""
        if self.last_source is None:
            return float("nan")
        from repro_torch.core.pipeline_state import pipelined_latency
        return pipelined_latency(self.last_source.stage_times(self.config))

    def poll(self, source: StageTimeSource) -> RuntimeStep:
        """Advance the state machine by one query."""
        self.last_source = source
        self._sync_mesh(source)
        if self.explorer is None:
            if not self.policy.detect(self.config, source):
                return RuntimeStep(list(self.config), serial=False,
                                   mesh=self._mesh_copy())
            if self.mesh is not None:
                self.explorer = self.policy.make_explorer(self.config,
                                                          mesh=self.mesh)
            else:
                self.explorer = self.policy.make_explorer(self.config)
            if self._serial_phase:
                self.num_rebalances += 1

        if not self._serial_phase:
            # Instant policy: commit within this poll; the query itself
            # runs pipelined on the new configuration.
            for _ in range(self.MAX_INSTANT_STEPS):
                if self.explorer.done:
                    break
                self.explorer.step(source)
            else:
                raise RuntimeError(
                    f"instant explorer {type(self.explorer).__name__} "
                    f"(policy {type(self.policy).__name__}) did not "
                    f"finish within {self.MAX_INSTANT_STEPS} steps")
            self._commit(source)
            return RuntimeStep(list(self.config), serial=False,
                               committed=True, mesh=self._mesh_copy())

        trial_mesh = None
        if self.mesh is not None:
            trial_mesh = list(getattr(self.explorer, "A", self.mesh))
        trial_cfg = self.explorer.step(source)
        if self.mesh is not None:
            # The step may itself have moved a device; report the
            # assignment the trial query actually runs with.
            trial_mesh = list(getattr(self.explorer, "A", trial_mesh))
        self._phase_steps += 1
        committed = False
        if self.explorer.done:
            self._commit(source)
            committed = True
        return RuntimeStep(list(trial_cfg), serial=True,
                           committed=committed, mesh=trial_mesh)

    def arm(self, source: StageTimeSource) -> None:
        """Prime detection with one observation, starting no phase.

        Drivers that cannot poll from the very first query (the live
        engine has no stage-time estimates until one query has been
        measured) call this once so 'now' becomes the detection
        baseline — the same thing the first ``poll``'s ``detect`` call
        does in the simulator.  Any trigger is discarded.
        """
        self.last_source = source
        self._sync_mesh(source)
        self.policy.detect(self.config, source)

    def reset(self, config: Optional[Sequence[int]] = None,
              mesh: Optional[Sequence[int]] = None) -> None:
        """Abandon any in-flight phase and re-arm the policy."""
        self.explorer = None
        self._phase_steps = 0
        self.last_source = None
        if config is not None:
            self.config = list(config)
        if mesh is not None:
            self.mesh = list(mesh)
        self.policy.reset()

    # -- internals -----------------------------------------------------------
    @property
    def _serial_phase(self) -> bool:
        return getattr(self.explorer, "serial", True)

    def _mesh_copy(self) -> Optional[List[int]]:
        return list(self.mesh) if self.mesh is not None else None

    def _sync_mesh(self, source: StageTimeSource) -> None:
        """Push the committed assignment onto mesh-aware time sources so
        single-argument ``stage_times(config)`` calls (detectors, the
        read-only estimators above) price the current slices."""
        if self.mesh is not None and hasattr(source, "assignment"):
            source.assignment = list(self.mesh)

    def _commit(self, source: StageTimeSource) -> None:
        res = self.explorer.result()
        if self._serial_phase:
            # Charge the serial queries the phase actually consumed, not
            # res.num_trials: explorer steps that could not apply a move
            # log no Trial but still serialized a query.
            self.total_trials += self._phase_steps
            self.mitigation_lengths.append(self._phase_steps)
        self.explorer = None
        self._phase_steps = 0
        self.config = list(res.config)
        res_mesh = getattr(res, "mesh", None)
        if self.mesh is not None and res_mesh is not None:
            if list(res_mesh) != list(self.mesh):
                self.num_mesh_resizes += 1
            self.mesh = list(res_mesh)
            self._sync_mesh(source)
        self.policy.finish(self.config, source)
