"""Pipeline-stage executor that times each stage.

Mirrors the JAX package's ``pipeline/executor.py``.  The model's blocks
are stacked along a leading ``[num_blocks, ...]`` axis; one
``stage_fn(x, positions, lo, hi)`` runs blocks ``[lo, hi)`` with the
bounds given at run time, so the ODIN rebalancer can move blocks between
stages without rebuilding anything.  Every stage runs on one device,
one after the other, and its wall time is measured -- the signal ODIN
consumes.  On CUDA the time is bracketed by ``torch.cuda.synchronize()``,
where JAX waits with ``block_until_ready()``.  All execution runs under
``torch.inference_mode()``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.mesh import (
    collective_frac as mesh_collective_frac,
    mesh_stage_times,
)
from repro_torch.models import blocks as blk
from repro_torch.models.layers import embed, rms_norm, unembed
from repro_torch.util.device import resolve_device
from repro_torch.util.errors import MixedSequenceLengthError


def stage_bounds(config: Sequence[int]) -> List[tuple]:
    """[(lo, hi)] block ranges per stage for a layer-count config."""
    out, lo = [], 0
    for c in config:
        out.append((lo, lo + c))
        lo += c
    return out


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (max(int(n), 1) - 1).bit_length()


def _tree_to(tree: Dict, device: torch.device) -> Dict:
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


class LocalPipelineExecutor:
    """Executes a stage-partitioned model on one device, timing each stage.

    ``params`` are moved to ``device`` (a no-op when they are there).
    """

    def __init__(self, cfg: ModelConfig, params: Dict,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _tree_to(params, self.device)
        # Views of each block's parameters, built once.
        self._blocks = [blk.block_params(self.params["blocks"], i)
                        for i in range(cfg.num_blocks)]
        self._warmed = set()       # (batch, seq) shapes already run

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _positions(self, B: int, S: int) -> torch.Tensor:
        return torch.arange(S, device=self.device).expand(B, S)

    @torch.inference_mode()
    def stage_fn(self, x: torch.Tensor, positions: torch.Tensor, lo: int,
                 hi: int) -> torch.Tensor:
        """Blocks ``[lo, hi)`` over ``x`` (bounds are run-time values); the
        blocks' router statistics are dropped, as the JAX stage_fn drops
        them."""
        for i in range(lo, hi):
            x, _ = blk.block_forward(self._blocks[i], self.cfg, x, positions)
        return x

    # -- warmup ---------------------------------------------------------------
    def warmup(self, batch: int, seq: int) -> None:
        """Run one (batch, seq) query through every block, so library
        handles and allocator pools exist before anything is timed."""
        x = torch.zeros((batch, seq), dtype=torch.long, device=self.device)
        self.run_query(x, [self.cfg.num_blocks])
        self._warmed.add((batch, seq))

    def ensure_warm(self, batch: int, seq: int) -> None:
        """Warm the (batch, seq) input shape if not yet seen, so a batched
        dispatch never measures a first-shape allocation as service
        time."""
        if (batch, seq) not in self._warmed:
            self.warmup(batch, seq)

    def warm_buckets(self, seq_buckets: Sequence[int],
                     max_batch: int) -> None:
        """Warm exactly the length-bucketed dispatch shapes.

        Bucketed dispatch pads every batch to a power-of-two row count
        and every query to its length-bucket edge, so the full shape set
        is ``{1, 2, 4, .., next_pow2(max_batch)} x seq_buckets`` -- a
        small closed set, keeping ``_warmed`` bounded however many
        distinct raw ``(batch, seq)`` combinations the traffic offers.
        """
        rows, r = [], 1
        cap = next_pow2(max_batch)
        while r <= cap:
            rows.append(r)
            r *= 2
        for seq in seq_buckets:
            for b in rows:
                self.ensure_warm(b, int(seq))

    # -- execution --------------------------------------------------------------
    @torch.inference_mode()
    def embed_tokens(self, tokens: torch.Tensor) -> tuple:
        """Embed ``[B, S]`` tokens -> (hidden ``[B, S, D]``, positions).

        Synchronises, so the first stage's measured time never includes
        the embedding.
        """
        tokens = tokens.to(self.device)
        B, S = tokens.shape
        x = embed(self.params["embed"], tokens)
        self._sync()
        return x, self._positions(B, S)

    def run_stages(self, x: torch.Tensor, positions: torch.Tensor,
                   config: Sequence[int], lo_stage: int, hi_stage: int,
                   slowdowns: Optional[Sequence[float]] = None,
                   bounds: Optional[List[tuple]] = None) -> tuple:
        """Run stages ``[lo_stage, hi_stage)`` of ``config`` over ``x``.

        The stage-granular entry point of continuous batching: a batch
        can stop at any stage boundary, take newly arrived (embedded and
        caught-up) rows along the batch axis, and resume with the same
        ``stage_fn``.  Returns ``(x, times)`` where ``times[s]`` is the
        measured wall time of stage ``lo_stage + s``.  ``slowdowns``
        emulates co-located interference per EP by stretching the
        measured stage time with a sleep, physically delaying the
        pipeline.  ``bounds`` takes ``stage_bounds(config)`` from a caller
        that runs one stage at a time and computed it once.
        """
        if bounds is None:
            bounds = stage_bounds(config)
        times = np.zeros(hi_stage - lo_stage)
        for s in range(lo_stage, hi_stage):
            lo, hi = bounds[s]
            t0 = time.perf_counter()
            x = self.stage_fn(x, positions, lo, hi)
            self._sync()
            dt = time.perf_counter() - t0
            if slowdowns is not None and slowdowns[s] > 1.0:
                extra = dt * (slowdowns[s] - 1.0)
                time.sleep(extra)
                dt += extra
            times[s - lo_stage] = dt
        return x, times

    @torch.inference_mode()
    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + unembed, synchronised."""
        x = rms_norm(x, self.params["final_norm"]["scale"], self.cfg.rms_eps)
        logits = unembed(self.params["head"], x)
        self._sync()
        return logits

    def run_query(self, tokens: torch.Tensor, config: Sequence[int],
                  slowdowns: Optional[Sequence[float]] = None) -> tuple:
        """Run one query through the pipeline of ``config``.

        Returns (logits, stage_times_seconds ndarray).  The scheduler only
        ever sees measured times.
        """
        x, positions = self.embed_tokens(tokens)
        x, times = self.run_stages(x, positions, config, 0, len(config),
                                   slowdowns=slowdowns)
        return self.head(x), times

    def run_batch(self, queries: Sequence[torch.Tensor],
                  config: Sequence[int],
                  slowdowns: Optional[Sequence[float]] = None) -> tuple:
        """Run a stacked batch of ``[B_i, S]`` queries through the pipeline
        once.  Returns (logits ``[sum(B_i), S, V]``, stage_times).

        A single-query batch is forwarded as it is; mixed sequence lengths
        raise :class:`MixedSequenceLengthError`.
        """
        if len(queries) == 0:
            raise ValueError("run_batch needs at least one query")
        if len(queries) == 1:
            tokens = queries[0]
        else:
            lengths = [int(t.shape[-1]) for t in queries]
            if len(set(lengths)) != 1:
                raise MixedSequenceLengthError(lengths)
            tokens = torch.cat([t.to(self.device) for t in queries])
        return self.run_query(tokens, config, slowdowns=slowdowns)

    def measure_block_times(self, tokens: torch.Tensor,
                            repeats: int = 3) -> np.ndarray:
        """Per-block clean execution times (min over ``repeats``)."""
        x, positions = self.embed_tokens(tokens)
        L = self.cfg.num_blocks
        times = np.zeros((repeats, L))
        for r in range(repeats):
            h = x
            for i in range(L):
                t0 = time.perf_counter()
                h = self.stage_fn(h, positions, i, i + 1)
                self._sync()
                times[r, i] = time.perf_counter() - t0
        return times.min(axis=0)


class MeasuredTimeSource:
    """StageTimeSource over real measured per-block times + live scenarios.

    Stage time = sum of its blocks' measured clean times × the EP's
    current slowdown; one ``np.add.reduceat`` over the config's block
    offsets.

    With a :class:`~repro_torch.core.mesh.MeshSpec` attached the source
    additionally models mesh-sliced stages (docs/SHARDING.md): the
    measured compute time divides by the stage's device count and a
    modeled collective term is added via
    :func:`~repro_torch.core.mesh.mesh_stage_times` -- the same cost model
    the simulator uses, so a live scheduler reasons over (boundary, slice)
    moves from measured data.  ``assignment`` is the committed slice
    vector (the runtime keeps it synced); ``coll_factor`` is the live
    collective-contention estimate (1.0 when quiet).  ``mesh=None`` (the
    default) touches none of this.  A copy of the JAX package's class;
    ``tests/test_torch_pipeline.py`` holds it equal to the original.
    """

    def __init__(self, block_times: np.ndarray, slowdowns: np.ndarray,
                 mesh=None, coll_times: Optional[np.ndarray] = None,
                 assignment: Optional[Sequence[int]] = None,
                 coll_factor: float = 1.0):
        self.block_times = np.asarray(block_times, float)
        self.slowdowns = np.asarray(slowdowns, float)  # per EP
        self.mesh = mesh  # MeshSpec or None
        self.coll_times = (np.asarray(coll_times, float)
                           if coll_times is not None
                           else (mesh.layer_costs(len(self.block_times))
                                 if mesh is not None else None))
        self.assignment = (list(assignment) if assignment is not None
                           else None)
        self.coll_factor = float(coll_factor)

    def _compute_times(self, config: Sequence[int]) -> np.ndarray:
        counts = np.asarray(config, dtype=np.int64)
        out = np.zeros(len(counts))
        nz = counts > 0
        if nz.any():
            starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
            # reduceat over the offsets of non-empty stages only: each
            # segment then ends exactly at the next non-empty stage's
            # start (empty stages contribute no blocks and stay 0).
            out[nz] = np.add.reduceat(self.block_times, starts[nz])
        return out * self.slowdowns

    def stage_times(self, config: Sequence[int],
                    assignment: Optional[Sequence[int]] = None
                    ) -> np.ndarray:
        compute = self._compute_times(config)
        if self.mesh is None:
            return compute
        a = assignment if assignment is not None else self.assignment
        if a is None:
            return compute
        return mesh_stage_times(compute, config, a, self.mesh,
                                self.coll_factor,
                                layer_costs=self.coll_times)

    def collective_frac(self, config: Sequence[int],
                        assignment: Optional[Sequence[int]] = None
                        ) -> float:
        """Bottleneck stage's modeled collective share (the live
        ``collective_frac`` trace column); 0.0 unsharded."""
        if self.mesh is None:
            return 0.0
        a = assignment if assignment is not None else self.assignment
        if a is None:
            return 0.0
        return mesh_collective_frac(self._compute_times(config), config, a,
                                    self.mesh, self.coll_factor,
                                    layer_costs=self.coll_times)
