"""SPMD pipeline-parallel execution (bind-to-stage on mesh slices).

Mirrors the JAX package's ``pipeline/spmd.py``.  The paper's execution
places are the ranks of a :class:`~repro_torch.launch.mesh.StageMesh`: a
``stage`` axis partitions them into N places, and each holds a *padded*
tile of the stacked block parameters (``[cap, ...]``, cap >= the largest
stage ODIN may create).  The live block count per stage is a run-time
argument, so ODIN rebalancing = a repack of the tile + a new count vector,
never a rebuild.

The schedule is GPipe fill/drain over M microbatches: each rank runs one
program (``make_pipeline_fn``), and activations go to the next stage with
``torch.distributed`` point-to-point ops each step, where JAX uses
``ppermute``.  Empty stages (count 0) forward activations untouched, which
is exactly the paper's "pipeline may shorten by one stage" semantics.

The ``model`` axis, where there is one, holds ranks that compute the same
stage (JAX's ``shard_map`` here also owns only the stage axis); no tensor
is sharded over it.

Unlike the JAX version, where the mesh shards one ``[n, cap, ...]`` array,
a rank gathers and keeps only its own tile (``stage_tile``): all ``n``
tiles of a full-width model on every rank would not fit beside each other.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import StageMesh, make_stage_mesh
from repro_torch.launch.roofline import CollectiveRecord
from repro_torch.models import blocks as blk
from repro_torch.models.layers import embed, rms_norm, unembed
from repro_torch.util.tree import leaves, tree_map


def stage_mesh(num_stages: int, *, model_parallel: int = 1,
               device=None) -> StageMesh:
    """The SPMD pipeline's mesh, built through the single shared
    constructor in :mod:`repro_torch.launch.mesh`.  ``stage`` partitions
    the ranks into execution places; ``model`` holds ranks that share
    one."""
    return make_stage_mesh(num_stages, model_parallel=model_parallel,
                           device=device)


def stage_tile(stacked_blocks: Dict, config: Sequence[int], cap: int,
                stage: int) -> Dict:
    """Stage ``stage``'s ``[cap, ...]`` tile of ``[L, ...]`` stacked blocks.

    Its blocks ``[lo, lo + count)`` fill slots ``[0, count)``; the padding
    slots hold the next blocks, clipped to the last (never executed).  A
    new tensor: a rebalance re-materialises it -- the weight-migration
    cost the paper pays when moving layers between EPs.
    """
    leaf = leaves(stacked_blocks)[0]
    lo = sum(int(c) for c in config[:stage])
    idx = (torch.arange(cap, device=leaf.device) + lo).clip(0,
                                                            leaf.shape[0] - 1)
    return tree_map(lambda p: p.index_select(0, idx), stacked_blocks)


def pack_stage_params(stacked_blocks: Dict, config: Sequence[int],
                      cap: int) -> Dict:
    """Repack ``[L, ...]`` stacked blocks into ``[num_stages, cap, ...]``
    tiles, each stage's as :func:`stage_tile` gathers it (what the JAX
    mesh shards; a rank of :func:`make_pipeline_fn` keeps only its own)."""
    tiles = [stage_tile(stacked_blocks, config, cap, s)
             for s in range(len(config))]
    return tree_map(lambda *ls: torch.stack(ls), *tiles)


class PipelineFn:
    """One rank's program of the GPipe schedule (see
    :func:`make_pipeline_fn`).

    ``sends`` counts the activations this rank handed to the next stage
    and ``host_copies`` the tensors it moved through a host buffer: under
    gloo, whose point-to-point ops take CPU tensors only, a CUDA
    activation is copied to a host tensor to be sent and out of one when
    received, and so is the final broadcast.  On a mesh on the meta device
    (the dry run's, over a fake group, whose point-to-point ops refuse
    meta tensors) each hand-off goes through an empty CPU tensor of its
    shape and dtype, since a meta tensor holds nothing to copy, and lands
    as a meta tensor again.  ``collectives`` records the
    bytes of each executed call under the JAX roofline's kind names: a
    hand-off as ``collective-permute`` (JAX's ``ppermute``), the final
    broadcast as ``all-reduce`` (its payload is what JAX's masked
    ``psum`` moves).
    """

    def __init__(self, cfg: ModelConfig, mesh: StageMesh, stage_axis: str,
                 num_microbatches: int, cap: int):
        self.cfg = cfg
        self.mesh = mesh
        self.M = int(num_microbatches)
        self.cap = int(cap)
        self.n_stages = mesh.shape[stage_axis]
        self.stage = mesh.axis_index(stage_axis)
        self.prev = mesh.shifted(stage_axis, -1)
        self.next = mesh.shifted(stage_axis, 1)
        # Every rank takes the outputs from the last stage's first rank.
        self.last = mesh.rank_at(**{stage_axis: self.n_stages - 1})
        self.staged = mesh.backend == "gloo" and mesh.device.type == "cuda"
        self.meta = mesh.device.type == "meta"
        self.sends = 0
        self.host_copies = 0
        self.collectives = CollectiveRecord()

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the group moves for ``t``: a host copy under gloo,
        an empty CPU tensor on the meta device."""
        if self.meta:
            return self._buffer(t)
        if not self.staged:
            return t
        self.host_copies += 1
        return t.to("cpu")

    def _buffer(self, like: torch.Tensor) -> torch.Tensor:
        return torch.empty(like.shape, dtype=like.dtype,
                           device="cpu" if self.staged or self.meta
                           else like.device)

    def _landed(self, buf: torch.Tensor) -> torch.Tensor:
        if self.meta:
            return torch.empty(buf.shape, dtype=buf.dtype, device="meta")
        if not self.staged:
            return buf
        self.host_copies += 1
        return buf.to(self.mesh.device)

    def _stage_compute(self, tile: Dict, x: torch.Tensor,
                       positions: torch.Tensor, count: int) -> torch.Tensor:
        for i in range(count):
            x, _ = blk.block_forward(blk.block_params(tile, i), self.cfg, x,
                                     positions)
        return x

    @torch.inference_mode()
    def __call__(self, stage_params: Dict, counts: Sequence[int],
                 inputs: torch.Tensor) -> torch.Tensor:
        counts = [int(c) for c in counts]
        if len(counts) != self.n_stages:
            raise ValueError(f"{len(counts)} counts for {self.n_stages} "
                             f"stages")
        if not all(0 <= c <= self.cap for c in counts):
            raise ValueError(f"counts {counts} outside [0, cap {self.cap}]")
        if inputs.shape[0] != self.M:
            raise ValueError(f"inputs hold {inputs.shape[0]} microbatches, "
                             f"the schedule {self.M}")
        count = counts[self.stage]
        M, mb, S, _ = inputs.shape
        positions = torch.arange(S, device=inputs.device).expand(mb, S)
        is_last = self.stage == self.n_stages - 1
        outputs = torch.zeros_like(inputs)
        x_cur = torch.zeros_like(inputs[0])
        for t in range(self.n_stages + M - 1):
            mb_idx = t - self.stage
            active = 0 <= mb_idx < M
            # stage 0 pulls microbatch t from the input queue
            x_in = inputs[min(t, M - 1)] if self.stage == 0 else x_cur
            y = (self._stage_compute(stage_params, x_in, positions, count)
                 if active else x_in)
            # Hand activations to the next stage.  Only an active step's
            # output is ever read there (the next stage is active at t + 1
            # exactly when this one is at t), so the other steps send
            # nothing, where ppermute moves every step's.
            ops, recv = [], None
            if active and self.next is not None:
                ops.append(dist.P2POp(dist.isend, self._wire(y), self.next,
                                      self.mesh.group))
                self.sends += 1
                self.collectives.add("collective-permute", "stage hand-off",
                                     y.numel() * y.element_size())
            if self.prev is not None and 0 <= t - (self.stage - 1) < M:
                recv = self._buffer(x_cur)
                ops.append(dist.P2POp(dist.irecv, recv, self.prev,
                                      self.mesh.group))
            if ops:
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
            if recv is not None:
                x_cur = self._landed(recv)
            # the last stage commits its finished microbatch
            if is_last and active:
                outputs[mb_idx] = y
        # Broadcast the last stage's buffer to every rank (JAX takes a
        # masked psum over the stage axis; both give the same values).
        buf = (self._wire(outputs) if self.mesh.rank == self.last
               else self._buffer(outputs))
        dist.broadcast(buf, self.last, group=self.mesh.group)
        self.collectives.add("all-reduce", "output broadcast",
                             buf.numel() * buf.element_size())
        return self._landed(buf)


def make_pipeline_fn(cfg: ModelConfig, mesh: StageMesh, *,
                     stage_axis: str = "stage", num_microbatches: int = 4,
                     cap: int) -> PipelineFn:
    """Build this rank's pipelined forward.

    Signature: fn(stage_params, counts, inputs) -> outputs
      stage_params: this rank's ``[cap, ...]`` tile (:func:`stage_tile`
                    of its stage), on ``mesh.device``
      counts:       ``[n_stages]`` live block counts (ints)
      inputs:       ``[M, mb, S, d]`` embedded microbatches (every rank's
                    the same; stage 0 reads them)
      outputs:      ``[M, mb, S, d]`` final hidden states (on every rank)

    Every rank of the mesh calls ``fn`` with the same counts and input
    shapes.  Rank ``s`` of the stage axis runs ``n + M - 1`` steps and
    works on microbatch ``t - s`` at step ``t``: its blocks ``[0,
    count)`` on what stage 0 pulled from ``inputs`` or what it received,
    its input unchanged on an inactive step or with a count of 0.  The
    hand-offs of a step are one ``batch_isend_irecv``; a ``model`` rank
    ``(s, m)`` hands to ``(s + 1, m)``.  The outputs reach every rank by
    a ``broadcast`` from the last stage.  Runs under
    ``torch.inference_mode()``.
    """
    return PipelineFn(cfg, mesh, stage_axis, num_microbatches, cap)


def pipelined_forward(cfg: ModelConfig, mesh: StageMesh,
                      stacked_blocks: Dict, config: Sequence[int],
                      inputs: torch.Tensor, *, cap: int,
                      stage_axis: str = "stage",
                      num_microbatches: int = 4) -> torch.Tensor:
    """Convenience wrapper: pack this rank's tile + run.  inputs:
    ``[M, mb, S, d]`` embedded."""
    tile = stage_tile(stacked_blocks, config, cap,
                       mesh.axis_index(stage_axis))
    fn = make_pipeline_fn(cfg, mesh, stage_axis=stage_axis,
                          num_microbatches=num_microbatches, cap=cap)
    return fn(tile, list(config), inputs)


class SpmdPipelineExecutor:
    """Physical sharded-stage execution -- the SPMD counterpart of
    :class:`repro_torch.pipeline.executor.LocalPipelineExecutor`.

    Every rank of the mesh builds one and calls ``run_query`` with the same
    tokens and config.  Each pipeline stage owns one slice of a
    :func:`stage_mesh`; a query runs embed -> GPipe-schedule stages
    (point-to-point hand-offs between ranks) -> head, and ODIN rebalancing
    stays rebuild-free because the live block counts are run-time
    arguments.  ``params`` (every rank's the same) lie on the mesh's
    device.  Requires a group of at least ``num_stages * model_parallel``
    ranks; ``mesh`` defaults to :func:`stage_mesh` over the default group's
    first ranks (the others raise ``ValueError``, see
    :func:`~repro_torch.launch.mesh.build_mesh`).
    """

    def __init__(self, cfg: ModelConfig, params: Dict, num_stages: int, *,
                 cap: int = 0, model_parallel: int = 1,
                 num_microbatches: int = 1,
                 mesh: Optional[StageMesh] = None):
        self.mesh = mesh if mesh is not None else stage_mesh(
            num_stages, model_parallel=model_parallel)
        if self.mesh.shape["stage"] != num_stages:
            raise ValueError(f"a mesh of {self.mesh.shape['stage']} stages "
                             f"for {num_stages}")
        self.cfg = cfg
        self.params = params
        self.cap = int(cap) if cap else cfg.num_blocks
        self.M = int(num_microbatches)
        self._fn = make_pipeline_fn(cfg, self.mesh,
                                    num_microbatches=self.M, cap=self.cap)

    @torch.inference_mode()
    def run_query(self, tokens: torch.Tensor,
                  config: Sequence[int]) -> torch.Tensor:
        """Run ``[B, S]`` tokens through the sharded pipeline of
        ``config``; returns logits ``[B, S, V]``.  ``B`` is padded up to
        a multiple of the microbatch count, padding rows dropped."""
        tokens = tokens.to(self.mesh.device)
        B, S = tokens.shape
        mb = -(-B // self.M)  # rows per microbatch, padded up
        if mb * self.M > B:
            tokens = torch.cat(
                [tokens, tokens.new_zeros((mb * self.M - B, S))])
        x = embed(self.params["embed"], tokens)
        inputs = x.reshape(self.M, mb, S, -1)
        tile = stage_tile(self.params["blocks"], config, self.cap,
                           self.mesh.axis_index("stage"))
        out = self._fn(tile, list(config), inputs)
        h = out.reshape(mb * self.M, S, -1)[:B]
        h = rms_norm(h, self.params["final_norm"]["scale"],
                     self.cfg.rms_eps)
        return unembed(self.params["head"], h)
