"""Meshes over a ``torch.distributed`` process group.

Mirrors the JAX package's ``launch/mesh.py`` (``build_mesh``,
``make_production_mesh``, ``make_stage_mesh``, ``data_axes``).  Where a JAX mesh
lays devices out on named axes, a :class:`StageMesh` lays out the first
ranks of the default process group, which the caller has initialised:
rank ``r`` sits at the row-major coordinates of ``r`` in the mesh's shape,
and each rank runs on one explicit ``torch.device``.  A group larger than
the mesh gets a subgroup of those ranks, as JAX builds a mesh on the first
devices.  :func:`spawn_ranks` starts such a group of processes on one host.

The backend is the one the caller initialised the group with, never
guessed, and nothing falls back from one backend to the other:

* ``nccl`` needs one card a rank: rank ``r`` runs on ``cuda:r``.  NCCL
  refuses two ranks on one device, so fewer cards than ranks raise.
* ``gloo`` runs anywhere, on the device the caller names.  Its
  point-to-point ops take CPU tensors only, so the pipeline hands CUDA
  activations on through a host buffer (``pipeline/spmd.py``).
* ``fake`` has one use: the dry runs' production meshes of 256 or 512
  ranks in one process (:func:`production_group`), the counterpart of the
  JAX dry runs' placeholder host devices.  Its collectives move nothing,
  so it runs only on the meta device, and only when the caller names it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.util.device import resolve_device

BACKENDS = ("gloo", "nccl")      # what spawn_ranks starts
FAKE = "fake"                    # production_group's, on the meta device
PRODUCTION_WORLDS = (256, 512)   # the 16x16 and 2x16x16 meshes' ranks
# Seconds that spawn_ranks waits for the other ranks once one has failed,
# and for all of them to finish.
FAILURE_GRACE = 10.0
TIMEOUT = 600.0


@dataclasses.dataclass(frozen=True)
class StageMesh:
    """This rank's place on a mesh of ranks.

    ``shape`` maps each axis name to its size, in the order of
    ``axis_names``; ``coords`` maps each axis to this rank's index on it
    (what ``jax.lax.axis_index`` reads inside a ``shard_map``).  ``group``
    is the process group of the mesh's ranks: the default one, or a
    subgroup of its first ranks.
    """
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Dict[str, int]
    rank: int
    backend: str
    device: torch.device
    group: dist.ProcessGroup

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def rank_at(self, **coords: int) -> int:
        """The rank at ``coords``; an axis not named is taken at 0."""
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords.get(a, 0)
        return r

    def shifted(self, axis: str, step: int) -> Optional[int]:
        """The rank ``step`` places along ``axis`` from this one, the other
        coordinates kept; None past either end."""
        i = self.coords[axis] + step
        if not 0 <= i < self.shape[axis]:
            return None
        return self.rank_at(**{**self.coords, axis: i})

    @property
    def model_ranks(self) -> Tuple[int, ...]:
        """The ranks that share this rank's stage (its ``model`` axis)."""
        if "model" not in self.shape:
            return (self.rank,)
        return tuple(self.rank_at(**{**self.coords, "model": m})
                     for m in range(self.shape["model"]))


def rank_device(backend: str, rank: int, world_size: int,
                device: Union[str, torch.device, None] = None
                ) -> torch.device:
    """The explicit device of ``rank`` under ``backend``.

    ``nccl``: ``cuda:{rank}``, one card a rank (raises when the host has
    fewer cards than ranks, or when ``device`` names another).  ``gloo``:
    ``device`` (``"cuda"`` when None) with its index made explicit.
    ``fake``: the meta device, which the caller must name.
    """
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if cards < world_size:
            raise ValueError(
                f"nccl needs one card a rank: {world_size} ranks, {cards} "
                f"cards (NCCL refuses two ranks on one device)")
        dev = torch.device("cuda", rank)
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"nccl rank {rank} runs on {dev}, not {device}")
        return dev
    if backend == "gloo":
        dev = resolve_device("cuda" if device is None else device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if backend == FAKE:
        if device is None or torch.device(device).type != "meta":
            raise ValueError(f"the {FAKE} backend moves no data: it runs "
                             f"only on device='meta', not {device}")
        return torch.device("meta")
    raise ValueError(f"backend {backend!r}: a mesh runs over "
                     f"{', '.join(BACKENDS + (FAKE,))}")


def build_mesh(shape: Sequence[int], axes: Sequence[str], *,
               device: Union[str, torch.device, None] = None) -> StageMesh:
    """The one mesh-construction path (every builder here and
    ``repro_torch.pipeline.spmd.stage_mesh`` routes through it).

    Lays the default group's first ``prod(shape)`` ranks out row-major on
    ``shape``; raises ``ValueError`` when the group has fewer ranks than
    the mesh.  In a larger group every rank must call it, since the mesh's
    subgroup is made collectively, and the ranks past the mesh then raise
    ``ValueError``: they take no part in the mesh's work.
    """
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world < size:
        raise ValueError(f"{'x'.join(map(str, shape))} mesh needs >= {size} "
                         f"ranks, have {world}")
    group = (dist.group.WORLD if world == size
             else dist.new_group(list(range(size))))
    if rank >= size:
        raise ValueError(f"rank {rank} lies outside the "
                         f"{'x'.join(map(str, shape))} mesh")
    coords, r = {}, rank
    for a, s in reversed(list(zip(axes, shape))):
        coords[a], r = r % s, r // s
    backend = dist.get_backend()
    return StageMesh(axis_names=tuple(axes), shape=dict(zip(axes, shape)),
                     coords={a: coords[a] for a in axes}, rank=rank,
                     backend=backend,
                     device=rank_device(backend, rank, world, device),
                     group=group)


@contextlib.contextmanager
def production_group(world_size: int, rank: int = 0):
    """A ``fake`` default group of ``world_size`` ranks (256 or 512) in
    this process, which is its rank ``rank``; destroyed on exit.

    The dry runs place the production mesh on it (with ``device="meta"``):
    its collectives return at once and move nothing.  Raises
    ``RuntimeError`` when a default group exists already, which it never
    reuses or replaces.
    """
    if world_size not in PRODUCTION_WORLDS:
        raise ValueError(f"a production group has {PRODUCTION_WORLDS} "
                         f"ranks, not {world_size}")
    if dist.is_initialized():
        raise RuntimeError(f"a default process group "
                           f"({dist.get_backend()}, {dist.get_world_size()} "
                           f"ranks) exists already")
    # Importing the module registers the backend.
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group(FAKE, store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device: Union[str, torch.device, None] = None
                         ) -> StageMesh:
    """The production mesh: 16 x 16 on ``("data", "model")``, or with
    ``multi_pod`` 2 x 16 x 16 on ``("pod", "data", "model")``, over the
    default group's first 256 or 512 ranks (raises with fewer)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return build_mesh(shape, axes, device=device)


def make_stage_mesh(num_stages: int, *, model_parallel: int = 1,
                    device: Union[str, torch.device, None] = None
                    ) -> StageMesh:
    """Serving-pipeline mesh: ``stage`` = execution places (paper EPs),
    ``model`` = operator parallelism within an EP."""
    if model_parallel > 1:
        return build_mesh((num_stages, model_parallel), ("stage", "model"),
                          device=device)
    return build_mesh((num_stages,), ("stage",), device=device)


def data_axes(mesh) -> tuple:
    """Axes that shard the batch (pod composes with data)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


# -- processes ---------------------------------------------------------------


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str,
               init_file: str, args: tuple, results) -> None:
    # Ranks share the host's cores: one intra-op thread each.
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=world_size)
        try:
            out = fn(rank, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def spawn_ranks(fn: Callable, world_size: int, args: tuple = (), *,
                backend: str, init_file: str) -> List:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes joined in
    one ``backend`` group, and return their results in rank order.

    ``fn`` must be importable by name (a module-level function; a script's
    own functions are, when the script is run as a file), and should
    return plain Python or numpy values.  ``args`` are pickled, CUDA
    tensors through CUDA IPC: the ranks read the caller's memory, which
    the caller keeps alive.  ``init_file`` is the rendezvous file: a path
    no other group uses, which must not exist yet.  When a rank raises or
    dies, the others get ``FAILURE_GRACE`` seconds to report (a rank
    blocked on the lost one usually fails too), then every rank left is
    stopped and ``RuntimeError`` raised with each failed rank's
    traceback; past ``TIMEOUT`` seconds every rank is stopped and
    ``TimeoutError`` raised.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if os.path.exists(init_file):
        raise ValueError(f"rendezvous file {init_file} exists already")
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, fn, world_size, backend, init_file, args,
                               results))
             for r in range(world_size)]
    got, failed = {}, {}

    def drain():
        # A rank blocks on a full queue until its result is read.
        while not results.empty():
            rank, ok, out = results.get()
            (got if ok else failed)[rank] = out

    deadline = time.monotonic() + TIMEOUT
    give_up = None
    try:
        for p in procs:
            p.start()
        while len(got) + len(failed) < world_size:
            drain()
            for r, p in enumerate(procs):
                if (p.exitcode is not None and r not in got
                        and r not in failed):
                    drain()     # it may have written just before exiting
                    if r not in got and r not in failed:
                        failed[r] = f"exited with code {p.exitcode}"
            now = time.monotonic()
            if failed and give_up is None:
                give_up = now + FAILURE_GRACE
            if give_up is not None and now > give_up:
                break
            if now > deadline:
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} "
                                   f"ran past {TIMEOUT} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)
    if failed:
        raise RuntimeError(
            f"{len(failed)} of {world_size} ranks of {fn.__name__} failed:\n"
            + "\n".join(f"-- rank {r}: {failed[r]}" for r in sorted(failed)))
    return [got[r] for r in range(world_size)]
