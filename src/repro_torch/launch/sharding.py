"""Sharding rules: parameters, optimizer state, caches, batches.

The port's copy of the JAX package's ``launch/sharding.py``, rule for rule.
Strategy: a 2D/3D FSDP x TP grid.

* last dim of every >= 2-D weight -> ``model`` (tensor parallel),
* second-to-last dim -> ``data`` (+``pod``) (ZeRO-3 / FSDP),
* stacked-block leading dim and 1-D params stay replicated,
* MoE expert dim -> ``model`` when divisible (expert parallelism takes
  precedence over per-expert TP),
* batch dims of activations / caches -> ``data`` (+``pod``); for the
  single-request long-context shape the cache sequence dim is sharded
  instead (see :func:`cache_shardings`).

Divisibility is checked per leaf; non-divisible dims fall back to
replication, so every (arch x mesh) combination has a sharding.

A rule gives each leaf a :class:`LeafSharding` in two forms: ``spec``, the
JAX-shaped spec (one entry per tensor dim, each ``None``, an axis name or
a tuple of axis names: what ``PartitionSpec`` holds), and ``placements``,
its ``torch.distributed.tensor`` placements (one ``Shard(d)`` or
``Replicate()`` per *mesh* axis, in the mesh's axis order).  A tensor dim
split over several mesh axes gets ``Shard(d)`` on each of them, which
DTensor splits in mesh order: JAX's order for a tuple of axes that follows
the mesh's, as every tuple here does.  Each leaf also carries its
per-device shard shape; only divisible dims are ever sharded, so that is
exact division.

The rules read only a mesh's ``shape`` (a mapping of axis sizes) and
``axis_names``: a ``launch.mesh.StageMesh``, or anything else that has
them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import data_axes


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return int(math.prod(mesh.shape[a] for a in axes))


def _fits(dim: int, mesh, axes) -> bool:
    return dim % _axsize(mesh, axes) == 0


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec``: for each mesh axis in order,
    ``Shard(d)`` where tensor dim ``d`` is split over it, else
    ``Replicate()``.  A spec that names an axis twice raises
    ``ValueError``."""
    names = tuple(mesh.axis_names)
    named = [a for entry in spec for a in _axes(entry)]
    if len(set(named)) != len(named):
        # JAX's NamedSharding refuses it too (DuplicateSpecError)
        raise ValueError(f"{spec} names a mesh axis twice")
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: the axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def shard_shape(shape, spec: tuple, mesh) -> Tuple[int, ...]:
    """The per-device shape of a ``shape`` leaf under ``spec``: each
    sharded dim divided by the product of its axes (which divides it)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n = _axsize(mesh, _axes(entry) or None)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {entry} ({n} devices)")
        out[d] //= n
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class LeafSharding:
    """One leaf's sharding: the JAX-shaped ``spec``, its DTensor
    ``placements``, and the leaf's global and per-device shapes."""
    spec: tuple
    placements: tuple
    shape: Tuple[int, ...]
    shard_shape: Tuple[int, ...]
    itemsize: int

    @property
    def shard_bytes(self) -> int:
        return math.prod(self.shard_shape) * self.itemsize


def leaf_sharding(leaf: torch.Tensor, spec, mesh) -> LeafSharding:
    spec = tuple(spec)
    return LeafSharding(spec=spec, placements=placements(spec, mesh),
                        shape=tuple(leaf.shape),
                        shard_shape=shard_shape(leaf.shape, spec, mesh),
                        itemsize=leaf.element_size())


def _map(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict (or one leaf), ``path`` the
    keys joined by ``/`` as ``jax.tree_util.keystr(..., simple=True,
    separator="/")`` writes them."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree)


def sharded_bytes(shardings) -> int:
    """Per-device bytes of a nested dict of :class:`LeafSharding`."""
    if isinstance(shardings, LeafSharding):
        return shardings.shard_bytes
    return sum(sharded_bytes(v) for v in shardings.values())


def param_pspec(path: str, leaf, mesh, *, stacked: bool,
                strategy: str = "tp", cfg=None) -> tuple:
    """The spec of one parameter leaf.

    ``stacked``: leaf has a leading num_blocks axis (never sharded -- it
    is the block loop's axis and the pipeline-stage axis).

    Strategies:
      * "tp"       -- tensor/expert parallel on ``model`` only; weights
                      are replicated over the data axes, and activations
                      are communicated once per TP matmul.
      * "zero3"    -- additionally shard a weight dim over the data axes.
      * "dp_seq"   -- weights sharded over the data axes for storage; the
                      batch/sequence of the activations carry all the
                      parallelism (for archs whose head counts do not
                      divide the model axis).
      * "fsdp_all" -- weights sharded over ``model`` for storage, batch
                      sharded over data x model: weights are gathered once
                      per layer (ZeRO-3 over the flattened mesh).
    """
    fsdp = data_axes(mesh)
    shape = leaf.shape
    lead = 1 if stacked else 0
    body = shape[lead:]
    spec: list = [None] * len(shape)
    if len(body) == 0:
        return ()
    if strategy == "dp_seq":
        # the largest dim the data axes divide is sharded over them
        if len(body) >= 2:
            dims = sorted(range(len(body)), key=lambda i: -body[i])
            for i in dims:
                if _fits(body[i], mesh, fsdp):
                    spec[lead + i] = fsdp
                    break
        return tuple(spec)
    if len(body) == 1:
        return tuple(spec)  # norms, biases, A_log ... replicated

    # Mamba2 sublayer: B/C projections and the depthwise conv are shared
    # across heads -- replicate them (they are tiny) and row-shard
    # out_proj so its all-reduce is the only collective.
    if "mixer/wB" in path or "mixer/wC" in path or "mixer/conv" in path:
        return tuple(spec)
    if path.endswith("mixer/out_proj") and _fits(body[0], mesh, "model"):
        spec[lead] = "model"
        return tuple(spec)

    is_expert = any(k in path for k in ("ffn/wi", "ffn/wg", "ffn/wo")) \
        and len(body) == 3  # [E, d, f] / [E, f, d]

    # GQA-aware attention TP: shard the projections by whole heads when
    # the heads divide the model axis, otherwise replicate them (k/v
    # projections are small under GQA); splitting a head's dims would
    # force per-chunk score all-reduces inside attention.
    if cfg is not None and "mixer/w" in path and strategy in ("tp", "zero3"):
        msize = _axsize(mesh, "model")
        is_kv = path.endswith("mixer/wk") or path.endswith("mixer/wv")
        heads = cfg.num_kv_heads if is_kv else cfg.num_heads
        if heads and heads % msize == 0:
            # wq/wk/wv: [.., d, H*h] -> model on out dim; wo: [.., H*h, d]
            dim = lead + (len(body) - 1 if not path.endswith("mixer/wo")
                          else len(body) - 2)
            spec[dim] = "model"
            return tuple(spec)
        if path.endswith("mixer/wo") and cfg.num_heads % msize == 0:
            spec[lead] = "model"
            return tuple(spec)
        return tuple(spec)  # replicate this projection

    if strategy == "fsdp_all":
        # storage sharding only: largest body dim -> model
        dims = sorted(range(len(body)), key=lambda i: -body[i])
        for i in dims:
            if _fits(body[i], mesh, "model"):
                spec[lead + i] = "model"
                break
        return tuple(spec)

    if is_expert and _fits(body[0], mesh, "model"):
        # expert parallelism (+ zero3: FSDP over the expert's input dim)
        spec[lead] = "model"
        if strategy == "zero3" and _fits(body[1], mesh, fsdp):
            spec[lead + 1] = fsdp
        return tuple(spec)

    # generic: last dim -> model (+ zero3: previous dim -> fsdp)
    if _fits(body[-1], mesh, "model"):
        spec[lead + len(body) - 1] = "model"
    if strategy == "zero3" and len(body) >= 2 and _fits(body[-2], mesh, fsdp):
        spec[lead + len(body) - 2] = fsdp
    return tuple(spec)


def params_shardings(params_shapes: Dict, mesh, strategy: str = "tp",
                     cfg=None) -> Dict:
    """A nested dict of :class:`LeafSharding` matching a params tree (of
    meta tensors)."""
    def one(key, leaf):
        spec = param_pspec(key, leaf, mesh, stacked=key.startswith("blocks/"),
                           strategy=strategy, cfg=cfg)
        return leaf_sharding(leaf, spec, mesh)
    return _map(one, params_shapes)


def _zero1_spec(leaf, base: tuple, mesh) -> tuple:
    """Add data-axis sharding to the largest still-unsharded dim (ZeRO-1:
    optimizer moments are sharded even where params are replicated)."""
    fsdp = data_axes(mesh)
    spec = list(base) + [None] * (leaf.ndim - len(base))
    best, best_dim = None, -1
    for i, (dim, s) in enumerate(zip(leaf.shape, spec)):
        if s is None and _fits(dim, mesh, fsdp) and dim > best_dim:
            best, best_dim = i, dim
    if best is not None and best_dim >= _axsize(mesh, fsdp):
        spec[best] = fsdp
    return tuple(spec)


def opt_state_shardings(opt_shapes: Dict, params_sh: Dict, mesh,
                        strategy: str = "tp") -> Dict:
    """m/v: param shardings + ZeRO-1 data-axis sharding; count
    replicated."""
    def mv_tree(m, sh):
        if isinstance(m, dict):
            return {k: mv_tree(m[k], sh[k]) for k in m}
        spec = sh.spec if strategy == "zero3" else _zero1_spec(m, sh.spec,
                                                              mesh)
        return leaf_sharding(m, spec, mesh)

    mv = mv_tree(opt_shapes["m"], params_sh)
    return {"m": mv, "v": mv,
            "count": leaf_sharding(opt_shapes["count"], (), mesh)}


def batch_pspec(batch_shapes: Any, mesh, strategy: str = "tp") -> Any:
    """Shard the inputs' batch dim on the data axes.

    * "dp_seq":   additionally shard the sequence dim on ``model``.
    * "fsdp_all": shard the batch over data x model (flattened mesh).
    """
    fsdp = data_axes(mesh)

    def spec(_, leaf):
        if leaf.ndim == 0:
            return leaf_sharding(leaf, (), mesh)
        s: list = [None] * leaf.ndim
        if strategy == "fsdp_all" and _fits(leaf.shape[0], mesh,
                                            fsdp + ("model",)):
            s[0] = fsdp + ("model",)
            return leaf_sharding(leaf, s, mesh)
        if _fits(leaf.shape[0], mesh, fsdp):
            s[0] = fsdp
        if (strategy == "dp_seq" and leaf.ndim >= 2
                and leaf.shape[1] > 1 and _fits(leaf.shape[1], mesh, "model")):
            s[1] = "model"
        return leaf_sharding(leaf, s, mesh)

    return _map(spec, batch_shapes)


def cache_shardings(cache_shapes: Dict, mesh, batch: int) -> Dict:
    """Decode-cache shardings.

    Layout per leaf: [L, B, ...].  Batch dim -> data axes when divisible
    (decode_32k); the attention-cache *sequence* dim -> ``model``
    (sequence-parallel cache residency: decode attention becomes a
    distributed softmax whose reductions are small, where sharding
    kv-heads or head_dim would gather the whole cache per block).  For the
    single-request long-context shape (B=1) the sequence dim is
    additionally sharded over the data axes.  Mamba state caches
    ([L,B,H,P,N] / conv [L,B,W,C]) shard heads / channels on ``model``.
    """
    fsdp = data_axes(mesh)

    def spec(_, leaf):
        shape = leaf.shape
        s: list = [None] * len(shape)
        is_kv = len(shape) == 5 and shape[2] >= 1024  # [L,B,S,kv,h]
        batched = len(shape) >= 2 and _fits(shape[1], mesh, fsdp)
        if batched:
            s[1] = fsdp  # batch
        if is_kv:
            if batched and _fits(shape[2], mesh, "model"):
                s[2] = "model"   # sequence
            elif not batched:
                # B=1 long-context: spread the sequence over the mesh
                if _fits(shape[2], mesh, fsdp + ("model",)):
                    s[2] = fsdp + ("model",)
                elif _fits(shape[2], mesh, "model"):
                    s[2] = "model"
        elif len(shape) == 5 and _fits(shape[2], mesh, "model"):
            # mamba ssm state heads [L,B,H,P,N] -- must match the
            # model-sharded channels of wx, or every block re-gathers the
            # state
            s[2] = "model"
        elif len(shape) == 4 and _fits(shape[3], mesh, "model"):
            s[3] = "model"   # mamba conv channels [L,B,W,C]
        return leaf_sharding(leaf, s, mesh)

    return _map(spec, cache_shapes)


def device_mesh(mesh):
    """A ``torch.distributed.device_mesh.DeviceMesh`` on ``mesh``'s ranks
    and axis names, for DTensors with a :class:`LeafSharding`'s
    placements.  Every rank of the mesh must call it."""
    from torch.distributed.device_mesh import DeviceMesh
    size = math.prod(mesh.shape[a] for a in mesh.axis_names)
    ranks = torch.arange(size).reshape([mesh.shape[a]
                                        for a in mesh.axis_names])
    return DeviceMesh(mesh.device.type, ranks,
                      mesh_dim_names=tuple(mesh.axis_names))


def dtensor_shard_shape(sharding: LeafSharding, dmesh,
                        dtype=torch.bfloat16) -> Tuple[int, ...]:
    """The shape this rank's shard of a meta tensor of ``sharding.shape``
    has as a DTensor with ``sharding.placements`` on ``dmesh``
    (``torch.distributed.tensor.distribute_tensor``): the placements'
    shard shape, found by DTensor itself."""
    from torch.distributed.tensor import distribute_tensor
    t = torch.empty(sharding.shape, dtype=dtype, device="meta")
    return tuple(distribute_tensor(t, dmesh,
                                   list(sharding.placements)).to_local().shape)
