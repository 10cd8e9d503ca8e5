"""Dry run: every (arch x input-shape) step on the meta device.

The port's counterpart of the JAX package's ``launch/dryrun.py``.  Where
JAX lowers and compiles each step for its 16x16 or 2x16x16 production
mesh, this runs the step once on the meta device (shapes without storage:
nothing is allocated, nothing is computed) and reports, for one NVIDIA
H100 or, with ``--strategy`` or ``--multi-pod``, for each device of the
production mesh (``launch/mesh.make_production_mesh`` over a fake process
group of 256 or 512 ranks):

* memory: the step's arguments summed exactly from the meta tensors
  (parameters, AdamW's state for train, the batch, the KV/SSM cache for
  decode), its outputs, and for train the gradients and the activations
  autograd keeps (``torch.autograd.graph.saved_tensors_hooks``), and
  whether the peak fits one card's 80 GiB.  On a mesh each figure is one
  device's: the shards that the strategy's rules (``launch/sharding.py``)
  give it, with the activation spec pinned at block entries
  (``models/sharding_ctx.py``) as the JAX dry run pins it;
* FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  step's products, beside ``launch/analytic.py``'s;
* the roofline terms over the report's cards (``launch/roofline.py``).
  A sharded step's collectives are not derived: no SPMD compiler
  partitions the step (``NO_SPMD``).

Attention runs its plain path (``impl="ref"``) and the Mamba2 scan the
model's chunked form (``models/mamba2.ssd_chunked``, the JAX model's own),
never the plain token recurrence, whose Python loop over 32768 or 524288
tokens would take minutes even on the meta device.  The plain attention
materialises its scores, so at long sequences the counted FLOPs and bytes
exceed the analytic ones (which count the kernels' causal culling).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k \\
        [--multi-pod] [--strategy auto|tp|zero3|dp_seq|fsdp_all] \\
        [--out results/dryrun_torch]
    python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    shape_is_applicable,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.launch import analytic as an
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as sh
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import (
    data_axes,
    make_production_mesh,
    production_group,
)
from repro_torch.models import blocks as blk
from repro_torch.models import mamba2, sharding_ctx
from repro_torch.util.tree import tree_map

CARD_BYTES = 80 * 2 ** 30       # one H100's device memory
TAG = "1xh100"                  # the report's mesh: one card
NO_MESH = ("none: one card; --strategy or --multi-pod give the 16x16 or "
           "2x16x16 production mesh")
STRATEGIES = ("auto", "tp", "zero3", "dp_seq", "fsdp_all")
NO_SPMD = ("none: no SPMD compiler partitions the step, so its collectives "
           "are not derived (DTensor cannot carry the model's ops); the "
           "bottleneck weighs compute and memory only")
NO_COMPILE = ("none: eager PyTorch compiles no step (the port's kernels "
              "build with nvcc at first use)")
TEMP_COUNTS = ("train: gradients + the activations autograd keeps with "
               "remat (outside the blocks, each block's input, one block's "
               "recomputed ones); inference: 0, a forward's transient "
               "buffers are not modelled")
SHARDED_COUNTS = ("per device: arguments, the shards launch/sharding.py "
                  "gives params, the ZeRO-1 optimizer state, the batch and "
                  "the decode cache; outputs at the same rules (train: params "
                  "and optimizer state, and the metrics whole; logits at the "
                  "batch's rule, prefill's cache at the cache's); gradients "
                  "as the params; the kept activations divided as the "
                  "activation spec divides [B, S, d] (whole without one)")


def _storages(tensors: Iterable) -> Dict[int, int]:
    """{storage id: bytes} of the distinct storages behind ``tensors``."""
    out = {}
    for t in tensors:
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            out[s._cdata] = s.nbytes()
    return out


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages in a nested structure of tensors."""
    return sum(_storages(tree_leaves(tree)).values())


class OpBytes(TorchDispatchMode):
    """While active, sums the bytes each executed op reads and writes
    (its tensor operands and results; views move nothing): the
    counterpart of XLA's "bytes accessed", with no fusion."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


class SavedBytes:
    """``saved_tensors_hooks`` that record the distinct storages autograd
    keeps, leaving out ``exclude``'s (the parameters it saves by
    reference)."""

    def __init__(self, exclude=()):
        self.exclude = set(_storages(tree_leaves(exclude)))
        self.kept, self.sizes = [], {}

    def _pack(self, t):
        s = t.untyped_storage()
        if s._cdata not in self.exclude:
            self.kept.append(t)           # keeps the storage id unique
            self.sizes[s._cdata] = s.nbytes()
        return t

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                        lambda t: t)

    @property
    def bytes(self) -> int:
        return sum(self.sizes.values())


def _chunked_scan(x, dt, A, B, C, *, chunk: int = 256, impl: str = "auto"):
    """``ops.ssd_scan``'s plain path as the model's chunked form, with the
    JAX model's chunk rule (the token recurrence loops over tokens)."""
    y, state = mamba2.ssd_chunked(x, dt, A, B, C,
                                  chunk=mamba2._chunk(chunk, x.shape[1]))
    return y, state.float()


def _plain_attention(q, k, v, *, causal: bool = True, window=None,
                     impl: str = "auto"):
    """``ops.flash_attention``'s plain path on any device."""
    return flash_attention_ref(q, k, v, causal=causal, window=window)


@contextlib.contextmanager
def plain_kernels():
    """While active, the Mamba2 scan runs the chunked form and attention
    its plain path (the steps ask for it with ``impl="ref"`` too), both
    of which run on the meta device."""
    saved = ops.ssd_scan, ops.flash_attention
    ops.ssd_scan, ops.flash_attention = _chunked_scan, _plain_attention
    try:
        yield
    finally:
        ops.ssd_scan, ops.flash_attention = saved


def auto_strategy(cfg: ModelConfig, shape: InputShape) -> str:
    """The JAX dry run's strategy for (arch, shape).

    * train: fine-grained MoE (small experts, high top-k) moves fewer
      bytes gathering weights than dispatching tokens -> "fsdp_all";
      everything else "tp" (GQA-aware tensor/expert parallel + ZeRO-1).
    * inference: models whose bf16 params fit comfortably when stored
      sharded over the data axes run sequence-parallel "dp_seq"
      (attention fully local per device); larger models run "tp".
    """
    pbytes = cfg.param_count() * 2
    if shape.mode == "train":
        if cfg.moe is not None and cfg.moe.d_expert <= 2048:
            return "fsdp_all"
        return "tp"
    if shape.mode == "prefill" and pbytes <= 70e9:
        return "dp_seq"
    return "tp"


def activation_spec_for(strategy: str, mesh, batch: int):
    """The spec pinned at block entries, as the JAX dry run picks it:
    batch on the data axes ("fsdp_all": over the whole mesh when it
    divides the batch; "dp_seq": + sequence on model); None when the data
    axes do not divide the batch."""
    fsdp = data_axes(mesh)
    size = math.prod(mesh.shape.values())
    if strategy == "fsdp_all" and batch % size == 0:
        return (fsdp + ("model",), None, None)
    if strategy == "dp_seq":
        return (fsdp, "model", None)
    if batch % (mesh.shape["data"] * mesh.shape.get("pod", 1)) == 0:
        return (fsdp, None, None)
    return None


def _one_block_saved(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> int:
    """The activations one block keeps for its backward (what remat
    recomputes for one block at a time)."""
    bp = blk.block_params(params["blocks"], 0)
    saved = SavedBytes(exclude=bp)
    live = tree_map(lambda p: p.detach().requires_grad_(True), bp)
    xb = x.detach().requires_grad_(True)
    positions = torch.arange(x.shape[1], device=x.device).expand(
        x.shape[0], x.shape[1])
    with torch.enable_grad(), saved.hooks():
        blk.block_forward(live, cfg, xb, positions, "ref")
    return saved.bytes


def step_shardings(cfg: ModelConfig, shape: InputShape, params: Dict,
               specs: Dict, mesh, strategy: str) -> Dict:
    """The step's argument shardings on ``mesh``, by what they shard:
    params, opt (train), inputs (the batch, or decode's tokens and index)
    and cache (decode), as the JAX dry run places each."""
    out = {"params": sh.params_shardings(params, mesh, strategy, cfg=cfg)}
    if shape.mode == "train":
        out["opt"] = sh.opt_state_shardings(st.opt_state_shapes(params),
                                            out["params"], mesh, strategy)
        out["inputs"] = sh.batch_pspec(specs["batch"], mesh, strategy)
    elif shape.mode == "prefill":
        out["inputs"] = sh.batch_pspec(specs, mesh, strategy)
    else:
        out["inputs"] = sh.batch_pspec({"tokens": specs["tokens"],
                                        "index": specs["index"]}, mesh)
        out["cache"] = sh.cache_shardings(specs["cache"], mesh,
                                          shape.global_batch)
    return out


def _per_device(mem: Dict, cfg: ModelConfig, shape: InputShape, out,
                shardings: Dict, mesh, strategy: str, act_spec) -> Dict:
    """``mem``'s figures for one device of ``mesh`` (``SHARDED_COUNTS``)."""
    nbytes = {k: sh.sharded_bytes(v) for k, v in shardings.items()}
    B, S = shape.global_batch, shape.seq_len
    per = dict(mem, params_bytes=nbytes["params"],
               opt_state_bytes=nbytes.get("opt", 0),
               input_bytes=nbytes["inputs"], cache_bytes=nbytes.get("cache",
                                                                    0))
    if shape.mode == "train":
        per["grad_bytes"] = per["params_bytes"]
        whole = (B, S, cfg.d_model)
        kept = (1.0 if act_spec is None else
                math.prod(sharding_ctx.shard_shape(whole, act_spec, mesh))
                / math.prod(whole))
        per["saved_activation_bytes"] = math.ceil(
            mem["saved_activation_bytes"] * kept)
        per["output_bytes"] = (per["params_bytes"] + per["opt_state_bytes"]
                               + tree_bytes(out[2]))
    elif shape.mode == "prefill" and cfg.is_decoder:
        logits, cache = out
        per["output_bytes"] = (
            sh.sharded_bytes(sh.batch_pspec(logits, mesh, strategy))
            + sh.sharded_bytes(sh.cache_shardings(cache, mesh, B)))
    elif shape.mode == "prefill":
        per["output_bytes"] = sh.sharded_bytes(sh.batch_pspec(out, mesh,
                                                              strategy))
    else:
        per["output_bytes"] = sh.sharded_bytes(sh.batch_pspec(out[0], mesh))
    per["argument_bytes"] = (per["params_bytes"] + per["opt_state_bytes"]
                             + per["input_bytes"] + per["cache_bytes"])
    return per


def run_step(cfg: ModelConfig, shape: InputShape, dtype=st.PARAM_DTYPE,
             mesh=None, strategy: Optional[str] = None) -> Dict:
    """Run ``shape``'s step for ``cfg`` once on the meta device, with
    parameters in ``dtype``; returns its memory (bytes) and counted
    operations.  With a ``mesh`` (and a ``strategy`` other than "auto")
    the memory is one device's, and the step runs with the activation
    spec the JAX dry run pins set (``activation_spec``)."""
    params = st.param_shapes(cfg, dtype)
    specs = st.input_specs(cfg, shape, dtype)
    mem = {"params_bytes": tree_bytes(params), "opt_state_bytes": 0,
           "input_bytes": 0, "cache_bytes": 0, "grad_bytes": 0,
           "saved_activation_bytes": 0}
    act_spec, pinned = None, contextlib.nullcontext()
    if mesh is not None:
        shardings = step_shardings(cfg, shape, params, specs, mesh, strategy)
        act_spec = activation_spec_for(strategy, mesh, shape.global_batch)
        pinned = sharding_ctx.activation_spec(act_spec, mesh)
    flops, nbytes = FlopCounterMode(display=False), OpBytes()
    t0 = time.perf_counter()
    with plain_kernels(), pinned:
        if shape.mode == "train":
            opt_state = st.opt_state_shapes(params)
            mem["opt_state_bytes"] = tree_bytes(opt_state)
            mem["input_bytes"] = tree_bytes(specs["batch"])
            args = (params, opt_state, specs["batch"])
            fn = st.make_train_step_fn(cfg, impl="ref")
            saved = SavedBytes(exclude=params)
            with saved.hooks(), flops, nbytes:
                out = fn(*args)
            # remat keeps each block's input and recomputes one block at a
            # time in the backward; the hooks see what lies outside them.
            B, S = shape.global_batch, shape.seq_len
            x = torch.empty((B, S, cfg.d_model), dtype=dtype,
                            device=st.META)
            mem["saved_activation_bytes"] = (
                saved.bytes + cfg.num_blocks * tree_bytes(x)
                + _one_block_saved(cfg, params, x))
            mem["grad_bytes"] = mem["params_bytes"]
        elif shape.mode == "prefill":
            mem["input_bytes"] = tree_bytes(specs)
            args = (params, specs)
            fn = st.make_prefill_fn(cfg, shape, impl="ref")
            with flops, nbytes:
                out = fn(params, **specs)
        else:
            mem["input_bytes"] = tree_bytes((specs["tokens"],
                                             specs["index"]))
            mem["cache_bytes"] = tree_bytes(specs["cache"])
            args = (params, specs)
            fn = st.make_decode_step_fn(cfg, impl="ref")
            with flops, nbytes:
                out = fn(params, specs["tokens"], specs["cache"],
                         specs["index"])
    seconds = time.perf_counter() - t0
    arg_storages = _storages(tree_leaves(args))
    mem["argument_bytes"] = sum(arg_storages.values())
    mem["output_bytes"] = sum(b for k, b in _storages(tree_leaves(out)).items()
                              if k not in arg_storages)
    if mesh is not None:
        mem = _per_device(mem, cfg, shape, out, shardings, mesh, strategy,
                          act_spec)
    mem["temp_bytes"] = mem["grad_bytes"] + mem["saved_activation_bytes"]
    # The peak: the arguments, and the larger of what the end of the
    # backward holds (every gradient, the kept activations at most) and
    # what the end of the update holds (gradients and the new leaves).
    mem["total_bytes"] = mem["argument_bytes"] + max(
        mem["temp_bytes"], mem["grad_bytes"] + mem["output_bytes"])
    mem["card_bytes"] = CARD_BYTES
    mem["fits_one_card"] = mem["total_bytes"] <= CARD_BYTES
    return {"seconds": seconds, "memory": mem, "activation_spec": act_spec,
            "counted_flops": float(flops.get_total_flops()),
            "counted_bytes": float(nbytes.bytes)}


def roofline_report(cfg: ModelConfig, shape: InputShape,
                    dtype=st.PARAM_DTYPE, mesh=None,
                    strategy: Optional[str] = None) -> Dict:
    """``run_step`` and the roofline terms of the step over one card, or
    over ``mesh``'s devices (analytic FLOPs and bytes, with remat as
    ``steps.make_train_step_fn`` applies it; the peak of ``dtype``'s
    products, TF32 off as the port runs)."""
    ran = run_step(cfg, shape, dtype, mesh=mesh, strategy=strategy)
    chips = 1 if mesh is None else math.prod(mesh.shape.values())
    analytic = an.analytic_totals(cfg, shape, remat=True)
    terms = rl.analyze(ran["counted_flops"], chips, dtype=dtype, tf32=False,
                       counted_bytes=ran["counted_bytes"],
                       model_flops=rl.model_flops_for(cfg, shape),
                       analytic=analytic)
    return dict(ran, terms=terms, analytic=analytic)


def dry_run(arch: str, shape_name: str, verbose: bool = True, *,
            multi_pod: bool = False, strategy: Optional[str] = None) -> Dict:
    """The report of one combination (the counterpart of the JAX
    ``lower_and_compile``): one card's, or with ``multi_pod`` or a
    ``strategy`` ("auto" picks JAX's, :func:`auto_strategy`) one device's
    of the production mesh, made here in a fake group of 256 or 512
    ranks (which raises if a default group exists already)."""
    shape = INPUT_SHAPES[shape_name]
    cfg0 = get_config(arch)
    ok, why = shape_is_applicable(cfg0, shape)
    variant = None
    if not ok and shape.name == "long_500k" and cfg0.is_decoder:
        cfg = st.resolve_config(cfg0, shape)      # sliding-window variant
        variant = "sliding_window"
    elif not ok:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": why}
    else:
        cfg = cfg0
    sharded = multi_pod or strategy is not None
    if not sharded:
        rep = roofline_report(cfg, shape)
        tag, chips = TAG, 1
    else:
        if strategy in (None, "auto"):
            strategy = auto_strategy(cfg, shape)
        chips = 512 if multi_pod else 256
        with production_group(chips):
            mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
            rep = roofline_report(cfg, shape, mesh=mesh, strategy=strategy)
        tag = "2x16x16" if multi_pod else "16x16"
    terms, mem = rep["terms"], rep["memory"]
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": tag if sharded else NO_MESH,
        "strategy": strategy if sharded else NO_MESH,
        "chips": chips,
        "variant": variant,
        "skipped": False,
        "mode": shape.mode,
        "dtype": str(st.PARAM_DTYPE).replace("torch.", ""),
        "lower_s": round(rep["seconds"], 2),
        "compile_s": NO_COMPILE,
        "memory": dict(mem, generated_code_bytes=NO_COMPILE,
                       temp_counts=TEMP_COUNTS),
        "flops_check": {"counted": rep["counted_flops"],
                        "analytic": rep["analytic"]["flops"],
                        "ratio": rep["counted_flops"]
                        / max(rep["analytic"]["flops"], 1.0)},
        "roofline": {
            "flops": terms.flops,
            "bytes_accessed": terms.bytes_accessed,
            "hlo_flops": terms.hlo_flops,
            "hlo_bytes": terms.hlo_bytes,
            "collective_bytes": terms.coll_bytes,
            "collective_breakdown": "none: one card runs no collective",
            "t_compute_s": terms.t_compute,
            "t_memory_s": terms.t_memory,
            "t_collective_s": terms.t_collective,
            "bottleneck": terms.bottleneck,
            "model_flops": terms.model_flops,
            "useful_ratio": terms.useful_ratio,
            "peak_flops": rl.peak_flops(terms.dtype, terms.tf32),
        },
    }
    if sharded:
        result["memory"]["counts"] = SHARDED_COUNTS
        result["activation_spec"] = rep["activation_spec"]
        result["roofline"].update(collective_bytes=NO_SPMD,
                                  collective_breakdown=NO_SPMD,
                                  t_collective_s=NO_SPMD)
    if verbose:
        where = ("one card" if not sharded else
                 f"one of {chips} devices ({strategy})")
        print(f"[dryrun] {arch} x {shape_name} x {tag}: meta run "
              f"{rep['seconds']:.1f}s, peak {mem['total_bytes'] / 2**30:.2f}"
              f" GiB (arguments {mem['argument_bytes'] / 2**30:.2f}) on "
              f"{where}, fits one card: {mem['fits_one_card']}, bottleneck="
              f"{terms.bottleneck}", flush=True)
        print(f"  flops: counted {rep['counted_flops']:.3e}, analytic "
              f"{terms.flops:.3e}; bytes: counted {terms.hlo_bytes:.3e}, "
              f"analytic {terms.bytes_accessed:.3e}", flush=True)
    return result


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Dry run of each step on the meta device, for one card "
                    "or for a device of the production mesh.")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh (512 devices), not 16x16")
    ap.add_argument("--strategy", default=None, choices=STRATEGIES,
                    help="sharding strategy on the production mesh (auto: "
                         "the JAX dry run's pick); without it and "
                         "--multi-pod, one card's report")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")

    combos = ([(args.arch, args.shape)] if not args.all else
              [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES])
    sharded = args.multi_pod or args.strategy is not None
    tag = (TAG if not sharded else "2x16x16" if args.multi_pod
           else "16x16")
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in combos:
        name = f"{arch}__{shape}__{tag}"
        try:
            res = dry_run(arch, shape, multi_pod=args.multi_pod,
                          strategy=args.strategy)
        except Exception as e:  # noqa: BLE001
            failures += 1
            res = {"arch": arch, "shape": shape, "error": str(e),
                   "traceback": traceback.format_exc()}
            print(f"[dryrun] FAIL {name}: {e}", flush=True)
        if res.get("skipped"):
            print(f"[dryrun] skip {name}: {res['reason']}", flush=True)
        with open(os.path.join(args.out, name + ".json"), "w") as f:
            json.dump(res, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
