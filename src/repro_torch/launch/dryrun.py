"""One-card dry run: every (arch x input-shape) step on the meta device.

The port's counterpart of the JAX package's ``launch/dryrun.py``.  Where
JAX lowers and compiles each step for a 256- or 512-chip TPU mesh, this
runs the step once on the meta device (shapes without storage: nothing
is allocated, nothing is computed) as one NVIDIA H100 would run it, and
reports:

* memory: the step's arguments summed exactly from the meta tensors
  (parameters, AdamW's state for train, the batch, the KV/SSM cache for
  decode), its outputs, and for train the gradients and the activations
  autograd keeps (``torch.autograd.graph.saved_tensors_hooks``), and
  whether the peak fits one card's 80 GiB;
* FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  step's products, beside ``launch/analytic.py``'s;
* the roofline terms for one card (``launch/roofline.py``).

Attention runs its plain path (``impl="ref"``) and the Mamba2 scan the
model's chunked form (``models/mamba2.ssd_chunked``, the JAX model's own),
never the plain token recurrence, whose Python loop over 32768 or 524288
tokens would take minutes even on the meta device.  The plain attention
materialises its scores, so at long sequences the counted FLOPs and bytes
exceed the analytic ones (which count the kernels' causal culling).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k \\
        [--out results/dryrun_torch]
    python -m repro_torch.launch.dryrun --all

``--multi-pod`` and ``--strategy`` (the JAX dry run's mesh and
sharding strategy) wait for the port's ``launch/sharding.py``, and are refused.
"""
from __future__ import annotations

import argparse
import contextlib
import json
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
from repro_torch.launch import analytic as an
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps as st
from repro_torch.models import blocks as blk
from repro_torch.models import mamba2
from repro_torch.util.tree import tree_map

CARD_BYTES = 80 * 2 ** 30       # one H100's device memory
TAG = "1xh100"                  # the report's mesh: one card
NO_MESH = ("none: one card; the JAX dry run's 16x16 and 2x16x16 TPU meshes "
           "wait for the port's launch/sharding.py")
NO_COMPILE = ("none: eager PyTorch compiles no step (the port's kernels "
              "build with nvcc at first use)")
TEMP_COUNTS = ("train: gradients + the activations autograd keeps with "
               "remat (outside the blocks, each block's input, one block's "
               "recomputed ones); inference: 0, a forward's transient "
               "buffers are not modelled")


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


@contextlib.contextmanager
def plain_kernels():
    """While active, the Mamba2 scan runs the chunked form (the attention
    kernels take ``impl="ref"`` from the steps)."""
    saved = ops.ssd_scan
    ops.ssd_scan = _chunked_scan
    try:
        yield
    finally:
        ops.ssd_scan = saved


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


def run_step(cfg: ModelConfig, shape: InputShape,
             dtype=st.PARAM_DTYPE) -> Dict:
    """Run ``shape``'s step for ``cfg`` once on the meta device, with
    parameters in ``dtype``; returns its memory (bytes) and counted
    operations."""
    params = st.param_shapes(cfg, dtype)
    specs = st.input_specs(cfg, shape, dtype)
    mem = {"params_bytes": tree_bytes(params), "opt_state_bytes": 0,
           "input_bytes": 0, "cache_bytes": 0, "grad_bytes": 0,
           "saved_activation_bytes": 0}
    flops, nbytes = FlopCounterMode(display=False), OpBytes()
    t0 = time.perf_counter()
    with plain_kernels():
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
    mem["temp_bytes"] = mem["grad_bytes"] + mem["saved_activation_bytes"]
    # The peak: the arguments, and the larger of what the end of the
    # backward holds (every gradient, the kept activations at most) and
    # what the end of the update holds (gradients and the new leaves).
    mem["total_bytes"] = mem["argument_bytes"] + max(
        mem["temp_bytes"], mem["grad_bytes"] + mem["output_bytes"])
    mem["card_bytes"] = CARD_BYTES
    mem["fits_one_card"] = mem["total_bytes"] <= CARD_BYTES
    return {"seconds": seconds, "memory": mem,
            "counted_flops": float(flops.get_total_flops()),
            "counted_bytes": float(nbytes.bytes)}


def roofline_report(cfg: ModelConfig, shape: InputShape,
                    dtype=st.PARAM_DTYPE) -> Dict:
    """``run_step`` and the one-card roofline terms of the step (analytic
    FLOPs and bytes, with remat as ``steps.make_train_step_fn`` applies
    it; the peak of ``dtype``'s products, TF32 off as the port runs)."""
    ran = run_step(cfg, shape, dtype)
    analytic = an.analytic_totals(cfg, shape, remat=True)
    terms = rl.analyze(ran["counted_flops"], 1, dtype=dtype, tf32=False,
                       counted_bytes=ran["counted_bytes"],
                       model_flops=rl.model_flops_for(cfg, shape),
                       analytic=analytic)
    return dict(ran, terms=terms, analytic=analytic)


def dry_run(arch: str, shape_name: str, verbose: bool = True) -> Dict:
    """The report of one combination (the counterpart of the JAX
    ``lower_and_compile``)."""
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
    rep = roofline_report(cfg, shape)
    terms, mem = rep["terms"], rep["memory"]
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": NO_MESH,
        "strategy": NO_MESH,
        "chips": 1,
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
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {TAG}: meta run "
              f"{rep['seconds']:.1f}s, peak {mem['total_bytes'] / 2**30:.2f}"
              f" GiB (arguments {mem['argument_bytes'] / 2**30:.2f}), fits "
              f"one card: {mem['fits_one_card']}, bottleneck="
              f"{terms.bottleneck}", flush=True)
        print(f"  flops: counted {rep['counted_flops']:.3e}, analytic "
              f"{terms.flops:.3e}; bytes: counted {terms.hlo_bytes:.3e}, "
              f"analytic {terms.bytes_accessed:.3e}", flush=True)
    return result


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="One-card dry run of each step on the meta device.")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="refused: TPU meshes wait for launch/sharding.py")
    ap.add_argument("--strategy", default=None,
                    help="refused: sharding strategies wait for "
                         "launch/sharding.py")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    if args.multi_pod or args.strategy is not None:
        ap.error("--multi-pod and --strategy need the port's "
                 "launch/sharding.py (DTensor placements over a mesh), "
                 "which is not written yet; this dry run is one card's")
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")

    combos = ([(args.arch, args.shape)] if not args.all else
              [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES])
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in combos:
        tag = f"{arch}__{shape}__{TAG}"
        try:
            res = dry_run(arch, shape)
        except Exception as e:  # noqa: BLE001
            failures += 1
            res = {"arch": arch, "shape": shape, "error": str(e),
                   "traceback": traceback.format_exc()}
            print(f"[dryrun] FAIL {tag}: {e}", flush=True)
        if res.get("skipped"):
            print(f"[dryrun] skip {tag}: {res['reason']}", flush=True)
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(res, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
