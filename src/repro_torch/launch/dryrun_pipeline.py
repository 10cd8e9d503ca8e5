"""Dry run of the ODIN pipeline-stage step on the production mesh.

The port's counterpart of the JAX package's ``launch/dryrun_pipeline.py``:
the paper's technique itself -- bind-to-stage pipeline execution with a
run-time block -> stage assignment -- at production scale.  The mesh's
``data`` axis plays the EP/stage role (16 execution places of 16 devices
each; 2 x 16 multi-pod), ``model`` is operator parallelism within an EP.

Where JAX lowers and compiles the GPipe ``shard_map`` schedule for every
device, this runs one rank's program of it (``pipeline/spmd.py``'s
``make_pipeline_fn``) on the meta device, in a fake process group of 256
or 512 ranks (``launch/mesh.production_group``): the rank of a middle
stage, which both receives and sends.  It reports the stage layout, the
arguments one device holds (its ``[cap, ...]`` tile, the counts and the
replicated inputs: what ``in_specs=(P(stage), P(), P())`` gives each JAX
device) and the collectives that rank issued, by the JAX roofline's kind
names.  The port hands on only an active step's activations, where JAX's
``ppermute`` moves every step's.

    python -m repro_torch.launch.dryrun_pipeline [--arch qwen3-32b] \\
        [--multi-pod] [--microbatch 4] [--mb-rows 2] [--seq 1024]
"""
from __future__ import annotations

import argparse
import math
import sys
import time
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ARCH_IDS, ModelConfig, get_config
from repro_torch.launch import roofline as rl
from repro_torch.launch import steps as st
from repro_torch.launch.dryrun import NO_COMPILE, plain_kernels, tree_bytes
from repro_torch.launch.mesh import make_production_mesh, production_group
from repro_torch.pipeline.spmd import make_pipeline_fn, stage_tile

STAGE_AXIS = "data"         # EPs = 16-device slices along this axis


def pipeline_dry_run(cfg: ModelConfig, *, multi_pod: bool = False,
                     microbatch: int = 4, mb_rows: int = 2,
                     seq: int = 1024) -> Dict:
    """One middle-stage rank's run of the pipelined forward over the
    production mesh, on the meta device; returns the layout, the
    per-device argument bytes and that rank's collective bytes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = dict(zip(axes, shape))
    n_stages = sizes[STAGE_AXIS]
    stage = n_stages // 2
    # The row-major rank at (pod 0, data = stage, model 0).
    rank = stage * sizes["model"]
    cap = -(-cfg.num_blocks // n_stages) * 2   # ODIN may double a stage
    counts = [cfg.num_blocks // n_stages] * n_stages
    with production_group(math.prod(shape), rank=rank):
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        params = st.param_shapes(cfg)
        tile = stage_tile(params["blocks"], counts, cap, stage)
        inputs = torch.empty((microbatch, mb_rows, seq, cfg.d_model),
                             dtype=torch.bfloat16, device="meta")
        fn = make_pipeline_fn(cfg, mesh, stage_axis=STAGE_AXIS,
                              num_microbatches=microbatch, cap=cap)
        t0 = time.perf_counter()
        with plain_kernels():
            out = fn(tile, counts, inputs)
        seconds = time.perf_counter() - t0
    if tuple(out.shape) != tuple(inputs.shape):
        raise AssertionError(f"outputs {tuple(out.shape)} for inputs "
                             f"{tuple(inputs.shape)}")
    tile_bytes, input_bytes = tree_bytes(tile), tree_bytes(inputs)
    counts_bytes = 4 * n_stages        # int32 [n_stages]
    return {
        "arch": cfg.name, "mesh": "x".join(map(str, shape)),
        "n_stages": n_stages, "chips_per_stage": math.prod(shape) // n_stages,
        "cap": cap, "counts": counts, "rank": rank, "stage": stage,
        "tile_bytes": tile_bytes, "counts_bytes": counts_bytes,
        "input_bytes": input_bytes,
        "argument_bytes": tile_bytes + counts_bytes + input_bytes,
        "collectives": rl.collective_bytes(fn.collectives),
        "sends": fn.sends, "seconds": seconds, "compiled": NO_COMPILE,
    }


def report_lines(r: Dict) -> list:
    """The printed report of :func:`pipeline_dry_run`."""
    coll = ", ".join(f"{k}={v / 2**20:.1f}MiB"
                     for k, v in r["collectives"].items() if v)
    return [
        f"[pipeline-dryrun] {r['arch']}: {r['n_stages']} stages x "
        f"{r['chips_per_stage']} chips, cap={r['cap']}, compiled in "
        f"{r['compiled']}; meta run {r['seconds']:.1f}s",
        f"  args/device: {r['argument_bytes'] / 2**30:.2f} GiB (one "
        f"[{r['cap']}, ...] tile {r['tile_bytes'] / 2**30:.2f} GiB, counts "
        f"{r['counts_bytes']} B, replicated inputs "
        f"{r['input_bytes'] / 2**20:.1f} MiB)",
        f"  collectives of rank {r['rank']} (stage {r['stage']} of "
        f"{r['n_stages']}, which receives and sends): {coll}; "
        f"{r['sends']} hand-offs, the active steps' only (JAX's ppermute "
        f"moves every step's)",
    ]


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun_pipeline",
        description="One stage rank's pipelined forward over the "
                    "production mesh, on the meta device.")
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-32b")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatch", type=int, default=4)
    ap.add_argument("--mb-rows", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args(argv)
    r = pipeline_dry_run(get_config(args.arch), multi_pod=args.multi_pod,
                         microbatch=args.microbatch, mb_rows=args.mb_rows,
                         seq=args.seq)
    for line in report_lines(r):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
