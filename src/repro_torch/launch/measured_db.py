"""Build a *measured* layer-time interference database (paper §3.3).

    python -m repro_torch.launch.measured_db [--arch qwen3-4b] [--blocks 12] \\
        [--seq 128] [--repeats 3] [--out results/measured_db.json] \\
        [--full] [--device cuda] [--card-tenants]

The port of the JAX package's ``tools/build_measured_db.py``, with its
arguments and defaults: time every block of a model executing alone
(column 0), then again while co-located stressor processes run (iBench-style
CPU busy-loops and 64 MiB memory streamers at the Table-1 counts), giving
the m x (n+1) ``LayerDatabase`` the simulator and the serving benchmarks
consume.  The saved JSON has the reference's four keys, so the JAX
package's ``benchmarks/measured_db_eval.py`` reads it unchanged.

Added here:

- ``--full``: the published config in bf16 (``--blocks 0`` keeps its
  depth); by default the smoke config in fp32, as the reference.
- ``--device`` (default ``cuda``; the CPU only when asked for).
- ``--card-tenants``: four more rows with co-tenants on the model's card
  (``stressors.card_scenarios``): a bf16 8192 x 8192 matmul loop and a
  2 GiB HBM copy loop, one and two processes of each.  They need CUDA.

Each stressor signals once it has done its first iteration, and timing
starts 0.3 s (the reference's ramp) after the last signal.  Each repeat is
one ``measure_block_times(repeats=1)`` pass; the database's column is the
element-wise minimum over repeats, as the reference's, and the median over
repeats is printed beside it: a co-tenant that takes turns with the model
on the card can hide behind a minimum.  A sidecar ``<out stem>.meta.json``
records the card, its compute mode, whether an MPS daemon runs, the host's
CPUs, the torch and CUDA versions, the medians, and each scenario's
start-up times and co-tenant rates.  A stressor that dies, exits non-zero
or misses its readiness limit raises, and nothing of its scenario is kept.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import LayerDatabase
from repro_torch.launch.stressors import (
    Scenario,
    Stressors,
    card_scenarios,
    is_card,
    scenarios_table1,
)
from repro_torch.models import Model
from repro_torch.pipeline import LocalPipelineExecutor
from repro_torch.util.device import resolve_device

RAMP_S = 0.3       # the reference's wait before timing, after readiness


@dataclasses.dataclass
class Measured:
    """One database's measurements.  ``table`` and ``medians`` are
    ``[blocks, scenarios]`` seconds: the minimum and the median over
    repeats.  ``load[name]`` holds each scenario's start-up times (s),
    its co-tenants' iteration rates (per second, summed over processes)
    over the ramp and during timing, and the card memory its processes
    took (bytes, from ``torch.cuda.mem_get_info``; card rows only)."""
    table: np.ndarray
    names: List[str]
    medians: np.ndarray
    load: Dict[str, dict]


def check_scenarios(scenarios: Sequence[Scenario],
                    device: torch.device) -> None:
    """Card co-tenants need the model on a CUDA card."""
    card = [sc.name for sc in scenarios if is_card(sc)]
    if card and device.type != "cuda":
        raise ValueError(f"card co-tenants {card} need the model on a CUDA "
                         f"device, not {device}")


def measure(executor: LocalPipelineExecutor, tokens: torch.Tensor,
            scenarios: Sequence[Scenario], repeats: int,
            log: Callable[[str], None] = print) -> Measured:
    """Time every block of ``executor``'s model over ``tokens`` under each
    scenario, ``repeats`` passes each, on an executor the caller built.

    The first scenario is column 0 and should be the reference's
    ``none``; the ratios printed are against it.
    """
    device = executor.device
    check_scenarios(scenarios, device)
    index = (None if device.type != "cuda" else
             device.index if device.index is not None
             else torch.cuda.current_device())
    executor.ensure_warm(*tokens.shape)
    mins, meds, load = [], [], {}
    for sc in scenarios:
        card = is_card(sc)
        free0 = torch.cuda.mem_get_info(device)[0] if card else 0
        with Stressors(sc, index) as s:
            took = free0 - torch.cuda.mem_get_info(device)[0] if card else 0
            n0, t0 = sum(s.iterations()), time.perf_counter()
            time.sleep(RAMP_S)
            n1, t1 = sum(s.iterations()), time.perf_counter()
            runs = np.stack([executor.measure_block_times(tokens, repeats=1)
                             for _ in range(repeats)])
            n2, t2 = sum(s.iterations()), time.perf_counter()
            s.check_alive()
        lo, med = runs.min(axis=0), np.median(runs, axis=0)
        mins.append(lo)
        meds.append(med)
        info = dict(startup_s=s.startup_s)
        log(f"  {sc.name:18s} mean_block={1e3 * lo.mean():7.2f} ms "
            f"(x{lo.mean() / mins[0].mean():.2f})")
        line = (f"      median of {repeats}: mean_block="
                f"{1e3 * med.mean():7.2f} ms "
                f"(x{med.mean() / meds[0].mean():.2f})")
        if sc.procs:
            line += (f"; start-up {min(s.startup_s):.2f}-"
                     f"{max(s.startup_s):.2f} s ({sc.procs} processes)")
        if card:
            info.update(rate_alone_hz=(n1 - n0) / (t1 - t0),
                        rate_timing_hz=(n2 - n1) / (t2 - t1),
                        card_bytes=took)
            line += (f"; card memory taken {took / 2**30:.2f} GiB; co-tenant"
                     f" iterations/s {info['rate_alone_hz']:.1f} before "
                     f"timing, {info['rate_timing_hz']:.1f} during it (x"
                     f"{info['rate_timing_hz'] / info['rate_alone_hz']:.2f})")
        log(line)
        load[sc.name] = info
    return Measured(np.stack(mins, axis=1), [sc.name for sc in scenarios],
                    np.stack(meds, axis=1), load)


def database(measured: Measured, cfg) -> LayerDatabase:
    """The reference's ``LayerDatabase``: units ``block0..``, model name
    ``<config name>-measured``."""
    return LayerDatabase(measured.table, measured.names,
                         unit_names=[f"block{i}"
                                     for i in range(len(measured.table))],
                         model_name=f"{cfg.name}-measured")


def nvidia_smi(query: str) -> str:
    """The first card's ``nvidia-smi --query-gpu=<query>`` line."""
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def mps_daemons() -> List[str]:
    """Names of the running processes whose command is an MPS control
    daemon or server (``nvidia-cuda-mps-control`` / ``-server``)."""
    names = []
    for comm in Path("/proc").glob("[0-9]*/comm"):
        try:
            name = comm.read_text().strip()
        except OSError:          # the process ended while we looked
            continue
        if name.startswith("nvidia-cuda-mps"):
            names.append(name)
    return sorted(names)


def run_meta(device: torch.device, measured: Measured) -> dict:
    """What the sidecar records beside the database."""
    on_card = device.type == "cuda"
    mps = mps_daemons()
    return {
        "device": str(device),
        "card": nvidia_smi("name,power.limit") if on_card else None,
        "compute_mode": nvidia_smi("compute_mode") if on_card else None,
        "mps_daemons": mps,
        "mps": bool(mps),
        "cpu_count": os.cpu_count(),
        "cpu_affinity": sorted(os.sched_getaffinity(0)),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "median_s": {name: measured.medians[:, k].tolist()
                     for k, name in enumerate(measured.names)},
        "load": measured.load,
    }


def describe(meta: dict) -> str:
    """One line: the card, its compute mode, the MPS finding, the CPUs."""
    mps = (f"daemons {meta['mps_daemons']}" if meta["mps"]
           else "no daemon running")
    return (f"card {meta['card']}, compute mode {meta['compute_mode']}, MPS:"
            f" {mps}; host CPUs {meta['cpu_count']} (affinity "
            f"{len(meta['cpu_affinity'])})")


def meta_path(out: str) -> str:
    return str(Path(out).with_suffix(".meta.json"))


def save(db: LayerDatabase, meta: dict, out: str) -> None:
    """``db`` to ``out`` (``LayerDatabase.save``), ``meta`` beside it."""
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    db.save(out)
    with open(meta_path(out), "w") as f:
        json.dump(meta, f, indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-4b")
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default="results/measured_db.json")
    ap.add_argument("--full", action="store_true",
                    help="the published config in bf16 (default: smoke, "
                         "fp32)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--card-tenants", action="store_true",
                    help="add the card co-tenant rows (needs CUDA)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    scenarios = scenarios_table1() + (card_scenarios()
                                      if args.card_tenants else [])
    check_scenarios(scenarios, device)
    print(f"measuring {args.arch} ({args.blocks} blocks) under Table-1 "
          f"stressor scenarios...")
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if args.blocks:
        cfg = dataclasses.replace(
            cfg, num_layers=args.blocks * len(cfg.layer_pattern))
    dtype = torch.bfloat16 if args.full else torch.float32
    params = Model(cfg).init_params(0, dtype, device)
    ex = LocalPipelineExecutor(cfg, params, device)
    tokens = torch.zeros((1, args.seq), dtype=torch.long, device=device)
    ex.warmup(1, args.seq)
    measured = measure(ex, tokens, scenarios, args.repeats)
    table = measured.table
    meta = run_meta(device, measured)
    print(describe(meta))
    save(database(measured, cfg), meta, args.out)
    print(f"saved {table.shape[0]}x{table.shape[1]} database -> {args.out}")
    print(f"impact range: x{(table[:, 1:] / table[:, :1]).min():.2f} .. "
          f"x{(table[:, 1:] / table[:, :1]).max():.2f}")


if __name__ == "__main__":
    main()
