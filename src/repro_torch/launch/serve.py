"""Serving driver: ODIN-managed inference pipeline under interference.

    python -m repro_torch.launch.serve --arch qwen3-4b --scheduler odin \\
        --eps 4 --queries 100 [--alpha 10] [--full] [--device cuda]

The port's counterpart of the JAX package's ``launch/serve.py`` for one
engine and the closed-loop workload.  It serves the smoke variant of the
chosen arch in fp32 (as the JAX CLI does) or, with ``--full``, the
published full-width config in bf16, injects interference episodes, and
reports latency / throughput / rebalance statistics.  The JAX CLI's
batching, open-loop, replica, admission, fault, tier and streaming options
wait for later slices of the port (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import Model
from repro_torch.schedulers import SCHEDULERS
from repro_torch.serving import ServingEngine
from repro_torch.util.device import resolve_device

#: Mean slowdowns of the twelve Table-1 colocation scenarios, in the order
#: of the JAX package's ``core.database.paper_scenarios()`` (six CPU
#: stressor settings, then six memory-bandwidth ones).
SCENARIO_SLOWDOWNS = (1.07, 1.18, 1.45, 1.95, 2.60, 3.20,
                      1.10, 1.28, 1.65, 2.25, 2.95, 3.50)


def interference_events(queries: int, eps: int, freq: int, duration: int,
                        rng: np.random.Generator) -> list:
    """[(start, end, ep, slowdown)]: one episode every ``freq`` queries,
    drawn as the JAX CLI draws them."""
    events = []
    for start in range(freq, queries, freq):
        ep = int(rng.integers(eps))
        f = float(SCENARIO_SLOWDOWNS[rng.integers(len(SCENARIO_SLOWDOWNS))])
        events.append((start, start + duration, ep, f))
    return events


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-4b")
    ap.add_argument("--scheduler", default="odin", choices=tuple(SCHEDULERS))
    ap.add_argument("--alpha", type=int, default=10)
    ap.add_argument("--eps", type=int, default=4)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--blocks", type=int, default=0,
                    help="override block count (0 = config default)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--freq", type=int, default=25,
                    help="interference frequency period (queries)")
    ap.add_argument("--duration", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="serve the published full-width config in bf16 "
                         "instead of its fp32 smoke variant")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain attention")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}")
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if args.blocks:
        cfg = dataclasses.replace(
            cfg, num_layers=args.blocks * len(cfg.layer_pattern))
    dtype = torch.bfloat16 if args.full else torch.float32
    params = Model(cfg).init_params(args.seed, dtype, device)

    rng = np.random.default_rng(args.seed)
    queries = [torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (1, args.seq)), device=device)
               for _ in range(args.queries)]
    events = interference_events(args.queries, args.eps, args.freq,
                                 args.duration, rng)

    def schedule(q):
        slow = [1.0] * args.eps
        for s, e, ep, f in events:
            if s <= q < e:
                slow[ep] = f
        return slow

    eng = ServingEngine(cfg, params, num_eps=args.eps,
                        scheduler=args.scheduler, alpha=args.alpha,
                        device=device)
    eng.executor.ensure_warm(1, args.seq)
    trace = eng.serve(queries, schedule)
    s = trace.summary()
    s["final_config"] = trace.configs[-1] if trace.configs else None
    if args.json:
        print(json.dumps(s))
    else:
        print(f"{cfg.name} scheduler={args.scheduler} device={device}")
        for k, v in s.items():
            print(f"  {k}: {v}")


if __name__ == "__main__":
    main()
