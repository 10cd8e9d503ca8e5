"""Serving driver: ODIN-managed inference pipeline under interference.

    python -m repro_torch.launch.serve --arch qwen3-4b --scheduler odin \\
        --eps 4 --queries 100 [--alpha 10] [--full] [--device cuda] \\
        [--workload bursty --rate 50 --batching continuous --max-batch 8 \\
         --buckets pow2:256:1024 --lengths bimodal]

The port's counterpart of the JAX package's ``launch/serve.py`` for one
engine.  It serves the smoke variant of the chosen arch in fp32 (as the
JAX CLI does) or, with ``--full``, the published full-width config in
bf16 (``--blocks`` cuts its depth: ``--full --arch mixtral-8x22b
--blocks 4``), injects interference episodes, and reports the trace's
summary.  Like the JAX CLI it refuses the embedding-input archs
(llava-next-34b, hubert-xlarge).  The summary holds
latency, queueing, throughput, rebalances and, for formed dispatches,
batch occupancy and padding.  The JAX CLI's replica, router, admission,
SLO, tier, fault, retry and hedging options wait for ROADMAP item 6f.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import Model
from repro_torch.schedulers import available_schedulers
from repro_torch.serving import ServingEngine
from repro_torch.telemetry import export_path_format, render_export
from repro_torch.util.device import resolve_device
from repro_torch.workloads import available_workloads, make_lengths

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
    # Every registered policy is servable except the oracle, which needs
    # a caller-supplied solver.
    ap.add_argument("--scheduler", default="odin",
                    choices=tuple(n for n in available_schedulers()
                                  if n != "oracle"))
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
    ap.add_argument("--workload", default="closed",
                    choices=tuple(n for n in available_workloads()
                                  if n != "trace"),
                    help="arrival process; open-loop runs report queueing "
                         "delay separately")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="open-loop arrival rate, q/s (poisson rate / "
                         "bursty burst_rate; bursty idles between bursts)")
    ap.add_argument("--max-batch", type=int, default=1,
                    help="batched serving: stack up to N queued arrivals "
                         "per dispatch (>1 only pays off for open-loop "
                         "workloads with bursts)")
    ap.add_argument("--batching", default="none",
                    choices=("none", "drain", "continuous"),
                    help="formed-dispatch mode: drain runs length-bucketed "
                         "batches to completion, continuous admits arrivals "
                         "into the in-flight batch at stage boundaries; "
                         "--max-batch caps the dispatch width")
    ap.add_argument("--buckets", default="",
                    help="length buckets for --batching: 'pow2:lo:hi', a "
                         "comma list like '64,128,256', or empty for the "
                         "raw lengths")
    ap.add_argument("--lengths", default="fixed",
                    choices=("fixed", "uniform", "bimodal"),
                    help="per-query sequence-length distribution, anchored "
                         "at --seq: uniform draws [seq/4, seq], bimodal "
                         "mixes seq/4 and seq")
    ap.add_argument("--trace-mode", default="dense",
                    choices=("dense", "streaming"),
                    help="streaming folds per-query telemetry into "
                         "constant-memory sketches and rollups instead of "
                         "dense arrays")
    ap.add_argument("--metrics-export", default="", metavar="PATH",
                    help="write the final metrics registry to PATH after "
                         "the run (.prom/.txt Prometheus text exposition, "
                         "anything else JSON; needs --trace-mode "
                         "streaming)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}")
    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if cfg.embedding_inputs:
        raise SystemExit("serve demo uses token models; pick a non-VLM arch")
    if args.blocks:
        cfg = dataclasses.replace(
            cfg, num_layers=args.blocks * len(cfg.layer_pattern))
    dtype = torch.bfloat16 if args.full else torch.float32
    params = Model(cfg).init_params(args.seed, dtype, device)

    if args.metrics_export and args.trace_mode != "streaming":
        ap.error("--metrics-export needs --trace-mode streaming (the "
                 "dense trace has no metrics registry)")

    rng = np.random.default_rng(args.seed)
    if args.lengths == "fixed":
        lens = np.full(args.queries, args.seq, dtype=np.int64)
    else:
        kw = (dict(lo=max(1, args.seq // 4), hi=args.seq)
              if args.lengths == "uniform"
              else dict(short=max(1, args.seq // 4), long=args.seq,
                        p_long=0.2))
        lens = make_lengths(args.lengths, seed=args.seed,
                            **kw).sample(args.queries)
    queries = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, int(n))),
                               device=device)
               for n in lens]
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
    if args.batching == "none":
        # Bucketed serving warms its own closed shape set
        # (configure_batching); the unbucketed path warms each raw length
        # once, up front.
        for length in sorted({int(n) for n in lens}):
            eng.executor.ensure_warm(1, length)
    if args.workload == "closed":
        wl_kwargs = None             # --rate is irrelevant (and may be 0)
    else:
        wl_kwargs = dict(rate=args.rate, burst_rate=args.rate,
                         base_rate=args.rate / 10,
                         mean_burst=5.0 / args.rate * args.eps,
                         mean_gap=10.0 / args.rate * args.eps,
                         seed=args.seed)
    trace = api.run(api.RunSpec(
        engine=eng, queries=queries, schedule=schedule,
        workload=api.WorkloadSpec(name=args.workload, kwargs=wl_kwargs),
        batching=api.BatchingSpec(
            mode=(None if args.batching == "none" else args.batching),
            max_batch=args.max_batch, buckets=(args.buckets or None)),
        telemetry=api.TelemetrySpec(trace_mode=args.trace_mode)))
    s = trace.summary()
    configs = trace.configs
    s["final_config"] = configs[-1] if configs else None
    if args.metrics_export:
        path, fmt = export_path_format(args.metrics_export)
        with open(path, "w") as f:
            f.write(render_export(trace.registry, fmt))
        if not args.json:
            print(f"metrics registry ({fmt}) -> {path}")
    if args.json:
        print(json.dumps(s))
    else:
        print(f"{cfg.name} scheduler={args.scheduler} device={device}")
        for k, v in s.items():
            print(f"  {k}: {v}")


if __name__ == "__main__":
    main()
