"""Serving driver: ODIN-managed inference pipeline under interference.

    python -m repro_torch.launch.serve --arch qwen3-4b --scheduler odin \\
        --eps 4 --queries 100 [--alpha 10] [--full] [--device cuda] \\
        [--workload bursty --rate 50 --batching continuous --max-batch 8 \\
         --buckets pow2:256:1024 --lengths bimodal]
    python -m repro_torch.launch.serve --full \\
        --configs qwen3-4b,qwen3-4b,qwen2-0.5b,qwen2-0.5b --router downgrade \\
        --tiers interactive,best_effort --admission value_shed \\
        --workload bursty --rate 60 --queries 64

The port's counterpart of the JAX package's ``launch/serve.py``.  It
serves the smoke variant of the chosen arch in fp32 (as the JAX CLI does)
or, with ``--full``, the published full-width config in bf16
(``--blocks`` cuts its depth: ``--full --arch mixtral-8x22b --blocks 4``),
injects interference episodes, and reports the trace's summary.  Like the
JAX CLI it refuses the embedding-input archs (llava-next-34b,
hubert-xlarge).  The summary holds latency, queueing, throughput,
rebalances and, for formed dispatches, batch occupancy and padding.

The JAX CLI's fleet and control-plane options run too: ``--admission``
and ``--slo``, ``--tiers``, ``--faults`` and ``--retries`` on one engine
or a fleet; ``--replicas``, ``--router``, ``--configs`` and
``--hedge-after`` serve a fleet through ``serve_cluster``.  Same-arch
replicas share one executor; a ``--configs`` arch other than the first
gets its own model and executor and is labelled pool ``small``.
``--full`` and ``--blocks`` apply to every arch of ``--configs``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.control import available_admission_policies
from repro_torch.models import Model
from repro_torch.qos import available_tiers
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
    ap.add_argument("--admission", default="none",
                    choices=tuple(available_admission_policies()),
                    help="admission policy; slo_shed / adaptive_batch "
                         "need --slo")
    ap.add_argument("--slo", type=float, default=0.0,
                    help="latency objective in seconds for --admission "
                         "slo_shed / adaptive_batch (0 = unset)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve a fleet of N engine replicas behind a "
                         "router; hedging and health-aware routing need "
                         "N >= 2")
    ap.add_argument("--router", default="round_robin",
                    help="fleet router registry name ('edf' and "
                         "'downgrade' are tier-aware); needs --replicas "
                         ">= 2 or --configs")
    ap.add_argument("--tiers", default="", metavar="NAMES",
                    help="comma list of QoS tier presets, e.g. "
                         "'interactive,best_effort': arrivals are stamped "
                         "with tier/deadline/value and the trace grows "
                         "per-tier accounting")
    ap.add_argument("--configs", default="", metavar="ARCHS",
                    help="comma list of arch ids, one per replica (a "
                         "heterogeneous fleet); replicas whose arch "
                         "differs from the first are labelled pool "
                         "'small' (the --router downgrade targets); "
                         "overrides --replicas")
    ap.add_argument("--faults", default="", metavar="SPEC",
                    help="fault plan spec, e.g. 'crash@50+20:r=0,"
                         "flaky@0+1000:p=0.05'; windows are query-indexed "
                         "on a single engine and wall-clock (open-loop "
                         "workloads only) on a --replicas fleet")
    ap.add_argument("--retries", type=int, default=-1, metavar="N",
                    help="per-query retry budget with exponential "
                         "backoff; -1 leaves the fault machinery unarmed")
    ap.add_argument("--hedge-after", type=float, default=0.0,
                    metavar="SECONDS",
                    help="hedge a dispatch to a healthy peer when its "
                         "projected wait exceeds this (needs --replicas "
                         ">= 2)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    configs_list = [c.strip() for c in args.configs.split(",")
                    if c.strip()]
    if configs_list:
        unknown = [c for c in configs_list if c not in ARCH_IDS]
        if unknown:
            ap.error(f"--configs has unknown arch ids {unknown}; "
                     f"pick from {ARCH_IDS}")
        if args.replicas > 1 and args.replicas != len(configs_list):
            ap.error(f"--configs names {len(configs_list)} replicas but "
                     f"--replicas says {args.replicas}")
        args.replicas = len(configs_list)
        args.arch = configs_list[0]
    if args.tiers:
        bad = [t.strip() for t in args.tiers.split(",")
               if t.strip() not in available_tiers()]
        if bad:
            ap.error(f"--tiers has unknown presets {bad}; pick from "
                     f"{available_tiers()}")

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(f"error: {err}")

    def arch_config(arch):
        c = get_config(arch) if args.full else get_smoke_config(arch)
        if args.blocks:
            c = dataclasses.replace(
                c, num_layers=args.blocks * len(c.layer_pattern))
        return c

    cfg = arch_config(args.arch)
    if cfg.embedding_inputs:
        raise SystemExit("serve demo uses token models; pick a non-VLM arch")
    # The JAX CLI's checks, in its order, before any weights are made.
    if args.admission in ("slo_shed", "adaptive_batch") and args.slo <= 0:
        ap.error(f"--admission {args.admission} requires --slo > 0")
    if args.metrics_export and args.trace_mode != "streaming":
        ap.error("--metrics-export needs --trace-mode streaming (the "
                 "dense trace has no metrics registry)")
    adm_kwargs = {"slo": args.slo} if args.slo > 0 else None
    faults = args.faults or None
    retries = None if args.retries < 0 else args.retries
    hedge_after = args.hedge_after if args.hedge_after > 0 else None
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if hedge_after is not None and args.replicas < 2:
        ap.error("--hedge-after needs --replicas >= 2 (hedging "
                 "dispatches to a healthy peer)")
    if args.replicas > 1:
        if args.batching != "none" or args.max_batch > 1:
            ap.error("--replicas > 1 serves per-query; drop --batching "
                     "/ --max-batch")
        if args.metrics_export:
            ap.error("--metrics-export is single-engine only (the "
                     "fleet trace has no one registry to export)")
        if faults is not None and args.workload == "closed":
            ap.error("fleet fault windows are wall-clock "
                     "(docs/FAULTS.md); pick an open-loop --workload")
    elif args.router != "round_robin":
        ap.error("--router needs a fleet: pass --replicas >= 2 or "
                 "--configs")
    dtype = torch.bfloat16 if args.full else torch.float32
    params = Model(cfg).init_params(args.seed, dtype, device)

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
    # A heterogeneous fleet shares the query stream, so token ids must be
    # valid for every replica's model: draw below the smallest vocab.
    vocab = cfg.vocab_size
    if configs_list:
        vocab = min(arch_config(c).vocab_size for c in configs_list)
    queries = [torch.as_tensor(rng.integers(0, vocab, (1, int(n))),
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
    if args.replicas > 1:
        # Same-arch replicas share the lead engine's executor (and its
        # warmed shapes) but keep their own runtime, detector and
        # estimates; a --configs arch of its own gets its own model and
        # executor.
        archs = configs_list or [args.arch] * args.replicas
        lead = {args.arch: (cfg, params, eng)}
        engines, pools = [], []
        for arch in archs:
            if arch not in lead:
                c2 = arch_config(arch)
                p2 = Model(c2).init_params(args.seed, dtype, device)
                e2 = ServingEngine(c2, p2, num_eps=args.eps,
                                   scheduler=args.scheduler,
                                   alpha=args.alpha, device=device)
                for length in sorted({int(n) for n in lens}):
                    e2.executor.ensure_warm(1, length)
                lead[arch] = (c2, p2, e2)
            acfg, aparams, first = lead[arch]
            if not any(x is first for x in engines):
                e = first
            else:
                e = ServingEngine(acfg, aparams, num_eps=args.eps,
                                  scheduler=args.scheduler,
                                  alpha=args.alpha,
                                  executor=first.executor, device=device)
            engines.append(e)
            pools.append("default" if arch == archs[0] else "small")
        trace = api.run(api.RunSpec(
            engines=engines, queries=queries, schedule=schedule,
            workload=api.WorkloadSpec(name=args.workload, kwargs=wl_kwargs),
            admission=api.AdmissionSpec(name=args.admission,
                                        kwargs=adm_kwargs),
            faults=api.FaultsSpec(plan=faults, hedge_after=hedge_after),
            retries=api.RetriesSpec(policy=retries),
            tiers=api.TiersSpec(spec=(args.tiers or None)),
            telemetry=api.TelemetrySpec(trace_mode=args.trace_mode),
            cluster=api.ClusterSpec(num_replicas=len(engines),
                                    router=args.router,
                                    pools=tuple(pools))))
        s = trace.summary()
        s["final_config"] = None
    else:
        trace = api.run(api.RunSpec(
            engine=eng, queries=queries, schedule=schedule,
            workload=api.WorkloadSpec(name=args.workload, kwargs=wl_kwargs),
            admission=api.AdmissionSpec(name=args.admission,
                                        kwargs=adm_kwargs),
            batching=api.BatchingSpec(
                mode=(None if args.batching == "none" else args.batching),
                max_batch=args.max_batch, buckets=(args.buckets or None)),
            faults=api.FaultsSpec(plan=faults),
            retries=api.RetriesSpec(policy=retries),
            tiers=api.TiersSpec(spec=(args.tiers or None)),
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
