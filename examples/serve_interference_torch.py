"""End-to-end serving example on the PyTorch port (the paper's kind of
workload), the counterpart of ``examples/serve_interference.py``.

Serves requests through a real PyTorch transformer pipeline on one
device: 4 execution places, dynamic stage boundaries, injected
interference, and the full ODIN monitor->detect->rebalance loop on
measured wall-clock stage times.  Compares ODIN, LLS, hybrid and a static
pipeline over the same query stream and interference schedule, then
re-serves ODIN under open-loop bursty (MMPP) arrivals, batched against
unbatched, and drain against continuous batching over mixed lengths.
On a CUDA card attention runs K1's fp32 kernel.

Run:  python examples/serve_interference_torch.py [--device cuda|cpu]
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.util.device import resolve_device  # noqa: E402

ARCH = "qwen3-4b"
NUM_EPS = 4
NUM_QUERIES = 80
SEQ = 128
#: Interference episodes (first query, end query, EP, slowdown): EP2 for
#: queries 15-45, EP0 for 50-70.
EPISODES = ((15, 45, 2, 3.0), (50, 70, 0, 2.2))


def default_config():
    return dataclasses.replace(get_smoke_config(ARCH), num_layers=8)


def make_schedule(num_eps: int, episodes):
    def schedule(q):
        slow = [1.0] * num_eps
        for lo, hi, ep, factor in episodes:
            if lo <= q < hi:
                slow[ep] = factor
        return slow
    return schedule


def main(device="cuda", cfg=None, num_eps: int = NUM_EPS,
         num_queries: int = NUM_QUERIES, seq: int = SEQ,
         episodes=EPISODES) -> dict:
    """Run the example; returns every summary it printed, the batched and
    unbatched accounting check (``acct_match``) and the traces' lengths."""
    dev = resolve_device(device)
    cfg = default_config() if cfg is None else cfg
    params = Model(cfg).init_params(seed=0, dtype=torch.float32, device=dev)
    print(f"model: {cfg.name} ({cfg.num_blocks} blocks, "
          f"{cfg.param_count() / 1e6:.1f}M params), {num_eps} execution "
          f"places, {dev}")

    rng = np.random.default_rng(0)
    queries = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, seq)),
                               device=dev)
               for _ in range(num_queries)]
    schedule = make_schedule(num_eps, episodes)
    out = {"served": {}}

    results = {}
    for sched in ("odin", "lls", "hybrid", "none"):
        eng = ServingEngine(cfg, params, num_eps=num_eps, scheduler=sched,
                            alpha=4, device=dev)
        eng.executor.warmup(1, seq)
        t0 = time.perf_counter()
        m = eng.serve(queries, schedule)
        wall = time.perf_counter() - t0
        s = m.summary()
        results[sched] = s
        out["served"][sched] = len(m.latencies)
        print(f"\n{sched.upper():5s}  wall={wall:.1f}s")
        print(f"  mean latency  : {s['mean_latency_s'] * 1e3:7.2f} ms")
        print(f"  p99 latency   : {s['p99_latency_s'] * 1e3:7.2f} ms")
        print(f"  throughput    : {s['mean_throughput_qps']:7.1f} q/s "
              "(pipeline capability)")
        print(f"  rebalances    : {s['rebalances']}  "
              f"(serial fraction {100 * s['serial_frac']:.0f}%)")
        print(f"  final config  : {m.configs[-1]}")
    out["schedulers"] = results

    odin, lls = results["odin"], results["lls"]
    odin_vs_lls = 100 * (1 - odin['mean_latency_s'] / lls['mean_latency_s'])
    thr = 100 * (odin['mean_throughput_qps'] / lls['mean_throughput_qps'] - 1)
    print(f"\nODIN vs LLS: {odin_vs_lls:+.1f}% mean latency, {thr:+.1f}% "
          f"throughput")

    # --- open-loop bursty traffic + batched serving ------------------------
    # Closed-loop above; now open-loop MMPP arrivals, one query at a time
    # against up to 8 a dispatch.  Frozen block-time estimates
    # (estimate_beta = 0 after a calibration window) make the scheduling
    # deterministic, so both runs take the same detect -> explore ->
    # commit walk and differ only in execution granularity.
    eng = ServingEngine(cfg, params, num_eps=num_eps, scheduler="odin",
                        alpha=4, estimate_beta=0.3, device=dev)
    eng.executor.warmup(1, seq)
    probe = eng.serve(queries[:10], lambda q: [1.0] * num_eps)  # calibrate
    mean_service = float(probe.service_latencies[3:].mean())
    eng.estimate_beta = 0.0          # freeze -> reproducible scheduling
    bursty_kwargs = dict(
        burst_rate=6.0 / mean_service,       # bursts outrun the pipeline
        base_rate=0.3 / mean_service,        # quiet phases drain the queue
        mean_burst=40 * mean_service, mean_gap=20 * mean_service, seed=0)

    batched = {}
    for max_batch in (1, 8):
        eng.reset_policy()               # fresh window, same frozen estimates
        m = eng.serve(queries, schedule, workload="bursty",
                      workload_kwargs=bursty_kwargs, max_batch=max_batch)
        batched[max_batch] = m
        s = m.summary()
        out["served"][f"bursty, max_batch {max_batch}"] = len(m.latencies)
        print(f"\nODIN under bursty arrivals (MMPP on/off), "
              f"max_batch={max_batch}:")
        print(f"  offered load  : {s['offered_load_qps']:7.1f} q/s  "
              f"(achieved {s['achieved_load_qps']:.1f} q/s)")
        print(f"  mean latency  : {s['mean_latency_s'] * 1e3:7.2f} ms  "
              f"= queue {s['mean_queue_delay_s'] * 1e3:.2f} ms "
              f"+ service {s['mean_service_latency_s'] * 1e3:.2f} ms")
        print(f"  p99 queue wait: {s['p99_queue_delay_s'] * 1e3:7.2f} ms   "
              f"max in-system depth: {int(m.queue_depths.max())}")
        print(f"  rebalances    : {s['rebalances']}  "
              f"(trials {m.total_trials}, serial fraction "
              f"{100 * s['serial_frac']:.0f}%)")
    out["bursty"] = {k: m.summary() for k, m in batched.items()}

    m1, m8 = batched[1], batched[8]
    acct_match = (m8.num_rebalances == m1.num_rebalances
                  and m8.total_trials == m1.total_trials
                  and m8.configs_trace == m1.configs_trace)
    out["acct_match"] = acct_match
    print("\nBatching (max_batch=8 vs 1) at the same offered load:")
    print(f"  mean queue delay: {m1.mean_queue_delay * 1e3:.2f} -> "
          f"{m8.mean_queue_delay * 1e3:.2f} ms "
          f"({m1.mean_queue_delay / max(m8.mean_queue_delay, 1e-12):.1f}x lower)")
    print(f"  achieved load   : {m1.achieved_load:.1f} -> "
          f"{m8.achieved_load:.1f} q/s")
    print(f"  rebalance/trial accounting identical: {acct_match} "
          f"(rebalances {m8.num_rebalances}, trials {m8.total_trials})")

    # --- continuous batching + length buckets ------------------------------
    # batching="continuous" admits arrivals into the in-flight batch at
    # stage boundaries; length-bucketed dispatch keeps the mixed stream
    # from padding every batch to its longest member.
    short = 3 * seq // 8
    mixed = [torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (1, seq if rng.random() < 0.15
                                           else short)), device=dev)
             for _ in range(num_queries)]
    # Re-calibrate on the mixed stream: short queries serve faster than
    # the all-long probe above.
    probe = eng.serve(mixed[:10], lambda q: [1.0] * num_eps)
    mixed_service = float(probe.service_latencies[3:].mean())
    cont_kwargs = dict(rate=0.35 / mixed_service,
                       burst_rate=1.5 / mixed_service, burst_prob=0.08,
                       seed=2)
    cont = {}
    for mode in ("drain", "continuous"):
        eng.reset_policy()
        m = eng.serve(mixed, schedule, workload="bursty",
                      workload_kwargs=cont_kwargs,
                      batching=mode, max_batch=8,
                      buckets=f"pow2:{seq // 2}:{seq}")
        cont[mode] = s = m.summary()
        out["served"][f"mixed, {mode}"] = len(m.latencies)
        print(f"\nODIN, mixed lengths ({short}/{seq}), batching={mode}:")
        print(f"  mean queue delay: {s['mean_queue_delay_s'] * 1e3:7.2f} ms"
              f"   p99 {s['p99_queue_delay_s'] * 1e3:.2f} ms")
        print(f"  batch occupancy : {s['mean_batch_occupancy']:7.2f}    "
              f"padded-token waste {100 * s['padded_token_frac']:.0f}%")
    out["mixed"] = cont

    ratio = (cont["drain"]["mean_queue_delay_s"]
             / max(cont["continuous"]["mean_queue_delay_s"], 1e-12))
    print(f"\nContinuous vs drain at the same offered load: "
          f"{ratio:.2f}x lower mean queue delay")
    print("(a live wall-clock A/B on a shared host is noisy run to run)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    main(device=ap.parse_args().device)
