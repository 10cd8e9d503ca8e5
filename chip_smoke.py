"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain versions.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero.  Each
phase prints its wall time.

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions.
   There must be a CUDA device.
2. build: the port's kernels K1 (its bf16 tensor-core kernel and its fp32
   CUDA-core kernel), K2 and K3 from their sources in this checkout, one
   ``nvcc`` per source, all started together; ``ptxas``' registers, spills
   and the dynamic shared memory of K1's tensor-core kernel and of K3's
   three launches (with their grids at mamba2-370m's shape).
3. K1 (flash attention) against its plain version on the card, at the
   shapes and tolerances of ``repro_torch.kernels.cases``: the JAX
   package's FLASH_CASES shapes in fp32 (TF32 off, tolerance 2e-5; the
   CUDA-core kernel) and bf16 (5e-2; the tensor-core kernel), ragged
   sequence lengths, TENSOR_CORE_CASES (the tensor-core kernel's corners),
   and the main path's shape -- q [1, 32, S, 128], k/v [1, 8, S, 128],
   causal, bf16, at S = 1024 and 2048, contiguous and in the model's
   strided layout, at a tighter limit (1e-2 elementwise, rms error under
   2e-4 of the output's rms).  It counts each route's launches.  At the
   main path's shape it times the kernel, its plain version and
   ``scaled_dot_product_attention`` (a yardstick the port never calls)
   with CUDA events, prints the TFLOP/s of both, and computes the least
   time the card could take.  The batched path's shapes (BATCHED_MAIN_CASES:
   8 rows at S 1024 and 256) are held at the same limits and timed the same
   way.
4. K3 (SSD scan) against its plain version (the token recurrence): the JAX
   package's SSD_CASES, ragged ones and the corners of the chunk-parallel
   kernel's tiles (SSD_CORNER_CASES), y with max error over max |ref|
   below 1e-4 in fp32 and 5e-2 in bf16, the fp32 final state below 1e-4.
   At mamba2-370m's shape (b 1, S 1024, H 32, P 64, N 128, chunk 256,
   bf16), with the JAX test's dt and with a slowly decaying state that
   carries across chunks, y is also held elementwise and by rms and the
   state by rms (SSD_MAIN_TOLERANCE, SSD_MAIN_RMS_LIMIT and
   SSD_STATE_RMS_LIMIT); the model's chunked form passes those limits,
   and with the state it carries between chunks scaled by 0.99 it must
   fail them while it passes the JAX one.  It prints the readings, times
   kernel and plain version (no single PyTorch call computes this
   function), and times the kernel at S 1025 (chunk 256, a one-token last
   chunk), which may take at most 1.2x its time at S 1024.  The batched
   path's shape (SSD_BATCHED_MAIN_CASE, b 8) is held at the main limits and
   timed too.
5. K2 (decode attention) against its plain version: DECODE_CASES, ragged
   ones and the corners of its split (DECODE_CORNER_CASES; 2e-5 in fp32,
   5e-2 in bf16), stale slots past ``index`` set to +-99, and qwen3-4b's
   decode shape read strided from a [B, S, Hkv, D] cache, held at
   DECODE_MAIN_TOLERANCE and DECODE_MAIN_RMS_LIMIT on eight draws, where it
   times the kernel (clusters of 16 blocks), its plain version and
   ``scaled_dot_product_attention`` with the L2 cache flushed before each
   launch (a decode step finds the cache cold).
6. full-width qwen3-4b (36 blocks, bf16, random weights from a seed): one
   block's attention sublayer with the kernel against the same sublayer
   with the plain attention (rms of the difference over rms of the plain
   output), then a ``ServingEngine`` with 4 stages under ODIN serves
   closed-loop queries of 1024 tokens with a 3x slowdown on one stage's
   device for queries 8-19.  It must rebalance, move blocks off the slowed
   stage, conserve blocks, and run every block's attention through K1's
   tensor-core kernel.  A clean query's block time is printed beside the
   one measured when K1 ran bf16 on the CUDA cores.
7. full-width mamba2-370m (48 blocks, bf16, random weights from seed 0):
   K3 at block 0's own scan inputs against the plain scan, with the
   model's dt_bias and with dt_bias drawn as Mamba2's reference init draws
   it, and block 0's Mamba2 sublayer with K3 against the same sublayer with
   the plain scan; then the same
   ODIN serve as phase 6: it must rebalance, move blocks off the slowed
   stage, conserve blocks, launch K3 48 times per query, and give logits
   that do not depend on the stage split.
8. the cached path at full width: qwen3-4b prefills 1024 tokens into a
   2048-slot cache (K1), then decodes 16 tokens (K2, 36 x 16 launches);
   the decode logits are held against the same steps with the plain
   attention, and the prefill's last logits against ``forward``'s.
   mamba2-370m prefills 1024 tokens (K3 with its final state) and decodes
   8; its first decoded logits are held against ``forward``'s, and the
   forward over 1025 tokens (chunk 256 with a one-token last chunk) is
   timed beside the one over 1024.
9. batched and open-loop serving at full width: qwen3-4b and mamba2-370m,
   each on 4 stages under ODIN (alpha 3), serve 32 queries of bimodal
   length (256 or 1024 tokens, a quarter long), bursty arrivals calibrated
   from a closed-loop probe, continuous batching (buckets pow2:256:1024,
   up to 8 rows), with a 3x slowdown on stage 1 for queries 8-20.  Every
   query must be served, ODIN must rebalance and move blocks off stage 1,
   batches must form and at least one query must join a batch in flight,
   every warmed shape must lie in the power-of-two rows x used bucket
   edges family, a second serve must need no warm-up, and the kernel's
   launches must equal the block forwards the executor ran (dispatches x
   blocks, plus each join's catch-up blocks), K1's all on its tensor-core
   kernel.  It prints the summary, the dispatches, occupancy and padding,
   the same arrivals served drained, unbatched and with exploration trials
   riding batches, one drained burst of 8 long queries against the same 8
   served one at a time (host clock and trace clock), one block at 8 x 1024
   tokens (CUDA events), the card's busy share over a drained burst and
   over one query (``torch.profiler``), and the logits of a batch's padded
   rows against each query served alone, which must stay within
   BATCHED_LOGITS_RMS_LIMIT.
10. the card line again, one ``{"kernels": [...]}`` line, and last
   ``{"ok": true, "device": {...}}``.

Bounds use the H100 SXM data-sheet peaks: 989 TFLOP/s dense bf16 on the
tensor cores and 3.35 TB/s of HBM3.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import decode_attention as k2_lib  # noqa: E402
from repro_torch.kernels import ssd_scan as k3_lib  # noqa: E402
from repro_torch.kernels.cases import (  # noqa: E402
    BATCHED_MAIN_CASES,
    DECODE_CASES,
    DECODE_CORNER_CASES,
    DECODE_MAIN_CASE,
    DECODE_MAIN_RMS_LIMIT,
    DECODE_MAIN_TOLERANCE,
    DECODE_RAGGED_CASES,
    FLASH_CASES,
    MAIN_CASES,
    MAIN_RMS_LIMIT,
    MAIN_TOLERANCE,
    RAGGED_CASES,
    SSD_BATCHED_MAIN_CASE,
    SSD_CASES,
    SSD_CORNER_CASES,
    SSD_MAIN_CASE,
    SSD_MAIN_RMS_LIMIT,
    SSD_MAIN_TOLERANCE,
    SSD_RAGGED_CASES,
    SSD_STATE_RMS_LIMIT,
    TENSOR_CORE_CASES,
    max_ratio,
    ssd_limit,
    tolerance,
)
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    decode_attention_ref,
    flash_attention_ref,
    ssd_scan_ref,
)
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import blocks as blk  # noqa: E402
from repro_torch.models import mamba2 as mamba_lib  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.pipeline.executor import next_pow2  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.serving import engine as engine_lib  # noqa: E402
from repro_torch.schedulers.runtime import RuntimeStep  # noqa: E402
from repro_torch.workloads import make_lengths, resolve_batching  # noqa: E402

PEAK_BF16_FLOPS = 989e12      # H100 SXM, dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12       # H100 SXM, fp32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12      # H100 SXM, HBM3
KERNELS = ("flash_attention_bf16", "flash_attention", "decode_attention",
           "ssd_scan")
# A clean query's block time with the first designs of K1 (bf16 on the fp32
# CUDA cores) and K3 (one block per head), chip_smoke.py on an NVIDIA H100
# 80GB HBM3 at 700 W, printed beside this run's.
EARLIER_BLOCKS_MS = {"qwen3-4b": 54.99, "mamba2-370m": 60.27}
# K3 over S + 1 positions at most this many times its time over S (the
# JAX chunk rule cost about 21x on the whole mamba2-370m forward).
CHUNK_CLIFF_LIMIT = 1.2
DECODE_MAIN_DRAWS = 8         # draws of K2's main case held at its limits
SPIN_CYCLES = 1_000_000       # about 0.5 ms at the H100's 1.98 GHz boost

SEQ = 1024                    # tokens per served query (the main path)
NUM_QUERIES = 24
SLOW_EP, SLOW_FROM, SLOW_TO, SLOW_FACTOR = 1, 8, 20, 3.0
# A full-width attention sublayer (K1 then wo) with the kernel against the
# same sublayer with the plain attention: rms of the difference over rms of
# the plain sublayer's output: about 5x the 2.0e-4 measured on an NVIDIA
# H100 80GB HBM3 at 700 W.
SUBLAYER_RMS_LIMIT = 1e-3
# The same for block 0's Mamba2 sublayer (K3 against the token recurrence)
# and for block 0's attention sublayer at the first decode step (K2 against
# the plain attention, on copies of one prefilled cache).  The Mamba2
# sublayer reads exactly 0 on an NVIDIA H100 80GB HBM3 at 700 W: with the
# random weights the scan's y (rms about 1e-5) vanishes in bf16 beside the
# skip term D x, so this is only a check that the sublayer runs and stays
# finite; K3 is held at block 0's own scan inputs by SSD_MAIN_RMS_LIMIT.
MAMBA_SUBLAYER_RMS_LIMIT = 1e-3
DECODE_SUBLAYER_RMS_LIMIT = 1e-3
# The cached path: 2048 cache slots, a 1024-token prompt, 16 decode steps
# (qwen3-4b) and 8 (mamba2-370m).
CACHE_LEN, DECODE_STEPS, MAMBA_DECODE_STEPS = 2048, 16, 8
# qwen3-4b's decode logits with K2 against the same steps with the plain
# attention, rms of the difference over rms of the plain logits: about 5x
# the 1.98e-2 measured (NVIDIA H100 80GB HBM3, 700 W).  The random bf16
# model amplifies one-ulp differences of the attention output through 36
# blocks; the sublayer check above isolates K2.
DECODE_RMS_LIMIT = 1e-1
# Prefill's last logits against forward's at the same position (the same
# kernels on the same inputs: measured 0).
PREFILL_RMS_LIMIT = 1e-3
# mamba2-370m's first decoded logits (bf16 state in the cache, one step of
# the bf16 recurrence) against forward's at the same position (K3): about
# 5x the 2.64e-2 measured (NVIDIA H100 80GB HBM3, 700 W).
MAMBA_DECODE_RMS_LIMIT = 1.3e-1
# Phase 9: batched and open-loop serving.  32 queries of bimodal length
# (256 or 1024 tokens, p_long 0.25, seed 0), buckets pow2:256:1024, up to 8
# rows a dispatch, continuous batching; bursty arrivals calibrated from a
# 4-query closed-loop probe at SEQ tokens (tests/test_serving.py's kwargs);
# a 3x slowdown on stage 1 for queries 8-20.
BATCH_QUERIES, MAX_BATCH, BUCKETS = 32, 8, "pow2:256:1024"
SHORT, LONG, P_LONG = 256, 1024, 0.25
BATCH_SLOW_FROM, BATCH_SLOW_TO = 8, 21
# A continuous dispatch's rows (padded to their bucket edge, one of them
# joined mid-flight) against each query served alone: rms of the logits'
# difference over the real positions, over the rms of the logits alone.
# Both models read exactly 0 on an NVIDIA H100 80GB HBM3 at 700 W (the
# rows are bit-equal); the limit admits the 2e-2 that one-ulp roundings
# reach through 36 random bf16 blocks (the decode check's reading) and
# fails a row that reads its padding or another row (order 1).
BATCHED_LOGITS_RMS_LIMIT = 1e-1

def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def randn(gen, shape, dtype: str):
    return torch.randn(shape, generator=gen,
                       device="cuda").to(getattr(torch, dtype))


def rms(t: torch.Tensor) -> float:
    return float(t.float().square().mean().sqrt())


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    return rms(got.float() - want.float()) / rms(want)


def compare(out: torch.Tensor, ref: torch.Tensor, tol: dict, what: str,
            rms_limit: float = None) -> dict:
    """Raises unless |out - ref| <= atol + rtol |ref| everywhere and, where
    ``rms_limit`` is given, rms(out - ref) <= rms_limit * rms(ref).
    Returns the max and rms error, the rms of ``ref`` and the least atol
    that would pass at this rtol."""
    torch.cuda.synchronize()
    diff = out.float() - ref.float()
    excess = diff.abs() - tol["rtol"] * ref.float().abs()
    got = dict(max_abs_err=float(diff.abs().max()), rms_err=rms(diff),
               rms_ref=rms(ref), atol_needed=max(float(excess.max()), 0.0))
    limit = tol["atol"] + tol["rtol"] * ref.float().abs()
    bad = (not bool(torch.isfinite(out.float()).all())
           or bool((diff.abs() > limit).any())
           or (rms_limit is not None
               and got["rms_err"] > rms_limit * got["rms_ref"]))
    if bad:
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version: {got} (limits {tol}, rms "
                             f"{rms_limit})")
    return got


def compare_max(out: torch.Tensor, ref: torch.Tensor, limit: float,
                what: str, rms_limit: float = None) -> dict:
    """The JAX SSD check: raises unless max |out - ref| / max |ref| <
    ``limit`` and, where ``rms_limit`` is given, rms(out - ref) <=
    rms_limit * rms(ref).  Returns the max and rms errors, max and rms of
    ``ref``, and the two ratios."""
    torch.cuda.synchronize()
    diff = out.float() - ref.float()
    got = dict(max_abs_err=float(diff.abs().max()), rms_err=rms(diff),
               max_ref=float(ref.float().abs().max()), rms_ref=rms(ref),
               rel=max_ratio(out, ref))
    got["rms_rel"] = got["rms_err"] / got["rms_ref"]
    if not (bool(torch.isfinite(out.float()).all()) and got["rel"] < limit
            and (rms_limit is None or got["rms_rel"] <= rms_limit)):
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version: {got} (limit {limit}, rms "
                             f"{rms_limit})")
    return got


def time_ms(fn, reps: int = 30, warmup: int = 3, flush=None) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up;
    ``flush()`` runs before each timed launch, outside the timing.  A spin
    kernel of about 0.5 ms keeps the card busy while the host enqueues the
    start event and ``fn``'s launches, so the time between the events is
    the card's, not the host's enqueue time (for work whose enqueue takes
    longer than the spin, as in a loop of many small launches, it is not)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(flops: float, nbytes: float, peak_flops: float) -> tuple:
    """(bound_ms, bound_by): the larger of the operations over the peak
    and the bytes over HBM's rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def attention_bound(B, Hq, Hkv, S, D, causal, elem_bytes) -> tuple:
    """K1: operations over the bf16 peak, bytes (q, k, v read once, o
    written once) over HBM."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 2 * 2 * B * Hq * pairs * D          # Q K^T and P V
    nbytes = (2 * Hq + 2 * Hkv) * B * S * D * elem_bytes
    return bound(flops, nbytes, PEAK_BF16_FLOPS)


def ssd_work(b, S, H, P, N, chunk, elem_bytes) -> tuple:
    """K3's (flops, bytes): x, dt, A, B, C read once, y and the fp32 final
    state written once; the products of the chunked form, C.B^T once per
    chunk (it is shared by the heads), per head the masked scores times
    x dt, the state read and the state update."""
    flops = 0
    for c0 in range(0, S, chunk):
        cl = min(chunk, S - c0)
        pairs = cl * (cl + 1) // 2
        flops += b * 2 * pairs * N
        flops += b * H * (2 * pairs * P + 2 * cl * N * P + 2 * cl * P * N)
    nbytes = ((2 * b * S * H * P + b * S * H + 2 * b * S * N + H)
              * elem_bytes + b * H * P * N * 4)
    return flops, nbytes


def ssd_executed(b, S, H, chunk) -> int:
    """The operations K3's bf16 route runs on the tensor cores: 64-row
    tiles, P padded to 64 and N to 128, C.B^T per head and key tile at or
    before the row tile, the products with an fp32 operand three times
    (its three bf16 terms)."""
    T, PP, NP = 64, 64, 128
    flops = 0
    for c0 in range(0, S, chunk):
        tiles = -(-min(chunk, S - c0) // T)
        flops += 3 * 2 * PP * NP * T * tiles             # the chunk's state
        flops += (c0 > 0) * tiles * 3 * 2 * T * NP * PP  # state read
        pairs = tiles * (tiles + 1) // 2                 # (row, key) tiles
        flops += pairs * (2 * T * T * NP + 3 * 2 * T * T * PP)
    return b * H * flops


def decode_work(B, Hq, Hkv, S, D, index, window, elem_bytes) -> tuple:
    """K2's (flops, bytes): the live slots of k and v read once, q read and
    o written once; two products over the live slots."""
    lo = 0 if window is None else max(index - window + 1, 0)
    live = min(index, S - 1) - lo + 1
    flops = 2 * 2 * B * Hq * live * D
    nbytes = (2 * B * Hq * D + 2 * B * Hkv * live * D) * elem_bytes
    return flops, nbytes


ROUTES = ("tensor_core_launches", "cuda_core_launches")


def reset_counts(wrapper) -> None:
    """Set every launch count of a kernel wrapper to 0."""
    for name in list(vars(wrapper)):
        if name.endswith("launches"):
            setattr(wrapper, name, 0)


def route_counts() -> dict:
    return {r: getattr(flash_attention, r) for r in ROUTES}


def ptxas_lines(nvcc_log: str) -> list:
    """One (entry function's mangled name, line) per entry function of an
    ``nvcc -Xptxas=-v`` log; the line gives its registers and spills."""
    lines = []
    for block in nvcc_log.split("Compiling entry function")[1:]:
        name = re.search(r"'(\S+)'", block).group(1)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        lines.append((name,
                      f"{regs.group(1) if regs else '?'} registers, "
                      f"{spill.group(1) if spill else '?'} B spill stores, "
                      f"{spill.group(2) if spill else '?'} B spill loads"))
    return lines


def phase_kernel_check() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    reset_counts(flash_attention)
    expected = {r: 0 for r in ROUTES}
    for case in FLASH_CASES + RAGGED_CASES + TENSOR_CORE_CASES:
        B, Hq, Hkv, S, D, causal, window, dtype = case
        q = randn(gen, (B, Hq, S, D), dtype)
        k = randn(gen, (B, Hkv, S, D), dtype)
        v = randn(gen, (B, Hkv, S, D), dtype)
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  impl="cuda")
        expected[ROUTES[dtype != "bfloat16"]] += 1
        ref = flash_attention_ref(q, k, v, causal=causal, window=window)
        got = compare(out, ref, tolerance(dtype), str(case))
        log(f"  K1 {case}: max |err| {got['max_abs_err']:.3e}, rms err / "
            f"rms ref {got['rms_err'] / got['rms_ref']:.3e}")
    log(f"  K1 launches by route over these cases: {route_counts()}")
    if route_counts() != expected:
        raise AssertionError(f"K1 routes: {route_counts()}, expected "
                             f"{expected} (bf16 on the tensor cores, fp32 on "
                             f"the CUDA cores)")

    main = {}
    for case in MAIN_CASES:
        B, Hq, Hkv, S, D, _, _, dtype = case
        q = randn(gen, (B, Hq, S, D), dtype)
        k = randn(gen, (B, Hkv, S, D), dtype)
        v = randn(gen, (B, Hkv, S, D), dtype)
        before = route_counts()["tensor_core_launches"]
        got = compare(ops.flash_attention(q, k, v, impl="cuda"),
                      flash_attention_ref(q, k, v), MAIN_TOLERANCE,
                      f"main S={S}", MAIN_RMS_LIMIT)
        if route_counts()["tensor_core_launches"] != before + 1:
            raise AssertionError("the main shape did not run on the "
                                 "tensor-core kernel")
        # The model's layout: [B, S, H, D] projections, read in place.
        x = randn(gen, (B, S, Hq + 2 * Hkv, D), dtype)
        qs = x[:, :, :Hq].transpose(1, 2)
        ks = x[:, :, Hq:Hq + Hkv].transpose(1, 2)
        vs = x[:, :, Hq + Hkv:].transpose(1, 2)
        out = ops.flash_attention(qs, ks, vs, impl="cuda")
        strided = compare(out, flash_attention_ref(qs, ks, vs),
                          MAIN_TOLERANCE, f"main S={S} strided",
                          MAIN_RMS_LIMIT)
        log(f"  K1 main S={S}: contiguous {got}, strided {strided}, rms err "
            f"/ rms ref {got['rms_err'] / got['rms_ref']:.3e} and "
            f"{strided['rms_err'] / strided['rms_ref']:.3e} (limits "
            f"{MAIN_TOLERANCE}, rms {MAIN_RMS_LIMIT})")
        err = max(got["max_abs_err"], strided["max_abs_err"])
        if not out.transpose(1, 2).is_contiguous():
            raise AssertionError("kernel output is not in the model's "
                                 "[B, S, H, D] layout")
        kernel_ms = time_ms(lambda: ops.flash_attention(q, k, v,
                                                        impl="cuda"))
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v))
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        bound_ms, bound_by = attention_bound(B, Hq, Hkv, S, D, True, 2)
        flops = 4 * B * Hq * D * (S * (S + 1) // 2)
        fp32_ms = 1e3 * flops / PEAK_FP32_FLOPS
        main[S] = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by)
        log(f"  K1 main S={S}: max |err| {err:.3e}  kernel_ms {kernel_ms:.4f}"
            f"  plain_ms {plain_ms:.4f}  library_ms {library_ms:.4f}"
            f"  bound_ms {bound_ms:.5f} ({bound_by}; {flops / 1e9:.2f} GFLOP;"
            f" TFLOP/s achieved: kernel {flops / kernel_ms / 1e9:.1f}, "
            f"scaled_dot_product_attention {flops / library_ms / 1e9:.1f}; "
            f"the same products at the fp32 peak: {fp32_ms:.4f} ms)")

    # The batched path: a formed dispatch of 8 rows at a bucket edge.
    for case in BATCHED_MAIN_CASES:
        B, Hq, Hkv, S, D, _, _, dtype = case
        q = randn(gen, (B, Hq, S, D), dtype)
        k = randn(gen, (B, Hkv, S, D), dtype)
        v = randn(gen, (B, Hkv, S, D), dtype)
        before = route_counts()["tensor_core_launches"]
        got = compare(ops.flash_attention(q, k, v, impl="cuda"),
                      flash_attention_ref(q, k, v), MAIN_TOLERANCE,
                      f"batched B={B} S={S}", MAIN_RMS_LIMIT)
        if route_counts()["tensor_core_launches"] != before + 1:
            raise AssertionError(f"the batched shape {case} did not run on "
                                 f"the tensor-core kernel")
        kernel_ms = time_ms(lambda: ops.flash_attention(q, k, v,
                                                        impl="cuda"))
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v), reps=10)
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        bound_ms, bound_by = attention_bound(B, Hq, Hkv, S, D, True, 2)
        flops = 4 * B * Hq * D * (S * (S + 1) // 2)
        main[(B, S)] = dict(max_abs_err=got["max_abs_err"], ms=kernel_ms,
                            plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
        log(f"  K1 batched {case}: max |err| {got['max_abs_err']:.3e}, rms "
            f"err / rms ref {got['rms_err'] / got['rms_ref']:.3e} (limits "
            f"{MAIN_TOLERANCE}, rms {MAIN_RMS_LIMIT})  kernel_ms "
            f"{kernel_ms:.4f}  plain_ms {plain_ms:.4f}  library_ms "
            f"{library_ms:.4f}  bound_ms {bound_ms:.5f} ({bound_by}; "
            f"{flops / 1e9:.2f} GFLOP; TFLOP/s achieved: kernel "
            f"{flops / kernel_ms / 1e9:.1f}, scaled_dot_product_attention "
            f"{flops / library_ms / 1e9:.1f})")
    return main


def ssd_inputs(gen, b, S, H, P, N, dtype: str, slow: bool = False) -> list:
    """x, dt = softplus(normal), A = -exp(normal / 2), B, C as the JAX
    kernel test draws them; with ``slow``, dt log-uniform in [1e-3, 1e-1]
    (the range Mamba2 initialises dt to), where the state decays slowly and
    carries across chunks."""
    x = randn(gen, (b, S, H, P), dtype)
    if slow:
        dt = torch.exp(torch.empty((b, S, H), device="cuda").uniform_(
            float(np.log(1e-3)), float(np.log(1e-1)), generator=gen))
    else:
        dt = torch.nn.functional.softplus(
            torch.randn((b, S, H), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((H,), generator=gen, device="cuda") * 0.5)
    B = randn(gen, (b, S, N), dtype)
    C = randn(gen, (b, S, N), dtype)
    t = getattr(torch, dtype)
    return [x, dt.to(t), A.to(t), B, C]


def phase_ssd_check() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    for case in SSD_CASES + SSD_RAGGED_CASES + SSD_CORNER_CASES:
        b, S, H, P, N, chunk, dtype = case
        ins = ssd_inputs(gen, b, S, H, P, N, dtype)
        y, state = ops.ssd_scan(*ins, chunk=chunk, impl="cuda")
        y_ref, s_ref = ssd_scan_ref(*ins)
        gy = compare_max(y, y_ref, ssd_limit(dtype), f"K3 {case} y")
        # The state is fp32 in both versions.
        gs = compare_max(state, s_ref, ssd_limit("float32"),
                         f"K3 {case} state")
        log(f"  K3 {case}: y max|err|/max|ref| {gy['rel']:.3e}, state "
            f"{gs['rel']:.3e}")

    b, S, H, P, N, chunk, dtype = SSD_MAIN_CASE
    errs = []
    for slow in (True, False):           # the times below take JAX's draw
        # The model's layout: x, B and C are views into one conv output.
        xbc = randn(gen, (b, S, H * P + 2 * N), dtype)
        x = xbc[..., :H * P].reshape(b, S, H, P)
        _, dt, A, _, _ = ssd_inputs(gen, b, S, H, P, N, dtype, slow)
        B, C = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        what = f"K3 main, {'slow' if slow else 'JAX'} dt"
        gy, _, y_ref = check_ssd_main(what, x, dt, A, B, C, chunk, dtype)
        errs.append(gy["max_abs_err"])
        check_wrong_carry_fails(what, x, dt, A, B, C, chunk, dtype, y_ref)
    kernel_ms = time_ms(lambda: ops.ssd_scan(x, dt, A, B, C, chunk=chunk,
                                             impl="cuda"))
    # The chunk cliff: one token more (a one-token last chunk of the
    # config's chunk) must cost K3 at most CHUNK_CLIFF_LIMIT times as much.
    xbc1 = randn(gen, (b, S + 1, H * P + 2 * N), dtype)
    _, dt1, A1, _, _ = ssd_inputs(gen, b, S + 1, H, P, N, dtype)
    ins1 = (xbc1[..., :H * P].reshape(b, S + 1, H, P), dt1, A1,
            xbc1[..., H * P:H * P + N], xbc1[..., H * P + N:])
    odd_ms = time_ms(lambda: ops.ssd_scan(*ins1, chunk=chunk, impl="cuda"))
    log(f"  K3 at S {S + 1} (chunk {chunk}, a one-token last chunk): "
        f"{odd_ms:.4f} ms, {odd_ms / kernel_ms:.3f}x the {kernel_ms:.4f} ms "
        f"at S {S} (limit {CHUNK_CLIFF_LIMIT}x)")
    if not odd_ms <= CHUNK_CLIFF_LIMIT * kernel_ms:
        raise AssertionError(f"K3 at S {S + 1} takes {odd_ms / kernel_ms:.3f}"
                             f"x its time at S {S}")
    plain_ms = time_ms(lambda: ssd_scan_ref(x, dt, A, B, C), reps=5,
                       warmup=1)
    flops, nbytes = ssd_work(b, S, H, P, N, chunk, 2)
    executed = ssd_executed(b, S, H, chunk)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"  K3 main: kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  "
        f"library_ms none (no single PyTorch call)  bound_ms {bound_ms:.5f}"
        f" ({bound_by}; {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP; "
        f"{nbytes / kernel_ms / 1e6:.1f} GB/s and {flops / kernel_ms / 1e9:.2f}"
        f" TFLOP/s achieved; {executed / 1e9:.3f} GFLOP executed on the "
        f"tensor cores, {executed / kernel_ms / 1e9:.2f} TFLOP/s); three "
        f"launches, "
        f"{grid_line(k3_lib.launch_shape(b, S, H, P, N, chunk, x.dtype))}, "
        f"on {torch.cuda.get_device_properties(0).multi_processor_count} "
        f"SMs")

    # The batched path: a formed dispatch of 8 rows of 1024 tokens.
    b, S, H, P, N, chunk, dtype = SSD_BATCHED_MAIN_CASE
    for slow in (True, False):           # the times below take JAX's draw
        xbc = randn(gen, (b, S, H * P + 2 * N), dtype)
        xb = xbc[..., :H * P].reshape(b, S, H, P)
        _, dtb, Ab, _, _ = ssd_inputs(gen, b, S, H, P, N, dtype, slow)
        Bb, Cb = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
        gy, _, _ = check_ssd_main(
            f"K3 batched, {'slow' if slow else 'JAX'} dt", xb, dtb, Ab, Bb,
            Cb, chunk, dtype)
        errs.append(gy["max_abs_err"])
    b_ms = time_ms(lambda: ops.ssd_scan(xb, dtb, Ab, Bb, Cb, chunk=chunk,
                                        impl="cuda"))
    b_plain_ms = time_ms(lambda: ssd_scan_ref(xb, dtb, Ab, Bb, Cb), reps=5,
                         warmup=1)
    b_flops, b_nbytes = ssd_work(b, S, H, P, N, chunk, 2)
    b_bound_ms, b_bound_by = bound(b_flops, b_nbytes, PEAK_BF16_FLOPS)
    log(f"  K3 batched {SSD_BATCHED_MAIN_CASE}: kernel_ms {b_ms:.4f} "
        f"({b_ms / kernel_ms:.2f}x b 1)  plain_ms {b_plain_ms:.4f}  "
        f"library_ms none  bound_ms {b_bound_ms:.5f} ({b_bound_by}; "
        f"{b_nbytes / 1e6:.2f} MB, {b_flops / 1e9:.3f} GFLOP; "
        f"{b_nbytes / b_ms / 1e6:.1f} GB/s and {b_flops / b_ms / 1e9:.2f} "
        f"TFLOP/s achieved; {ssd_executed(b, S, H, chunk) / b_ms / 1e9:.2f}"
        f" TFLOP/s executed); "
        f"{grid_line(k3_lib.launch_shape(b, S, H, P, N, chunk, xb.dtype))}")
    return dict(max_abs_err=max(errs), ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                batched_ms=b_ms)


def grid_line(shapes: dict) -> str:
    return ", ".join(f"{name} {int(np.prod(grid))} blocks of {threads}"
                     for name, (grid, threads, _) in shapes.items())


def main_limits(y: torch.Tensor, y_ref: torch.Tensor) -> tuple:
    """y against the plain scan's ``y_ref`` at the main shape: (rms error
    over rms ref, whether SSD_MAIN_TOLERANCE holds everywhere, whether both
    it and SSD_MAIN_RMS_LIMIT hold)."""
    d, ref = y.float() - y_ref.float(), y_ref.float()
    rms_rel = rms(d) / rms(ref)
    elementwise = bool((d.abs() <= SSD_MAIN_TOLERANCE["atol"]
                        + SSD_MAIN_TOLERANCE["rtol"] * ref.abs()).all())
    return rms_rel, elementwise, elementwise and rms_rel <= SSD_MAIN_RMS_LIMIT


def check_wrong_carry_fails(what: str, x, dt, A, B, C, chunk: int,
                            dtype: str, y_ref: torch.Tensor) -> None:
    """The card's counterpart of test_ssd_main_limits_catch_a_wrong_carry:
    the model's chunked form (``ssd_chunked`` one chunk at a time in fp32,
    y rounded to ``y_ref``'s dtype) passes the main-shape limits against
    the plain scan's ``y_ref``; with the state it carries from chunk to
    chunk scaled by 0.99 it still passes the JAX limit, but fails
    SSD_MAIN_TOLERANCE or SSD_MAIN_RMS_LIMIT."""
    S = x.shape[1]
    xf, dtf, Af, Bf, Cf = (t.float() for t in (x, dt, A, B, C))

    def chunked(carry: float) -> torch.Tensor:
        state, ys = None, []
        for c in range(0, S, chunk):
            sl = slice(c, c + chunk)
            y, state = mamba_lib.ssd_chunked(
                xf[:, sl], dtf[:, sl], Af, Bf[:, sl], Cf[:, sl], chunk=chunk,
                init_state=None if state is None else carry * state)
            ys.append(y.to(y_ref.dtype))
        return torch.cat(ys, dim=1)

    for carry in (1.0, 0.99):
        y = chunked(carry)
        rms_rel, elementwise, passes = main_limits(y, y_ref)
        rel = max_ratio(y, y_ref)
        log(f"  {what}, the chunked form with the state carried x{carry}: "
            f"y max|err|/max|ref| {rel:.3e} (JAX limit {ssd_limit(dtype)}), "
            f"rms err / rms ref {rms_rel:.3e} (limit {SSD_MAIN_RMS_LIMIT}), "
            f"within SSD_MAIN_TOLERANCE everywhere: {elementwise}")
        if not rel < ssd_limit(dtype):
            raise AssertionError(f"{what}: the chunked form with a carry of "
                                 f"{carry} fails the JAX limit")
        if passes != (carry == 1.0):
            raise AssertionError(f"{what}: the main-shape limits "
                                 f"{'fail' if carry == 1.0 else 'pass'} the "
                                 f"chunked form with a carry of {carry}")


def check_ssd_main(what: str, x, dt, A, B, C, chunk: int, dtype: str,
                   elementwise: bool = True) -> tuple:
    """K3 against the token recurrence at a main-path shape: y at the JAX
    limit and by rms, and with ``elementwise`` at SSD_MAIN_TOLERANCE (whose
    atol is set for N(0, 1) inputs); the fp32 final state at the fp32 limit
    and by rms.  Prints the readings; returns the y and state readings and
    the plain scan's y."""
    y, state = ops.ssd_scan(x, dt, A, B, C, chunk=chunk, impl="cuda")
    y_ref, s_ref = ssd_scan_ref(x, dt, A, B, C)
    gy = compare_max(y, y_ref, ssd_limit(dtype), f"{what} y",
                     SSD_MAIN_RMS_LIMIT)
    ge = (compare(y, y_ref, SSD_MAIN_TOLERANCE, f"{what} y") if elementwise
          else dict(atol_needed=float("nan")))
    gs = compare_max(state, s_ref, ssd_limit("float32"), f"{what} state",
                     SSD_STATE_RMS_LIMIT)
    log(f"  {what} {tuple(x.shape)}: y max |err| {gy['max_abs_err']:.3e} "
        f"(max|ref| {gy['max_ref']:.3e}, ratio {gy['rel']:.3e}, limit "
        f"{ssd_limit(dtype)}); y rms err {gy['rms_err']:.3e} of rms ref "
        f"{gy['rms_ref']:.3e} = {gy['rms_rel']:.3e} (limit "
        f"{SSD_MAIN_RMS_LIMIT}); least atol at rtol "
        f"{SSD_MAIN_TOLERANCE['rtol']}: {ge['atol_needed']:.3e} (limit "
        f"{SSD_MAIN_TOLERANCE['atol']}); state max|err|/max|ref| "
        f"{gs['rel']:.3e}, rms err {gs['rms_err']:.3e} of rms ref "
        f"{gs['rms_ref']:.3e} = {gs['rms_rel']:.3e} (limit "
        f"{SSD_STATE_RMS_LIMIT})")
    return gy, gs, y_ref


def phase_decode_check() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)
    for case in DECODE_CASES + DECODE_RAGGED_CASES + DECODE_CORNER_CASES:
        B, Hq, Hkv, S, D, idx, window, dtype = case
        q = randn(gen, (B, Hq, D), dtype)
        k = randn(gen, (B, Hkv, S, D), dtype)
        v = randn(gen, (B, Hkv, S, D), dtype)
        out = ops.decode_attention(q, k, v, idx, window=window, impl="cuda")
        got = compare(out, decode_attention_ref(q, k, v, idx, window=window),
                      tolerance(dtype), str(case))
        # Stale slots past index must not change the output.
        k[:, :, idx + 1:] = 99.0
        v[:, :, idx + 1:] = -99.0
        stale = ops.decode_attention(q, k, v, idx, window=window,
                                     impl="cuda")
        torch.cuda.synchronize()
        if not torch.equal(stale, out):
            raise AssertionError(f"K2 {case}: stale slots past index "
                                 f"changed the output")
        log(f"  K2 {case}: max |err| {got['max_abs_err']:.3e}; stale slots "
            f"+-99 leave it unchanged")

    B, Hq, Hkv, S, D, idx, window, dtype = DECODE_MAIN_CASE
    index = torch.tensor(idx, dtype=torch.int32, device="cuda")
    # Several draws: one bf16 output a ulp off alone reads an rms over
    # DECODE_MAIN_RMS_LIMIT.  The first draw is the one timed below.
    readings = []
    for draw in range(DECODE_MAIN_DRAWS):
        q = randn(gen, (B, Hq, D), dtype)
        cache_k = randn(gen, (B, S, Hkv, D), dtype)   # the model's layout
        cache_v = randn(gen, (B, S, Hkv, D), dtype)
        k, v = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
        out = ops.decode_attention(q, k, v, index, impl="cuda")
        readings.append(compare(out, decode_attention_ref(q, k, v, idx),
                                DECODE_MAIN_TOLERANCE, f"K2 main, draw {draw}",
                                DECODE_MAIN_RMS_LIMIT))
        if draw == 0:
            timed = (q, k, v)
    q, k, v = timed
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    flush = scratch.zero_                          # 64 MB > the 50 MB L2
    mask = (torch.arange(S, device="cuda") <= index)[None, None, None, :]
    q4 = q[:, :, None]
    kernel_ms = time_ms(lambda: ops.decode_attention(q, k, v, index,
                                                     impl="cuda"),
                        flush=flush)
    plain_ms = time_ms(lambda: decode_attention_ref(q, k, v, index),
                       flush=flush)
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k, v, attn_mask=mask, enable_gqa=True), flush=flush)
    flops, nbytes = decode_work(B, Hq, Hkv, S, D, idx, window, 2)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    log(f"  K2 main {DECODE_MAIN_CASE} (read strided from a [B, S, Hkv, D] "
        f"cache, index on the card), {DECODE_MAIN_DRAWS} draws: max |err| "
        f"{[r['max_abs_err'] for r in readings]}, rms err / rms ref "
        f"{[round(r['rms_err'] / r['rms_ref'], 9) for r in readings]} "
        f"(limits {DECODE_MAIN_TOLERANCE}, rms {DECODE_MAIN_RMS_LIMIT})")
    log(f"  K2 main: one launch of {B * Hkv} clusters of {k2_lib.NSPLIT} "
        f"blocks of 256 threads")
    log(f"  K2 main: kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  "
        f"library_ms {library_ms:.4f}  bound_ms {bound_ms:.5f} ({bound_by};"
        f" {nbytes / 1e6:.2f} MB of live cache, q and o; "
        f"{nbytes / kernel_ms / 1e6:.1f} GB/s achieved); L2 flushed before "
        f"each launch")
    return dict(max_abs_err=max(r["max_abs_err"] for r in readings),
                ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def schedule(q: int) -> list:
    slow = [1.0] * 4
    if SLOW_FROM <= q < SLOW_TO:
        slow[SLOW_EP] = SLOW_FACTOR
    return slow


def serve_under_odin(cfg, params, counter, kernel: str,
                     per_block_ms: float) -> dict:
    """Serve NUM_QUERIES closed-loop queries of SEQ tokens on 4 stages under
    ODIN with a 3x slowdown on stage SLOW_EP for queries SLOW_FROM..SLOW_TO;
    raise unless it rebalances, moves blocks off the slowed stage,
    conserves blocks, launches ``counter``'s kernel once per block and
    query, and gives logits that do not depend on the split."""
    rng = np.random.default_rng(0)
    eng = ServingEngine(cfg, params, num_eps=4, scheduler="odin", alpha=3,
                        device="cuda")
    eng.executor.warmup(1, SEQ)
    queries = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, SEQ)),
                               device="cuda")
               for _ in range(NUM_QUERIES)]

    start_config = eng.config
    reset_counts(counter)
    t0 = time.perf_counter()
    trace = eng.serve(queries, schedule)
    wall = time.perf_counter() - t0
    counts = {name: n for name, n in vars(counter).items()
              if name.endswith("launches")}
    launches = counts.pop("launches")

    summary = trace.summary()
    log(f"  served {NUM_QUERIES} queries of {SEQ} tokens in {wall:.2f} s: "
        f"{json.dumps(summary)}")
    log(f"  configs: {trace.configs}")
    log(f"  start {start_config}, final {trace.configs[-1]}, "
        f"rebalances {trace.num_rebalances}, trials {trace.total_trials}, "
        f"{kernel} launches {launches}" + (f", by route {counts}" if counts
                                           else ""))
    episode = trace.configs[SLOW_FROM:SLOW_TO]
    if trace.num_rebalances < 1:
        raise AssertionError("ODIN never rebalanced")
    if not min(c[SLOW_EP] for c in episode) < start_config[SLOW_EP]:
        raise AssertionError(f"no blocks moved off the slowed stage "
                             f"{SLOW_EP}: {episode}")
    if any(sum(c) != cfg.num_blocks for c in trace.configs):
        raise AssertionError(f"a config lost blocks: {trace.configs}")
    if launches != cfg.num_blocks * NUM_QUERIES:
        raise AssertionError(f"{kernel} launched {launches} times, expected "
                             f"{cfg.num_blocks} x {NUM_QUERIES}")

    # Outputs: finite logits of the right shape, independent of the split.
    with torch.inference_mode():
        a, _ = eng.executor.run_query(queries[0], start_config)
        b, _ = eng.executor.run_query(queries[0], trace.configs[-1])
    if tuple(a.shape) != (1, SEQ, cfg.vocab_size) or not bool(
            torch.isfinite(a).all()):
        raise AssertionError(f"bad logits {tuple(a.shape)}")
    drift = float((a.float() - b.float()).abs().max())
    if not drift <= 1e-3 * float(a.float().abs().max()):
        raise AssertionError(f"logits depend on the stage split: {drift}")

    # Where a clean query's time goes (no slowdown, balanced split).
    x, positions = eng.executor.embed_tokens(queries[1])
    t0 = time.perf_counter()
    x, stages = eng.executor.run_stages(x, positions, start_config, 0,
                                        len(start_config))
    t1 = time.perf_counter()
    eng.executor.head(x)
    t2 = time.perf_counter()
    kern = cfg.num_blocks * per_block_ms
    log(f"  clean query on {start_config}: blocks {1e3 * (t1 - t0):.2f} ms "
        f"(before: {EARLIER_BLOCKS_MS[cfg.name]} ms; stages "
        f"{[round(1e3 * float(s), 2) for s in stages]}), head "
        f"{1e3 * (t2 - t1):.2f} ms; {kernel} {cfg.num_blocks} x "
        f"{per_block_ms:.4f} = {kern:.2f} ms ({100 * kern / (1e3 * (t2 - t0)):.0f}"
        f"% of blocks + head)")
    return dict(launches=launches, counts=counts, summary=summary)


def init_model(arch: str) -> tuple:
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = Model(cfg).init_params(seed=0, dtype=torch.bfloat16,
                                    device="cuda")
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.param_count() / 1e9:.2f} B parameters, "
        f"{cfg.num_blocks} blocks, d_model {cfg.d_model}, initialised in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    return cfg, params


def phase_qwen(cfg, params, kernel_ms: float) -> dict:
    rng = np.random.default_rng(0)
    # Block 0's attention sublayer (projections, K1, wo) on its normed
    # input, with the kernel against the same sublayer with the plain
    # attention.  The residual is left out: it would hide the sublayer.
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, SEQ)),
                             device="cuda")
    x = params["embed"]["table"][tokens]
    pos = torch.arange(SEQ, device="cuda").expand(1, SEQ)
    bp = blk.block_params(params["blocks"], 0)
    sub = bp["sub0"]
    with torch.inference_mode():
        h = rms_norm(x, sub["ln1"]["scale"], cfg.rms_eps)
        a_kernel = attn_lib.attention_forward(sub["mixer"], cfg, h, pos)
        a_plain = attn_lib.attention_forward(sub["mixer"], cfg, h, pos,
                                             impl="ref")
        torch.cuda.synchronize()
        diff = a_kernel.float() - a_plain.float()
        ratio = rms(diff) / rms(a_plain)
        rel_max = float(diff.abs().max() / a_plain.float().abs().max())
        block_ms = time_ms(lambda: blk.block_forward(bp, cfg, x, pos),
                           reps=10)
    if (not ratio <= SUBLAYER_RMS_LIMIT
            or not bool(torch.isfinite(a_kernel).all())):
        raise AssertionError(f"block 0's attention with the kernel: rms|d|"
                             f"/rms|ref| {ratio:.3e} (limit "
                             f"{SUBLAYER_RMS_LIMIT})")
    log(f"  block 0's attention sublayer, kernel vs plain attention: "
        f"rms|d|/rms|ref| {ratio:.3e} (limit {SUBLAYER_RMS_LIMIT}), "
        f"max|d|/max|ref| {rel_max:.3e}, rms|ref| {rms(a_plain):.3e}; "
        f"one block {block_ms:.3f} ms, of which attention {kernel_ms:.3f}"
        f" ms ({100 * kernel_ms / block_ms:.0f}%)")
    served = serve_under_odin(cfg, params, flash_attention, "K1", kernel_ms)
    want = {"tensor_core_launches": cfg.num_blocks * NUM_QUERIES,
            "cuda_core_launches": 0}
    if served["counts"] != want:
        raise AssertionError(f"K1 routes while serving: {served['counts']}, "
                             f"expected {want}")
    d, hd = cfg.d_model, cfg.head_dim
    products = 2 * SEQ * (d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
                          + cfg.num_heads * hd * d + 3 * d * cfg.d_ff)
    log(f"  a qwen3-4b block's projection and MLP products are "
        f"{products / 1e9:.1f} GFLOP, {1e3 * products / PEAK_BF16_FLOPS:.3f}"
        f" ms at the bf16 peak")
    return served


def phase_mamba(cfg, params, kernel_ms: float) -> dict:
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, SEQ)),
                             device="cuda")
    x = params["embed"]["table"][tokens]
    pos = torch.arange(SEQ, device="cuda").expand(1, SEQ)
    bp = blk.block_params(params["blocks"], 0)
    sub = bp["sub0"]
    # The model's init sets dt_bias to 0, so dt = softplus(normal) and the
    # state decays within a few tokens.  Mamba2's reference init draws
    # dt_bias so that softplus(dt_bias) is log-uniform in [1e-3, 1e-1]:
    # there the state carries across chunks.  Block 0 is checked both ways.
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt0 = torch.exp(torch.empty(sub["mixer"]["dt_bias"].shape,
                                device="cuda").uniform_(
        float(np.log(1e-3)), float(np.log(1e-1)), generator=gen))
    mixers = {"the model's init": sub["mixer"],
              "dt_bias as Mamba2's reference init": dict(
                  sub["mixer"], dt_bias=dt0 + torch.log(-torch.expm1(-dt0)))}
    with torch.inference_mode():
        h = rms_norm(x, sub["ln1"]["scale"], cfg.rms_eps)
        for name, mixer in mixers.items():
            # K3 at block 0's own scan inputs (strided views, as served);
            # y is small there (rms about 1e-5), so it is held by ratios.
            _, _, xs, dt, A, Bm, Cm = mamba_lib.scan_inputs(mixer, cfg, h)
            check_ssd_main(f"K3 at block 0's inputs, {name},", xs, dt, A, Bm,
                           Cm, cfg.ssm.chunk_size, "bfloat16",
                           elementwise=False)
        m_kernel = mamba_lib.mamba_forward(sub["mixer"], cfg, h)
        m_plain = mamba_lib.mamba_forward(sub["mixer"], cfg, h, impl="ref")
        ratio = rel_rms(m_kernel, m_plain)
        log(f"  block 0's Mamba2 sublayer, K3 vs the plain scan: rms|d|/"
            f"rms|ref| {ratio:.3e} (limit {MAMBA_SUBLAYER_RMS_LIMIT}), "
            f"rms|ref| {rms(m_plain):.3e}")
        if (not ratio <= MAMBA_SUBLAYER_RMS_LIMIT
                or not bool(torch.isfinite(m_kernel).all())):
            raise AssertionError(f"block 0's Mamba2 sublayer with K3: "
                                 f"rms|d|/rms|ref| {ratio:.3e}")
        block_ms = time_ms(lambda: blk.block_forward(bp, cfg, x, pos),
                           reps=10)
    log(f"  one block {block_ms:.3f} ms, of which the scan {kernel_ms:.3f} "
        f"ms ({100 * kernel_ms / block_ms:.0f}%)")
    return serve_under_odin(cfg, params, ssd_scan, "K3", kernel_ms)


def clone_tree(tree: dict) -> dict:
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def wall_ms(fn, reps: int = 3) -> float:
    """Median host-clock time of ``fn`` (synchronised), in ms."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def decode_loop(model, params, cache, tokens, start: int, impl: str) -> tuple:
    """Decode ``tokens`` [1, n] one at a time from position ``start``, with
    the position kept on the card; returns (logits per step, ms per
    step)."""
    index = torch.tensor(start, dtype=torch.int32, device="cuda")
    logits, times = [], []
    for t in range(tokens.shape[1]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = model.decode_step(params, tokens[:, t:t + 1], cache,
                                      index, impl=impl)
        index += 1
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        logits.append(lg)
    return logits, times


def phase_cached(qcfg, qparams, mcfg, mparams) -> dict:
    rng = np.random.default_rng(2)
    out = {}
    # qwen3-4b: prefill through K1, decode through K2.
    model = Model(qcfg)
    prompt = torch.as_tensor(rng.integers(0, qcfg.vocab_size, (1, SEQ)),
                             device="cuda")
    cont = torch.as_tensor(
        rng.integers(0, qcfg.vocab_size, (1, DECODE_STEPS)), device="cuda")
    with torch.inference_mode():
        cache = model.init_cache(1, CACHE_LEN, torch.bfloat16, "cuda")
        reset_counts(flash_attention)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = model.prefill(qparams, tokens=prompt, cache=cache)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        k1 = flash_attention.launches
        k1_tensor_cores = flash_attention.tensor_core_launches
        full = model.forward(qparams, prompt)
        prefill_ratio = rel_rms(last[:, 0], full[:, -1])
        del full
        # How much this random bf16 model amplifies one-ulp differences:
        # the same prefill with the plain attention in place of K1.
        plain_last, _ = model.prefill(
            qparams, tokens=prompt, impl="ref",
            cache=model.init_cache(1, SEQ, torch.bfloat16, "cuda"))
        k1_model_ratio = rel_rms(last[:, 0], plain_last[:, 0])
        # K2 alone: block 0's attention sublayer at the first decode step,
        # with the kernel and with the plain attention, on copies of the
        # prefilled cache.
        sub = blk.block_params(qparams["blocks"], 0)["sub0"]
        h = rms_norm(qparams["embed"]["table"][cont[:, :1]],
                     sub["ln1"]["scale"], qcfg.rms_eps)
        c0 = blk.block_params(cache, 0)["sub0"]
        o_kernel, _ = attn_lib.attention_decode(sub["mixer"], qcfg, h,
                                                clone_tree(c0), SEQ)
        o_plain, _ = attn_lib.attention_decode(sub["mixer"], qcfg, h,
                                               clone_tree(c0), SEQ,
                                               impl="ref")
        sub_ratio = rel_rms(o_kernel, o_plain)
        cache_plain = clone_tree(cache)
        reset_counts(decode_attention)
        kern, kern_ms = decode_loop(model, qparams, cache, cont, SEQ, "auto")
        launches = decode_attention.launches
        plain, plain_ms = decode_loop(model, qparams, cache_plain, cont, SEQ,
                                      "ref")
    ratios = [rel_rms(a[:, 0], b[:, 0]) for a, b in zip(kern, plain)]
    log(f"  qwen3-4b prefill of {SEQ} tokens into {CACHE_LEN} slots: "
        f"{prefill_ms:.2f} ms, K1 launches {k1}; last logits vs forward's "
        f"rms|d|/rms|ref| {prefill_ratio:.3e} (limit {PREFILL_RMS_LIMIT})")
    log(f"  the same prefill with the plain attention in place of K1: last "
        f"logits rms|d|/rms|ref| {k1_model_ratio:.3e} (a reading of how far "
        f"36 bf16 blocks carry one-ulp differences); block 0's attention "
        f"sublayer at the first decode step, K2 vs plain: rms|d|/rms|ref| "
        f"{sub_ratio:.3e} (limit {DECODE_SUBLAYER_RMS_LIMIT})")
    log(f"  qwen3-4b {DECODE_STEPS} decode steps: K2 launches {launches}; "
        f"ms per step with K2 {[round(t, 2) for t in kern_ms]} (median "
        f"{np.median(kern_ms):.2f}), with the plain attention median "
        f"{np.median(plain_ms):.2f}; logits K2 vs plain rms|d|/rms|ref| per "
        f"step {[f'{r:.2e}' for r in ratios]} (max {max(ratios):.3e}, limit "
        f"{DECODE_RMS_LIMIT})")
    if not k1 == k1_tensor_cores == qcfg.num_blocks:
        raise AssertionError(f"prefill launched K1 {k1} times, "
                             f"{k1_tensor_cores} on the tensor cores")
    if launches != qcfg.num_blocks * DECODE_STEPS:
        raise AssertionError(f"K2 launched {launches} times, expected "
                             f"{qcfg.num_blocks} x {DECODE_STEPS}")
    if not prefill_ratio <= PREFILL_RMS_LIMIT:
        raise AssertionError(f"prefill's last logits differ from forward's: "
                             f"{prefill_ratio:.3e}")
    if not sub_ratio <= DECODE_SUBLAYER_RMS_LIMIT:
        raise AssertionError(f"block 0's attention at decode with K2: "
                             f"rms|d|/rms|ref| {sub_ratio:.3e}")
    if not (max(ratios) <= DECODE_RMS_LIMIT
            and all(bool(torch.isfinite(a).all()) for a in kern)):
        raise AssertionError(f"decode logits with K2 differ from the plain "
                             f"attention's: {ratios}")
    out["qwen3-4b"] = dict(launches=launches, ms_per_step=kern_ms)

    # mamba2-370m: prefill through K3 (with its final state), decode
    # through the plain one-token recurrence.
    model = Model(mcfg)
    prompt = torch.as_tensor(rng.integers(0, mcfg.vocab_size, (1, SEQ + 1)),
                             device="cuda")
    cont = torch.as_tensor(
        rng.integers(0, mcfg.vocab_size, (1, MAMBA_DECODE_STEPS - 1)),
        device="cuda")
    with torch.inference_mode():
        cache = model.init_cache(1, CACHE_LEN, torch.bfloat16, "cuda")
        reset_counts(ssd_scan)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, cache = model.prefill(mparams, tokens=prompt[:, :SEQ],
                                    cache=cache)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        k3 = ssd_scan.launches
        # Forward over the same prompt (the same chunks), then over one
        # more token (an odd length: chunk 256 with a one-token last chunk;
        # the JAX rule would give 1025 chunks of one token).
        # Each is timed as the median of three after one untimed call (the
        # first call at a new length also allocates).
        fwd = model.forward(mparams, prompt[:, :SEQ])[:, -1]
        full = model.forward(mparams, prompt)[:, SEQ]
        fwd_ms = {n: wall_ms(lambda: model.forward(mparams, prompt[:, :n]))
                  for n in (SEQ, SEQ + 1)}
        prefill_ratio = rel_rms(last[:, 0], fwd)
        steps = torch.cat([prompt[:, SEQ:], cont], dim=1)
        logits, ms = decode_loop(model, mparams, cache, steps, SEQ, "auto")
    first_ratio = rel_rms(logits[0][:, 0], full)
    log(f"  mamba2-370m prefill of {SEQ} tokens: {prefill_ms:.2f} ms, K3 "
        f"launches {k3}; last logits vs forward's rms|d|/rms|ref| "
        f"{prefill_ratio:.3e} (limit {PREFILL_RMS_LIMIT}); first decoded "
        f"logits vs forward's {first_ratio:.3e} (limit "
        f"{MAMBA_DECODE_RMS_LIMIT}); {MAMBA_DECODE_STEPS} decode steps, ms "
        f"per step {[round(t, 2) for t in ms]} (median {np.median(ms):.2f})")
    log(f"  mamba2-370m forward over {SEQ} tokens (chunk 256): "
        f"{fwd_ms[SEQ]:.2f} ms; over {SEQ + 1} tokens (chunk 256, a "
        f"one-token last chunk): {fwd_ms[SEQ + 1]:.2f} ms, "
        f"{fwd_ms[SEQ + 1] / fwd_ms[SEQ]:.3f}x")
    if k3 != mcfg.num_blocks:
        raise AssertionError(f"prefill launched K3 {k3} times")
    if not prefill_ratio <= PREFILL_RMS_LIMIT:
        raise AssertionError(f"mamba prefill's last logits differ from "
                             f"forward's: {prefill_ratio:.3e}")
    if not (first_ratio <= MAMBA_DECODE_RMS_LIMIT
            and all(bool(torch.isfinite(a).all()) for a in logits)):
        raise AssertionError(f"mamba decode logits differ from forward's: "
                             f"{first_ratio:.3e}")
    out["mamba2-370m"] = dict(launches=k3, ms_per_step=ms)
    return out


def batch_schedule(q: int) -> list:
    slow = [1.0] * 4
    if BATCH_SLOW_FROM <= q < BATCH_SLOW_TO:
        slow[SLOW_EP] = SLOW_FACTOR
    return slow


class BlockForwards:
    """Counts, while active, the block forwards the executor ``ex`` runs
    (the blocks of every ``stage_fn`` call), the dispatches (formed
    dispatches finished and queries executed alone) and each join's
    catch-up blocks (the blocks of the fused launch over the joiner)."""

    def __init__(self, ex):
        self.ex = ex
        self.blocks = self.dispatches = self.joins = self.catchup = 0

    def __enter__(self):
        ex, counts = self.ex, self
        stage_fn = ex.stage_fn
        builder, live = engine_lib._LiveDispatchBuilder, \
            engine_lib._LiveQueryExecutor
        self._saved = (builder.join, builder.finish, live.execute)
        join, finish, execute = self._saved

        def counted_stage_fn(x, positions, lo, hi):
            counts.blocks += hi - lo
            return stage_fn(x, positions, lo, hi)

        def counted_join(b, q):
            counts.joins += 1
            counts.catchup += b._bounds[b._stage - 1][1]
            return join(b, q)

        def counted_finish(b):
            counts.dispatches += 1
            return finish(b)

        def counted_execute(lv, q, step):
            counts.dispatches += 1
            return execute(lv, q, step)

        ex.stage_fn = counted_stage_fn
        builder.join, builder.finish = counted_join, counted_finish
        live.execute = counted_execute
        return self

    def __exit__(self, *exc):
        del self.ex.stage_fn
        builder, live = engine_lib._LiveDispatchBuilder, \
            engine_lib._LiveQueryExecutor
        builder.join, builder.finish, live.execute = self._saved
        return False


def load_line(trace) -> str:
    s = trace.summary()
    return (f"mean queue delay {s['mean_queue_delay_s']:.4f} s, p99 "
            f"latency {s['p99_latency_s']:.4f} s, achieved load "
            f"{s['achieved_load_qps']:.2f} of {s['offered_load_qps']:.2f} q/s "
            f"offered, mean occupancy {s['mean_batch_occupancy']:.3f}")


def batched_logits_ratio(eng, cfg, rng) -> list:
    """One continuous dispatch through the engine's builder, two queries
    formed (256 and 200 tokens) and one (230 tokens) joining after stage 1,
    all right-padded to the 256-token bucket edge: per row, rms(batched
    logits - the query's logits alone) over its real positions, over the
    rms of the logits alone."""
    lengths = np.array([256, 200, 230])
    queries = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, int(n))),
                               device="cuda") for n in lengths]
    live = eng.query_executor(queries, lambda q: [1.0] * 4)
    former = resolve_batching("continuous", max_batch=MAX_BATCH,
                              buckets=BUCKETS, seq=LONG)
    live.configure_batching(former, lengths, former.padded_lengths(lengths))
    live.begin_query(0)
    builder = live.begin_dispatch(0, RuntimeStep(eng.config, serial=False))
    builder.add(0)
    builder.add(1)
    builder.next_boundary()
    builder.join(2)
    builder.finish()
    ratios = []
    with torch.inference_mode():
        logits = eng.executor.head(builder._x)
        for i, n in enumerate(lengths):
            alone, _ = eng.executor.run_query(queries[i], eng.config)
            ratios.append(rel_rms(logits[i, :n], alone[0]))
            if not bool(torch.isfinite(logits[i, :n]).all()):
                raise AssertionError(f"row {i} of the batch has non-finite "
                                     f"logits")
    return ratios


def device_busy(fn) -> tuple:
    """(host-clock seconds of ``fn``, synchronised; seconds the card spent
    in kernels meanwhile, from ``torch.profiler``'s device times)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(getattr(ev, "device_time_total", None)
               or getattr(ev, "cuda_time_total", 0)
               for ev in prof.key_averages())
    return wall, busy / 1e6


def serve_batched(cfg, params, counter, kernel: str,
                  kernel_ms: float) -> dict:
    """Phase 9 for one model: bursty, continuous-batched traffic under ODIN
    (see the module docstring)."""
    rng = np.random.default_rng(3)
    lengths = make_lengths("bimodal", short=SHORT, long=LONG, p_long=P_LONG,
                           seed=0).sample(BATCH_QUERIES)
    queries = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, int(n))),
                               device="cuda") for n in lengths]
    eng = ServingEngine(cfg, params, num_eps=4, scheduler="odin", alpha=3,
                        device="cuda")
    ex = eng.executor
    ex.warmup(1, SEQ)
    probe = eng.serve([torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (1, SEQ)), device="cuda")
                       for _ in range(4)], lambda q: [1.0] * 4)
    service = float(probe.service_latencies[1:].mean())
    eng.reset_policy()
    wl = dict(burst_rate=8.0 / service, base_rate=0.3 / service,
              mean_burst=60 * service, mean_gap=15 * service, seed=0)
    kw = dict(workload="bursty", workload_kwargs=wl, max_batch=MAX_BATCH,
              batching="continuous", buckets=BUCKETS)
    former = resolve_batching("continuous", max_batch=MAX_BATCH,
                              buckets=BUCKETS, seq=LONG)
    edges = sorted({int(e) for e in former.padded_lengths(lengths)})
    # The serve warms this set itself; warmed here, its launches stay out
    # of the counted run.
    ex.warm_buckets(edges, MAX_BATCH)

    start_config = eng.config
    reset_counts(counter)
    with BlockForwards(ex) as fw:
        t0 = time.perf_counter()
        trace = eng.serve(queries, batch_schedule, **kw)
        wall = time.perf_counter() - t0
    counts = {name: n for name, n in vars(counter).items()
              if name.endswith("launches")}
    launches = counts.pop("launches")
    s = trace.summary()
    log(f"  {cfg.name}: probe service {1e3 * service:.2f} ms a 1024-token "
        f"query; bursty burst_rate {wl['burst_rate']:.2f} q/s, base_rate "
        f"{wl['base_rate']:.3f} q/s, mean_burst {wl['mean_burst']:.3f} s, "
        f"mean_gap {wl['mean_gap']:.3f} s; lengths {lengths.tolist()}")
    log(f"  served {len(trace.latencies)} queries in {wall:.2f} s: "
        f"{json.dumps(s)}")
    log(f"  configs: {trace.configs}")
    log(f"  dispatches {fw.dispatches}, joins {fw.joins} (catch-up blocks "
        f"{fw.catchup}), block forwards {fw.blocks}, {kernel} launches "
        f"{launches}" + (f", by route {counts}" if counts else "")
        + f"; mean occupancy {s['mean_batch_occupancy']:.3f}, p99 "
        f"{s['p99_batch_occupancy']:.1f}, padded_token_frac "
        f"{s['padded_token_frac']:.4f}; rebalances {trace.num_rebalances}, "
        f"trials {trace.total_trials}")
    episode = trace.configs[BATCH_SLOW_FROM:BATCH_SLOW_TO]
    checks = {
        "every query served": len(trace.latencies) == BATCH_QUERIES,
        "ODIN rebalanced": trace.num_rebalances >= 1,
        "blocks moved off stage 1": min(c[SLOW_EP] for c in episode)
        < start_config[SLOW_EP],
        "every config conserves blocks": all(
            sum(c) == cfg.num_blocks for c in trace.configs),
        "batches formed": s["mean_batch_occupancy"] > 1.0,
        "a query joined a batch in flight": fw.joins >= 1,
        "only warm shapes": all(seq in edges and rows == next_pow2(rows)
                                for rows, seq in ex._warmed),
        "launches = block forwards = dispatches x blocks + catch-up":
            launches == fw.blocks
            == fw.dispatches * cfg.num_blocks + fw.catchup,
    }
    if counter is flash_attention:
        checks["every K1 launch on the tensor cores"] = \
            counts["cuda_core_launches"] == 0
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{cfg.name} batched serving: {failed}")
    log(f"  warmed shapes {sorted(ex._warmed)}")

    # A second serve over warm shapes must not warm anything.
    def no_warmups(*a, **k):
        raise AssertionError(f"warm-up requested in a warm serve: {a}")

    eng.reset_policy()
    ex.warmup = no_warmups
    try:
        again = eng.serve(queries, batch_schedule, **kw)
    finally:
        del ex.warmup
    if len(again.latencies) != BATCH_QUERIES:
        raise AssertionError("the second serve lost queries")
    eng.reset_policy()
    drain = eng.serve(queries, batch_schedule, **dict(kw, batching="drain"))
    eng.reset_policy()
    solo = eng.serve(queries, batch_schedule, workload="bursty",
                     workload_kwargs=wl, max_batch=1)
    eng.reset_policy()
    riding = eng.serve(queries, batch_schedule,
                       **dict(kw, explore_in_batch=True))
    for name, tr in (("continuous", trace), ("continuous, again", again),
                     ("drain", drain), ("max_batch=1", solo),
                     ("continuous, trials riding batches", riding)):
        log(f"  the same arrivals, {name}: {load_line(tr)}, serial_frac "
            f"{tr.summary()['serial_frac']:.3f}")

    # One drained burst of 8 long queries against the same 8 one at a time,
    # all arriving at once, on a static split.
    static = ServingEngine(cfg, params, num_eps=4, scheduler="none",
                           executor=ex)
    burst = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, LONG)),
                             device="cuda") for _ in range(MAX_BATCH)]
    at_once = dict(workload="trace", workload_kwargs=dict(
        inter_arrivals=[0.0]))
    walls, spans = {}, {}
    for name, opts in (("solo", dict(max_batch=1)),
                       ("drained", dict(batching="drain",
                                        max_batch=MAX_BATCH,
                                        buckets=BUCKETS)),
                       ("drained, again", dict(batching="drain",
                                               max_batch=MAX_BATCH,
                                               buckets=BUCKETS)),
                       ("solo, again", dict(max_batch=1))):
        t0 = time.perf_counter()
        tr = static.serve(burst, lambda q: [1.0] * 4, **at_once, **opts)
        walls[name] = time.perf_counter() - t0
        spans[name] = float(tr.completion_times.max()
                            - tr.arrival_times.min())
    # The trace's clock credits queries served one at a time with
    # pipelined stages (the next starts when the bottleneck stage frees);
    # on one card the stages run one after the other, so the host clock is
    # the burst's real time.
    # Where a drained dispatch's time goes: one block at 8 x LONG tokens
    # (CUDA events), and the card's busy share over a drained burst and
    # over one query served alone.
    with torch.inference_mode():
        x = params["embed"]["table"][torch.cat(burst)]
        pos = torch.arange(LONG, device="cuda").expand(MAX_BATCH, LONG)
        bp = blk.block_params(params["blocks"], 0)
        block_ms = time_ms(lambda: blk.block_forward(bp, cfg, x, pos),
                           reps=10)
    del x
    busy = {
        "drained burst": device_busy(lambda: static.serve(
            burst, lambda q: [1.0] * 4, **at_once, batching="drain",
            max_batch=MAX_BATCH, buckets=BUCKETS)),
        "one query alone": device_busy(lambda: static.serve(
            burst[:1], lambda q: [1.0] * 4)),
    }
    log(f"  one block at {MAX_BATCH} x {LONG} tokens {block_ms:.3f} ms "
        f"(CUDA events), of which {kernel} {kernel_ms:.4f} ms "
        f"({100 * kernel_ms / block_ms:.0f}%); card busy (torch.profiler "
        f"kernel time over the host clock): " + ", ".join(
            f"{name} {b:.4f} of {w:.4f} s ({100 * b / w:.0f}%)"
            for name, (w, b) in busy.items()))
    log(f"  8 queries of {LONG} tokens arriving at once on "
        f"{static.config}, host clock: drained burst {walls['drained']:.4f}"
        f" / {walls['drained, again']:.4f} s, one at a time "
        f"{walls['solo']:.4f} / {walls['solo, again']:.4f} s; the trace's "
        f"last completion: drained {spans['drained']:.4f} / "
        f"{spans['drained, again']:.4f} s, one at a time (pipelined "
        f"stages) {spans['solo']:.4f} / {spans['solo, again']:.4f} s")

    ratios = batched_logits_ratio(eng, cfg, rng)
    log(f"  logits of a continuous dispatch with a join (rows of 256, 200 "
        f"and 230 tokens padded to 256) against each query alone, rms|d|/"
        f"rms|alone| over the real positions: "
        f"{[f'{r:.3e}' for r in ratios]} (limit {BATCHED_LOGITS_RMS_LIMIT})")
    if not max(ratios) <= BATCHED_LOGITS_RMS_LIMIT:
        raise AssertionError(f"{cfg.name}: a batched row's logits differ "
                             f"from the query's alone: {ratios}")
    return dict(launches=launches, summary=s, walls=walls, ratios=ratios,
                block_ms=block_ms, busy=busy)


def phase_batched(qcfg, qparams, mcfg, mparams, k1_ms: float,
                  k3_ms: float) -> dict:
    """``k1_ms`` / ``k3_ms``: each kernel's time at its batched shape
    (phases 3-4)."""
    return {"qwen3-4b": serve_batched(qcfg, qparams, flash_attention, "K1",
                                      k1_ms),
            "mamba2-370m": serve_batched(mcfg, mparams, ssd_scan, "K3",
                                         k3_ms)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    def phase(title: str, fn, *args):
        log(title)
        t0 = time.perf_counter()
        result = fn(*args)
        log(f"  [{title.split(':')[0]}: {time.perf_counter() - t0:.1f} s; "
            f"{time.perf_counter() - t_start:.1f} s since start]")
        return result

    def build_all():
        logs = build.build_kernels(KERNELS)
        for name, (nvcc_log, seconds) in logs.items():
            log(f"  {name}: {build.lib_path(name).name}, nvcc {seconds:.1f} s"
                + ("" if nvcc_log is None else f"\n{nvcc_log}"))
        logs = {name: nvcc_log for name, (nvcc_log, _) in logs.items()}
        lib = build.load("flash_attention_bf16")
        smem = lib.odin_flash_attention_bf16_smem_bytes
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
        for name, line in ptxas_lines(logs["flash_attention_bf16"] or ""):
            dp = int(re.search(r"ILi(\d+)E", name).group(1))
            log(f"  K1 tensor-core kernel, head dims padded to {dp}: {line}, "
                f"{smem(dp)} B dynamic shared memory")
        b, S, H, P, N, chunk, _ = SSD_MAIN_CASE
        shapes = k3_lib.launch_shape(b, S, H, P, N, chunk, torch.bfloat16)
        for name, line in ptxas_lines(logs["ssd_scan"] or ""):
            launch = next(k for k in shapes if k in name)
            if "bfloat16" not in name and launch != "ssd_state_pass":
                continue                 # the fp32 instantiation
            grid, threads, smem_bytes = shapes[launch]
            log(f"  K3 {launch} (bf16) at {SSD_MAIN_CASE}: grid {grid} = "
                f"{int(np.prod(grid))} blocks of {threads} threads, {line}, "
                f"{smem_bytes} B dynamic shared memory")
        for name, line in ptxas_lines(logs["decode_attention"] or ""):
            if "bfloat16" in name:
                log(f"  K2 decode_fwd (bf16): {line}")

    phase("phase 2: build K1 (bf16 and fp32), K2, K3", build_all)
    main_k1 = phase("phase 3: K1 against its plain version",
                    phase_kernel_check)
    k3 = phase("phase 4: K3 against its plain version", phase_ssd_check)
    k2 = phase("phase 5: K2 against its plain version", phase_decode_check)
    qcfg, qparams = init_model("qwen3-4b")
    served = phase("phase 6: full-width qwen3-4b under ODIN", phase_qwen,
                   qcfg, qparams, main_k1[SEQ]["ms"])
    mcfg, mparams = init_model("mamba2-370m")
    served_m = phase("phase 7: full-width mamba2-370m under ODIN",
                     phase_mamba, mcfg, mparams, k3["ms"])
    cached = phase("phase 8: the cached path (prefill, decode)",
                   phase_cached, qcfg, qparams, mcfg, mparams)
    batched = phase("phase 9: batched and open-loop serving at full width",
                    phase_batched, qcfg, qparams, mcfg, mparams,
                    main_k1[(MAX_BATCH, LONG)]["ms"], k3["batched_ms"])

    k1 = main_k1[SEQ]
    k1 = dict(k1, max_abs_err=max(m["max_abs_err"] for m in main_k1.values()))
    # Launches on the main paths: the closed-loop serve and the batched
    # one for K1 and K3, the decode steps for K2.
    rows = [
        ("flash_attention", "flash_attention.py:96",
         served["counts"]["tensor_core_launches"]
         + batched["qwen3-4b"]["launches"], k1),
        ("decode_attention", "decode_attention.py:78",
         cached["qwen3-4b"]["launches"], k2),
        ("ssd_scan", "ssd_scan.py:71",
         served_m["launches"] + batched["mamba2-370m"]["launches"], k3),
    ]
    sources = {"flash_attention": "flash_attention_bf16"}
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{sources.get(name, name)}.cu",
        "replaces": f"src/repro/kernels/{replaces}",
        "launches": launches,
        "max_abs_err": m["max_abs_err"],
        "ms": m["ms"],
        "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"],
        "library_ms": m["library_ms"],
    } for name, replaces, launches, m in rows]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
