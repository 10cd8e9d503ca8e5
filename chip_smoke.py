"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain versions.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions.
   There must be a CUDA device.
2. build: the port's kernel K1 from its source in this checkout.
3. K1 (flash attention) against its plain version on the card, at the
   shapes and tolerances of ``repro_torch.kernels.cases``: the JAX
   package's FLASH_CASES shapes in fp32 (TF32 off, tolerance 2e-5) and bf16
   (5e-2), ragged sequence lengths, and the main path's shape -- q
   [1, 32, S, 128], k/v [1, 8, S, 128], causal, bf16, at S = 1024 and 2048,
   contiguous and in the model's strided layout, at a tighter limit (1e-2
   elementwise, rms error under 2e-4 of the output's rms).  At the main
   path's shape it times the kernel, its plain version and
   ``scaled_dot_product_attention`` (a yardstick the port never calls)
   with CUDA events, and computes the least time the card could take.
4. full-width qwen3-4b (36 blocks, bf16, random weights from a seed): one
   block's attention sublayer with the kernel against the same sublayer
   with the plain attention (rms of the difference over rms of the plain
   output), then a ``ServingEngine`` with 4 stages under ODIN serves
   closed-loop queries of 1024 tokens with a 3x slowdown on one stage's
   device for queries 8-19.  It must rebalance, move blocks off the slowed
   stage, conserve blocks, and run every block's attention through the
   kernel.
5. the card line again, one ``{"kernels": [...]}`` line, and last
   ``{"ok": true, "device": {...}}``.

Bounds use the H100 SXM data-sheet peaks: 989 TFLOP/s dense bf16 on the
tensor cores and 3.35 TB/s of HBM3.
"""
from __future__ import annotations

import json
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
from repro_torch.kernels.cases import (  # noqa: E402
    FLASH_CASES,
    MAIN_CASES,
    MAIN_RMS_LIMIT,
    MAIN_TOLERANCE,
    RAGGED_CASES,
    tolerance,
)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import blocks as blk  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

PEAK_BF16_FLOPS = 989e12      # H100 SXM, dense bf16 tensor cores
PEAK_FP32_FLOPS = 67e12       # H100 SXM, fp32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12      # H100 SXM, HBM3

SEQ = 1024                    # tokens per served query (the main path)
NUM_QUERIES = 24
SLOW_EP, SLOW_FROM, SLOW_TO, SLOW_FACTOR = 1, 8, 20, 3.0
# A full-width attention sublayer (K1 then wo) with the kernel against the
# same sublayer with the plain attention: rms of the difference over rms of
# the plain sublayer's output: about 5x the 2.0e-4 measured on an NVIDIA
# H100 80GB HBM3 at 700 W.
SUBLAYER_RMS_LIMIT = 1e-3


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


def compare(out: torch.Tensor, ref: torch.Tensor, tol: dict, what: str,
            rms_limit: float = None) -> dict:
    """Raises unless |out - ref| <= atol + rtol |ref| everywhere and, where
    ``rms_limit`` is given, rms(out - ref) <= rms_limit * rms(ref).
    Returns the max and rms error and the rms of ``ref``."""
    torch.cuda.synchronize()
    diff = out.float() - ref.float()
    got = dict(max_abs_err=float(diff.abs().max()), rms_err=rms(diff),
               rms_ref=rms(ref))
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


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def attention_bound(B, Hq, Hkv, S, D, causal, elem_bytes) -> tuple:
    """(bound_ms, bound_by): the larger of the operations over the bf16
    peak and the bytes (q, k, v read once, o written once) over HBM."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 2 * 2 * B * Hq * pairs * D          # Q K^T and P V
    nbytes = (2 * Hq + 2 * Hkv) * B * S * D * elem_bytes
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernel_check() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case in FLASH_CASES + RAGGED_CASES:
        B, Hq, Hkv, S, D, causal, window, dtype = case
        q = randn(gen, (B, Hq, S, D), dtype)
        k = randn(gen, (B, Hkv, S, D), dtype)
        v = randn(gen, (B, Hkv, S, D), dtype)
        out = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  impl="cuda")
        ref = flash_attention_ref(q, k, v, causal=causal, window=window)
        got = compare(out, ref, tolerance(dtype), str(case))
        log(f"  K1 {case}: max |err| {got['max_abs_err']:.3e}")

    main = {}
    for case in MAIN_CASES:
        B, Hq, Hkv, S, D, _, _, dtype = case
        q = randn(gen, (B, Hq, S, D), dtype)
        k = randn(gen, (B, Hkv, S, D), dtype)
        v = randn(gen, (B, Hkv, S, D), dtype)
        got = compare(ops.flash_attention(q, k, v, impl="cuda"),
                      flash_attention_ref(q, k, v), MAIN_TOLERANCE,
                      f"main S={S}", MAIN_RMS_LIMIT)
        # The model's layout: [B, S, H, D] projections, read in place.
        x = randn(gen, (B, S, Hq + 2 * Hkv, D), dtype)
        qs = x[:, :, :Hq].transpose(1, 2)
        ks = x[:, :, Hq:Hq + Hkv].transpose(1, 2)
        vs = x[:, :, Hq + Hkv:].transpose(1, 2)
        out = ops.flash_attention(qs, ks, vs, impl="cuda")
        strided = compare(out, flash_attention_ref(qs, ks, vs),
                          MAIN_TOLERANCE, f"main S={S} strided",
                          MAIN_RMS_LIMIT)
        log(f"  K1 main S={S}: contiguous {got}, strided {strided} "
            f"(limits {MAIN_TOLERANCE}, rms {MAIN_RMS_LIMIT})")
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
            f"  bound_ms {bound_ms:.5f} ({bound_by}; {flops / 1e9:.2f} GFLOP,"
            f" {flops / kernel_ms / 1e9:.1f} TFLOP/s achieved; the same "
            f"products at the fp32 peak: {fp32_ms:.4f} ms)")
    return main


def phase_model(kernel_ms: float) -> dict:
    cfg = get_config("qwen3-4b")
    t0 = time.perf_counter()
    params = Model(cfg).init_params(seed=0, dtype=torch.bfloat16,
                                    device="cuda")
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.param_count() / 1e9:.2f} B parameters, "
        f"{cfg.num_blocks} blocks, d_model {cfg.d_model}, initialised in "
        f"{time.perf_counter() - t0:.1f} s; device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
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
        rel_rms = rms(diff) / rms(a_plain)
        rel_max = float(diff.abs().max() / a_plain.float().abs().max())
        block_ms = time_ms(lambda: blk.block_forward(bp, cfg, x, pos),
                           reps=10)
    if (not rel_rms <= SUBLAYER_RMS_LIMIT
            or not bool(torch.isfinite(a_kernel).all())):
        raise AssertionError(f"block 0's attention with the kernel: rms|d|"
                             f"/rms|ref| {rel_rms:.3e} (limit "
                             f"{SUBLAYER_RMS_LIMIT})")
    log(f"  block 0's attention sublayer, kernel vs plain attention: "
        f"rms|d|/rms|ref| {rel_rms:.3e} (limit {SUBLAYER_RMS_LIMIT}), "
        f"max|d|/max|ref| {rel_max:.3e}, rms|ref| {rms(a_plain):.3e}; "
        f"one block {block_ms:.3f} ms, of which attention {kernel_ms:.3f}"
        f" ms ({100 * kernel_ms / block_ms:.0f}%)")

    eng = ServingEngine(cfg, params, num_eps=4, scheduler="odin", alpha=3,
                        device="cuda")
    eng.executor.warmup(1, SEQ)
    queries = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, SEQ)),
                               device="cuda")
               for _ in range(NUM_QUERIES)]

    def schedule(q):
        slow = [1.0] * eng.num_eps
        if SLOW_FROM <= q < SLOW_TO:
            slow[SLOW_EP] = SLOW_FACTOR
        return slow

    start_config = eng.config
    flash_attention.launches = 0
    t0 = time.perf_counter()
    trace = eng.serve(queries, schedule)
    wall = time.perf_counter() - t0
    launches = flash_attention.launches

    summary = trace.summary()
    log(f"  served {NUM_QUERIES} queries of {SEQ} tokens in {wall:.2f} s: "
        f"{json.dumps(summary)}")
    log(f"  configs: {trace.configs}")
    log(f"  start {start_config}, final {trace.configs[-1]}, "
        f"rebalances {trace.num_rebalances}, trials {trace.total_trials}, "
        f"K1 launches {launches}")
    episode = trace.configs[SLOW_FROM:SLOW_TO]
    if trace.num_rebalances < 1:
        raise AssertionError("ODIN never rebalanced")
    if not min(c[SLOW_EP] for c in episode) < start_config[SLOW_EP]:
        raise AssertionError(f"no blocks moved off the slowed stage "
                             f"{SLOW_EP}: {episode}")
    if any(sum(c) != cfg.num_blocks for c in trace.configs):
        raise AssertionError(f"a config lost blocks: {trace.configs}")
    if launches != cfg.num_blocks * NUM_QUERIES:
        raise AssertionError(f"K1 launched {launches} times, expected "
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
    attn = cfg.num_blocks * kernel_ms
    d, hd = cfg.d_model, cfg.head_dim
    products = 2 * SEQ * (d * (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
                          + cfg.num_heads * hd * d + 3 * d * cfg.d_ff)
    log(f"  clean query on {start_config}: blocks {1e3 * (t1 - t0):.2f} ms "
        f"(stages {[round(1e3 * float(s), 2) for s in stages]}), head "
        f"{1e3 * (t2 - t1):.2f} ms; K1 {cfg.num_blocks} x {kernel_ms:.3f} "
        f"= {attn:.2f} ms ({100 * attn / (1e3 * (t2 - t0)):.0f}% of "
        f"blocks + head); a block's projection and MLP products are "
        f"{products / 1e9:.1f} GFLOP, {1e3 * products / PEAK_BF16_FLOPS:.3f}"
        f" ms at the bf16 peak")
    return dict(launches=launches, summary=summary)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    log("phase 2: build")
    t0 = time.perf_counter()
    nvcc_log = build.build_kernel("flash_attention")
    log(f"  flash_attention: {build.lib_path('flash_attention').name}, "
        f"build {time.perf_counter() - t0:.1f} s"
        + ("" if nvcc_log is None else f"\n{nvcc_log}"))

    log("phase 3: K1 against its plain version")
    main_k1 = phase_kernel_check()

    log("phase 4: full-width qwen3-4b under ODIN")
    served = phase_model(main_k1[SEQ]["ms"])

    k1 = main_k1[SEQ]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:96",
        "launches": served["launches"],
        "max_abs_err": max(m["max_abs_err"] for m in main_k1.values()),
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
    }]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
