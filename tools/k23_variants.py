"""Compile variants of K2 (decode attention) or K3 (SSD scan) and compare
them on one card.

    python3 tools/k23_variants.py KERNEL NAME:SOURCE[:FLAG...] [...]

KERNEL is ``decode_attention`` or ``ssd_scan``.  Each variant is a CUDA
source with the C interface of ``src/repro_torch/kernels/csrc/KERNEL.cu``
(a path relative to the repository's root), compiled by ``nvcc`` with the
port's flags plus its FLAGs (``NAME=VALUE`` becomes ``-DNAME=VALUE``) into
``build/variants/``; ``ptxas``' registers and spills are printed.  Then
every variant runs the kernel's cases of ``repro_torch.kernels.cases`` at
their limits, and the main shape is checked and timed with CUDA events,
the variants in turns (each twice, in order and then reversed):

* decode_attention: DECODE_MAIN_CASE read strided from a [B, S, Hkv, D]
  cache, four draws held at its limits, timed with the L2 flushed before
  each launch, beside ``scaled_dot_product_attention``.  The cluster size
  is a FLAG: ``c8:src/repro_torch/kernels/csrc/decode_attention.cu:
  ODIN_DECODE_CLUSTER=8`` (no spaces) builds clusters of 8;
* ssd_scan: SSD_MAIN_CASE in the model's strided layout, with the JAX
  test's dt and a slowly decaying one, three draws each: y's rms error and
  the least atol at SSD_MAIN_TOLERANCE's rtol, and the state's rms error.

At the main shape each variant's kernels are also timed one by one with
``torch.profiler`` (device time per call, the L2 warm).

All variants run in one process on one card, so their times compare.
Without a CUDA card it exits nonzero.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import decode_attention as k2  # noqa: E402
from repro_torch.kernels.cases import (  # noqa: E402
    DECODE_CASES,
    DECODE_CORNER_CASES,
    DECODE_MAIN_CASE,
    DECODE_MAIN_RMS_LIMIT,
    DECODE_MAIN_TOLERANCE,
    DECODE_RAGGED_CASES,
    SSD_CASES,
    SSD_CORNER_CASES,
    SSD_MAIN_CASE,
    SSD_MAIN_RMS_LIMIT,
    SSD_MAIN_TOLERANCE,
    SSD_RAGGED_CASES,
    SSD_STATE_RMS_LIMIT,
    max_ratio,
    ssd_limit,
    tolerance,
)
from repro_torch.kernels.ref import (  # noqa: E402
    decode_attention_ref,
    ssd_scan_ref,
)

sys.path.insert(0, str(ROOT / "tools"))
from k1_variants import OUT, compile_variant, time_ms  # noqa: E402


def kernel_times(fn, reps: int = 20) -> str:
    """Device time per call of each CUDA kernel that ``fn`` launches, from
    ``torch.profiler`` (averaged over ``reps`` calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t > 0 and ev.count >= reps:
            rows.append(f"{ev.key[:60]} {t / reps / 1e3:.4f} ms")
    return "; ".join(rows) or "no device time recorded"


def rms(t) -> float:
    return float(t.float().square().mean().sqrt())


def in_turns(libs: dict, use, fn, **kw) -> dict:
    times = {name: [] for name in libs}
    for name in list(libs) + list(reversed(list(libs))):
        use(name)
        times[name].append(time_ms(fn, **kw))
    return times


def check_decode(libs: dict, use, gen) -> bool:
    ok = True
    for case in DECODE_CASES + DECODE_RAGGED_CASES + DECODE_CORNER_CASES:
        B, Hq, Hkv, S, D, idx, window, dtype = case
        t = getattr(torch, dtype)
        q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(t)
        k = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").to(t)
        v = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").to(t)
        ref = decode_attention_ref(q, k, v, idx, window=window).float()
        tol, marks = tolerance(dtype), []
        for name in libs:
            use(name)
            out = ops.decode_attention(q, k, v, idx, window=window,
                                       impl="cuda").float()
            good = bool(((out - ref).abs() <= tol["atol"]
                         + tol["rtol"] * ref.abs()).all())
            ok &= good
            marks.append(f"{name} {'ok' if good else 'BAD'}")
        print(f"{case}: {', '.join(marks)}", flush=True)
    B, Hq, Hkv, S, D, idx, window, dtype = DECODE_MAIN_CASE
    index = torch.tensor(idx, dtype=torch.int32, device="cuda")
    for draw in range(4):
        q = torch.randn((B, Hq, D), generator=gen, device="cuda").bfloat16()
        cache_k = torch.randn((B, S, Hkv, D), generator=gen,
                              device="cuda").bfloat16()
        cache_v = torch.randn((B, S, Hkv, D), generator=gen,
                              device="cuda").bfloat16()
        k, v = cache_k.transpose(1, 2), cache_v.transpose(1, 2)
        ref = decode_attention_ref(q, k, v, idx).float()
        readings = []
        for name in libs:
            use(name)
            out = k2.decode_attention(q, k, v, index).float()
            d, tol = out - ref, DECODE_MAIN_TOLERANCE
            good = (bool((d.abs() <= tol["atol"] + tol["rtol"]
                          * ref.abs()).all())
                    and rms(d) <= DECODE_MAIN_RMS_LIMIT * rms(ref))
            ok &= good
            readings.append(f"{name} {'ok' if good else 'BAD'}, rms "
                            f"{rms(d) / rms(ref):.2e}")
        print(f"main, draw {draw}: " + "; ".join(readings), flush=True)
    scratch = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    times = in_turns(libs, use, lambda: k2.decode_attention(q, k, v, index),
                     flush=scratch.zero_)
    print("main: " + "  ".join(f"{n} {t[0]:.4f}/{t[1]:.4f} ms"
                               for n, t in times.items()), flush=True)
    for name in libs:
        use(name)
        print(f"main, {name}, by kernel (L2 warm): " + kernel_times(
            lambda: k2.decode_attention(q, k, v, index)), flush=True)
    mask = (torch.arange(S, device="cuda") <= index)[None, None, None, :]
    sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True),
        flush=scratch.zero_)
    print(f"main: scaled_dot_product_attention {sdpa:.4f} ms", flush=True)
    return ok


def ssd_inputs(gen, case, slow: bool, strided: bool) -> list:
    b, S, H, P, N, _, dtype = case
    t = getattr(torch, dtype)
    if strided:
        xbc = torch.randn((b, S, H * P + 2 * N), generator=gen,
                          device="cuda").to(t)
        x = xbc[..., :H * P].reshape(b, S, H, P)
        B, C = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    else:
        x = torch.randn((b, S, H, P), generator=gen, device="cuda").to(t)
        B = torch.randn((b, S, N), generator=gen, device="cuda").to(t)
        C = torch.randn((b, S, N), generator=gen, device="cuda").to(t)
    if slow:
        dt = torch.exp(torch.empty((b, S, H), device="cuda").uniform_(
            float(np.log(1e-3)), float(np.log(1e-1)), generator=gen))
    else:
        dt = torch.nn.functional.softplus(
            torch.randn((b, S, H), generator=gen, device="cuda"))
    A = -torch.exp(torch.randn((H,), generator=gen, device="cuda") * 0.5)
    return [x, dt.to(t), A.to(t), B, C]


def check_ssd(libs: dict, use, gen) -> bool:
    ok = True
    for case in SSD_CASES + SSD_RAGGED_CASES + SSD_CORNER_CASES:
        ins = ssd_inputs(gen, case, False, False)
        y_ref, s_ref = ssd_scan_ref(*ins)
        marks = []
        for name in libs:
            use(name)
            y, state = ops.ssd_scan(*ins, chunk=case[5], impl="cuda")
            good = (max_ratio(y, y_ref) < ssd_limit(case[-1])
                    and max_ratio(state, s_ref) < ssd_limit("float32"))
            ok &= good
            marks.append(f"{name} {'ok' if good else 'BAD'}")
        print(f"{case}: {', '.join(marks)}", flush=True)
    chunk, rtol = SSD_MAIN_CASE[5], SSD_MAIN_TOLERANCE["rtol"]
    for slow in (False, True):
        for draw in range(3):
            ins = ssd_inputs(gen, SSD_MAIN_CASE, slow, True)
            y_ref, s_ref = ssd_scan_ref(*ins)
            readings = []
            for name in libs:
                use(name)
                y, state = ops.ssd_scan(*ins, chunk=chunk, impl="cuda")
                d, ref = y.float() - y_ref.float(), y_ref.float()
                atol = float((d.abs() - rtol * ref.abs()).max())
                y_rms, s_rms = rms(d) / rms(ref), rms(state - s_ref) / rms(
                    s_ref)
                good = (atol <= SSD_MAIN_TOLERANCE["atol"]
                        and y_rms <= SSD_MAIN_RMS_LIMIT
                        and s_rms <= SSD_STATE_RMS_LIMIT)
                ok &= good
                readings.append(f"{name} {'ok' if good else 'BAD'} atol "
                                f"{atol:.2e} y rms {y_rms:.2e} state rms "
                                f"{s_rms:.2e}")
            print(f"main, {'slow' if slow else 'JAX'} dt, draw {draw}: "
                  + "; ".join(readings), flush=True)
    ins = ssd_inputs(gen, SSD_MAIN_CASE, False, True)
    times = in_turns(libs, use, lambda: ops.ssd_scan(*ins, chunk=chunk,
                                                     impl="cuda"))
    print("main: " + "  ".join(f"{n} {t[0]:.4f}/{t[1]:.4f} ms"
                               for n, t in times.items()), flush=True)
    for name in libs:
        use(name)
        print(f"main, {name}, by kernel: " + kernel_times(
            lambda: ops.ssd_scan(*ins, chunk=chunk, impl="cuda")), flush=True)
    return ok


def main() -> int:
    if (not torch.cuda.is_available() or len(sys.argv) < 3
            or sys.argv[1] not in ("decode_attention", "ssd_scan")):
        print(__doc__)
        return 2
    kernel = sys.argv[1]
    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    specs = {}
    for arg in sys.argv[2:]:
        name, source, *flags = arg.split(":")
        specs[name] = (ROOT / source, flags)
    with ThreadPoolExecutor(max_workers=len(specs)) as pool:
        built = {name: pool.submit(compile_variant, name, *spec)
                 for name, spec in specs.items()}
        built = {name: f.result() for name, f in built.items()}
    libs = {}
    for name, (path, log) in built.items():
        ptxas = re.findall(r"(\d+ bytes spill stores, \d+ bytes spill loads"
                           r"|Used \d+ registers)", log)
        print(f"{name}: ptxas {ptxas}", flush=True)
        libs[name] = ctypes.CDLL(str(path))

    def use(name: str) -> None:
        # The wrappers load their library through build.load, which returns
        # what build._LIBS holds for the name.
        build._LIBS[kernel] = libs[name]

    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = (check_decode if kernel == "decode_attention" else check_ssd)(
        libs, use, gen)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
