"""Compile variants of K2 (decode attention), K3 (SSD scan) or K3's
backward and compare them on one card.

    python3 tools/k23_variants.py KERNEL [--case SPEC ...] NAME:SOURCE[:FLAG...] [...]

KERNEL is ``decode_attention``, ``ssd_scan`` or ``ssd_scan_bwd``.  Each
variant is a CUDA source with the C interface of
``src/repro_torch/kernels/csrc/KERNEL.cu`` (a path relative to the
repository's root), compiled by ``nvcc`` with the
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
  test's dt and a slowly decaying one, three draws each: y's max error over
  max |ref| (at ``ssd_limit`` of the case's dtype), its rms error and the
  least atol at SSD_MAIN_TOLERANCE's rtol, and the state's rms error.
  ``--case SPEC`` (repeatable) takes other main shapes in its place: SPEC
  names an entry of ``repro_torch.kernels.cases``, ``NAME``, ``NAME[i]``
  for an entry of a list, and ``:DTYPE`` after either sets the dtype, e.g.
  ``--case SSD_BACKWARD_TRAIN_CASE --case SSD_MAIN_CASE:float32
  --case SSD_FAMILY_MAIN_CASES[0]:float32``.  ``cuobjdump -sass`` counts
  of each variant's tensor-core (``HMMA``) and ``FFMA`` instructions are
  printed by kernel;
* ssd_scan_bwd: every SSD_BACKWARD_CASES case with the JAX test's dt and a
  slowly decaying one, x, B and C in the model's strided layout, random dy
  and dstate: each gradient against the plain backward at
  ``ssd_backward_check``'s limits, two calls bit-equal and finite; then
  SSD_BACKWARD_TIMED in both dtypes (no dstate, as a train step has none).
  The blocks an SM of the launches a variant reports
  (``odin_ssd_scan_bwd_blocks_per_sm``, where it has one) are printed.
  The parent's source is a variant like any other (``git show
  HEAD:src/repro_torch/kernels/csrc/ssd_scan_bwd.cu > build/parent.cu``):
  the C interface is the same, and the wrapper's scratch is at least what
  it needs.

At the main (or timed) shape each variant's kernels are also timed one by
one with ``torch.profiler`` (device time per call, the L2 warm).

All variants run in one process on one card, so their times compare.
Without a CUDA card it exits nonzero.
"""
from __future__ import annotations

import ctypes
import re
import sys

import numpy as np
import torch

# variant_tools puts the repository's src/ on sys.path.
from variant_tools import (build_variants, card, kernel_times,
                           ptxas_summary, sass_summary, time_ms)
from repro_torch.kernels import build, cases, ops
from repro_torch.kernels import decode_attention as k2
from repro_torch.kernels import ssd_scan as k3
from repro_torch.kernels.cases import (
    DECODE_CASES,
    DECODE_CORNER_CASES,
    DECODE_MAIN_CASE,
    DECODE_MAIN_RMS_LIMIT,
    DECODE_MAIN_TOLERANCE,
    DECODE_RAGGED_CASES,
    SSD_BACKWARD_CASES,
    SSD_BACKWARD_TIMED,
    SSD_CASES,
    SSD_CORNER_CASES,
    SSD_MAIN_CASE,
    SSD_MAIN_RMS_LIMIT,
    SSD_MAIN_TOLERANCE,
    SSD_RAGGED_CASES,
    SSD_STATE_RMS_LIMIT,
    max_ratio,
    ssd_backward_check,
    ssd_limit,
    tolerance,
)
from repro_torch.kernels.ref import (
    decode_attention_ref,
    ssd_scan_bwd_ref,
    ssd_scan_ref,
)


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


def ssd_case(spec: str) -> tuple:
    """The 7-tuple an ``--case`` SPEC names: ``NAME``, ``NAME[i]``, either
    with ``:DTYPE``."""
    name, _, dtype = spec.partition(":")
    m = re.fullmatch(r"(\w+)(?:\[(\d+)\])?", name)
    if m is None or not hasattr(cases, m.group(1)):
        raise SystemExit(f"--case {spec}: no such entry of kernels/cases.py")
    case = getattr(cases, m.group(1))
    if m.group(2) is not None:
        case = case[int(m.group(2))]
    return tuple(case[:6]) + (dtype or case[6],)


def check_ssd(libs: dict, use, gen, mains: list) -> bool:
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
    rtol = SSD_MAIN_TOLERANCE["rtol"]
    for main in mains:
        chunk, limit = main[5], ssd_limit(main[6])
        for slow in (False, True):
            for draw in range(3):
                ins = ssd_inputs(gen, main, slow, True)
                y_ref, s_ref = ssd_scan_ref(*ins)
                readings = []
                for name in libs:
                    use(name)
                    y, state = ops.ssd_scan(*ins, chunk=chunk, impl="cuda")
                    d, ref = y.float() - y_ref.float(), y_ref.float()
                    atol = float((d.abs() - rtol * ref.abs()).max())
                    ratio = max_ratio(y, y_ref)
                    y_rms, s_rms = rms(d) / rms(ref), rms(
                        state - s_ref) / rms(s_ref)
                    good = (ratio < limit
                            and atol <= SSD_MAIN_TOLERANCE["atol"]
                            and y_rms <= SSD_MAIN_RMS_LIMIT
                            and s_rms <= SSD_STATE_RMS_LIMIT)
                    ok &= good
                    readings.append(
                        f"{name} {'ok' if good else 'BAD'} max_ratio "
                        f"{ratio:.2e} atol {atol:.2e} y rms {y_rms:.2e} "
                        f"state rms {s_rms:.2e}")
                print(f"{main}, {'slow' if slow else 'JAX'} dt, draw {draw}: "
                      + "; ".join(readings), flush=True)
        ins = ssd_inputs(gen, main, False, True)
        times = in_turns(libs, use, lambda: ops.ssd_scan(*ins, chunk=chunk,
                                                         impl="cuda"))
        print(f"{main}: " + "  ".join(f"{n} {t[0]:.4f}/{t[1]:.4f} ms"
                                      for n, t in times.items()), flush=True)
        for name in libs:
            use(name)
            print(f"{main}, {name}, by kernel: " + kernel_times(
                lambda: ops.ssd_scan(*ins, chunk=chunk, impl="cuda")),
                flush=True)
    return ok


GRADS = ("dx", "ddt", "dA", "dB", "dC")


def bind_backward(lib: ctypes.CDLL) -> None:
    """The C entry's types, set here so that the wrapper (which sets them
    where they are unset, with the queries of the current source) takes a
    variant's library as it is."""
    fn = lib.odin_ssd_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.odin_cuda_error_string.argtypes = [ctypes.c_int]
    lib.odin_cuda_error_string.restype = ctypes.c_char_p


def check_ssd_bwd(libs: dict, use, gen) -> bool:
    ok = True
    for name, lib in libs.items():
        query = getattr(lib, "odin_ssd_scan_bwd_blocks_per_sm", None)
        if query is not None:
            query.argtypes, query.restype = [ctypes.c_int] * 2, ctypes.c_int
            print(f"{name}: blocks an SM, launch 1 / tile launch: fp32 "
                  f"{query(0, 0)} / {query(2, 0)}, bf16 {query(0, 1)} / "
                  f"{query(2, 1)}", flush=True)
    for case in SSD_BACKWARD_CASES:
        b, S, H, P, N, chunk, dtype = case
        for slow in (False, True):
            ins = ssd_inputs(gen, case, slow, True)
            dy = torch.randn((b, S, H, P), generator=gen,
                             device="cuda").to(ins[0].dtype)
            dstate = torch.randn((b, H, P, N), generator=gen, device="cuda")
            _, _, cs, states = k3.forward_for_backward(*ins, chunk=chunk)
            want = ssd_scan_bwd_ref(*ins, dy, dstate)
            marks = []
            for name in libs:
                use(name)
                got = k3.backward(*ins, cs, states, dy, dstate, chunk=chunk)
                again = k3.backward(*ins, cs, states, dy, dstate,
                                    chunk=chunk)
                readings = [ssd_backward_check(g, w, dtype)
                            for g, w in zip(got, want)]
                same = all(torch.equal(g, g2) for g, g2 in zip(got, again))
                finite = all(bool(torch.isfinite(g.float()).all())
                             for g in got)
                good = all(r[2] for r in readings) and same and finite
                ok &= good
                marks.append(
                    f"{name} {'ok' if good else 'BAD'} max_ratio "
                    f"{max(r[0] for r in readings):.2e} rms "
                    f"{max(r[1] for r in readings):.2e}" + ("" if good else (
                        " (" + ", ".join(f"{n} {r[0]:.2e}/{r[1]:.2e}"
                                         for n, r in zip(GRADS, readings))
                        + f"; bit-equal {same}, finite {finite})")))
            print(f"{case} {'slow' if slow else 'JAX'} dt: "
                  + "; ".join(marks), flush=True)
    for shape in SSD_BACKWARD_TIMED:
        for dtype in ("float32", "bfloat16"):
            case = tuple(shape) + (dtype,)
            ins = ssd_inputs(gen, case, False, True)
            dy = torch.randn(ins[0].shape, generator=gen,
                             device="cuda").to(ins[0].dtype)
            _, _, cs, states = k3.forward_for_backward(*ins, chunk=shape[5])

            def run():
                return k3.backward(*ins, cs, states, dy, None,
                                   chunk=shape[5])

            times = in_turns(libs, use, run)
            print(f"{case}: " + "  ".join(f"{n} {t[0]:.4f}/{t[1]:.4f} ms"
                                          for n, t in times.items()),
                  flush=True)
            for name in libs:
                use(name)
                print(f"{case}, {name}, by kernel: " + kernel_times(run),
                      flush=True)
    return ok


KERNELS = ("decode_attention", "ssd_scan", "ssd_scan_bwd")


def main() -> int:
    args, mains = sys.argv[1:], []
    while len(args) > 2 and args[1] == "--case":
        mains.append(ssd_case(args[2]))
        del args[1:3]
    if (not torch.cuda.is_available() or len(args) < 2
            or args[0] not in KERNELS
            or (mains and args[0] != "ssd_scan")):
        print(__doc__)
        return 2
    kernel = args[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    libs = {}
    for name, (path, log) in build_variants(args[1:]).items():
        print(f"{name}: ptxas", flush=True)
        for line in ptxas_summary(log):
            print(f"  {line}", flush=True)
        print(f"{name}: SASS", flush=True)
        for line in sass_summary(path, ("HMMA.1688.F32.TF32", "HMMA.16816",
                                        "FFMA")):
            print(f"  {line}", flush=True)
        libs[name] = ctypes.CDLL(str(path))
        if kernel == "ssd_scan_bwd":
            bind_backward(libs[name])

    def use(name: str) -> None:
        # The wrappers load their library through build.load, which returns
        # what build._LIBS holds for the name.
        build._LIBS[kernel] = libs[name]

    gen = torch.Generator(device="cuda").manual_seed(0)
    if kernel == "decode_attention":
        ok = check_decode(libs, use, gen)
    elif kernel == "ssd_scan":
        ok = check_ssd(libs, use, gen, mains or [SSD_MAIN_CASE])
    else:
        ok = check_ssd_bwd(libs, use, gen)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
