"""The shapes and tolerances at which each kernel is held against its
plain version, in the tests and on the card.

K1 (flash attention): a case is ``(B, Hq, Hkv, S, D, causal, window,
dtype)``; bf16 cases run on its bf16 kernel, fp32 ones on its fp32
kernel (3xTF32), BACKWARD_CASES on its fp32 backward kernel and
BACKWARD_BF16_CASES on its bf16 backward kernel.  K2
(decode attention): ``(B, Hq, Hkv, S, D, index, window, dtype)``.  K3
(SSD scan): ``(b, S, H, P, N, chunk, dtype)``; SSD_BACKWARD_CASES run on
its backward kernel.  Dtypes are named as torch dtypes.
"""
from __future__ import annotations

import numpy as np

# The JAX package's FLASH_CASES (tests/test_kernels.py).
FLASH_CASES = [
    (2, 4, 2, 256, 64, True, None, "float32"),
    (1, 8, 8, 128, 128, True, None, "float32"),    # MHA
    (2, 4, 1, 256, 64, False, None, "float32"),    # encoder + MQA
    (1, 4, 2, 512, 64, True, 128, "float32"),      # sliding window
    (1, 4, 2, 256, 80, True, None, "float32"),     # hubert head dim
    (1, 2, 2, 128, 56, True, None, "float32"),     # qwen2 head dim
    (2, 4, 2, 256, 64, True, None, "bfloat16"),
    (1, 4, 2, 512, 128, True, 256, "bfloat16"),
]
# S not a multiple of 64 (the Pallas kernel would refuse these).
RAGGED_CASES = [
    (1, 4, 2, 77, 64, True, None, "float32"),
    (2, 4, 1, 200, 56, True, 48, "float32"),
    (2, 4, 2, 1000, 128, True, 100, "bfloat16"),
    (1, 4, 2, 130, 128, False, None, "bfloat16"),
]
# bf16 shapes that reach the corners of the tensor-core kernel
# (csrc/flash_attention_bf16.cu: 128-row query blocks, 128-key tiles,
# 64-column head-dim panels).
TENSOR_CORE_CASES = [
    (1, 4, 2, 200, 56, True, None, "bfloat16"),    # D 56: padded to 64
    (2, 4, 2, 256, 80, True, None, "bfloat16"),    # D 80: padded to 128
    (1, 4, 2, 1, 128, True, None, "bfloat16"),     # S 1
    (2, 4, 1, 17, 64, True, None, "bfloat16"),     # S 17, below one tile
    (1, 14, 2, 384, 64, True, None, "bfloat16"),   # group 7 (qwen2 ratios)
    (1, 4, 2, 300, 128, True, 16, "bfloat16"),     # window below one tile
    (2, 4, 2, 333, 64, False, None, "bfloat16"),   # bidirectional, ragged
]
# The main path: qwen3-4b's attention, q [1, 32, S, 128], k/v [1, 8, S, 128].
MAIN_SEQS = (1024, 2048)
MAIN_CASES = [(1, 32, 8, s, 128, True, None, "bfloat16") for s in MAIN_SEQS]
# The batched path: a formed dispatch of 8 rows at the bucket edges of
# chip_smoke.py's bimodal traffic (256 and 1024 tokens), held at the main
# limits below.
BATCHED_MAIN_CASES = [(8, 32, 8, s, 128, True, None, "bfloat16")
                      for s in (1024, 256)]
# The paths of the MoE and embedding-input families at their published
# widths, held at the main limits below: group 1 (MHA) on the tensor-core
# route, D 80 bidirectional, group 7 over a length that is not a multiple of
# 128, and a window that bites (it is below S).  The last is the small-model
# pool of a mixed fleet: qwen2-0.5b at full width, group 7 at D 64.
FAMILY_MAIN_CASES = [
    (1, 16, 16, 1024, 128, True, None, "bfloat16"),   # deepseek-moe-16b
    (8, 16, 16, 1024, 128, True, None, "bfloat16"),   # deepseek, 8 rows
    (8, 16, 16, 256, 128, True, None, "bfloat16"),
    (1, 16, 16, 1024, 80, False, None, "bfloat16"),   # hubert-xlarge
    # llava-next-34b: 2880 patch positions plus 64 text tokens.
    (1, 56, 8, 2944, 128, True, None, "bfloat16"),
    (1, 48, 8, 4608, 128, True, 4096, "bfloat16"),    # mixtral-8x22b
    (1, 64, 8, 1024, 128, True, None, "bfloat16"),    # jamba-1.5-large
    (1, 14, 2, 1024, 64, True, None, "bfloat16"),     # qwen2-0.5b
]

# Elementwise |got - want| <= atol + rtol |want|.  The JAX package's limits
# hold for FLASH_CASES and RAGGED_CASES: bf16 keeps ~3 significant digits.
# At the main path's S a causal row averages many keys, so outputs are
# small (for N(0, 1) inputs a row that sees n keys has an output std of
# about sqrt(e / n)) and 5e-2 would be of their size.  There the limit is
# 1e-2 elementwise (above one bf16 ulp of the largest outputs), and the
# root-mean-square error must stay below MAIN_RMS_LIMIT times the output's
# own rms: about 6x the 3.5e-5 that K1 measured at S = 1024 and 2048 on an
# NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py prints both readings).
MAIN_TOLERANCE = dict(atol=1e-2, rtol=1e-2)
MAIN_RMS_LIMIT = 2e-4


# K1's backward (csrc/flash_attention_bwd.cu, fp32 only): every fp32 shape
# of FLASH_CASES and RAGGED_CASES, qwen2-0.5b's training shape (the
# training CLI's batch 8 of 256 tokens, group 7 at D 64), hubert-xlarge's
# heads bidirectional over a length that is not a multiple of the tiles, a
# window below one key tile at D 128, and qwen2-0.5b's heads over 1024
# tokens.
BACKWARD_TRAIN_CASE = (8, 14, 2, 256, 64, True, None, "float32")
BACKWARD_LONG_CASE = (1, 14, 2, 1024, 64, True, None, "float32")
BACKWARD_CASES = [c for c in FLASH_CASES + RAGGED_CASES
                  if c[7] == "float32"] + [
    BACKWARD_TRAIN_CASE,
    (1, 16, 16, 512, 80, False, None, "float32"),
    (1, 4, 2, 300, 128, True, 16, "float32"),
    BACKWARD_LONG_CASE,
]
# Each of dq, dk and dv against the plain backward (autograd through
# flash_attention_ref): max |got - want| / max |want| (``max_ratio``) at
# most BACKWARD_LIMIT, K3's fp32 limit.  Both sides sum in fp32 in
# different orders; set before the kernel's first run on the card.
BACKWARD_LIMIT = 1e-4

# K1's bf16 backward (csrc/flash_attention_bwd_bf16.cu): every bf16 shape
# of FLASH_CASES, RAGGED_CASES and TENSOR_CORE_CASES, qwen2-0.5b's training
# shape and its heads over 1024 tokens, qwen3-4b's heads (group 4, D 128)
# and deepseek-moe-16b's (group 1, D 128) over 1024 tokens.
BACKWARD_BF16_TRAIN_CASE = (8, 14, 2, 256, 64, True, None, "bfloat16")
BACKWARD_BF16_LONG_CASE = (1, 14, 2, 1024, 64, True, None, "bfloat16")
BACKWARD_BF16_WIDE_CASE = (1, 32, 8, 1024, 128, True, None, "bfloat16")
BACKWARD_BF16_CASES = [c for c in FLASH_CASES + RAGGED_CASES
                       + TENSOR_CORE_CASES if c[7] == "bfloat16"] + [
    BACKWARD_BF16_TRAIN_CASE,
    BACKWARD_BF16_LONG_CASE,
    BACKWARD_BF16_WIDE_CASE,
    (1, 16, 16, 1024, 128, True, None, "bfloat16"),
]
# Each of dq, dk and dv against the plain backward on the same bf16 inputs
# (the fp32 gradient rounded to bf16 once): max_ratio at most
# BACKWARD_BF16_LIMIT, and rms(got - want) at most BACKWARD_BF16_RMS_LIMIT
# of rms(want), since both sides round to bf16 and mostly agree bit for
# bit.  Set before the kernel's first run on the card at about 5x the worst
# reading of a CPU model of its rounding against jax.grad of the JAX
# model's flash_attention_jnp (tests/test_torch_kernels.py): bf16 operands,
# fp32 sums per k16 step, P (in dV) and dS (in dK and dQ) split into bf16
# hi and lo, delta from the forward's fp32 O: rms 7.0e-5 to 1.40e-4,
# max_ratio 4.5e-4 to 2.70e-3.  Rounding P or dS to bf16 alone, or taking
# delta from the bf16 O, reads 1.1e-3 to 2.7e-3 rms: each breaks the rms
# limit, and each breaks MAIN_RMS_LIMIT, the bf16 forward's standard, which
# decided the design.
BACKWARD_BF16_LIMIT = 1.4e-2
BACKWARD_BF16_RMS_LIMIT = 7e-4
# A gradient that is exactly 0 in the plain version (dq and dk at S 1: the
# one key takes all the weight, and the softmax's gradient vanishes) has no
# scale of its own: max |got| at most BACKWARD_BF16_ZERO_ATOL, about 5x the
# 6.3e-7 that the CPU model reads over five N(0, 1) draws (fp32 rounding of
# dP - delta, two sums of the same products in different orders).  Added
# after the kernel's first run on the card stopped at that case, before its
# reading there was seen.
BACKWARD_BF16_ZERO_ATOL = 3e-6


# K2: the JAX package's DECODE_CASES (tests/test_kernels.py).
DECODE_CASES = [
    (2, 8, 2, 512, 64, 300, None, "float32"),
    (1, 4, 4, 256, 128, 17, None, "float32"),
    (2, 8, 2, 512, 64, 400, 128, "float32"),      # sliding window
    (1, 14, 2, 256, 64, 255, None, "float32"),    # qwen2 ratios (group 7)
    (2, 8, 2, 512, 64, 300, None, "bfloat16"),
]
# S not a multiple of the kernel's tile, odd groups, qwen2's head dim.
DECODE_RAGGED_CASES = [
    (1, 6, 2, 200, 64, 150, None, "float32"),
    (2, 12, 4, 333, 128, 332, 100, "bfloat16"),
    (1, 14, 2, 300, 56, 123, None, "bfloat16"),
]
# The corners of the kernel's split of the live slots among the blocks of
# a cluster: one live slot (index 0), every slot live (index S - 1), fewer
# live slots than blocks (index inside the first split), a window narrower
# than one block's share of the cache, and group 7 at D 64.
DECODE_CORNER_CASES = [
    (1, 8, 2, 256, 64, 0, None, "bfloat16"),
    (2, 8, 2, 256, 128, 255, None, "bfloat16"),
    (1, 32, 8, 2048, 128, 5, None, "bfloat16"),
    (1, 32, 8, 2048, 128, 1500, 40, "bfloat16"),
    (1, 14, 2, 512, 64, 300, None, "bfloat16"),
    (1, 4, 2, 100, 64, 0, None, "float32"),
]
# The main path: qwen3-4b's decode, q [1, 32, 128] against a 2048-slot
# cache holding a 1024-token prompt and 16 decoded tokens.
DECODE_MAIN_CASE = (1, 32, 8, 2048, 128, 1040, None, "bfloat16")
# The decode of the MoE and embedding-input families at their published
# widths, held at the main limits below: deepseek-moe-16b (MHA) after a
# 1024-token prompt, llava-next-34b after 2880 patch positions and 64
# tokens, and mixtral-8x22b past its 4096-slot window.
DECODE_FAMILY_MAIN_CASES = [
    (1, 16, 16, 2048, 128, 1040, None, "bfloat16"),
    (1, 56, 8, 4096, 128, 2960, None, "bfloat16"),
    (1, 48, 8, 8192, 128, 4620, 4096, "bfloat16"),
]
# There a row averages 1041 live slots, so the output's rms is about 0.054
# for N(0, 1) inputs and the bf16 limit of 5e-2 would be of its size.  At
# the main shape: 1e-4 elementwise (0.2% of rms(ref)) plus 1e-2 of |ref|
# (one bf16 ulp is at most 2^-7 of a value), and an rms error under
# DECODE_MAIN_RMS_LIMIT of rms(ref): about 5x the 4.4e-6 that K2 measured
# on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py prints the readings).
DECODE_MAIN_TOLERANCE = dict(atol=1e-4, rtol=1e-2)
DECODE_MAIN_RMS_LIMIT = 2e-5

# K3: the JAX package's SSD_CASES (tests/test_kernels.py).
SSD_CASES = [
    (2, 256, 8, 64, 32, 64, "float32"),
    (1, 128, 4, 32, 64, 32, "float32"),
    (1, 256, 16, 64, 128, 64, "float32"),         # mamba2-370m dims
    (2, 128, 8, 64, 32, 32, "bfloat16"),
]
# S not a multiple of the chunk (the Pallas kernel would refuse these).
SSD_RAGGED_CASES = [
    (1, 200, 4, 64, 128, 64, "float32"),
    (2, 77, 3, 32, 32, 32, "bfloat16"),
]
# The corners of the chunk-parallel kernel's tiles (64-row tiles of a
# chunk): S below one tile, a one-token last chunk (S 1025, chunk 256),
# a chunk that is not a multiple of the tile, N 64 with P 32, and more
# chunks than heads.
SSD_CORNER_CASES = [
    (1, 17, 4, 64, 128, 256, "bfloat16"),
    (1, 1025, 32, 64, 128, 256, "bfloat16"),
    (1, 300, 4, 64, 128, 96, "bfloat16"),
    (1, 256, 4, 32, 64, 64, "bfloat16"),
    (2, 512, 2, 64, 32, 32, "bfloat16"),
    (1, 200, 3, 32, 64, 96, "float32"),
]
# The main path: one mamba2-370m block at S = 1024 (H 32, P 64, N 128,
# the model's chunk of 256).
SSD_MAIN_CASE = (1, 1024, 32, 64, 128, 256, "bfloat16")
# The batched path: a formed dispatch of 8 rows of 1024 tokens, held at the
# main limits below.
SSD_BATCHED_MAIN_CASE = (8, 1024, 32, 64, 128, 256, "bfloat16")
# There y's max |ref| is about 300 against an rms of about 14, so the JAX
# bf16 limit (5e-2 of max |ref|) would pass an error of the rms's size: a
# state carried across chunks scaled by 0.99 passes it.  At the main shape
# y is also held elementwise, 5e-4 plus 1e-2 of |ref| (a bf16 ulp), and by
# rms, under SSD_MAIN_RMS_LIMIT of rms(ref).  The final state is fp32 in
# both versions: it is held at the fp32 limit of ssd_limit and by rms, under
# SSD_STATE_RMS_LIMIT of rms(ref).  Each limit is about 5-10x the largest
# reading of K3 on an NVIDIA H100 80GB HBM3 at 700 W, with the JAX test's
# dt, a slowly decaying dt and block 0's own inputs: atol 5.2e-5 needed at
# rtol 1e-2, rms ratios 3.3e-5 to 4.5e-5 for y and 4.2e-7 to 2.1e-6 for the
# state (chip_smoke.py prints the readings).
SSD_MAIN_TOLERANCE = dict(atol=5e-4, rtol=1e-2)
SSD_MAIN_RMS_LIMIT = 2e-4
SSD_STATE_RMS_LIMIT = 1e-5
# jamba-1.5-large-398b's Mamba2 sublayers, held at the main limits above:
# at its published width (H 256, P 64, N 128) and at its smoke width (H 8,
# N 32, chunk 32), which is what its block runs on the card.
SSD_FAMILY_MAIN_CASES = [
    (1, 1024, 256, 64, 128, 256, "bfloat16"),
    (1, 1024, 8, 64, 32, 32, "bfloat16"),
]


# K3's backward (csrc/ssd_scan_bwd.cu): every shape of SSD_CASES,
# SSD_RAGGED_CASES and SSD_CORNER_CASES and the main shape, each in both
# dtypes; the training shape (the train CLI's 8 x 256 tokens at
# mamba2-370m's widths, one chunk) and the smoke width of mamba2-370m and
# jamba (H 8, P 64, N 32, chunk 32) over 2 x 128 tokens, in both dtypes.
SSD_BACKWARD_TRAIN_CASE = (8, 256, 32, 64, 128, 256, "float32")
SSD_BACKWARD_SMOKE_CASE = (2, 128, 8, 64, 32, 32, "float32")
# K3's fp32 forward (3xTF32) where the train step runs it: the training
# shape, mamba2-370m's heads over 1024 tokens (four chunks) and jamba's
# (H 256); held at the main limits above with the fp32 JAX limit, and
# timed.
SSD_FP32_MAIN_CASES = [SSD_BACKWARD_TRAIN_CASE,
                       (1, 1024, 32, 64, 128, 256, "float32"),
                       (1, 1024, 256, 64, 128, 256, "float32")]
SSD_BACKWARD_CASES = list(dict.fromkeys(
    c[:6] + (dtype,)
    for c in (SSD_CASES + SSD_RAGGED_CASES + SSD_CORNER_CASES
              + [SSD_MAIN_CASE, SSD_BACKWARD_TRAIN_CASE,
                 SSD_BACKWARD_SMOKE_CASE])
    for dtype in ("float32", "bfloat16")))
# Timed beside the plain backward: the training shape, mamba2-370m's heads
# over 1024 tokens (four chunks) and jamba-1.5-large's (H 256).
SSD_BACKWARD_TIMED = [SSD_BACKWARD_TRAIN_CASE[:6],
                      (1, 1024, 32, 64, 128, 256),
                      (1, 1024, 256, 64, 128, 256)]
# Each of dx, ddt, dA, dB and dC against the plain backward (autograd
# through ssd_scan_ref) on the same inputs and cotangents, set before the
# kernel's first run on the card from a CPU model of its five launches
# (tests/test_torch_kernels.py: fp32 products, fp64 sums of the decay
# terms).  fp32: max_ratio at most SSD_BACKWARD_LIMIT, the JAX SSD test's
# fp32 limit: the model reads 1.4e-7 to 8.6e-7 against the plain backward,
# and two fp32 gradients that sum in other orders (JAX's jnp ssd_chunked
# against the plain backward) differ by up to 6.0e-6.  bf16: both sides
# round the fp32 gradient to bf16 once and mostly agree bit for bit; a
# rounding that flips moves a value by one bf16 ulp, at most 2^-7 of it.
# max_ratio at most SSD_BACKWARD_BF16_LIMIT (two ulps of the largest
# value) and rms(got - want) at most SSD_BACKWARD_BF16_RMS_LIMIT of
# rms(want), about 10x the model's worst reading (5.1e-5, dB at the
# training shape's widths; max_ratio 1.1e-3).
SSD_BACKWARD_LIMIT = 1e-4
SSD_BACKWARD_BF16_LIMIT = 1.6e-2
SSD_BACKWARD_BF16_RMS_LIMIT = 5e-4


def ssd_backward_check(got, want, dtype: str) -> tuple:
    """(max_ratio, rms error over rms(want), within the limits) of one
    gradient of K3's backward against the plain backward's, two torch
    tensors on any device."""
    got, want = got.float(), want.float()
    ratio = max_ratio(got, want)
    rms = float((got - want).square().mean().sqrt()
                / (want.square().mean().sqrt() + 1e-30))
    if dtype == "bfloat16":
        return (ratio, rms, ratio <= SSD_BACKWARD_BF16_LIMIT
                and rms <= SSD_BACKWARD_BF16_RMS_LIMIT)
    return ratio, rms, ratio <= SSD_BACKWARD_LIMIT


def ssd_limit(dtype: str) -> float:
    """The JAX package's SSD limit on :func:`max_ratio`."""
    return 5e-2 if dtype == "bfloat16" else 1e-4


def max_ratio(got, want) -> float:
    """The JAX package's SSD measure, max |got - want| / max |want|, of two
    torch tensors or of two arrays (numpy, JAX)."""
    if hasattr(got, "float"):                 # torch, on any device
        got, want = got.float(), want.float()
    else:
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(abs(got - want).max() / (abs(want).max() + 1e-9))


def bf16_backward_check(got, want) -> tuple:
    """(max_ratio, rms error over rms(want), within the limits) of a bf16
    gradient against the plain version's, two torch tensors on any device.
    Where the plain gradient is exactly 0 the readings are max |got| and
    rms(got), held to BACKWARD_BF16_ZERO_ATOL."""
    got, want = got.float(), want.float()
    if float(want.abs().max()) == 0.0:
        top = float(got.abs().max())
        return (top, float(got.square().mean().sqrt()),
                top <= BACKWARD_BF16_ZERO_ATOL)
    ratio = max_ratio(got, want)
    rms = float((got - want).square().mean().sqrt()
                / want.square().mean().sqrt())
    return (ratio, rms, ratio <= BACKWARD_BF16_LIMIT
            and rms <= BACKWARD_BF16_RMS_LIMIT)


def tolerance(dtype: str) -> dict:
    return (dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16"
            else dict(atol=2e-5, rtol=2e-5))


def case_id(c) -> str:
    return f"B{c[0]}Hq{c[1]}Hkv{c[2]}S{c[3]}D{c[4]}c{int(c[5])}w{c[6]}{c[7]}"


def decode_case_id(c) -> str:
    return f"B{c[0]}Hq{c[1]}Hkv{c[2]}S{c[3]}D{c[4]}i{c[5]}w{c[6]}{c[7]}"


def ssd_case_id(c) -> str:
    return f"b{c[0]}S{c[1]}H{c[2]}P{c[3]}N{c[4]}c{c[5]}{c[6]}"
