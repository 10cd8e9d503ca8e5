"""The shapes and tolerances at which each kernel is held against its
plain version, in the tests and on the card.

K1 (flash attention): a case is ``(B, Hq, Hkv, S, D, causal, window,
dtype)``; bf16 cases run on its tensor-core kernel, fp32 ones on its
CUDA-core kernel.  K2 (decode attention): ``(B, Hq, Hkv, S, D, index,
window, dtype)``.  K3 (SSD scan): ``(b, S, H, P, N, chunk, dtype)``.
Dtypes are named as torch dtypes.
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
# 128, and a window that bites (it is below S).
FAMILY_MAIN_CASES = [
    (1, 16, 16, 1024, 128, True, None, "bfloat16"),   # deepseek-moe-16b
    (8, 16, 16, 1024, 128, True, None, "bfloat16"),   # deepseek, 8 rows
    (8, 16, 16, 256, 128, True, None, "bfloat16"),
    (1, 16, 16, 1024, 80, False, None, "bfloat16"),   # hubert-xlarge
    # llava-next-34b: 2880 patch positions plus 64 text tokens.
    (1, 56, 8, 2944, 128, True, None, "bfloat16"),
    (1, 48, 8, 4608, 128, True, 4096, "bfloat16"),    # mixtral-8x22b
    (1, 64, 8, 1024, 128, True, None, "bfloat16"),    # jamba-1.5-large
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


def tolerance(dtype: str) -> dict:
    return (dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16"
            else dict(atol=2e-5, rtol=2e-5))


def case_id(c) -> str:
    return f"B{c[0]}Hq{c[1]}Hkv{c[2]}S{c[3]}D{c[4]}c{int(c[5])}w{c[6]}{c[7]}"


def decode_case_id(c) -> str:
    return f"B{c[0]}Hq{c[1]}Hkv{c[2]}S{c[3]}D{c[4]}i{c[5]}w{c[6]}{c[7]}"


def ssd_case_id(c) -> str:
    return f"b{c[0]}S{c[1]}H{c[2]}P{c[3]}N{c[4]}c{c[5]}{c[6]}"
