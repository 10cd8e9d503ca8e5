"""The shapes and tolerances at which K1 (flash attention) is held against
its plain version, in the tests and on the card.

A case is ``(B, Hq, Hkv, S, D, causal, window, dtype)``, the dtype as the
name of a torch dtype.
"""
from __future__ import annotations

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
# The main path: qwen3-4b's attention, q [1, 32, S, 128], k/v [1, 8, S, 128].
MAIN_SEQS = (1024, 2048)
MAIN_CASES = [(1, 32, 8, s, 128, True, None, "bfloat16") for s in MAIN_SEQS]

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


def tolerance(dtype: str) -> dict:
    return (dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16"
            else dict(atol=2e-5, rtol=2e-5))


def case_id(c) -> str:
    return f"B{c[0]}Hq{c[1]}Hkv{c[2]}S{c[3]}D{c[4]}c{int(c[5])}w{c[6]}{c[7]}"
