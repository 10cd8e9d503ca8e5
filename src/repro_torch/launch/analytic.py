"""Analytic FLOP / HBM-byte model per (architecture × input shape).

Why this exists: XLA's ``compiled.cost_analysis()`` counts each
while-loop body exactly once (verified in-tree — a 10-iteration
``lax.scan`` of a matmul reports 1× the matmul FLOPs), so anything under
``lax.scan`` / ``lax.map`` / ``fori_loop`` (our block stack, the chunked
flash attention, the SSD chunk scan) is undercounted.  The dry-run
unrolls the *block* loop so the HLO collective schedule is exact, but the
roofline compute/memory terms come from this module: exact matmul-level
accounting, cross-validated against ``cost_analysis`` on fully-unrolled
reduced configs (see tests/test_analytic.py).

Conventions:
* FLOPs: 2·M·N·K per matmul.  Causal attention counts the executed
  (block-culled) score/PV work: the chunked implementation skips fully
  masked tiles, so ≈ half the S² work at long S, and the sliding-window
  variant only touches ~window·S.
* Train = fwd + 2×bwd (+1 extra fwd when remat=True).
* HBM bytes: every parameter read once per fwd pass (bf16); optimizer
  update reads/writes params + m/v in fp32; activations counted at the
  block interfaces (the dominant intra-block traffic is modeled per
  component); decode reads the whole KV cache once per step.

The port's copy of the JAX package's ``launch/analytic.py``; only the
import path differs.  ``tests/test_torch_training.py`` holds its counts
equal to the original's.  The training phase of ``chip_smoke.py`` reads
a train step's operations from ``totals("train", remat=True)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import InputShape, ModelConfig

BF16 = 2
F32 = 4


def _attn_ctx_tokens(S: int, window, causal: bool) -> float:
    """Average attended keys per query under block culling."""
    if window is not None:
        w = min(window, S)
        # query i attends min(i+1, w) keys
        return (w * (w + 1) / 2 + (S - w) * w) / S if causal else min(2 * w, S)
    return (S + 1) / 2 if causal else S


@dataclasses.dataclass
class CostBreakdown:
    flops_fwd: float
    bytes_fwd: float            # params + activations traffic, one fwd
    param_bytes: float
    kv_bytes_step: float = 0.0  # decode: cache read+write per step

    def totals(self, mode: str, remat: bool = True) -> Dict[str, float]:
        if mode == "train":
            fwd_mult = 4.0 if remat else 3.0   # fwd + 2 bwd (+ remat fwd)
            flops = self.flops_fwd * fwd_mult
            # params bf16 read (fwd+bwd) + grad write + AdamW fp32 m/v
            # read+write + param read/write
            opt_bytes = self.param_bytes / BF16 * (2 * BF16 + 4 * F32 + 2 * F32)
            bytes_ = self.bytes_fwd * fwd_mult + opt_bytes
        else:
            flops = self.flops_fwd
            bytes_ = self.bytes_fwd + self.kv_bytes_step
        return {"flops": flops, "bytes": bytes_}


def analytic_cost(cfg: ModelConfig, shape: InputShape) -> CostBreakdown:
    B, S = shape.global_batch, shape.seq_len
    mode = shape.mode
    d, h = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    V = cfg.vocab_size

    if mode == "decode":
        T = B            # tokens processed this step
        S_ctx = S        # cache length attended
        seq_for_acts = 1
    else:
        T = B * S
        S_ctx = S
        seq_for_acts = S

    flops = 0.0
    act_bytes = 0.0
    param_bytes = 0.0
    kv_bytes = 0.0

    def matmul(t, din, dout):
        nonlocal flops, act_bytes, param_bytes
        flops += 2.0 * t * din * dout
        act_bytes += (t * din + t * dout) * BF16
        param_bytes += din * dout * BF16

    # ---- embeddings ------------------------------------------------------
    if not cfg.embedding_inputs or mode == "decode":
        act_bytes += T * d * BF16           # gather output
        param_bytes += V * d * BF16
    # ---- blocks -----------------------------------------------------------
    for bi in range(cfg.num_blocks):
        for i, kind in enumerate(cfg.layer_pattern):
            if kind == "attn":
                matmul(T, d, (nq + 2 * nkv) * h)          # qkv
                ctx = _attn_ctx_tokens(S_ctx, cfg.sliding_window, cfg.causal) \
                    if mode != "decode" else _attn_ctx_tokens(
                        S_ctx, cfg.sliding_window, True)
                if mode == "decode":
                    ctx = (min(cfg.sliding_window, S_ctx)
                           if cfg.sliding_window else S_ctx)
                flops += 2.0 * T * nq * h * ctx * 2        # scores + PV
                act_bytes += T * nq * h * BF16 * 2
                matmul(T, nq * h, d)                       # out proj
                if mode == "decode":
                    # read whole cache + write one slot
                    kv_bytes += 2 * B * S_ctx * nkv * h * BF16
                elif mode == "prefill" and cfg.is_decoder:
                    kv_bytes += 2 * B * S * nkv * h * BF16  # cache write
            else:  # mamba2
                s = cfg.ssm
                din = s.d_inner(d)
                H = s.num_heads(d)
                P = s.head_dim
                N = s.d_state
                matmul(T, d, 2 * din + 2 * N + H)          # in_proj
                flops += 2.0 * T * (din + 2 * N) * s.d_conv  # conv
                if mode == "decode":
                    # recurrent step: state update + readout
                    flops += T * H * P * N * 4.0
                    kv_bytes += 2 * B * H * P * N * BF16
                else:
                    cs = min(s.chunk_size, S)
                    # dual form per chunk: CBᵀ + (L∘CB)X + state write/read
                    flops += 2.0 * T * cs * N              # C·Bᵀ
                    flops += 2.0 * T * cs * H * P          # (L∘CB)·X
                    flops += 2.0 * T * N * H * P * 2       # states in/out
                matmul(T, din, d)                          # out_proj
                param_bytes += (s.d_conv * (din + 2 * N) + 3 * H) * BF16
            # ---- FFN ------------------------------------------------------
            if cfg.family == "ssm":
                continue
            if cfg.moe is not None and cfg.sublayer_is_moe(i):
                m = cfg.moe
                flops += 2.0 * T * d * m.num_experts       # router
                param_bytes += d * m.num_experts * F32
                routed_t = T * m.num_experts_per_tok * m.capacity_factor
                flops += 2.0 * routed_t * d * m.d_expert * 3
                act_bytes += routed_t * (2 * d + m.d_expert) * BF16
                param_bytes += m.num_experts * 3 * d * m.d_expert * BF16
                if m.num_shared_experts:
                    matmul(T, d, m.num_shared_experts * m.d_shared * 3)
            elif cfg.d_ff > 0:
                matmul(T, d, cfg.d_ff * 3)
            act_bytes += T * d * BF16 * 4                  # norms/residuals
    # ---- head --------------------------------------------------------------
    # decoders emit last-position logits at prefill; encoders emit all
    head_t = T if (mode == "train" or not cfg.is_decoder) else B
    flops += 2.0 * head_t * d * V
    act_bytes += head_t * (d + V) * BF16
    param_bytes += d * V * BF16

    return CostBreakdown(
        flops_fwd=flops,
        bytes_fwd=act_bytes + param_bytes,
        param_bytes=param_bytes,
        kv_bytes_step=kv_bytes,
    )


def analytic_totals(cfg: ModelConfig, shape: InputShape,
                    remat: bool = True) -> Dict[str, float]:
    return analytic_cost(cfg, shape).totals(shape.mode, remat=remat)
