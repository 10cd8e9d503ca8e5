"""Model configuration: the port's copy of the JAX package's
``configs/base.py`` (every arch of the JAX package, with the same fields,
parameter counts and registry).

Every architecture is a :class:`ModelConfig`.  The pipeline unit is a
*block* (a homogeneous super-layer), so stage boundaries can be runtime
arguments.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings for the FFN sublayer."""

    num_experts: int
    num_experts_per_tok: int
    d_expert: int                 # hidden size of each routed expert
    num_shared_experts: int = 0   # DeepSeek-style always-on experts
    d_shared: int = 0             # hidden size of each shared expert
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # Apply MoE every `every` blocks starting at `offset` (Jamba: every=2).
    every: int = 1
    offset: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) settings."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # SSD head dim (P)
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description (same fields and meanings as the JAX
    package's ``ModelConfig``)."""

    name: str
    family: str
    num_layers: int               # total sublayers, == num_blocks*len(pattern)
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # defaults to d_model // num_heads
    layer_pattern: Tuple[str, ...] = ("attn",)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None    # None = full attention
    causal: bool = True                     # False for encoder-only (audio)
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    embedding_inputs: bool = False
    is_decoder: bool = True
    source: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_layers % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern length {len(self.layer_pattern)}")

    @property
    def num_blocks(self) -> int:
        return self.num_layers // len(self.layer_pattern)

    def block_has_attn(self) -> bool:
        return "attn" in self.layer_pattern

    def block_has_mamba(self) -> bool:
        return "mamba" in self.layer_pattern

    def sublayer_is_moe(self, sublayer_idx: int) -> bool:
        """Whether the FFN of sublayer `sublayer_idx` (within a block) is MoE."""
        if self.moe is None:
            return False
        return sublayer_idx % self.moe.every == self.moe.offset

    def param_count(self) -> int:
        """Rough parameter count (embed + blocks + head), the JAX
        package's formula."""
        d, h = self.d_model, self.head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d
        if self.is_decoder:
            total += self.vocab_size * d
        per_pattern = 0
        for i, kind in enumerate(self.layer_pattern):
            if kind == "attn":
                per_pattern += d * (n_q * h) + 2 * d * (n_kv * h) + (n_q * h) * d
            else:  # mamba2
                s = self.ssm
                din = s.d_inner(d)
                nh = s.num_heads(d)
                # in_proj produces [z, x, B, C, dt]
                per_pattern += d * (2 * din + 2 * s.d_state + nh) + din * d
                per_pattern += s.d_conv * (din + 2 * s.d_state)
            per_pattern += 2 * d  # norms
            if self.moe is not None and self.sublayer_is_moe(i):
                m = self.moe
                per_pattern += m.num_experts * 3 * d * m.d_expert
                per_pattern += m.num_shared_experts * 3 * d * m.d_shared
                per_pattern += d * m.num_experts  # router
            elif kind == "attn" and self.d_ff > 0 and self.family != "ssm":
                per_pattern += 3 * d * self.d_ff
        return total + self.num_blocks * per_pattern

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        moe_sublayers = sum(
            1 for i in range(len(self.layer_pattern)) if self.sublayer_is_moe(i))
        inactive = (m.num_experts - m.num_experts_per_tok) * 3 \
            * self.d_model * m.d_expert
        return self.param_count() - self.num_blocks * moe_sublayers * inactive


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_ARCH_MODULES = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x22b": "mixtral_8x22b",
    "llava-next-34b": "llava_next_34b",
    "mamba2-370m": "mamba2_370m",
    "hubert-xlarge": "hubert_xlarge",
    "qwen3-32b": "qwen3_32b",
    "qwen3-4b": "qwen3_4b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen3-8b": "qwen3_8b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    """The full (published) config for ``--arch <id>``."""
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced variant of the same family: <= 2 blocks, d_model <= 512,
    <= 4 experts."""
    return _module(arch).smoke_config()
