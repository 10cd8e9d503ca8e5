"""Mixtral-8x22B — MoE 8 experts top-2, GQA kv=8, SWA. [arXiv:2401.04088]"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=32768, head_dim=128,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, num_experts_per_tok=2, d_expert=16384),
    source="arXiv:2401.04088",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mixtral-8x22b-smoke", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        sliding_window=64,
        moe=MoEConfig(num_experts=4, num_experts_per_tok=2, d_expert=512))
