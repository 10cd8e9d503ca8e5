"""Jamba-1.5-Large 398B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887]  Block = period-8 super-block (1 attn + 7 mamba);
MoE replaces the MLP on every other sublayer (offset 1), per the Jamba
paper's e=2 MoE placement.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536, head_dim=128,
    layer_pattern=("attn",) + ("mamba",) * 7,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
    moe=MoEConfig(num_experts=16, num_experts_per_tok=2, d_expert=24576,
                  every=2, offset=1),
    source="arXiv:2403.19887",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="jamba-1.5-large-398b-smoke",
        num_layers=8, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512,
        ssm=SSMConfig(d_state=32, d_conv=4, expand=2, head_dim=64,
                      chunk_size=32),
        moe=MoEConfig(num_experts=4, num_experts_per_tok=2, d_expert=512,
                      every=2, offset=1))
