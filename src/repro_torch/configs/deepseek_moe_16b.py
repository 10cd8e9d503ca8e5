"""DeepSeekMoE-16B — fine-grained 64 routed top-6 + 2 shared. [arXiv:2401.06066]"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400, head_dim=128,
    rope_theta=1e4,
    moe=MoEConfig(num_experts=64, num_experts_per_tok=6, d_expert=1408,
                  num_shared_experts=2, d_shared=1408),
    source="arXiv:2401.06066",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-moe-16b-smoke", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=4, head_dim=64, d_ff=128, vocab_size=512,
        moe=MoEConfig(num_experts=4, num_experts_per_tok=2, d_expert=128,
                      num_shared_experts=1, d_shared=128))
