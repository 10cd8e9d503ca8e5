"""Qwen3-8B — dense decoder, GQA kv=8, qk_norm. [hf:Qwen/Qwen3-8B]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=12288, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-8b-smoke", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512)
