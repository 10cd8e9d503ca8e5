"""Qwen3-32B — dense decoder, GQA kv=8, qk_norm. [hf:Qwen/Qwen3-8B]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
    d_ff=25600, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B (scaled per assignment)",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-32b-smoke", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512)
