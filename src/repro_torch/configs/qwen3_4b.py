"""Qwen3-4B — dense decoder, GQA kv=8, qk_norm. [hf:Qwen/Qwen3-8B]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    num_layers=36, d_model=2560, num_heads=32, num_kv_heads=8,
    d_ff=9728, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B (4B sibling per assignment)",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-4b-smoke", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512)
