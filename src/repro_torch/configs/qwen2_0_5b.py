"""Qwen2-0.5B — dense decoder, GQA kv=2, QKV bias. [arXiv:2407.10671]"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151936, head_dim=64,
    qkv_bias=True, rope_theta=1e6,
    source="arXiv:2407.10671",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen2-0.5b-smoke", num_layers=2, d_model=224,
        num_heads=4, num_kv_heads=2, head_dim=56, d_ff=448, vocab_size=512)
