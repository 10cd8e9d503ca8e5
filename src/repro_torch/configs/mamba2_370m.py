"""Mamba2-370M — attention-free SSD (state-space duality). [arXiv:2405.21060]"""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, head_dim=64,
    layer_pattern=("mamba",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64),
    source="arXiv:2405.21060",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mamba2-370m-smoke", num_layers=2, d_model=256,
        vocab_size=512,
        ssm=SSMConfig(d_state=32, d_conv=4, expand=2, head_dim=64,
                      chunk_size=32))
