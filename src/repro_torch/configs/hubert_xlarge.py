"""HuBERT-XLarge — encoder-only audio backbone; conv feature extractor is a
stub per the carve-out (input_specs provides frame embeddings).
[arXiv:2106.07447]
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504, head_dim=80,
    causal=False, is_decoder=False, embedding_inputs=True,
    source="arXiv:2106.07447",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="hubert-xlarge-smoke", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=4, head_dim=64, d_ff=512, vocab_size=128)
