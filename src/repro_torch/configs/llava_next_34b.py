"""LLaVA-NeXT-34B — VLM: dense decoder backbone; anyres vision frontend is a
stub per the carve-out (input_specs provides patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf]
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

# Number of precomputed vision-patch embedding positions assumed by
# input_specs for anyres tiling (base 576 + 4 tiles x 576).
NUM_PATCH_TOKENS = 2880

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128,
    embedding_inputs=True,   # patch+token embeddings arrive precomputed
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (34B per assignment)",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="llava-next-34b-smoke", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512)
