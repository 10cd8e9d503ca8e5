from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    get_smoke_config,
    long_context_variant,
    shape_is_applicable,
)
