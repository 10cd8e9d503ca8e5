from repro_torch.pipeline.executor import (  # noqa: F401
    LocalPipelineExecutor,
    MeasuredTimeSource,
    next_pow2,
    stage_bounds,
)
