from repro_torch.pipeline.executor import (  # noqa: F401
    LocalPipelineExecutor,
    MeasuredTimeSource,
    next_pow2,
    stage_bounds,
)
from repro_torch.pipeline.spmd import (  # noqa: F401
    SpmdPipelineExecutor,
    make_pipeline_fn,
    pack_stage_params,
    pipelined_forward,
    stage_mesh,
    stage_tile,
)
