"""ODIN's exploration algorithms and pipeline cost primitives (copies of
the JAX package's ``repro.core`` modules, without the mesh parts)."""
from repro_torch.core.lls import LLSExplorer, lls_rebalance  # noqa: F401
from repro_torch.core.odin import (  # noqa: F401
    OdinExplorer,
    RebalanceResult,
    Trial,
    odin_rebalance,
)
from repro_torch.core.pipeline_state import (  # noqa: F401
    balanced_config,
    throughput,
)
