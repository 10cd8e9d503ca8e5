"""Paper-faithful ODIN core: pure Python/NumPy, no JAX dependency.

The port's copy of the JAX package's ``core/__init__.py``; only import paths
differ.  ``tests/test_torch_simulator.py`` holds it equal to the original.
"""
from repro_torch.core.database import (  # noqa: F401
    InterferenceScenario,
    LayerDatabase,
    paper_scenarios,
    synthetic_database,
    transformer_database,
)
from repro_torch.core.exhaustive import (  # noqa: F401
    brute_force_partition,
    optimal_partition,
)
from repro_torch.core.lls import LLSExplorer, lls_rebalance  # noqa: F401
from repro_torch.core.odin import (  # noqa: F401
    OdinExplorer,
    RebalanceResult,
    Trial,
    odin_rebalance,
)
from repro_torch.core.pipeline_state import (  # noqa: F401
    balanced_config,
    boundaries,
    pipelined_latency,
    serial_latency,
    throughput,
    utilization,
    validate_config,
    waiting_times,
)
from repro_torch.core.events import (  # noqa: F401
    EventTimeline,
    events_for_replica,
)
from repro_torch.core.simulator import (  # noqa: F401
    PAPER_SETTINGS,
    DatabaseQueryExecutor,
    InterferenceEvent,
    SimResult,
    SimTimeSource,
    generate_events,
    simulate,
)


def __getattr__(name):
    """Back-compat: the online controllers moved to repro_torch.schedulers.

    ``OdinController`` / ``LLSController`` remain importable from
    ``repro_torch.core`` as aliases of the registry policies.  Lazy so that
    ``import repro_torch.schedulers`` (which imports repro_torch.core submodules
    while its own policies module is still executing) cannot deadlock
    the two packages' initialisation.
    """
    aliases = {"OdinController": "OdinPolicy", "LLSController": "LLSPolicy"}
    if name in aliases:
        from repro_torch.schedulers import policies
        return getattr(policies, aliases[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
