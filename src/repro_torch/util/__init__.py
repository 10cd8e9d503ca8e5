from repro_torch.util.device import resolve_device  # noqa: F401
from repro_torch.util.errors import (  # noqa: F401
    DispatchTimeoutError,
    MixedSequenceLengthError,
    QueryError,
    ReplicaUnavailableError,
    TransientQueryError,
    is_transient,
)
from repro_torch.util.registry import Registry  # noqa: F401
