from repro_torch.util.device import resolve_device  # noqa: F401
from repro_torch.util.errors import (  # noqa: F401
    MixedSequenceLengthError,
    QueryError,
)
