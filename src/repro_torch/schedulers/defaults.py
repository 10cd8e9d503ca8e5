"""Shared scheduler tuning defaults — documented once, used everywhere.

Policies resolve ``rel_threshold=None`` to :data:`DEFAULT_REL_THRESHOLD`.

* :data:`DEFAULT_REL_THRESHOLD` — the paper's §3.1 monitoring rule
  triggers when the bottleneck stage time shifts by more than this
  fraction relative to the post-rebalance reference.  2% is tight
  enough to catch every Table-1 scenario (the mildest is ~5-7%
  slowdown) without firing on database-level noise.
* :data:`DEFAULT_ALPHA` — ODIN's exploration patience (paper evaluates
  α=2 and α=10; 10 is the headline setting).
* :data:`MEASURED_DETECTOR_MODE` — wall-clock stage times jitter well
  beyond 2% query-to-query, so the live engine keeps the shared
  threshold but runs the detector in its EMA/hysteresis mode
  (``InterferenceDetector(mode="ema")``): the reference is a smoothed
  average and a trigger needs ``hysteresis`` consecutive out-of-band
  observations.  Same rule, debounced — not a different threshold.
"""
from __future__ import annotations

from typing import Optional

DEFAULT_REL_THRESHOLD: float = 0.02
DEFAULT_ALPHA: int = 10
MEASURED_DETECTOR_MODE: str = "ema"


def resolve_rel_threshold(value: Optional[float]) -> float:
    """``None`` -> the shared default; explicit values pass through."""
    return DEFAULT_REL_THRESHOLD if value is None else float(value)
