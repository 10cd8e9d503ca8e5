"""Roofline terms of a step on NVIDIA H100 SXM cards.

    compute term    = FLOPs / (chips x peak FLOP/s of the step's dtype)
    memory term     = HBM bytes / (chips x HBM rate)
    collective term = collective bytes a chip moves / link rate

The port's counterpart of the JAX package's ``launch/roofline.py``, which
holds a TPU's constants and reads its costs from compiled XLA HLO.  Here
the card's constants are the H100 SXM data sheet's, and the costs come
from three sources that need no compiler: ``launch/analytic.py`` for the
compute and memory terms, ``torch.utils.flop_counter.FlopCounterMode``
over the step run on the meta device in place of HLO's FLOPs (see
``launch/dryrun.py``), and a :class:`CollectiveRecord` of the
``torch.distributed`` traffic a run executed in place of HLO's collective
ops.  A record counts executed calls, so it is loop-aware by
construction, where the JAX parser multiplies a while body by its trip
count.

This module is the one place in the port that holds the card's peaks:
``chip_smoke.py``'s bounds read them from here.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Optional, Tuple

# NVIDIA H100 SXM5 data-sheet figures, per card.
PEAK_BF16_FLOPS = 989e12      # H100 SXM data sheet: dense bf16, tensor cores
PEAK_TF32_FLOPS = 495e12      # H100 SXM data sheet: dense TF32, tensor cores
PEAK_FP32_FLOPS = 67e12       # H100 SXM data sheet: fp32 outside the tensor cores
HBM_BW = 3.35e12              # H100 SXM data sheet: HBM3, bytes/s
LINK_BW = 450e9               # H100 SXM data sheet: NVLink, bytes/s a direction

#: Collective kinds, named as XLA names them (the JAX roofline's keys).
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def peak_flops(dtype: str = "bfloat16", tf32: bool = False) -> float:
    """The card's peak for products in ``dtype``: bf16 (and fp16) on the
    tensor cores; fp32 on the CUDA cores, as the port runs it with TF32
    off, unless the caller says the products run in TF32."""
    name = str(dtype).replace("torch.", "")
    if name in ("bfloat16", "float16"):
        return PEAK_BF16_FLOPS
    if name == "float32":
        return PEAK_TF32_FLOPS if tf32 else PEAK_FP32_FLOPS
    raise ValueError(f"no peak for dtype {dtype!r}")


def bound(flops: float, nbytes: float, peak: float) -> Tuple[float, str]:
    """(seconds, bound_by): the larger of the operations over ``peak`` and
    the bytes over HBM's rate, and which of the two it is."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BW
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


class CollectiveRecord:
    """Bytes one rank moved through ``torch.distributed``, by kind and op.

    ``add`` is called where a collective is issued, once per executed
    call, with the payload it puts on the wire: a send's tensor for a
    point-to-point hand-off (``collective-permute``), the buffer for a
    broadcast or an all-reduce.
    """

    def __init__(self):
        self.rows: Dict[Tuple[str, str], int] = defaultdict(int)

    def add(self, kind: str, op: str, nbytes: int) -> None:
        if kind not in COLLECTIVES:
            raise ValueError(f"unknown collective kind {kind!r}; expected "
                             f"one of {COLLECTIVES}")
        self.rows[(kind, op)] += int(nbytes)


def collective_bytes(record: Optional[CollectiveRecord]) -> Dict[str, int]:
    """Per-chip collective payload bytes by kind (every kind present, 0
    where nothing moved): the counterpart of the JAX
    ``collective_bytes(hlo_text)``, read from what a run executed."""
    out = {k: 0 for k in COLLECTIVES}
    if record is not None:
        for (kind, _), b in record.rows.items():
            out[kind] += b
    return out


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # global FLOPs (analytic when provided)
    bytes_accessed: float        # global HBM bytes (analytic when provided)
    hlo_flops: float             # counted FLOPs (FlopCounterMode, meta run)
    hlo_bytes: float             # counted bytes (each op's operands, meta run)
    coll_bytes: float            # per-chip collective payload (a record)
    coll_breakdown: Dict[str, int]
    chips: int
    dtype: str = "bfloat16"      # the products' dtype: picks the peak
    tf32: bool = False           # fp32 products in TF32 (caller's choice)
    # derived (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    model_flops: Optional[float] = None
    useful_ratio: Optional[float] = None

    def finalize(self) -> "RooflineTerms":
        self.t_compute = self.flops / (self.chips
                                       * peak_flops(self.dtype, self.tf32))
        self.t_memory = self.bytes_accessed / (self.chips * HBM_BW)
        # collective bytes of a record are per chip
        self.t_collective = self.coll_bytes / LINK_BW
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        if self.model_flops:
            self.useful_ratio = self.model_flops / max(self.flops, 1.0)
        return self


def analyze(counted_flops: float, chips: int, *, dtype: str = "bfloat16",
            tf32: bool = False, counted_bytes: float = 0.0,
            collectives: Optional[CollectiveRecord] = None,
            model_flops: Optional[float] = None,
            analytic: Optional[Dict[str, float]] = None) -> RooflineTerms:
    """``counted_flops`` / ``counted_bytes``: what the meta-device run of
    the step counted, global (``chips`` x one chip's).  ``analytic``:
    {"flops", "bytes"} global totals from ``launch/analytic.py``; they
    drive the compute and memory terms where given, as in the JAX
    version.  The collective term comes from ``collectives``, a record of
    executed traffic (none on one card)."""
    coll = collective_bytes(collectives)
    return RooflineTerms(
        flops=analytic["flops"] if analytic else float(counted_flops),
        bytes_accessed=(analytic["bytes"] if analytic
                        else float(counted_bytes)),
        hlo_flops=float(counted_flops),
        hlo_bytes=float(counted_bytes),
        coll_bytes=float(sum(coll.values())),
        coll_breakdown=coll,
        chips=chips,
        dtype=str(dtype).replace("torch.", ""),
        tf32=tf32,
        model_flops=model_flops,
    ).finalize()


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (train), 2·N·D (inference); N = active params."""
    n = cfg.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # decode: one token per request
    return 2.0 * n * tokens

