"""PyTorch/CUDA port of the ODIN reproduction.

The JAX package ``repro`` stays the reference; this package does the same
work with PyTorch on an NVIDIA H100, with hand-written Hopper kernels in
place of the Pallas ones.  It imports neither JAX nor ``repro``: the part
of the numpy control plane it needs is copied here and held equal to the
original by the tests.

Entry points take ``device=`` and default to ``"cuda"``; the CPU is used
only when a caller passes ``device="cpu"``.
"""
