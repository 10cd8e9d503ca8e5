"""Hand-written Hopper kernels, their builds and their plain versions.

* ``csrc/*.cu`` -- CUDA C++ sources for ``sm_90a`` (built by ``build``)
* ``flash_attention`` -- wrapper of kernel K1 (replaces the Pallas
  ``repro.kernels.flash_attention``): bf16 and fp32 (3xTF32) kernels,
  both on the tensor cores, with a launch count for each; fp32 inputs that
  require grad take its backward kernel (``csrc/flash_attention_bwd.cu``, which
  has no Pallas counterpart) through an autograd Function
* ``decode_attention`` -- wrapper of kernel K2 (replaces the Pallas
  ``repro.kernels.decode_attention``), with its launch count
* ``ssd_scan`` -- wrapper of kernel K3 (replaces the Pallas
  ``repro.kernels.ssd_scan``), with its launch count; inputs that require
  grad take its backward kernel (``csrc/ssd_scan_bwd.cu``, which has no
  Pallas counterpart) through an autograd Function
* ``ref`` -- plain PyTorch versions
* ``ops`` -- ``impl`` dispatch between the two
* ``cases`` -- the shapes and tolerances at which a kernel is held against
  its plain version
"""
