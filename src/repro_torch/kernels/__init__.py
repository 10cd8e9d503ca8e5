"""Hand-written Hopper kernels, their builds and their plain versions.

* ``csrc/*.cu`` -- CUDA C++ sources for ``sm_90a`` (built by ``build``)
* ``flash_attention`` -- wrapper of kernel K1 (replaces the Pallas
  ``repro.kernels.flash_attention``): bf16 on the tensor cores, fp32 on
  the CUDA cores, with a launch count for each
* ``decode_attention`` -- wrapper of kernel K2 (replaces the Pallas
  ``repro.kernels.decode_attention``), with its launch count
* ``ssd_scan`` -- wrapper of kernel K3 (replaces the Pallas
  ``repro.kernels.ssd_scan``), with its launch count
* ``ref`` -- plain PyTorch versions
* ``ops`` -- ``impl`` dispatch between the two
* ``cases`` -- the shapes and tolerances at which a kernel is held against
  its plain version
"""
