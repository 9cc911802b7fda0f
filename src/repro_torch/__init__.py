"""PyTorch and CUDA port of the SART serving reproduction (``repro``).

Same sub-package layout as the JAX package, which stays the reference.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the paged attention kernels are hand-written CUDA C++
for Hopper (``csrc/``), built with nvcc at first use.
"""
