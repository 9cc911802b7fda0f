# Hand-written Hopper kernels of the serving step, each behind an ops.py
# dispatcher that runs the CUDA kernel for CUDA tensors and the plain
# PyTorch version (ref.py) for CPU tensors:
#   paged_attention — flash-decode over block-table-indexed KV pages (K1,
#                     csrc/paged_decode.cu, wrapper paged_attention.py);
#   flash_prefill   — the fused paged flash-prefill of a prefill chunk's
#                     rows in the mixed decode+prefill step (K2,
#                     csrc/paged_prefill.cu, wrapper paged_prefill.py).
# build.py compiles csrc/ with nvcc at first use. Nothing is re-exported
# here, so each wrapper module stays importable under its own name (its
# ``launches`` counter is a module attribute).
