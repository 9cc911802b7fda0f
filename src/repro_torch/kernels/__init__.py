# Hand-written Hopper kernels of the serving step, each behind an ops.py
# dispatcher that runs the CUDA kernel for CUDA tensors and the plain
# PyTorch version (ref.py) for CPU tensors:
#   paged_attention — flash-decode over block-table-indexed KV pages (K1,
#                     csrc/paged_decode.cu, wrapper paged_attention.py)
#                     and the tree-decode pair over a fork-group map (K3,
#                     csrc/paged_tree_decode.cu, wrapper tree_decode.py);
#   flash_prefill   — the fused paged flash-prefill of a prefill chunk's
#                     rows in the mixed decode+prefill step (K2,
#                     csrc/paged_prefill.cu, wrapper paged_prefill.py)
#                     and the dense flash prefill of a whole prompt on the
#                     exact-length path and in Model.forward/prefill (K5,
#                     csrc/flash_prefill_sm90.cu in bf16 and
#                     csrc/flash_prefill.cu in fp32, wrapper
#                     flash_prefill.py), with its backward for training
#                     (csrc/flash_prefill_bwd.cu, wrapper and autograd
#                     binding flash_prefill_bwd.py);
#   ssd_scan        — the Mamba-2 SSD chunked scan with state in and out of
#                     the ssm/hybrid chunk lanes (K4, csrc/ssd_scan.cu,
#                     wrapper ssd_scan.py; plain versions in ref.py);
#   adamw           — AdamW's update of one leaf in one fused pass (not a
#                     TPU kernel: what XLA fuses in the reference's jitted
#                     update; csrc/adamw.cu, wrapper adamw.py).
# build.py compiles csrc/ with nvcc at first use. Nothing is re-exported
# here, so each wrapper module stays importable under its own name (its
# launch counters are module attributes).
