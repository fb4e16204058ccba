"""Hand-written Hopper kernels (paged and dense decode, paged and dense
chunked prefill, paged chunk-verify and tree-verify, flash attention forward
and backward) and their dispatch.

``ops`` picks the CUDA kernel for CUDA tensors and the plain PyTorch version
for CPU tensors.  Kernel sources live in ``csrc/`` and are compiled by
``build`` at first use; importing this package builds nothing.
"""
