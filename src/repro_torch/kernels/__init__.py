"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

Each kernel directory contains:
  ref.py — the plain PyTorch version (the CPU path, and the reference the
           kernel is held against on the card)
  ops.py — the public wrapper: the kernel for a CUDA tensor, the plain
           version for a CPU tensor, a launch counter on the wrapper
The CUDA sources live in `repro_torch/csrc/`; `_build.py` compiles them
for sm_90a with nvcc at first use.

  bsr_predict  block-sparse x W^T predict over the packed surviving blocks
  topk         blocked two-stage top-k (per-block candidates + merge)
  hinge        fused squared-hinge objective, gradient and active mask
               (TRON's obj_grad)
  hvp          generalized-Hessian vector product (TRON's CG step)
"""
