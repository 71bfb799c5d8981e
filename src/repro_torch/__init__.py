"""DiSMEC's serving and training paths in PyTorch, with hand-written CUDA
kernels for Hopper (H100).

A port of the JAX package `repro` that stands beside it and imports
nothing of it: the same specs, checkpoint formats, training engine
(`xmc_api.fit` -> `train.xmc.XMCTrainJob` -> batched TRON) and serving
engine, with the BSR predict, blocked top-k, fused hinge and
Hessian-vector-product kernels written in CUDA C++ (`csrc/`, built by
`kernels/_build.py`). Entry points run on the card unless the caller
passes `device="cpu"`; on the CPU every kernel wrapper runs its plain
PyTorch version instead.
"""
