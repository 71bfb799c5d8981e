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

Two JAX modules have no counterpart here: `launch/hlo_cost.py`, a cost
model of XLA's optimised HLO that corrects its while-loop trip counts
(the port has no HLO, and its Python loops run each operation as often
as it runs: `launch/dryrun.py` counts FLOPs over those calls on fake
tensors), and `compat.py`, which shims jax versions.
"""
