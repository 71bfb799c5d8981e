"""DiSMEC's serving path in PyTorch, with hand-written CUDA kernels for
Hopper (H100).

A port of the JAX package `repro` that stands beside it and imports
nothing of it: the same checkpoint formats, specs, backends and engine,
with the BSR predict and blocked top-k kernels written in CUDA C++
(`csrc/`, built by `kernels/_build.py`). Entry points run on the card
unless the caller passes `device="cpu"`; on the CPU every kernel wrapper
runs its plain PyTorch version instead.
"""
