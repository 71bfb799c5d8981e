"""Banded (sliding-window) causal GQA attention: the CUDA kernel
(csrc/banded_attn.cu) behind `ops.banded_attention`, and its plain version
in `ref.py`."""
