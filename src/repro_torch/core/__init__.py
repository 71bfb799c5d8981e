"""DiSMEC core: Delta-pruning, BSR packing and dense scoring."""

from repro_torch.core.pruning import (ambiguous_fraction, nnz, prune,
                                      sparsity, weight_histogram)

__all__ = ["prune", "nnz", "sparsity", "ambiguous_fraction",
           "weight_histogram"]
