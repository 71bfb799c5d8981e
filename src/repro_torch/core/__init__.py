"""DiSMEC core: Delta-pruning, BSR packing and dense scoring."""
