"""The LM side's models: layers, the Mamba mixer, the KV cache, the
decoder-only stack (`transformer`) and `build_model`. The dense and hybrid
families serve (prefill and decode); see `transformer.NOT_PORTED` for the
rest."""
