"""The LM side's models: layers, the recurrent mixers (xLSTM's mLSTM and
sLSTM, Mamba), the MoE FFN, the KV cache, the decoder-only stack
(`transformer`) and `build_model`. Every decoder-only family serves and
trains; see `transformer.NOT_PORTED` for the rest."""
