"""The LM side's models: layers, the recurrent mixers (xLSTM's mLSTM and
sLSTM, Mamba), the MoE FFN, the KV cache, the decoder-only stack
(`transformer`), the encoder-decoder (`encdec`), the partition specs and
mesh placement (`sharding`) and `build_model`. Every family serves and
trains, on one device or over a mesh."""
