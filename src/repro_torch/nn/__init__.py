"""NN layers of the port: primitives (`core`), LM attention and MoE
(`attention`, `moe`), the decoder and the BERT4Rec encoder
(`transformer`), graph message passing (`gnn`) and equivariant blocks
(`equivariant`)."""
