"""Synthetic data of the GNN and recsys families: padded graph batches
(`graph_data`), the neighbor sampler (`sampler`) and BERT4Rec histories
with cloze masks (`recsys_synth`). numpy only, copies of the JAX
package's `data/`."""
