"""granite-moe-3b-a800m [hf:ibm-granite]: 32L d1536 24H GQA(kv=8),
MoE 40 experts top-8, expert d_ff 512, vocab 49155."""
from repro_torch.config import LMConfig


def config() -> LMConfig:
    return LMConfig(name="granite-moe-3b-a800m", n_layers=32, d_model=1536,
                    n_heads=24, n_kv_heads=8, head_dim=64, d_ff=512,
                    vocab=49_155, moe_experts=40, moe_top_k=8,
                    tie_embeddings=True, grad_accum=4)


def reduced() -> LMConfig:
    return LMConfig(name="granite-moe-reduced", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32, vocab=256,
                    moe_experts=8, moe_top_k=2, tie_embeddings=True,
                    max_seq=256, q_chunk=16, k_chunk=32)
