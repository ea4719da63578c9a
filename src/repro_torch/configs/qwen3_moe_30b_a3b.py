"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L d2048 32H GQA(kv=4),
MoE 128 experts top-8, expert d_ff 768, vocab 151936."""
from repro_torch.config import LMConfig


def config() -> LMConfig:
    return LMConfig(name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048,
                    n_heads=32, n_kv_heads=4, head_dim=128, d_ff=768,
                    vocab=151_936, moe_experts=128, moe_top_k=8, grad_accum=4)


def reduced() -> LMConfig:
    return LMConfig(name="qwen3-moe-reduced", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32, vocab=256,
                    moe_experts=8, moe_top_k=2, max_seq=256, q_chunk=16,
                    k_chunk=32)
