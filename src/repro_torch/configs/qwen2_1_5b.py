"""qwen2-1.5b [arXiv:2407.10671]: 28L d1536 12H GQA(kv=2) d_ff 8960
vocab 151936, QKV bias, tied embeddings."""
from repro_torch.config import LMConfig


def config() -> LMConfig:
    return LMConfig(name="qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12,
                    n_kv_heads=2, head_dim=128, d_ff=8960, vocab=151_936,
                    qkv_bias=True, tie_embeddings=True, grad_accum=4)


def reduced() -> LMConfig:
    return LMConfig(name="qwen2-1.5b-reduced", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
                    qkv_bias=True, tie_embeddings=True, max_seq=256,
                    q_chunk=16, k_chunk=32)
