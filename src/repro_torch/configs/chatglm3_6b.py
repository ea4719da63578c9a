"""chatglm3-6b [arXiv:2406.12793]: 28L d4096 32H GQA(kv=2) d_ff 13696
vocab 65024, 2d RoPE (rotary on half the head dims)."""
from repro_torch.config import LMConfig


def config() -> LMConfig:
    return LMConfig(name="chatglm3-6b", n_layers=28, d_model=4096, n_heads=32,
                    n_kv_heads=2, head_dim=128, d_ff=13_696, vocab=65_024,
                    rope_frac=0.5, qkv_bias=True, grad_accum=4)


def reduced() -> LMConfig:
    return LMConfig(name="chatglm3-6b-reduced", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=160, vocab=256,
                    rope_frac=0.5, qkv_bias=True, max_seq=256, q_chunk=16,
                    k_chunk=32)
