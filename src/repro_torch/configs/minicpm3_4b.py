"""minicpm3-4b [hf:openbmb/MiniCPM3-4B]: 62L d2560 40H MLA d_ff 6400
vocab 73448. MLA ranks per the HF config: q_lora 768, kv_lora 256,
qk_nope 64, qk_rope 32, v_head 64."""
from repro_torch.config import LMConfig


def config() -> LMConfig:
    return LMConfig(name="minicpm3-4b", n_layers=62, d_model=2560, n_heads=40,
                    n_kv_heads=40, head_dim=96, d_ff=6400, vocab=73_448,
                    attention="mla", q_lora_rank=768, kv_lora_rank=256,
                    qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64, grad_accum=8)


def reduced() -> LMConfig:
    return LMConfig(name="minicpm3-4b-reduced", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=4, head_dim=24, d_ff=128, vocab=256,
                    attention="mla", q_lora_rank=32, kv_lora_rank=16,
                    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                    max_seq=256, q_chunk=16, k_chunk=32)
