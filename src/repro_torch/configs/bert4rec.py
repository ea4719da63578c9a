"""bert4rec [arXiv:1904.06690]: embed 64, 2 blocks, 2 heads, seq 200.
Item vocabulary sized 10⁶ to make the retrieval_cand shape (1M candidates)
and the huge-sparse-embedding regime real."""
from repro_torch.config import RecsysConfig


def config() -> RecsysConfig:
    return RecsysConfig(name="bert4rec", embed_dim=64, n_blocks=2, n_heads=2,
                        seq_len=200, n_items=1_000_000)


def reduced() -> RecsysConfig:
    return RecsysConfig(name="bert4rec-reduced", embed_dim=16, n_blocks=2,
                        n_heads=2, seq_len=24, n_items=500)
