"""Synthetic BERT4Rec data: Zipf-distributed item histories + cloze masking."""
from __future__ import annotations

import numpy as np

__all__ = ["cloze_batch", "history_batch"]


def history_batch(batch: int, seq_len: int, n_items: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    # Zipf-ish popularity
    ranks = rng.zipf(1.3, size=(batch, seq_len)).astype(np.int64)
    ids = (ranks % (n_items - 1)) + 1     # 0 reserved for [MASK]
    return ids.astype(np.int32)


def cloze_batch(batch: int, seq_len: int, n_items: int, *, mask_prob=0.15,
                max_masks: int | None = None, seed: int = 0):
    """Masked-position representation: (ids, mask_idx, mask_targets,
    mask_valid) with a static M = max_masks per row — the loss touches only
    masked positions (memory: M ≪ S against a 10⁶-item vocabulary)."""
    rng = np.random.default_rng(seed)
    ids = history_batch(batch, seq_len, n_items, seed)
    if max_masks is None:
        max_masks = max(int(seq_len * mask_prob * 1.3), 4)
    m_idx = np.zeros((batch, max_masks), np.int32)
    m_tgt = np.zeros((batch, max_masks), np.int32)
    m_val = np.zeros((batch, max_masks), bool)
    out_ids = ids.copy()
    for b in range(batch):
        n_mask = min(max_masks, max(1, rng.binomial(seq_len, mask_prob)))
        pos = rng.choice(seq_len, size=n_mask, replace=False)
        pos[0] = seq_len - 1              # always predict the last item
        pos = np.unique(pos)
        k = pos.shape[0]
        m_idx[b, :k] = pos
        m_tgt[b, :k] = ids[b, pos]
        m_val[b, :k] = True
        out_ids[b, pos] = 0
    return {"ids": out_ids.astype(np.int32), "mask_idx": m_idx,
            "mask_targets": m_tgt, "mask_valid": m_val}
