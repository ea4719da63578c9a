"""repro_torch.api — the session-layer API of the torch port.

    from repro_torch.api import Dataset, MatchOptions, Matcher

    ds = Dataset.synthetic("yeast", scale=0.05)   # preprocess once
    m = Matcher(ds)                               # the card, engine="auto"
    out = m.count(query)                          # MatchOutcome
    for emb in m.stream(query, limit=10): ...     # explicit embeddings
    print(m.explain(query))                       # order/coloring/plan
"""
from .dataset import Dataset
from .matcher import (AUTO_VECTOR_MIN_ROWS, CacheInfo, CompiledQuery,
                      Matcher, MatchOutcome)
from .options import (ENCODINGS, ENGINES, INTERSECT_MODES, ORDER_HEURISTICS,
                      MatchOptions)
from .signature import graph_signature

__all__ = [
    "Dataset", "Matcher", "MatchOptions", "MatchOutcome", "CompiledQuery",
    "CacheInfo", "graph_signature", "AUTO_VECTOR_MIN_ROWS",
    "ENGINES", "ENCODINGS", "ORDER_HEURISTICS", "INTERSECT_MODES",
]
