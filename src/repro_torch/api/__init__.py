"""repro_torch.api — the session-layer API of the torch port.

    from repro_torch.api import Dataset, MatchOptions, Matcher

    ds = Dataset.synthetic("yeast", scale=0.05)   # preprocess once
    m = Matcher(ds)                               # the card, engine="auto"
    out = m.count(query)                          # MatchOutcome
    for emb in m.stream(query, limit=10): ...     # explicit embeddings
    print(m.explain(query))                       # order/coloring/plan
    outs = m.match_many(queries)                  # cross-query superbatch
    m.count(query)                                # seeds an exact base
    m.count_delta(query, GraphDelta(edge_inserts=[(0, 5)]))  # rolls it on
"""
from ..streaming import DeltaOutcome, DeltaSummary, GraphDelta

from .dataset import Dataset
from .matcher import (AUTO_VECTOR_MIN_ROWS, CacheInfo, CompiledQuery,
                      Matcher, MatchOutcome)
from .options import (BATCH_MODES, ENCODINGS, ENGINES, INTERSECT_MODES,
                      ORDER_HEURISTICS, MatchOptions)
from .signature import graph_signature

__all__ = [
    "Dataset", "Matcher", "MatchOptions", "MatchOutcome", "CompiledQuery",
    "CacheInfo", "graph_signature", "AUTO_VECTOR_MIN_ROWS",
    "ENGINES", "ENCODINGS", "ORDER_HEURISTICS", "INTERSECT_MODES",
    "BATCH_MODES", "GraphDelta", "DeltaSummary", "DeltaOutcome",
]
