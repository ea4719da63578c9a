"""CEMR core, torch port: the numpy compile side (copies of `repro.core`)
and the torch runtime.

Module map (public entry point is `repro_torch.api`, not this package):

  graph       host-side CSR graphs, generators, random-walk queries
  filtering   vectorized compile pipeline: LDF/NLF + refinement + CSR
              auxiliary structure + bitmap packing; DataGraphIndex =
              query-independent preprocessing (label-sorted CSR, NLF
              histogram) shared across queries (owned by api.Dataset)
  filtering_ref  retained per-candidate compiler: differential oracle for
              the vectorized pipeline
  ordering    matching orders (Eq. 2-3 + ablation orders)
  encoding    black-white encoding (Eq. 4-5) + static query analysis
  plan        MatchingPlan: compile-time metadata + bitmap tables
  ref_engine  paper-faithful DFS engine (Algorithms 1-4) — baseline
  engine      vectorized tile engine (the card's bitmap kernels)
  scheduler   fused supersteps, the compat loop and the superbatch
  shard       sharded enumeration over the lanes of an EnumMesh
  count       leaf counting with injectivity inclusion-exclusion
  bitops      torch bitset primitives (popcount, expand_select, ...)
  oracle      networkx cross-check (tests only; networkx is imported
              inside its functions)

Session layer (`repro_torch.api`): Dataset preprocesses a data graph once;
Matcher compiles queries into cached plans and runs either engine behind
one result type. `cemr_match` / `vector_match` below are deprecated
per-call shims kept for compatibility — they re-derive the candidate
space and plan on every call, and each warns once.
"""
import warnings

from .filtering import (CandidateSpace, DataGraphIndex, build_candidate_space,
                        build_data_index, pack_bitmap_adjacency)
from .filtering_ref import build_candidate_space_reference
from .graph import (Graph, build_graph, random_walk_query, synthetic_dataset,
                    synthetic_labeled_graph)
from .ref_engine import MatchResult, MatchStats, preprocess
from .ref_engine import cemr_match as _cemr_match

__all__ = [
    "Graph", "build_graph", "random_walk_query", "synthetic_dataset",
    "synthetic_labeled_graph", "CandidateSpace", "DataGraphIndex",
    "build_candidate_space", "build_candidate_space_reference",
    "build_data_index", "pack_bitmap_adjacency",
    "MatchResult", "MatchStats", "cemr_match", "vector_match", "preprocess",
]

_DEPRECATION_WARNED: set[str] = set()


def _warn_deprecated(name: str) -> None:
    if name in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(name)
    warnings.warn(
        f"repro_torch.core.{name} is deprecated: it rebuilds the candidate "
        f"space and plan on every call. Use the session API instead — "
        f"repro_torch.api.Matcher(Dataset.from_graph(data)).count(query) — "
        f"which amortizes data-graph preprocessing and caches compiled "
        f"plans.", DeprecationWarning, stacklevel=3)


def cemr_match(*args, **kwargs):
    """Deprecated shim for `core.ref_engine.cemr_match` — see
    repro_torch.api."""
    _warn_deprecated("cemr_match")
    return _cemr_match(*args, **kwargs)


def vector_match(*args, **kwargs):
    """Deprecated shim for `core.engine.vector_match` (on the card unless
    given `device="cpu"`) — see repro_torch.api. The lazy import keeps
    `import repro_torch.core` free of torch."""
    _warn_deprecated("vector_match")
    from .engine import vector_match as _vector_match
    return _vector_match(*args, **kwargs)
