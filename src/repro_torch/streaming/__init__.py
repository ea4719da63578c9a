"""Streaming graph deltas: validated edits, incremental index maintenance,
and delta enumeration for standing queries.

Layering (docs/streaming.md): `delta` defines `GraphDelta` (the validated
edit batch) and the rebuild-from-scratch oracle; `maintain` applies a delta
to a (Graph, DataGraphIndex) pair incrementally, bit-identically to the
oracle; `standing` counts the embeddings a delta creates/destroys so a
standing query's count rolls forward without a full re-enumeration. The
user-facing surface is `Dataset.apply_delta`, `Matcher.count_delta`, and
`MatchQueueRuntime.register_standing` — this package is the machinery
underneath.

A copy of the reference's `repro.streaming` (numpy only, on the host):
the port's `Matcher` reaches the device only for full recounts.
"""
from .delta import GraphDelta, apply_delta_reference, random_delta
from .maintain import DeltaSummary, apply_delta
from .standing import DeltaOutcome, DeltaOverflow, embeddings_touching

__all__ = ["GraphDelta", "apply_delta_reference", "random_delta",
           "DeltaSummary", "apply_delta", "DeltaOutcome", "DeltaOverflow",
           "embeddings_touching"]
