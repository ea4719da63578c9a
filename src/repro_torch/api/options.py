"""MatchOptions: one validated, frozen configuration object for both engines.

Copy of `repro.api.MatchOptions` with every field kept and validated as
the reference validates it. Being frozen and data-only, an options instance
is hashable and safely shareable between a Matcher, its plan cache keys,
and per-call overrides.
"""
from __future__ import annotations

import dataclasses

from ..core.plan import INTERSECT_MODES

__all__ = ["MatchOptions", "ENGINES", "ENCODINGS", "ORDER_HEURISTICS",
           "INTERSECT_MODES", "BATCH_MODES", "SHARD_AUTO_MIN_ROWS",
           "auto_mesh_devices"]

ENGINES = ("ref", "vector", "auto")
ENCODINGS = ("cost", "all_black", "all_white", "case12")
ORDER_HEURISTICS = ("cemr", "ri", "gql")
# Matcher.match_many execution modes: "auto" drains vector-engine queries
# through cross-query superbatches; "off" runs them one by one.
BATCH_MODES = ("auto", "off")

# mesh="auto" cost model: below this many total candidate rows the shard
# tax (host-side rebalance + per-superstep lane padding) always exceeds
# the parallel win, so auto resolves to the single-device path.
SHARD_AUTO_MIN_ROWS = 4096


def auto_mesh_devices(total_rows: int | None, *, n_devices: int,
                      cpu_count: int, platform: str,
                      min_rows: int = SHARD_AUTO_MIN_ROWS) -> int:
    """Cost-based device count for ``mesh="auto"``: how many mesh lanes a
    workload of `total_rows` candidate rows should shard across.

    Returns 0 (→ single-device path) whenever sharding cannot win:

      * one visible device — nothing to shard across;
      * a CPU host whose physical core count does not exceed the visible
        device count — the "mesh lanes" would be timeshared threads;
      * fewer than `min_rows` total candidate rows — the per-superstep
        shard tax exceeds the work that can be spread.

    `total_rows=None` means the caller cannot size the workload; it is
    treated as large (shard if the hardware allows).
    """
    if n_devices <= 1:
        return 0
    if platform == "cpu" and cpu_count <= n_devices:
        return 0
    if total_rows is not None and total_rows < min_rows:
        return 0
    return n_devices


@dataclasses.dataclass(frozen=True)
class MatchOptions:
    """Unified matching configuration.

    engine          : "ref" (paper-faithful DFS), "vector" (tile engine),
                      or "auto" (see Matcher docstring for the heuristic).
    encoding        : black-white encoding mode (paper §6.3 / Fig. 10a).
    order_heuristic : matching-order heuristic (Eq. 2-3 / ablations).
    order           : explicit matching order (overrides the heuristic).
    tile_rows       : tile capacity of the vector engine (rows per device
                      step); ignored by the ref engine.
    use_cer         : Common Extension Reuse (ref engine; the vector engine's
                      analogue is `use_dedup`).
    use_cv          : contained-vertex pruning (both engines).
    use_fs          : failing-set backjumping (ref engine only).
    use_dedup       : brother-embedding dedup / CER (vector engine only).
    use_cer_buffer  : fused supersteps with the cross-tile CER ring buffer
                      (vector engine). False runs the stage-at-a-time
                      compat loop (with its per-tile bucketed CER when
                      use_dedup); in `match_many`'s superbatch it turns
                      the CER ring buffer off and keeps fused supersteps.
    cer_buffer_slots: ring-buffer capacity per CER-enabled stage.
    use_failure_cache: failure-reuse negative cache (vector fused path and
                      superbatch): ring buffer of failed extension read-sets
                      whose hits mask dead frontier rows before dispatch.
                      The compat stage-at-a-time loop never consults it and
                      reports its stats as zeros.
    failure_cache_slots: ring-buffer capacity per fail-cache-enabled stage.
    pack_tiles      : merge sub-capacity sibling frontiers before dispatch
                      (frontier compaction; vector engine only).
    overlap         : double-buffered supersteps (vector engine): dispatch
                      superstep N+1 before reading back N and coalesce the
                      readbacks. Changes only *when* host syncs happen,
                      never what is computed — counts and stats (modulo the
                      readbacks/overlapped_supersteps counters) are
                      bit-identical to overlap=False; see docs/engine.md
                      §Overlapped supersteps.
    intersect       : intersect kernel — "auto" and "pallas" (the CUDA
                      bitmap-intersect kernel on the card, its plain torch
                      version on the CPU), "jnp" (plain torch gathers), or
                      "fused" (fold the boundary expand+intersect+popcount
                      into the fused CUDA kernel).
    mesh            : multi-device sharded enumeration (vector engine):
                      None or 1 = single device; an int k > 1 = k lanes,
                      clamped to the visible devices (one device runs
                      the single-device path); "auto" = cost-based
                      (`auto_mesh_devices`).
    limit           : stop after this many embeddings.
    delta_limit     : cap on the embeddings a `Matcher.count_delta` pinned
                      enumeration may visit per side (created/destroyed);
                      overflowing falls back to a full recount.
    budget          : device/search step budget (`step_budget` of the ref
                      engine, `max_steps` = superstep dispatches of the vector
                      engine); None = no cap.
    refine_rounds   : candidate-space refinement iterations.
    materialize     : return explicit embeddings (Matcher.stream sets this).
    """

    engine: str = "auto"
    encoding: str = "cost"
    order_heuristic: str = "cemr"
    order: tuple[int, ...] | None = None
    tile_rows: int = 256
    use_cer: bool = True
    use_cv: bool = True
    use_fs: bool = True
    use_dedup: bool = True
    use_cer_buffer: bool = True
    cer_buffer_slots: int = 256
    use_failure_cache: bool = True
    failure_cache_slots: int = 64
    pack_tiles: bool = True
    overlap: bool = True
    intersect: str = "auto"
    mesh: str | int | None = None
    limit: int = 1_000_000
    delta_limit: int = 200_000
    budget: int | None = None
    refine_rounds: int = 3
    materialize: bool = False

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, "
                             f"got {self.engine!r}")
        if self.encoding not in ENCODINGS:
            raise ValueError(f"encoding must be one of {ENCODINGS}, "
                             f"got {self.encoding!r}")
        if self.order_heuristic not in ORDER_HEURISTICS:
            raise ValueError(f"order_heuristic must be one of "
                             f"{ORDER_HEURISTICS}, got "
                             f"{self.order_heuristic!r}")
        if self.order is not None:
            object.__setattr__(self, "order", tuple(int(u) for u in self.order))
        if not isinstance(self.tile_rows, int) or self.tile_rows < 1:
            raise ValueError(f"tile_rows must be a positive int, "
                             f"got {self.tile_rows!r}")
        if self.intersect not in INTERSECT_MODES:
            raise ValueError(f"intersect must be one of {INTERSECT_MODES}, "
                             f"got {self.intersect!r}")
        if (not isinstance(self.cer_buffer_slots, int)
                or self.cer_buffer_slots < 1):
            raise ValueError(f"cer_buffer_slots must be a positive int, "
                             f"got {self.cer_buffer_slots!r}")
        if (not isinstance(self.failure_cache_slots, int)
                or self.failure_cache_slots < 1):
            raise ValueError(f"failure_cache_slots must be a positive int, "
                             f"got {self.failure_cache_slots!r}")
        if not isinstance(self.overlap, bool):
            raise ValueError(f"overlap must be a bool, "
                             f"got {self.overlap!r}")
        if self.mesh is not None and self.mesh != "auto" and (
                not isinstance(self.mesh, int) or isinstance(self.mesh, bool)
                or self.mesh < 1):
            raise ValueError(f"mesh must be None, \"auto\", or a positive "
                             f"int device count, got {self.mesh!r}")
        if not isinstance(self.limit, int) or self.limit < 1:
            raise ValueError(f"limit must be a positive int, "
                             f"got {self.limit!r}")
        if not isinstance(self.delta_limit, int) or self.delta_limit < 1:
            raise ValueError(f"delta_limit must be a positive int, "
                             f"got {self.delta_limit!r}")
        if self.budget is not None and (not isinstance(self.budget, int)
                                        or self.budget < 1):
            raise ValueError(f"budget must be None or a positive int, "
                             f"got {self.budget!r}")
        if not isinstance(self.refine_rounds, int) or self.refine_rounds < 0:
            raise ValueError(f"refine_rounds must be a non-negative int, "
                             f"got {self.refine_rounds!r}")

    def replace(self, **overrides) -> "MatchOptions":
        """Return a copy with fields overridden (validation re-runs)."""
        return dataclasses.replace(self, **overrides)

    @property
    def plan_key(self) -> tuple:
        """The option fields that determine the compiled plan (candidate
        space + order + encoding). Everything else is a runtime knob that
        reuses the same CompiledQuery."""
        return (self.encoding, self.order_heuristic, self.order,
                self.refine_rounds)
