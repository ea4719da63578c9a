"""How far equiformer-v2's float32 loss moves with the order of its sums,
on one card.

    python3 chip_gnn_gap.py          # one card: full width, 512 seeds
    python3 chip_gnn_gap.py --cpu    # the reduced config on the CPU

`chip_dist.py` holds equiformer-v2 x minibatch_lg's placed float32 train
step against one card's within PLACE_LOSS_RTOL (1e-5). That shape has one
graph, so the loss is the square of one predicted energy: the sum of every
node's energy (`gnn_models._graph_readout`), hundreds of thousands of
float32 terms whose sum depends on their order. This script runs the same
float32 train step (a fresh seed-0 model, the seed-0 batch at
`chip_dist.GNN_CHECK_SEEDS` seeds, TF32 off) on one card under each order
below, and prints each run's loss and gnorm beside their relative distance
from the first `det` run:

  atomics      torch's defaults: `segment_sum`'s index_add by atomics
               (ATOMIC_RUNS runs: their spread);
  det          `chip_dist.deterministic()`: torch's deterministic
               algorithms (2 runs: equal bit for bit, or the script fails);
  det_max      det, with `segment_max` as a max over a padded block of
               each segment's rows (an exact max without a scatter: the
               same bits expected);
  det_split    det, every `segment_sum` as the partial sums of SPLIT row
               blocks added in block order (how SPLIT ranks add their
               partials: `segment_sum` on a mesh does so where the range
               splits over the ranks, and sums one that does not, such as
               this readout, whole);
  det_readout  det, the graph readout's one-segment sum alone split so;
  det_rows     det, every dense layer, SO(2) convolution, edge-frame
               rotation and gather by an edge index on SPLIT row blocks,
               concatenated (the shapes each of SPLIT ranks runs, and the
               gathers' gradients summed over the blocks);
  det_placed   det_split and det_rows together: SPLIT ranks' arithmetic
               on one card.

A variant that raises (out of memory, or an op with no deterministic
kernel) is recorded with its error and the others run on. Prints the card
line, one JSON line of the runs and, last, `{"ok": true, "device":
{...}}`.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
ARCH, SHAPE = "equiformer-v2", "minibatch_lg"
ATOMIC_RUNS = 3
SPLIT = 4


@contextlib.contextmanager
def patched(obj, name: str, fn):
    saved = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def split_sum(segment_sum, only=None):
    """`segment_sum` over SPLIT row blocks, the partials added in block
    order; with `only`, for that many segments alone."""
    def run(values, ids, num_segments):
        if only is not None and num_segments != only:
            return segment_sum(values, ids, num_segments)
        parts = [segment_sum(v, i, num_segments) for v, i in
                 zip(values.tensor_split(SPLIT), ids.tensor_split(SPLIT))]
        return functools.reduce(torch.add, parts)
    return run


def padded_max(values, ids, num_segments):
    """`core.segment_max` without a scatter: the rows sorted by segment
    (stably) into a (segments, largest segment, ...) block of -inf, then
    its max over the block's second axis."""
    ids = ids.long()
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    counts = torch.bincount(ids, minlength=num_segments)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(ids.shape[0], device=ids.device) - starts[sid]
    out = values.new_full((num_segments, max(int(counts.max()), 1))
                          + values.shape[1:], -torch.inf)
    out[sid, pos] = values[order]
    return out.amax(1)


def row_blocks(core, eq, rows: set):
    """The patches of det_rows: each per-row function on SPLIT blocks of
    its rows when its first tensor has a whole row count of `rows`."""
    dense, so2, rotate, gather = (core.dense, eq.so2_conv,
                                  eq.rotate_to_edge_frame, core.gather_rows)

    def blocks(x):
        return x.shape[0] in rows

    def cat_dicts(outs):
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def split_dict(feats):
        parts = {k: v.tensor_split(SPLIT) for k, v in feats.items()}
        return [{k: parts[k][i] for k in feats} for i in range(SPLIT)]

    def dense_b(p, x):
        if not blocks(x):
            return dense(p, x)
        return torch.cat([dense(p, b) for b in x.tensor_split(SPLIT)])

    def so2_b(p, feats, l_max, c_out):
        if not blocks(feats[0]):
            return so2(p, feats, l_max, c_out)
        return cat_dicts([so2(p, f, l_max, c_out)
                          for f in split_dict(feats)])

    def rotate_b(feats, alpha, beta, l_max, inverse=False):
        if not blocks(alpha):
            return rotate(feats, alpha, beta, l_max, inverse=inverse)
        return cat_dicts([rotate(f, a, b, l_max, inverse=inverse)
                          for f, a, b in zip(split_dict(feats),
                                             alpha.tensor_split(SPLIT),
                                             beta.tensor_split(SPLIT))])

    def gather_b(x, idx):
        if not blocks(idx):
            return gather(x, idx)
        return torch.cat([gather(x, i) for i in idx.tensor_split(SPLIT)])

    return [(core, "dense", dense_b), (eq, "so2_conv", so2_b),
            (eq, "rotate_to_edge_frame", rotate_b),
            (core, "gather_rows", gather_b)]


def variants(core, eq, rows: set, n_graphs: int) -> dict:
    """Each variant's name → the (object, attribute, function) patches it
    runs under, and whether it runs under `deterministic()`."""
    rows_patches = row_blocks(core, eq, rows)
    split = [(core, "segment_sum", split_sum(core.segment_sum))]
    return {
        **{f"atomics {i}": (False, []) for i in range(ATOMIC_RUNS)},
        "det 0": (True, []), "det 1": (True, []),
        "det_max": (True, [(core, "segment_max", padded_max)]),
        "det_split": (True, split),
        "det_readout": (True, [(core, "segment_sum", split_sum(
            core.segment_sum, only=n_graphs))]),
        "det_rows": (True, rows_patches),
        "det_placed": (True, split + rows_patches),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="the reduced config on the CPU")
    args = ap.parse_args(argv)
    # cuBLAS runs deterministically only with this set before its first
    # call (torch raises under deterministic algorithms otherwise)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not args.cpu and not torch.cuda.is_available():
        print("chip_gnn_gap: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_dist
    import chip_smoke as cs
    from repro_torch.models.api import build_bundle
    from repro_torch.nn import core
    from repro_torch.nn import equivariant as eq
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cpu" if args.cpu else "cuda")
    card = "cpu" if args.cpu else cs.card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    seeds = (chip_dist.GNN_CHECK_SEEDS_REDUCED if args.cpu
             else chip_dist.GNN_CHECK_SEEDS)
    bundle = build_bundle(ARCH, reduced=args.cpu, device=dev)
    t0 = time.perf_counter()
    batch = bundle.make_inputs(SHAPE, seed=0, batch=seeds)
    rows = {batch["node_mask"].shape[0], batch["edge_mask"].shape[0]}
    n_graphs = batch["energies"].shape[0]
    out = {"arch": ARCH, "shape": SHAPE, "seeds": seeds,
           "nodes": batch["node_mask"].shape[0],
           "edges": batch["edge_mask"].shape[0], "graphs": n_graphs,
           "split": SPLIT, "make_inputs_s": time.perf_counter() - t0,
           "runs": {}}
    for name, (det, patches) in variants(core, eq, rows, n_graphs).items():
        with contextlib.ExitStack() as stack:
            if det:
                stack.enter_context(chip_dist.deterministic())
            for obj, attr, fn in patches:
                stack.enter_context(patched(obj, attr, fn))
            try:
                r = cs._gnn_step(bundle, SHAPE, None, batch, dev)
            except Exception as e:  # noqa: BLE001 — recorded, runs on
                r = {"error": f"{type(e).__name__}: {str(e)[:300]}"}
        cs.release(dev)
        out["runs"][name] = r
        print(f"{name}: " + json.dumps(r), flush=True)
    base = out["runs"]["det 0"]
    if "error" in base:
        raise SystemExit(f"the deterministic step failed: {base['error']}")
    for r in out["runs"].values():
        if "error" not in r:
            r["loss_rel"] = abs(r["loss"] - base["loss"]) / abs(base["loss"])
            r["gnorm_rel"] = (abs(r["gnorm"] - base["gnorm"])
                              / abs(base["gnorm"]))
    atomics = [r["loss"] for k, r in out["runs"].items()
               if k.startswith("atomics") and "error" not in r]
    if atomics:
        out["atomics_loss_spread"] = (max(atomics) - min(atomics)) / abs(
            base["loss"])
    again = out["runs"]["det 1"]
    if (again.get("loss"), again.get("gnorm")) != (base["loss"],
                                                   base["gnorm"]):
        raise SystemExit(f"two deterministic steps differ: {base} and "
                         f"{again}")
    for name, r in out["runs"].items():
        if "error" not in r:
            print(f"{name} on {card}: loss {r['loss']!r} ({r['loss_rel']:.3g}"
                  f" from det), gnorm {r['gnorm']!r} ({r['gnorm_rel']:.3g})",
                  flush=True)
    print(card)
    print(json.dumps(out), flush=True)
    if not args.cpu:
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
