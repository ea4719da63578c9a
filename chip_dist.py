"""Phase 5e of `chip_smoke.py` alone, for a machine with several cards,
then the cells that one card runs cut, uncut on four.

    python3 chip_dist.py               # phase 5e, then the cells (4 cards)
    python3 chip_dist.py --cells-only  # the cells alone
    python3 chip_dist.py --cpu         # both on 4 gloo CPU ranks, reduced

Builds the bitmap and flash_decode kernels and runs
`chip_smoke.run_phase_5e` without its dry runs (they trace on the host
alone, whatever the cards; `chip_smoke.py` runs them): one NCCL rank a
visible card on a (data, model) mesh ((2, 2) on four cards), qwen2-1.5b
at full width trained one float32 train_4k step by the policy and held
against the undistributed step, 3 decode_32k steps over a cache sharded
by `cache_bsnd` held against the whole-cache decode in float32 and
against the plain attention in bf16 (each partials and merge call held
against its plain version), the engine cell at the reference's default
size bit for bit against the plain version and `bitmap_intersect` over
the whole tables, and each GNN's float32 train step at its published
width placed over the whole mesh (nodes, edges and triplets split over
both mesh dims) held against its undistributed step; on four cards the
FFN's `wi` must be sharded.

Then, on four cards, one NCCL rank a card again, the cells (`CELLS`) that
`chip_smoke.py` cuts to fit one card, uncut, in this order, each freed
before the next. Before each, rank 0 prints the cell's per-card argument
and temp bytes from `dryrun.dryrun_cell` on a fake group of four in a
process of its own (all cells traced together, beside the ranks, from
the start); after it, every card's measured peak beside that reading.

  1. equiformer-v2 x minibatch_lg at its 1,024 seeds (chip_smoke's phase
     5d cuts it to 512): one float32 train step over the batch split over
     both mesh dims. At 512 seeds the placed step is held against one
     card's undistributed step (loss PLACE_LOSS_RTOL, gnorm
     PLACE_GNORM_RTOL); at 1,024 its loss against one card's forward of
     the whole batch under `torch.no_grad()` (PLACE_LOSS_RTOL). Both sides
     of these float32 checks sum deterministically (`deterministic()`:
     torch's deterministic algorithms, CUBLAS_WORKSPACE_CONFIG set in
     every rank); the same comparisons in torch's default order (index_add
     by atomics) run first and are recorded, not held. The shape has one
     graph, so the loss squares one sum over every node, and its float32
     value moves with the order of that sum; on a mesh `segment_sum` sums
     such a range whole, in one card's row order (`chip_gnn_gap.py`
     measures each source on one card). At both seed counts, the same
     forward in float64, placed and on one card, within PLACE_LOSS_RTOL.
     ms a step (the default order's) and model_flops over it as a share
     of the four cards' float32 peak.
  2. qwen3-moe-30b-a3b x decode_32k at all 48 layers (phase 5c cuts it to
     12), batch 32, bf16 weights placed by the policy (experts over
     `model`) block by block as they are drawn, float32 activations over
     a bf16 cache placed by `cache_bsnd`. At 12 layers the placed logits
     are held against one card's undistributed 12-layer run within
     PLACE_LOGITS_ATOL; at 48, 3 steps through the kernels (each layer
     and step a `flash_decode_partials` and a `flash_decode_merge` launch,
     counted) are held against the same steps through their plain
     versions on the same mesh within PLACE_LOGITS_ATOL. ms a step.
  3. decode_32k at its published 128 rows (phase 5e runs 32) for
     qwen2-1.5b, chatglm3-6b (on (2, 2)) and minicpm3-4b (on (4, 1): an
     MLA cache is placed by its rows only), bf16 weights placed by the
     policy, float32 activations over a bf16 cache: 3 steps, launches
     counted (a partials and a merge a layer and step for the GQA models,
     none for MLA). Decode rows are independent: once the placed run has
     freed its caches, rank r holds rows [32 r, 32 r + 32) of each step's
     logits against one card's undistributed run on those rows within
     PLACE_LOGITS_ATOL.

What stays cut, with its bytes and reason, is listed in ROADMAP.md
(bert4rec x train_batch among them: its dry run on (2, 2) reckons 153.8
GB of temp a card).
A failed check is recorded and its cell runs on (every rank must reach
every collective); at the end the script exits non-zero, listing each
failure, as it does with fewer than two cards or when a rank fails. The
cells need four cards (with two or three, phase 5e runs alone).
Prints the card line, the results' JSON and, last, `{"ok": true,
"device": {...}}`.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CELLS_WORLD = 4
CELLS = ("equiformer-v2 minibatch_lg", "qwen3-moe-30b-a3b decode_32k",
         "qwen2-1.5b decode_32k", "chatglm3-6b decode_32k",
         "minicpm3-4b decode_32k")
# the mesh of each cell over the four ranks: (data, model); an MLA decode
# cache is placed by its rows alone (`lm_init_caches`), so minicpm3's 128
# rows split over all four cards as data
CELL_MESH = {"minicpm3-4b decode_32k": (4, 1)}
# equiformer-v2: the check of the placed step against one card's
# undistributed step at the seeds phase 5d runs (the reduced config's
# sampled batch is 16 seeds)
GNN_CHECK_SEEDS = 512
GNN_CHECK_SEEDS_REDUCED = 8
# the orders of equiformer-v2's float32 sums: the checks hold both sides
# summed deterministically (HELD_ORDER); torch's defaults, whose index_add
# adds by atomics, run beside them, recorded and not held
ORDERS = ("atomics", "deterministic")
HELD_ORDER = "deterministic"
# qwen3-moe: the layers of the one-card check (phase 5c's cut) and the
# decode batch (phase 5c's; the shape's 128 rows need 412 GB of cache)
MOE_CHECK_LAYERS = 12
MOE_DECODE_BATCH = 32
# decode_32k at the shape's rows; each rank checks one block of rows
WIDE_DECODE_BATCH = 128
DECODE_BLOCK = 32
# rank 0 waits at most this long for a cell's dry-run reading before it
# runs the cell without it (the reading is then printed at the end)
RECKON_WAIT_S = 600


# ------------------------------------------------------------ reckonings
def _reckon_one(i: int, out_dir: str, reduced: bool) -> None:
    """Cell i's dry run on a fake group of four, its mesh, at the batch
    the cell runs; writes out_dir/reckon<i>.json."""
    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.config import LM_SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.models import api
    arch, shape = CELLS[i].split()
    if reduced:
        dryrun.build_bundle = functools.partial(api.build_bundle,
                                                reduced=True)
    if arch == "qwen3-moe-30b-a3b":
        # the cell runs MOE_DECODE_BATCH of the shape's rows
        LM_SHAPES[shape] = dict(LM_SHAPES[shape],
                                global_batch=MOE_DECODE_BATCH)
    t0 = time.perf_counter()
    with dryrun.fake_world(CELLS_WORLD):
        mesh = init_device_mesh("cpu", CELL_MESH.get(CELLS[i], (2, 2)),
                                mesh_dim_names=("data", "model"))
        try:
            row = dryrun.dryrun_cell(arch, shape, mesh, verbose=False)
        except Exception as e:  # noqa: BLE001 — reported, fails the run
            row = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    row["trace_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"reckon{i}.json"), "w") as f:
        json.dump(row, f, default=str)


def reckon(out_dir: str, reduced: bool) -> None:
    """Every cell's dry run, each in a process of its own, all at once."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(len(CELLS),
                             mp_context=mp.get_context("spawn")) as ex:
        list(ex.map(_reckon_one, range(len(CELLS)),
                    [out_dir] * len(CELLS), [reduced] * len(CELLS)))


def reading(out_dir: str, i: int, wait_s: float) -> dict | None:
    path = os.path.join(out_dir, f"reckon{i}.json")
    deadline = time.monotonic() + wait_s
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(1)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def reading_line(row: dict | None) -> str:
    if row is None:
        return "no dry-run reading yet"
    if not row.get("ok"):
        return f"dry run failed: {row.get('error')}"
    mem = row["memory"]
    return (f"dry run on a fake group of {row['chips']} ({row['mesh']}): "
            f"arguments {mem['argument_size_in_bytes']:,} B, temp "
            f"{mem['temp_size_in_bytes']:,} B a card, traced in "
            f"{row['trace_s']:.1f} s")


# ------------------------------------------------------------------ cells
# A failed check is recorded in the cell's `failures` and the cell runs
# on, so that every rank reaches every collective of every cell (a rank
# that stopped would leave the others waiting); the script fails at the
# end if any rank recorded one.
def _hold(fails: list, where: str, got: float, want: float,
          rtol: float) -> float:
    rel = abs(got - want) / abs(want)
    if not rel <= rtol:
        fails.append(f"{where}: {got} against {want}, relative {rel:.3g}, "
                     f"rtol {rtol}")
    return rel


def _logits_err(fails: list, got: list, want: list, where: str,
                atol: float) -> list:
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    if not all(bool(torch.isfinite(g).all()) for g in got) \
            or max(errs) > atol:
        fails.append(f"{where}: logits max_abs_err {errs}, atol {atol}")
    return errs


def _launches(fails: list, where: str, got: dict, n: int) -> None:
    want = {k: 0 for k in got}
    want.update({"flash_decode_partials": n, "flash_decode_merge": n})
    if got != want:
        fails.append(f"{where}: launches {got}, want {want}")


def _forward_loss(bundle, shape: str, mesh, batch, dtype) -> float:
    """The loss of a fresh model of seed 0 in `dtype` on `batch` (its
    floating inputs cast to `dtype`) under `torch.no_grad()`: on one card
    with `mesh` None, else placed by the policy as `_gnn_step` places it."""
    from repro_torch.distributed import policy
    from repro_torch.distributed.sharding import full, sharding_ctx
    from repro_torch.config import GNN_SHAPES
    batch = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
    model = bundle.init_fn_for(shape)(0, dtype=dtype)
    ctx = contextlib.nullcontext
    if mesh is not None:
        mesh = policy.placement_mesh("gnn", mesh)
        policy.distribute_model(model, bundle.cfg, mesh)
        batch = policy.distribute_inputs(batch, mesh, "gnn")
        ctx = functools.partial(sharding_ctx, mesh, policy.activation_rules(
            bundle.cfg, mesh, GNN_SHAPES[shape]["kind"]))
    with torch.no_grad(), ctx():
        return float(full(model.loss(batch)[0]))


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms for the block (no warn-only mode:
    an op without a deterministic kernel raises), then the caller's
    setting again. On a card, CUBLAS_WORKSPACE_CONFIG must be set before
    the process's first cuBLAS call."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def _f32_held(cs, bundle, shape: str, mesh, batch, dev, cut, fails: list,
              where: str, order: str) -> dict:
    """Cell 1's float32 comparisons with the sums of both sides in `order`
    ("deterministic": under `deterministic()`; "atomics": torch's
    defaults): with `cut` seeds the placed step against one card's
    undistributed step (loss and gnorm), uncut the placed step's loss
    against one card's forward under `torch.no_grad()`. A failed check
    goes to `fails`."""
    ctx = deterministic if order == "deterministic" else contextlib.nullcontext
    r = {}
    with ctx():
        if cut is not None:
            r["plain"] = cs._gnn_step(bundle, shape, None, batch, dev)
            cs.release(dev)
        r["placed"] = cs._gnn_step(bundle, shape, mesh, batch, dev)
        cs.release(dev)
        if cut is None:
            model = bundle.init_fn_for(shape)(0)
            with torch.no_grad():
                r["forward_loss"] = float(model.loss(batch)[0])
            del model
            cs.release(dev)
    if cut is not None:
        r["loss_rel"] = _hold(fails, f"{where}: placed float32 loss",
                              r["placed"]["loss"], r["plain"]["loss"],
                              cs.PLACE_LOSS_RTOL)
        r["gnorm_rel"] = _hold(fails, f"{where}: placed float32 gnorm",
                               r["placed"]["gnorm"], r["plain"]["gnorm"],
                               cs.PLACE_GNORM_RTOL)
    else:
        r["loss_rel"] = _hold(fails, f"{where}: placed float32 loss against "
                              "one card's forward", r["placed"]["loss"],
                              r["forward_loss"], cs.PLACE_LOSS_RTOL)
    return r


def cell_equiformer(cs, mesh, dev, reduced: bool, fails: list) -> dict:
    """Cell 1 (module docstring)."""
    from repro_torch.models.api import build_bundle
    arch, shape = CELLS[0].split()
    bundle = build_bundle(arch, reduced=reduced, device=dev)
    seeds = GNN_CHECK_SEEDS_REDUCED if reduced else GNN_CHECK_SEEDS
    out = {}
    for cut in (seeds, None):
        where = f"{arch} at {cut or 'all its'} seeds"
        t0 = time.perf_counter()
        batch = bundle.make_inputs(shape, seed=0, batch=cut)
        r = {"make_inputs_s": time.perf_counter() - t0,
             "nodes": batch["node_mask"].shape[0],
             "edges": batch["edge_mask"].shape[0]}
        for order in ORDERS:
            r[order] = _f32_held(cs, bundle, shape, mesh, batch, dev, cut,
                                 fails if order == HELD_ORDER else [],
                                 f"{where} ({order} sums)", order)
        # the same forward in float64, placed and on one card
        r["f64_placed"] = _forward_loss(bundle, shape, mesh, batch,
                                        torch.float64)
        cs.release(dev)
        try:        # one card's float64 forward of the whole batch
            r["f64_one_card"] = _forward_loss(bundle, shape, None, batch,
                                              torch.float64)
            r["f64_rel"] = _hold(fails, f"{where}: placed float64 forward "
                                 "loss", r["f64_placed"], r["f64_one_card"],
                                 cs.PLACE_LOSS_RTOL)
        except torch.cuda.OutOfMemoryError as e:
            fails.append(f"{where}: one card's float64 forward did not fit: "
                         f"{str(e)[:200]}")
        cs.release(dev)
        del batch
        out["check" if cut is not None else "uncut"] = r
    uncut = out["uncut"]["atomics"]
    flops = bundle.model_flops(shape)
    out.update(seeds=seeds, ms_per_step=uncut["placed"]["ms"],
               model_flops=flops,
               f32_peak_share=flops / (uncut["placed"]["ms"] / 1e3)
               / (mesh.size() * cs.hw()["flops_f32"]))
    return out


def _decode(bundle, model, caches_of, feeds: list, dtype, dev, cs, *,
            use_kernel: bool = True, ctx=contextlib.nullcontext) -> tuple:
    """PLACE_DECODE_STEPS decode steps from fresh caches (`caches_of()`),
    step i fed feeds[i]; where feeds ends, appends the next step's feed
    (the argmax tokens, lengths + 1). Returns (the whole float32 logits a
    step, ms a step)."""
    from repro_torch.distributed.sharding import full
    with ctx():
        caches = caches_of()
    out, ms = [], []
    for i in range(cs.PLACE_DECODE_STEPS):
        cs.sync(dev)
        t0 = time.perf_counter()
        with ctx():
            logits, caches = bundle.steps["decode"](
                model, caches, feeds[i], dtype=dtype, use_kernel=use_kernel)
        logits = full(logits).float()
        cs.sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        if len(feeds) == i + 1:
            feeds.append({"token": torch.argmax(logits, -1).to(torch.int32),
                          "lengths": feeds[i]["lengths"] + 1})
        out.append(logits)
    del caches
    cs.release(dev)
    return out, ms


def cell_moe(cs, mesh, dev, reduced: bool, fails: list) -> dict:
    """Cell 2 (module docstring)."""
    from repro_torch.config import LM_SHAPES
    from repro_torch.distributed import policy
    from repro_torch.distributed.sharding import sharding_ctx
    from repro_torch.kernels import bitmap_intersect as bi
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.api import build_bundle
    arch, shape = CELLS[1].split()
    b = MOE_DECODE_BATCH if not reduced else 8
    seq = LM_SHAPES[shape]["seq_len"] if not reduced else 128
    out = {"batch": b}

    def run(bundle, placed: bool, feeds, **kw):
        model = bundle.init_fn(0, dtype=torch.bfloat16,
                               mesh=mesh if placed else None)
        rules = policy.activation_rules(bundle.cfg, mesh, "decode", batch=b)
        ctx = (functools.partial(sharding_ctx, mesh, rules) if placed
               else contextlib.nullcontext)
        res = _decode(bundle, model,
                      lambda: bundle.init_caches(b, seq), feeds,
                      torch.float32, dev, cs, ctx=ctx, **kw)
        del model
        cs.release(dev)
        return res

    layers = MOE_CHECK_LAYERS if not reduced else 1
    small = build_bundle(arch, reduced=reduced, device=dev,
                         override={"n_layers": layers})
    feeds = [small.make_inputs(shape, seed=0, batch=b)]
    want, _ = run(small, False, feeds)
    got, _ = run(small, True, feeds)
    out["check"] = {"layers": layers, "max_abs_err": _logits_err(
        fails, got, want, f"{arch} at {layers} layers, placed against one "
        "card", cs.PLACE_LOGITS_ATOL)}
    bundle = build_bundle(arch, reduced=reduced, device=dev)
    feeds = [bundle.make_inputs(shape, seed=0, batch=b)]
    cs.reset_kernel_launches(bi, fd)
    kernel, ms = run(bundle, True, feeds)
    out["launches"] = cs.kernel_launch_counts(bi, fd)
    plain, _ = run(bundle, True, feeds, use_kernel=False)
    # on the CPU (a rehearsal) the wrappers run their plain versions and
    # count no launch
    _launches(fails, arch, out["launches"], bundle.cfg.n_layers
              * cs.PLACE_DECODE_STEPS * (dev.type == "cuda"))
    out.update(layers=bundle.cfg.n_layers, ms=ms, max_abs_err=_logits_err(
        fails, kernel, plain, f"{arch} at {bundle.cfg.n_layers} layers, the "
        "kernels against their plain versions", cs.PLACE_LOGITS_ATOL))
    return out


def cell_wide_decode(cs, mesh, dev, reduced: bool, fails: list,
                     idx: int) -> dict:
    """Cell 3 (module docstring): CELLS[idx] at WIDE_DECODE_BATCH rows."""
    import torch.distributed as dist
    from repro_torch.config import LM_SHAPES
    from repro_torch.distributed import policy
    from repro_torch.distributed.sharding import sharding_ctx
    from repro_torch.kernels import bitmap_intersect as bi
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.api import build_bundle
    arch, shape = CELLS[idx].split()
    b = WIDE_DECODE_BATCH if not reduced else 16
    blk = DECODE_BLOCK if not reduced else 4
    seq = LM_SHAPES[shape]["seq_len"] if not reduced else 128
    bundle = build_bundle(arch, reduced=reduced, device=dev)
    rules = policy.activation_rules(bundle.cfg, mesh, "decode", batch=b)
    model = bundle.init_fn(0, dtype=torch.bfloat16, mesh=mesh)
    feeds = [bundle.make_inputs(shape, seed=0, batch=b)]
    cs.reset_kernel_launches(bi, fd)
    got, ms = _decode(bundle, model, lambda: bundle.init_caches(b, seq),
                      feeds, torch.float32, dev, cs,
                      ctx=functools.partial(sharding_ctx, mesh, rules))
    launches = cs.kernel_launch_counts(bi, fd)
    del model
    cs.release(dev)
    gqa = bundle.cfg.attention != "mla"
    _launches(fails, arch, launches, bundle.cfg.n_layers
              * cs.PLACE_DECODE_STEPS * (gqa and dev.type == "cuda"))
    rank = dist.get_rank()
    rows = slice(rank * blk, (rank + 1) * blk)
    model = bundle.init_fn(0, dtype=torch.bfloat16)
    cs.reset_kernel_launches(bi, fd)
    one, _ = _decode(bundle, model, lambda: bundle.init_caches(blk, seq),
                     [{k: v[rows] for k, v in f.items()} for f in feeds],
                     torch.float32, dev, cs)
    del model
    cs.release(dev)
    return {"batch": b, "ms": ms, "launches": launches,
            "block_launches": cs.kernel_launch_counts(bi, fd),
            "rows_held": [rows.start, rows.stop],
            "max_abs_err": _logits_err(
                fails, [g[rows] for g in got], one, f"{arch} at {b} rows, "
                f"rows {rows.start}..{rows.stop} against one card",
                cs.PLACE_LOGITS_ATOL)}


def cells_rank(rank: int, world: int, port: int, out_dir: str,
               reduced: bool) -> None:
    """One rank of the cells (spawned: NCCL on card `rank`; with
    `reduced`, gloo on the CPU at the reduced configs, for a rehearsal).
    Writes out_dir/cells<rank>.json; a failed check raises, which fails
    the spawn."""
    import torch.distributed as dist
    # before this rank's first cuBLAS call: cell 1's deterministic sums
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.launch.mesh import make_local_mesh
    if not reduced:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cpu") if reduced else torch.device("cuda", rank)
    dist.init_process_group("gloo" if reduced else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(
                                seconds=cs.PLACE_TIMEOUT_S))
    try:
        # every rank makes the meshes (process groups) in one order
        meshes = {shape: make_local_mesh(*shape, device=dev.type)
                  for shape in sorted({(2, 2), *CELL_MESH.values()})}
        fns = (cell_equiformer, cell_moe,
               *(functools.partial(cell_wide_decode, idx=i)
                 for i in range(2, len(CELLS))))
        res = {"rank": rank}
        for i, (name, fn) in enumerate(zip(CELLS, fns)):
            mesh = meshes[CELL_MESH.get(name, (2, 2))]
            if rank == 0:
                row = reading(out_dir, i, RECKON_WAIT_S)
                print(f"cell {name}: mesh {tuple(mesh.shape)}; "
                      + reading_line(row), flush=True)
            dist.barrier()
            if dev.type == "cuda":
                cs.reset_peak(dev)
            t0 = time.perf_counter()
            fails = []
            r = fn(cs, mesh, dev, reduced, fails)
            r["seconds"] = time.perf_counter() - t0
            gathered = [None] * world
            dist.all_gather_object(gathered, (
                cs.peak_bytes(dev) if dev.type == "cuda" else None, fails))
            r["peak_bytes"] = [g[0] for g in gathered]
            r["failures"] = [f"rank {i}: {f}" for i, g in enumerate(gathered)
                             for f in g[1]]
            res[name] = r
            cs.release(dev)
            if rank == 0:
                print(f"cell {name} " + json.dumps(r), flush=True)
        with open(os.path.join(out_dir, f"cells{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def run_cells(card: str, reduced: bool) -> dict:
    """The cells on CELLS_WORLD spawned ranks, their dry runs traced
    beside them. Returns rank 0's results with each cell's reading."""
    import torch.multiprocessing as mp
    import chip_smoke as cs
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
               "CUDA_VISIBLE_DEVICES": ""}
        tracer = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_dist.py"), "--reckon", tmp]
            + (["--cpu"] if reduced else []), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
        try:
            mp.spawn(cells_rank, args=(CELLS_WORLD, cs.free_port(), tmp,
                                       reduced),
                     nprocs=CELLS_WORLD, join=True)
            log = tracer.communicate(timeout=RECKON_WAIT_S)[0]
        finally:
            if tracer.poll() is None:
                import signal
                os.killpg(tracer.pid, signal.SIGKILL)
                tracer.wait()
        if tracer.returncode != 0:
            raise SystemExit(f"the dry runs exited {tracer.returncode}:\n"
                             f"{log[-3000:]}")
        with open(os.path.join(tmp, "cells0.json")) as f:
            res = json.load(f)
        readings = [reading(tmp, i, 0) for i in range(len(CELLS))]
    bad = [name for name, row in zip(CELLS, readings)
           if not (row and row.get("ok"))]
    failed = {name: res[name]["failures"] for name in CELLS
              if res[name]["failures"]}
    for name, row in zip(CELLS, readings):
        r = res[name]
        res[name]["reading"] = row
        mem = (row or {}).get("memory", {})
        print(f"cell {name} on {card}: peak per card "
              f"{r['peak_bytes']} B against the dry run's arguments "
              f"{mem.get('argument_size_in_bytes')} + temp "
              f"{mem.get('temp_size_in_bytes')} B a card; "
              f"{r['seconds']:.1f} s", flush=True)
    if bad or failed:
        raise SystemExit(f"dry runs failed for {bad}; checks failed: "
                         + json.dumps(failed, indent=1))
    print(f"cells in {time.perf_counter() - t0:.3f} s", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells-only", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="4 gloo CPU ranks at the reduced configs")
    ap.add_argument("--reckon", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    if args.reckon:
        reckon(args.reckon, args.cpu)
        return 0
    if not args.cpu and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < 2):
        print("chip_dist: needs two or more CUDA devices", file=sys.stderr)
        return 2
    import chip_smoke as cs
    t0 = time.perf_counter()
    if args.cpu:
        card = "cpu (4 gloo ranks, reduced configs)"
        cs.sync = lambda dev: None
        cs.require_placement_launches = lambda *a: None
    else:
        from repro_torch.kernels import bitmap_intersect as bi
        from repro_torch.kernels import build
        from repro_torch.kernels import flash_decode as fd
        card = cs.card_line()
        print(f"card: {card}; {torch.cuda.device_count()} cards", flush=True)
        for name, (lib, secs) in cs.build_all(
                build, (bi.LIBRARY, fd.LIBRARY)).items():
            print(f"build: {lib.name} in {secs:.3f} s", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    out = {}
    if not args.cells_only:
        res = cs.run_phase_5e(card, dryruns=False,
                              world=4 if args.cpu else None,
                              reduced=args.cpu)
        if res["ranks"] >= 4 and res["train"]["placed"]["wi_local_shape"] \
                == res["train"]["placed"]["wi_shape"]:
            raise SystemExit("wi is not sharded on a mesh of four cards")
    if args.cpu or torch.cuda.device_count() >= CELLS_WORLD:
        out["cells"] = run_cells(card, args.cpu)
    else:
        print(f"cells not run: they need {CELLS_WORLD} cards",
              flush=True)
    print(f"chip_dist: all in {time.perf_counter() - t0:.3f} s", flush=True)
    if args.cpu:
        return 0
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
