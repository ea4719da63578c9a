"""Multi-pod dry run: trace one step of every (architecture x shape) cell on
the production meshes, with no card and no memory, and report each
device's memory, collectives and roofline terms.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
      [--out FILE]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --engine --both-meshes

Torch counterpart of `repro.launch.dryrun`. Each (architecture x shape)
cell is traced in a worker process of its own (as many at once as the
host has cores), the engine cell in this one. The tracing process's
default group is a fake one (`torch.testing._internal.distributed.fake_pg`)
of 256 ranks ((16, 16) data x model) or 512 ((2, 16, 16) pod x data x
model), and every tensor is a `FakeTensorMode` tensor: the process plays
rank 0. A cell's
parameters become fake DTensors placed by the policy, its inputs are
sharded over the data-parallel axes (a GNN's over every axis, the mesh
flattened to one dim: `policy.placement_mesh`) where they divide
(`policy.distribute_inputs`), and one step of
the cell's kind runs eagerly (train, prefill, decode with the policy's
cache placement, serve or retrieval, a GNN's train step, its gathers and
sums by node or edge index on each rank's own rows) inside the
policy's sharding context, under `roofline.StepTrace`: rank 0's FLOPs,
collectives and peak live bytes. The HBM term is
`hbm_floor_bytes(bundle, shape, MeshShape(...))`, as in the reference;
the collective term is the bytes over NVLink (`HW["nvlink_bw"]`). This
proves the distribution config is coherent: a placement DTensor cannot
propagate, or a shape that does not split, fails here.

Deliberate differences from the reference: the step is traced at full
depth (no 1- and 2-layer extrapolation: an eager trace has no scan whose
body is counted once), and collectives are counted from the dispatched
collective ops rather than parsed from HLO text.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback

import torch

from repro_torch.configs.registry import arch_ids, shapes_for
from repro_torch.distributed import policy
from repro_torch.distributed.sharding import P, sharding_ctx, to_placements
from repro_torch.launch.hbm_model import hbm_floor_bytes
from repro_torch.launch.mesh import make_production_mesh, mesh_shape
from repro_torch.launch.roofline import (StepTrace, collective_bytes,
                                         parse_memory_analysis,
                                         roofline_terms)
from repro_torch.models.api import build_bundle

__all__ = ["fake_world", "dryrun_cell", "dryrun_engine_cell",
           "engine_extend", "main"]


@contextlib.contextmanager
def fake_world(n: int):
    """A fake default process group of `n` ranks, this process rank 0, for
    the length of the block (collectives return without moving data)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a dry run needs a process with no group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _strided_shard_offsets_on_host():
    """DTensor works out a strided shard's offsets (two sharded dims
    flattened into one, as an einsum's batch of B over data and heads over
    model) with a `torch.arange` and `.tolist()`; under `FakeTensorMode`
    that arange is fake and has no values. For the block, it is made as a
    real host tensor: it holds index arithmetic, not data."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as pt
    cls = getattr(pt, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def on_host(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)

    cls.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


@contextlib.contextmanager
def _fresh_tensor_caches():
    """The GNNs' cached constant tensors (Gaunt tensors, rotation
    conjugators) emptied before and after the block: made under one fake
    mode, they belong to it and to no later trace or real run."""
    from repro_torch.models import gnn_models
    from repro_torch.nn import equivariant
    caches = (gnn_models._gaunt, equivariant._x_rot_tensors)
    for c in caches:
        c.cache_clear()
    try:
        yield
    finally:
        for c in caches:
            c.cache_clear()


def _batch_of(specs: dict) -> int:
    for k in ("tokens", "token", "ids"):
        if k in specs:
            return specs[k][0][0]
    return 0


def _trace_cell(arch: str, shape_id: str, mesh, override=None):
    """One step of the cell under fake tensors: (bundle, kind, trace,
    arguments, outputs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    bundle = build_bundle(arch, override=override, device="cpu")
    mesh = policy.placement_mesh(bundle.family, mesh)
    spec = shapes_for(arch)[shape_id]
    kind = spec["kind"]
    step = bundle.steps[kind]
    in_specs = bundle.input_specs(shape_id)
    batch = _batch_of(in_specs)
    rules = policy.activation_rules(bundle.cfg, mesh, kind, batch=batch)
    init = (bundle.init_fn_for(shape_id) if bundle.family == "gnn"
            else bundle.init_fn)
    with FakeTensorMode(), _strided_shard_offsets_on_host(), \
            _fresh_tensor_caches():
        model = policy.distribute_model(init(0), bundle.cfg, mesh)
        inputs = policy.distribute_inputs(
            {name: torch.zeros(shape, dtype=dtype)
             for name, (shape, dtype) in in_specs.items()}, mesh,
            bundle.family)
        with sharding_ctx(mesh, rules):
            if kind == "train" or bundle.family == "gnn":
                state = bundle.optimizer.init(dict(model.named_parameters()))
                args = (model, state, inputs)
            elif kind == "decode":
                state = bundle.init_caches(batch, spec["seq_len"])
                args = (model, state, inputs)
            else:       # prefill / serve / retrieval
                args = (model, inputs)
            with StepTrace() as trace:
                out = step(*args)
        params = dict(model.named_parameters())
        arguments = (params, args[1:])
    return bundle, kind, trace, arguments, out


def dryrun_cell(arch: str, shape_id: str, mesh, *, verbose: bool = True,
                overrides: dict | None = None) -> dict:
    """Trace one (arch, shape) cell on `mesh` (a `DeviceMesh` over a fake
    group) and return the reference's row."""
    t0 = time.time()
    bundle, kind, trace, arguments, out = _trace_cell(arch, shape_id, mesh,
                                                      override=overrides)
    mem = parse_memory_analysis(trace, arguments, out)
    coll = collective_bytes(trace)
    shape = mesh_shape(mesh)
    chips = shape.size
    hbm_floor = hbm_floor_bytes(bundle, shape_id, shape)
    terms = roofline_terms(trace.flops, hbm_floor, chips, coll_bytes=coll,
                           model_flops=bundle.model_flops(shape_id))
    res = {
        "arch": arch, "shape": shape_id, "mesh": shape.shape,
        "chips": chips, "kind": kind,
        "memory": mem, "roofline": terms.row(),
        "coll_breakdown": terms.coll_breakdown,
        "coll_bytes_per_dev": terms.coll_bytes,
        "hbm_floor_per_device": hbm_floor,
        "hbm_bytes_hlo_raw": None,
        "compile_s": round(time.time() - t0, 1),
        "ok": True,
    }
    if verbose:
        print(f"[{arch} × {shape_id} × {chips}chips] "
              f"trace {res['compile_s']}s  "
              f"mem/dev={_fmt_b(mem['argument_size_in_bytes'])}+"
              f"{_fmt_b(mem['temp_size_in_bytes'])}tmp  "
              f"dominant={terms.dominant}  "
              f"t_comp={terms.compute_s:.2e}s t_mem={terms.memory_s:.2e}s "
              f"t_coll={terms.collective_s:.2e}s "
              f"useful={terms.useful_fraction:.2f}", flush=True)
    return res


def _fmt_b(b):
    if b is None:
        return "?"
    for unit in ["B", "KB", "MB", "GB", "TB"]:
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


# ------------------------------------------------------ CEMR engine cell
def engine_extend(tables, idxs):
    """The CEMR extension step on a mesh: tables k x (S, W) int32 DTensors
    replicated over the data-parallel axes and word-sharded over `model`,
    idxs (T, k) int32 sharded over the data-parallel axes. Each rank runs
    `kernels.bitmap_intersect.bitmap_intersect` on its local shards (the
    card's kernel on CUDA tensors, its plain version on the CPU and under
    fake tensors) and the popcounts are summed over `model` (an
    all-reduce). Returns DTensors R (T, W) and pop (T,) int32."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.kernels.bitmap_intersect import bitmap_intersect
    mesh = idxs.device_mesh
    r, pop = bitmap_intersect([t.to_local() for t in tables],
                              idxs.to_local())
    model = mesh.mesh_dim_names.index("model")
    row_pl = list(idxs.placements)
    r_pl = [Shard(1) if i == model else p for i, p in enumerate(row_pl)]
    pop_pl = [Partial("sum") if i == model else p
              for i, p in enumerate(row_pl)]
    r = DTensor.from_local(r, mesh, r_pl, run_check=False)
    pop = DTensor.from_local(pop.reshape(-1), mesh, pop_pl, run_check=False)
    return r, pop.redistribute(mesh, [Replicate() if i == model else p
                                      for i, p in enumerate(pop_pl)])


def engine_inputs(mesh, *, frontier_rows: int, space: int, k_bwd: int,
                  seed: int | None = None, device="cpu"):
    """The engine cell's tables and idxs as DTensors on `mesh`, placed as
    `engine_extend` takes them: zeros (`seed` None, for a fake trace), or
    seeded random words and rows, the same on every rank."""
    from torch.distributed.tensor import distribute_tensor
    words = space // 32
    dp = policy.dp_axes(mesh)
    t_pl = to_placements(P(None, "model"), mesh)
    i_pl = to_placements(P(dp, None), mesh)
    if seed is None:
        tabs = [torch.zeros((space, words), dtype=torch.int32, device=device)
                for _ in range(k_bwd)]
        idxs = torch.zeros((frontier_rows, k_bwd), dtype=torch.int32,
                           device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        tabs = [torch.randint(-2 ** 31, 2 ** 31 - 1, (space, words),
                              generator=gen, dtype=torch.int32,
                              device=device) for _ in range(k_bwd)]
        idxs = torch.randint(0, space, (frontier_rows, k_bwd), generator=gen,
                             dtype=torch.int32, device=device)
    tables = [distribute_tensor(t, mesh, t_pl, src_data_rank=None)
              for t in tabs]
    return tables, distribute_tensor(idxs, mesh, i_pl, src_data_rank=None)


def dryrun_engine_cell(mesh, *, frontier_rows: int = 65_536,
                       space: int = 262_144, k_bwd: int = 3,
                       verbose: bool = True) -> dict:
    """Dry run of the CEMR vectorized extension step on the production
    mesh: frontier rows sharded over (pod x) data, bitmap words over
    model, adjacency tables replicated over data and word-sharded over
    model (`engine_extend`). The memory term is the bytes one device must
    move: its k gathered row slices, R's and pop's shards and its idxs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    words = space // 32
    with FakeTensorMode():
        tables, idxs = engine_inputs(mesh, frontier_rows=frontier_rows,
                                     space=space, k_bwd=k_bwd)
        with StepTrace() as trace:
            r, pop = engine_extend(tables, idxs)
        arguments = (tables, idxs)
    shape = mesh_shape(mesh)
    t_dev = idxs.to_local().shape[0]
    w_dev = tables[0].to_local().shape[1]
    hbm = 4 * (t_dev * k_bwd * w_dev + t_dev * w_dev + t_dev * k_bwd + t_dev)
    terms = roofline_terms(trace.flops, hbm, shape.size,
                           coll_bytes=collective_bytes(trace),
                           model_flops=float(frontier_rows * k_bwd * words))
    res = {"arch": "cemr-engine", "shape": f"T{frontier_rows}_S{space}",
           "mesh": shape.shape, "chips": shape.size, "kind": "match",
           "memory": parse_memory_analysis(trace, arguments, (r, pop)),
           "roofline": terms.row(), "coll_breakdown": terms.coll_breakdown,
           "compile_s": round(time.time() - t0, 1), "ok": True}
    if verbose:
        print(f"[cemr-engine × {shape.size}chips] dominant={terms.dominant} "
              f"t_mem={terms.memory_s:.2e}s t_coll={terms.collective_s:.2e}s",
              flush=True)
    return res


def _production(multi_pod: bool):
    return make_production_mesh(multi_pod=multi_pod, device="cpu")


def _cell_row(mesh, arch: str, shape_id: str, overrides) -> dict:
    """`dryrun_cell`'s row, or the reference's failed row with the
    error."""
    try:
        return dryrun_cell(arch, shape_id, mesh, overrides=overrides)
    except Exception as e:   # noqa: BLE001 — report, don't die
        traceback.print_exc()
        return {"arch": arch, "shape": shape_id,
                "mesh": mesh_shape(mesh).shape, "ok": False,
                "error": f"{type(e).__name__}: {e}"}


def _cell_in_own_world(multi_pod: bool, arch: str, shape_id: str,
                       overrides) -> dict:
    """One cell in a worker process of its own fake group."""
    with fake_world(512 if multi_pod else 256):
        return _cell_row(_production(multi_pod), arch, shape_id, overrides)


def _trace_cells(tasks: list) -> list:
    """The rows of (multi_pod, arch, shape, overrides) cells, in order,
    each traced in a worker process of its own fake group, as many at
    once as the host has cores."""
    import multiprocessing as mp
    import os
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(min(len(tasks), os.cpu_count() or 1),
                             mp_context=mp.get_context("spawn")) as ex:
        return list(ex.map(_cell_in_own_world, *zip(*tasks)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--engine", action="store_true",
                    help="dry-run the CEMR engine cell")
    ap.add_argument("--out", default=None)
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=int (e.g. --set cp_degree=16)")
    args = ap.parse_args(argv)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=")
        overrides[k] = int(v)
    if not (args.engine or args.all or (args.arch and args.shape)):
        ap.error("--arch and --shape (or --all, or --engine)")

    pods = [False, True] if args.both_meshes else [args.multi_pod]
    cells = ([(a, s) for a in arch_ids() for s in shapes_for(a)]
             if args.all else [(args.arch, args.shape)])
    rows = [] if args.engine else _trace_cells(
        [(multi_pod, a, s, overrides or None)
         for multi_pod in pods for a, s in cells])
    results = []
    for multi_pod in pods:
        if not args.engine:
            results += rows[:len(cells)]
            rows = rows[len(cells):]
        if args.engine or args.all:
            with fake_world(512 if multi_pod else 256):
                results.append(dryrun_engine_cell(_production(multi_pod)))

    n_ok = sum(1 for r in results if r.get("ok"))
    print(f"\n== dry-run: {n_ok}/{len(results)} cells traced ==")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print(f"wrote {args.out}")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
