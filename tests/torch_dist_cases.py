"""Multi-process cases of the port's placement layer, run by the tests in a
subprocess of their own (each with a time limit) and written to a
directory as numpy and JSON files for the tests to hold against the JAX
package:

    python tests/torch_dist_cases.py ranks OUT     # 4 gloo ranks, (2, 2)
    python tests/torch_dist_cases.py gnn OUT       # 4 gloo ranks, (2, 2)
    python tests/torch_dist_cases.py segments OUT  # 4 gloo ranks, (2, 2)
    python tests/torch_dist_cases.py dryrun OUT    # fake groups of 8 and 1

`ranks` spawns four gloo CPU ranks on a (data, model) = (2, 2) mesh; each
joins the group with a timeout and leaves it in `finally`. On them: the
reduced qwen2-1.5b trained STEPS float32 steps on one batch under the
policy, bert4rec's sharded `score_next`, decode steps over caches sharded
by `cache_bsnd` (and MLA's by its batch entry), `compressed_psum` and
`compressed_allreduce_tree` on seeded per-rank inputs, and a checkpoint
of the distributed model. Rank 0 writes the results.

`gnn` spawns four gloo CPU ranks on (2, 2) and trains each reduced GNN of
GNN_CELLS one float32 step through the policy (nodes, edges and
triplets split over both mesh dims, flattened to one, parameters whole), from the weights
OUT/<arch>-<shape>.npz when the caller wrote them (else the seed-0 init),
under `IndexGuard`: every op DTensor dispatches in the step is recorded,
and the index, gather, scatter and embedding ops that meet a DTensor are
listed (those with one dim split over two mesh dims marked). Rank 0 writes the loss,
gnorm, updated parameters and the guard's lists. Then reduced qwen3-moe
placed block by block as it is drawn (`init_fn(mesh=)`) is compared with
the same model placed whole.

`segments` spawns four gloo CPU ranks on (2, 2), flattened to one dim as
a GNN is placed, and runs `core.segment_sum` inside `shard_rows` on each
rank's rows of the seeded SEGMENT_CASES: ranges of 1 and 6 segments (not
a multiple of four: summed whole on every rank) and of 8 and 16 (split:
reduce-scattered), two of them with empty segments, each with the
gradient of a seeded weighted sum of the result. Rank 0 writes every
rank's result and gradient.

`dryrun` traces reduced cells, the engine cell and a known sequence of
redistributes on fake groups of 8 ranks ((4, 2)) and of 1 ((1, 1)).
"""
from __future__ import annotations

import datetime
import json
import os
import socket
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
STEPS = 6
TRAIN_BATCH, TRAIN_SEQ = 8, 32
DECODE_BATCH, DECODE_LEN, DECODE_STEPS = 4, 64, 4
N_ITEMS = 512
TIMEOUT = datetime.timedelta(seconds=240)
GNN_CELLS = (("gatedgcn", "full_graph_sm"), ("gatedgcn", "molecule"),
             ("nequip", "molecule"), ("equiformer-v2", "molecule"),
             ("dimenet", "molecule"), ("equiformer-v2", "minibatch_lg"))
# (segments, rows, empty segments): `segment_inputs`
SEGMENT_CASES = ((1, 64, False), (6, 64, True), (8, 64, False),
                 (16, 96, True))


def train_batch(vocab: int) -> np.ndarray:
    return np.random.default_rng(11).integers(
        0, vocab, (TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)


def segment_inputs(n: int, rows: int, empty: bool) -> tuple:
    """A SEGMENT_CASES case's seeded values (rows, 3) float32, segment ids
    (rows,) int32 (only even ones with `empty`, so the odd segments are
    empty) and the weights (n, 3) of the sum whose gradient is taken."""
    rng = np.random.default_rng(1000 + n)
    values = rng.standard_normal((rows, 3)).astype(np.float32)
    ids = rng.integers(0, n, rows).astype(np.int32)
    if empty:
        ids -= ids % 2
    return values, ids, rng.standard_normal((n, 3)).astype(np.float32)


def compression_inputs(rank: int) -> dict:
    rng = np.random.default_rng(100 + rank)
    return {"a": rng.standard_normal((6, 5)).astype(np.float32),
            "b": (3.0 * rng.standard_normal(7)).astype(np.float32)}


def decode_inputs(vocab: int) -> dict:
    rng = np.random.default_rng(5)
    return {"token": rng.integers(0, vocab, DECODE_BATCH).astype(np.int32),
            "lengths": rng.integers(1, DECODE_LEN - DECODE_STEPS - 1,
                                    DECODE_BATCH).astype(np.int32)}


def _rank(rank: int, port: int, out: str, mode: str = "ranks") -> None:
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank, timeout=TIMEOUT)
    try:
        results = {"ranks": _cases, "gnn": _gnn_cases,
                   "segments": _segment_cases}[mode](rank, out)
        if rank == 0:
            np.savez(os.path.join(out, f"{mode}.npz"),
                     **results.pop("arrays"))
            with open(os.path.join(out, f"{mode}.json"), "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


class IndexGuard:
    """A dispatch mode over a block: counts the ops dispatched with a
    DTensor argument and lists each index, gather, scatter or embedding op
    (forward or backward) dispatched with one, marking those of whose
    DTensor arguments has a tensor dim split over two or more mesh dims,
    which DTensor in some torch releases (2.11) cannot place. The port's
    GNNs run every such op on each rank's own rows, on plain tensors."""

    OPS = ("index", "gather", "scatter", "embedding", "take")

    def __init__(self):
        self.ops, self.backward_ops, self.names, self.flagged = 0, 0, set(), []

    def __enter__(self):
        from torch.distributed.tensor import DTensor, Shard
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves
        guard = self

        def twice_split(t) -> bool:
            dims = [p.dim for p in t.placements if isinstance(p, Shard)]
            return len(dims) != len(set(dims))

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                dts = [a for a in tree_leaves((args, kwargs))
                       if isinstance(a, DTensor)]
                if dts:
                    name = func.overloadpacket.__name__.strip("_")
                    guard.ops += 1
                    # an op of the autograd engine's backward pass
                    guard.backward_ops += \
                        torch._C._current_graph_task_id() != -1
                    guard.names.add(name)
                    if name.startswith(IndexGuard.OPS):
                        guard.flagged.append(
                            [str(func), [str(list(t.placements))
                                         for t in dts],
                             any(twice_split(t) for t in dts)])
                return func(*args, **kwargs)

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def _gnn_cases(rank: int, out: str) -> dict:
    from repro_torch.distributed import policy
    from repro_torch.distributed.sharding import full, sharding_ctx
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.api import build_bundle
    from repro_torch.config import GNN_SHAPES

    mesh = make_local_mesh(2, 2, device="cpu")
    res = {"arrays": {}}
    for arch, shape in GNN_CELLS:
        key = f"{arch}-{shape}"
        b = build_bundle(arch, reduced=True, device="cpu")
        model = b.init_fn_for(shape)(0)
        weights = os.path.join(out, f"{key}.npz")
        if os.path.exists(weights):
            model.load_state_dict({k: torch.from_numpy(v) for k, v
                                   in np.load(weights).items()}, strict=True)
        flat = policy.placement_mesh("gnn", mesh)
        policy.distribute_model(model, b.cfg, flat)
        kind = GNN_SHAPES[shape]["kind"]
        batch = policy.distribute_inputs(b.make_inputs(shape), flat, "gnn")
        state = b.optimizer.init(dict(model.named_parameters()))
        rules = policy.activation_rules(b.cfg, flat, kind)
        with IndexGuard() as guard, sharding_ctx(flat, rules):
            _, state, m = b.steps[kind](model, state, batch)
        res[key] = {"loss": float(m["loss"]), "gnorm": float(m["gnorm"]),
                    "mesh": dict(zip(flat.mesh_dim_names, flat.shape)),
                    "dtensor_ops": guard.ops,
                    "backward_dtensor_ops": guard.backward_ops,
                    "op_names": sorted(guard.names),
                    "flagged": guard.flagged,
                    "placements": {k: [str(p) for p in v.placements]
                                   for k, v in batch.items()}}
        for k, v in model.named_parameters():
            res["arrays"][f"{key}/{k}"] = full(v.detach()).numpy()
    # an LM placed block by block as it is drawn (`init_fn(mesh=)`) against
    # the same model placed whole
    lb = build_bundle("qwen3-moe-30b-a3b", reduced=True, device="cpu")
    by_block = lb.init_fn(0, mesh=mesh)
    whole = policy.distribute_model(lb.init_fn(0), lb.cfg, mesh)
    wp = dict(whole.named_parameters())
    res["placed_init"] = {
        "names_equal": sorted(wp) == sorted(
            k for k, _ in by_block.named_parameters()),
        "placements_equal": all(
            tuple(p.placements) == tuple(wp[k].placements)
            for k, p in by_block.named_parameters()),
        "values_equal": all(torch.equal(full(p.detach()), full(wp[k].detach()))
                            for k, p in by_block.named_parameters()),
        "experts": [str(q) for q in by_block.blocks[0].ffn.wi.placements]}
    return res


def _segment_cases(rank: int, out: str) -> dict:
    import torch.distributed as dist
    from repro_torch.distributed import policy
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.nn import core

    flat = policy.placement_mesh("gnn", make_local_mesh(2, 2, device="cpu"))
    res = {"arrays": {}}
    for n, rows, empty in SEGMENT_CASES:
        values, ids, w = segment_inputs(n, rows, empty)
        per = rows // WORLD
        mine = slice(rank * per, (rank + 1) * per)
        v = torch.from_numpy(values[mine]).requires_grad_()
        with core.shard_rows(flat):
            got = core.segment_sum(v, torch.from_numpy(ids[mine]), n)
        whole = n % WORLD != 0
        wt = torch.from_numpy(w)
        if not whole:       # this rank's rows of the result
            wt = wt[rank * (n // WORLD):(rank + 1) * (n // WORLD)]
        (got * wt).sum().backward()
        outs = [torch.empty_like(got) for _ in range(WORLD)]
        dist.all_gather(outs, got.detach())
        grads = [torch.empty_like(v) for _ in range(WORLD)]
        dist.all_gather(grads, v.grad)
        key = f"{n}-{rows}-{int(empty)}"
        res["arrays"][f"{key}/out"] = (outs[0] if whole
                                       else torch.cat(outs)).numpy()
        res["arrays"][f"{key}/grad"] = torch.cat(grads).numpy()
        res[key] = {"rows_back": list(got.shape),
                    "equal_on_every_rank": all(torch.equal(o, outs[0])
                                               for o in outs)}
    return res


def _cases(rank: int, out: str) -> dict:
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import policy
    from repro_torch.distributed.sharding import (full, sharding_ctx,
                                                  to_placements)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.api import build_bundle
    from repro_torch.train import checkpoint, compression

    mesh = make_local_mesh(2, 2, device="cpu")
    res = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "arrays": {}}
    arrays = res["arrays"]

    def place(t, spec):
        return distribute_tensor(t, mesh, to_placements(spec, mesh),
                                 src_data_rank=None)

    # training: STEPS float32 steps on one batch
    b = build_bundle("qwen2-1.5b", reduced=True, device="cpu")
    model = policy.distribute_model(b.init_fn(0), b.cfg, mesh)
    state = b.optimizer.init(dict(model.named_parameters()))
    tokens = torch.from_numpy(train_batch(b.cfg.vocab))
    spec = policy.batch_pspecs("lm", "train", mesh,
                               batch=TRAIN_BATCH)["tokens"]
    rules = policy.activation_rules(b.cfg, mesh, "train", batch=TRAIN_BATCH)
    losses, gnorms = [], []
    for _ in range(STEPS):
        with sharding_ctx(mesh, rules):
            _, state, m = b.steps["train"](
                model, state, {"tokens": place(tokens, spec)},
                dtype=torch.float32)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    res["train"] = {"losses": losses, "gnorms": gnorms}
    wi = model.blocks[0].ffn.wi.w
    res["wi"] = {"shape": list(wi.shape),
                 "local": list(wi.to_local().shape),
                 "placements": [str(p) for p in wi.placements]}
    params = {k: full(v.detach()) for k, v in model.named_parameters()}
    for k, v in params.items():
        arrays[f"param/{k}"] = v.numpy()
    # checkpoint of the distributed state: only rank 0 writes
    ck_dir = os.path.join(out, "ckpt")
    written = checkpoint.save_checkpoint(
        ck_dir, STEPS, {"params": dict(model.named_parameters()),
                        "opt": state})
    import torch.distributed as dist
    res["ckpt_written"] = [None] * WORLD
    dist.all_gather_object(res["ckpt_written"], bool(written))
    restored, _ = checkpoint.load_checkpoint(
        ck_dir, {"params": dict(model.named_parameters()), "opt": state})
    res["ckpt_restored_placements_equal"] = all(
        tuple(restored["params"][k].placements) == tuple(p.placements)
        for k, p in model.named_parameters())
    res["ckpt_restored_equal"] = all(
        torch.equal(full(restored["params"][k]), params[k])
        for k in params)
    del model, state

    # the MoE FFN on each rank's shard: qwen3-moe's experts split over
    # model (expert parallel); granite's, 6 experts on a model axis of 4,
    # at a slice of d_expert each (tensor parallel inside the experts)
    for arch, shape, over in (("qwen3-moe-30b-a3b", (2, 2), None),
                              ("granite-moe-3b-a800m", (1, 4),
                               {"moe_experts": 6})):
        mb = build_bundle(arch, reduced=True, override=over, device="cpu")
        mmesh = make_local_mesh(*shape, device="cpu")
        mmodel = policy.distribute_model(mb.init_fn(0), mb.cfg, mmesh)
        mstate = mb.optimizer.init(dict(mmodel.named_parameters()))
        mtok = torch.from_numpy(train_batch(mb.cfg.vocab))
        mspec = policy.batch_pspecs("lm", "train", mmesh,
                                    batch=TRAIN_BATCH)["tokens"]
        mrules = policy.activation_rules(mb.cfg, mmesh, "train",
                                         batch=TRAIN_BATCH)
        out = []
        for _ in range(2):
            with sharding_ctx(mmesh, mrules):
                _, mstate, m = mb.steps["train"](
                    mmodel, mstate, {"tokens": distribute_tensor(
                        mtok, mmesh, to_placements(mspec, mmesh),
                        src_data_rank=None)}, dtype=torch.float32)
            out.append(float(m["loss"]))
        res[f"moe/{arch}"] = {"losses": out, "wi": [
            str(q) for q in mmodel.blocks[0].ffn.wi.placements]}

    # bert4rec score_next, the item table vocab-sharded over model
    rb = build_bundle("bert4rec", reduced=True, override={"n_items": N_ITEMS},
                      device="cpu")
    rmodel = policy.distribute_model(rb.init_fn(0), rb.cfg, mesh)
    ids = rb.make_inputs("serve_p99")["ids"]
    rrules = policy.activation_rules(rb.cfg, mesh, "serve",
                                     batch=ids.shape[0])
    with sharding_ctx(mesh, rrules):
        vals, idx = rb.steps["serve"](rmodel, {"ids": place(
            ids, policy.batch_pspecs("recsys", "serve", mesh,
                                     batch=ids.shape[0])["ids"])})
    arrays["bert4rec/values"] = full(vals).numpy()
    arrays["bert4rec/indices"] = full(idx).numpy()
    res["bert4rec_table_local"] = list(
        rmodel.embed.table.to_local().shape)

    # decode over sharded caches: GQA (S over model, B over data) and MLA
    for arch in ("qwen2-1.5b", "minicpm3-4b"):
        db = build_bundle(arch, reduced=True, device="cpu")
        placed_model = policy.distribute_model(db.init_fn(0), db.cfg, mesh)
        feed = {k: torch.from_numpy(v)
                for k, v in decode_inputs(db.cfg.vocab).items()}
        drules = policy.activation_rules(db.cfg, mesh, "decode",
                                         batch=DECODE_BATCH)
        with sharding_ctx(mesh, drules):
            caches = db.init_caches(DECODE_BATCH, DECODE_LEN,
                                    dtype=torch.float32)
        res[f"{arch}/cache_placements"] = [
            str(p) for p in next(iter(caches.values())).placements]
        for i in range(DECODE_STEPS):
            with sharding_ctx(mesh, drules):
                logits, caches = db.steps["decode"](placed_model, caches,
                                                    feed, dtype=torch.float32)
            arrays[f"decode/{arch}/{i}"] = full(logits).numpy()
            feed = {"token": torch.argmax(full(logits), -1).to(torch.int32),
                    "lengths": feed["lengths"] + 1}

    # compressed all-reduce: each rank's own seeded inputs
    x = {k: torch.from_numpy(v) for k, v in compression_inputs(rank).items()}
    data = mesh.mesh_dim_names.index("data")
    arrays["psum/a"] = compression.compressed_psum(x["a"], (mesh, data)) \
        .numpy()
    tree = compression.compressed_allreduce_tree(x, mesh, axes=("data",))
    for k, v in tree.items():
        arrays[f"tree/{k}"] = v.numpy()
    res["data_group"] = _group_ranks(mesh, data)
    return res


def _group_ranks(mesh, dim: int) -> list:
    import torch.distributed as dist
    return dist.get_process_group_ranks(mesh.get_group(dim))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(out: str, mode: str = "ranks") -> None:
    import torch.multiprocessing as mp
    mp.spawn(_rank, args=(free_port(), out, mode), nprocs=WORLD, join=True)


def run_gnn(out: str) -> None:
    run_ranks(out, "gnn")


# ------------------------------------------------------------------ dryrun
def run_dryrun(out: str) -> None:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.distributed import policy
    from repro_torch.launch import dryrun, roofline
    from repro_torch.models import api

    res = {}
    reduced = api.build_bundle

    def build_reduced(arch, **kw):
        return reduced(arch, reduced=True, **kw)

    dryrun.build_bundle = build_reduced
    cells = [("qwen2-1.5b", "train_4k"), ("qwen2-1.5b", "decode_32k"),
             ("qwen2-1.5b", "prefill_32k"), ("bert4rec", "serve_p99"),
             ("gatedgcn", "full_graph_sm"), ("nequip", "molecule"),
             ("equiformer-v2", "molecule"), ("dimenet", "molecule")]
    for world, shape in ((8, (4, 2)), (1, (1, 1))):
        with dryrun.fake_world(world):
            mesh = init_device_mesh("cpu", shape,
                                    mesh_dim_names=("data", "model"))
            key = "x".join(map(str, shape))
            res[f"engine/{key}"] = dryrun.dryrun_engine_cell(
                mesh, frontier_rows=1024, space=4096, k_bwd=2,
                verbose=False)
            for arch, sid in cells:
                res[f"{arch}/{sid}/{key}"] = dryrun.dryrun_cell(
                    arch, sid, mesh, verbose=False)
            # the policy's local shard bytes of the prefill cell's arguments
            b = build_reduced("qwen2-1.5b", device="cpu")
            with FakeTensorMode():
                model = b.init_fn(0)
            specs = policy.param_pspecs(model, b.cfg, mesh)
            sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
            n = 0
            for name, p in model.named_parameters():
                local = list(p.shape)
                for d in range(len(specs[name])):
                    for a in specs[name].axes_of(d):
                        local[d] //= sizes[a]
                n += int(np.prod(local)) * p.element_size()
            # the tokens split over data where the batch divides
            tok = b.input_specs("prefill_32k")["tokens"][0]
            rows = (tok[0] // sizes["data"] if tok[0] % sizes["data"] == 0
                    else tok[0])
            n += rows * tok[1] * 4
            res[f"policy_bytes/{key}"] = n
            if world == 1:
                # FLOPs of the plain (undistributed) steps
                from repro_torch.launch.roofline import count_flops
                flops = {}
                with FakeTensorMode():
                    for kind, sid in (("train", "train_4k"),
                                      ("prefill", "prefill_32k")):
                        m = b.init_fn(0)
                        inputs = {k: torch.zeros(s, dtype=t) for k, (s, t)
                                  in b.input_specs(sid).items()}
                        args = ((m, b.optimizer.init(
                            dict(m.named_parameters())), inputs)
                                if kind == "train" else (m, inputs))
                        flops[sid] = count_flops(b.steps[kind], *args)[1]
                res["plain_flops"] = flops
            else:
                # a known sequence of redistributes: bytes by kind
                from torch.distributed.tensor import distribute_tensor
                with FakeTensorMode():
                    x = distribute_tensor(torch.zeros(16, 8), mesh,
                                          [Shard(0), Shard(1)])
                    p = distribute_tensor(torch.zeros(16, 8), mesh,
                                          [Replicate(), Replicate()])
                    with roofline.StepTrace() as t:
                        # all-gather over model: out (4, 8) float32
                        a = x.redistribute(mesh, [Shard(0), Replicate()])
                        # all-gather over data: out (16, 8)
                        a.redistribute(mesh, [Replicate(), Replicate()])
                        q = type(x).from_local(
                            torch.zeros(16, 8), mesh,
                            [Partial(), Replicate()], run_check=False)
                        # reduce-scatter over data: out (4, 8)
                        q.redistribute(mesh, [Shard(0), Replicate()])
                        r = type(x).from_local(
                            torch.zeros(16, 8, dtype=torch.bfloat16), mesh,
                            [Replicate(), Partial()], run_check=False)
                        # all-reduce over model: out (16, 8) bf16
                        r.redistribute(mesh, [Replicate(), Replicate()])
                        del p
                res["collectives"] = roofline.collective_bytes(t)
                res["collective_calls"] = t.collectives
    with open(os.path.join(out, "dryrun.json"), "w") as f:
        json.dump(res, f, default=str)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    mode, out_dir = sys.argv[1], sys.argv[2]
    os.makedirs(out_dir, exist_ok=True)
    {"ranks": run_ranks, "gnn": run_gnn, "dryrun": run_dryrun,
     "segments": lambda out: run_ranks(out, "segments")}[mode](out_dir)
