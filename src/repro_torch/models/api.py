"""Model API of the port: `build_bundle(arch)` → init, optimizer, step
functions, inputs and model FLOPs for every (architecture × shape) cell of
the three families: the five LMs (train, prefill, decode), the four GNNs
(train on each GNN shape) and bert4rec (train, serve, retrieval).

    bundle = build_bundle("qwen2-1.5b", reduced=True, device="cpu")
    model = bundle.init_fn(0)
    opt_state = bundle.optimizer.init(dict(model.named_parameters()))
    model, opt_state, metrics = bundle.steps["train"](
        model, opt_state, bundle.make_inputs("train_4k"))
    logits = bundle.steps["prefill"](model, bundle.make_inputs("prefill_32k"))
    caches = bundle.init_caches(batch, max_len)
    logits, caches = bundle.steps["decode"](model, caches, batch_inputs)

    gnn = build_bundle("nequip", reduced=True, device="cpu")
    model = gnn.init_fn_for("molecule")(0)     # the shape sets d_feat
    model, opt_state, metrics = gnn.steps["train"](
        model, gnn.optimizer.init(dict(model.named_parameters())),
        gnn.make_inputs("molecule"))

    rec = build_bundle("bert4rec", reduced=True, device="cpu")
    vals, idx = rec.steps["serve"](rec.init_fn(0),
                                   rec.make_inputs("serve_p99"))

Every train step updates the model's parameters and the optimizer's
moments in place (the reference returns new trees; the values are equal).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.config import GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.data import graph_data, recsys_synth
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import full, reduce_to_placements
from repro_torch.models import bert4rec
from repro_torch.models.gnn_models import NequIP, gnn_init
from repro_torch.nn import transformer as T
from repro_torch.train.optimizer import AdamW

__all__ = ["ModelBundle", "build_bundle", "TRIPLET_CAPS"]

# DimeNet triplet caps per shape (bounds the O(Σdeg²) blow-up)
TRIPLET_CAPS = {"full_graph_sm": 8, "minibatch_lg": 8, "ogb_products": 4,
                "molecule": 16}


@dataclasses.dataclass
class ModelBundle:
    arch: str
    cfg: Any
    family: str                  # "lm" | "gnn" | "recsys"
    device: torch.device
    init_fn: Callable            # (seed=0, dtype=float32) -> model
    optimizer: AdamW
    init_caches: Callable | None  # LM: (batch, max_len, dtype=bf16) -> caches
    steps: dict                  # shape kind -> step callable
    input_specs: Callable        # (shape_id) -> {name: (shape, dtype)}
    make_inputs: Callable        # (shape_id, seed=0, batch=None) -> tensors
    model_flops: Callable        # (shape_id) -> float
    init_fn_for: Callable | None = None   # GNN: (shape_id) -> init_fn


def build_bundle(arch: str, *, reduced: bool = False,
                 override: dict | None = None, device=None) -> ModelBundle:
    """The bundle of `arch` on `device` (the card unless "cpu" is asked
    for). `reduced` selects the tiny same-family config, and the reduced
    shapes that the reference's bundle uses; `override` replaces config
    fields, as the reference's does."""
    cfg = get_config(arch, reduced=reduced)
    if override:
        cfg = dataclasses.replace(cfg, **override)
    dev = resolve_device(device)
    if cfg.family == "gnn":
        return _gnn_bundle(arch, cfg, reduced, dev)
    if cfg.family == "recsys":
        return _recsys_bundle(arch, cfg, reduced, dev)
    return _lm_bundle(arch, cfg, reduced, dev)


def _train_update(opt: AdamW, model, opt_state, loss_fn):
    """loss_fn(model) → (loss, metrics); its gradients and one AdamW update
    in place. Returns
    (model, opt_state, {"loss", "gnorm", **metrics})."""
    params = dict(model.named_parameters())
    loss, metrics = loss_fn(model)
    # a parameter the loss does not reach (the last GNN layer's l > 0
    # weights feed no readout) gets a zero gradient, as in the reference
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    grads = reduce_to_placements(grads, params.values())
    _, opt_state, gnorm = opt.update(dict(zip(params, grads)), opt_state,
                                     params)
    return model, opt_state, {
        "loss": full(loss.detach()), "gnorm": gnorm,
        **{k: full(v.detach()) for k, v in metrics.items()}}


# =============================================================== LM bundles
def _lm_bundle(arch: str, cfg, reduced: bool, dev) -> ModelBundle:
    opt = AdamW(lr=3e-4)

    def init_fn(seed: int = 0, dtype=torch.float32, mesh=None):
        """The model with each weight drawn on the device and stored in
        `dtype` as it is made (one float32 draw of one tensor at a time,
        never a float32 copy of the model). With `mesh` (a `DeviceMesh`)
        its parameters are placed by the policy, each block's as soon as
        the block is drawn, so no card holds the whole model."""
        if mesh is None:
            return T.lm_init(cfg, seed=seed, device=dev, dtype=dtype)
        from repro_torch.distributed import policy
        return policy.distribute_model(T.lm_init(
            cfg, seed=seed, device=dev, dtype=dtype,
            place=lambda blk: policy.distribute_model(blk, cfg, mesh)),
            cfg, mesh)

    def init_caches(batch: int, max_len: int, dtype=torch.bfloat16):
        """Zero decode caches in the attention's layout: GQA {"k", "v"},
        MLA {"c_kv", "k_rope"}, stacked over layers."""
        return T.lm_init_caches(cfg, batch, max_len, dtype=dtype, device=dev)

    def train_step(model, opt_state, batch, *, dtype=torch.bfloat16):
        """Microbatched (gradient-accumulation) train step: `grad_accum`
        microbatches of consecutive rows when the batch (on a mesh, each
        rank's rows) divides by it, else one; gradients summed in a
        float32 buffer and divided by their count, the loss averaged, then
        one AdamW update. Returns (model, opt_state, {"loss", "gnorm"})."""
        tokens = batch["tokens"]
        # a rank splits its own rows (all of them without a mesh)
        b = (tokens.to_local() if isinstance(tokens, DTensor)
             else tokens).shape[0]
        a = cfg.grad_accum if b % max(cfg.grad_accum, 1) == 0 else 1
        params = dict(model.named_parameters())
        leaves = list(params.values())
        gacc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for tok in _microbatches(tokens, a):
            loss, _ = T.lm_loss(model, tok, dtype=dtype)
            # the gradients live only for this statement: the update
            # below runs with the accumulation buffer alone (on a mesh,
            # each reduced to its parameter's placements first)
            torch._foreach_add_(gacc, [g.float() for g in reduce_to_placements(
                torch.autograd.grad(loss, leaves), leaves)])
            loss_sum += full(loss.detach())
        torch._foreach_div_(gacc, a)
        _, opt_state, gnorm = opt.update(dict(zip(params, gacc)), opt_state,
                                         params)
        return model, opt_state, {"loss": loss_sum / a, "gnorm": gnorm}

    def prefill_step(model, batch, *, dtype=torch.bfloat16):
        return T.lm_prefill_logits(model, batch["tokens"], dtype=dtype)

    def decode_step(model, caches, batch, *, dtype=torch.bfloat16,
                    use_kernel: bool = True):
        return T.lm_decode_step(model, batch["token"], caches,
                                batch["lengths"], dtype=dtype,
                                use_kernel=use_kernel)

    def shape_dims(shape_id, batch=None):
        spec = LM_SHAPES[shape_id]
        b, s = spec["global_batch"], spec["seq_len"]
        if reduced:
            b, s = max(b // 64, 2), min(s, 128)
        return spec["kind"], (b if batch is None else batch), s

    def input_specs(shape_id):
        kind, b, s = shape_dims(shape_id)
        if kind in ("train", "prefill"):
            return {"tokens": ((b, s), torch.int32)}
        return {"token": ((b,), torch.int32), "lengths": ((b,), torch.int32)}

    def make_inputs(shape_id, seed: int = 0, batch: int | None = None):
        """The reference's inputs for `shape_id` (same numpy draws: tokens
        (B, S) for train and prefill; for decode one token a row and
        lengths in [1, S-2]); `batch` cuts the shape's batch (the draws
        then differ from the reference's)."""
        kind, b, s = shape_dims(shape_id, batch)
        rng = np.random.default_rng(seed)
        if kind in ("train", "prefill"):
            tokens = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
            return {"tokens": torch.from_numpy(tokens).to(dev)}
        token = rng.integers(0, cfg.vocab, (b,)).astype(np.int32)
        lengths = rng.integers(1, s - 1, (b,)).astype(np.int32)
        return {"token": torch.from_numpy(token).to(dev),
                "lengths": torch.from_numpy(lengths).to(dev)}

    def model_flops(shape_id):
        """2 (6 in training) · active parameters (a MoE counts its top-k
        experts only) · tokens, as the reference counts them."""
        kind, b, s = shape_dims(shape_id)
        n_active = cfg.n_active_params()
        if kind == "train":
            return 6.0 * n_active * b * s
        if kind == "prefill":
            return 2.0 * n_active * b * s
        return 2.0 * n_active * b     # decode: one token per row

    return ModelBundle(arch=arch, cfg=cfg, family="lm", device=dev,
                       init_fn=init_fn, optimizer=opt,
                       init_caches=init_caches,
                       steps={"train": train_step, "prefill": prefill_step,
                              "decode": decode_step},
                       input_specs=input_specs, make_inputs=make_inputs,
                       model_flops=model_flops)


def _microbatches(tokens: torch.Tensor, a: int) -> list:
    """`a` microbatches of consecutive rows of `tokens` (B, S). A DTensor
    batch sharded over data splits on each rank's own rows (the local
    block's consecutive rows; with one data rank, the reference's split),
    so no row moves between ranks."""
    if a == 1:
        return [tokens]
    if isinstance(tokens, DTensor):
        # microbatches of equal size: their mean gradient is the whole
        # batch's, whichever rows each takes
        local = tokens.to_local()
        return [DTensor.from_local(t, tokens.device_mesh, tokens.placements,
                                   run_check=False)
                for t in local.reshape(a, local.shape[0] // a,
                                       local.shape[1])]
    return list(tokens.reshape(a, tokens.shape[0] // a, tokens.shape[1]))


def _to_device(arrays: dict, dev) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items()}


# ============================================================== GNN bundles
def _gnn_bundle(arch: str, cfg, reduced: bool, dev) -> ModelBundle:
    opt = AdamW(lr=1e-3)
    needs_triplets = cfg.model == "dimenet"

    def batch_of(shape_id, batch):
        """The seed nodes of a sampled shape or the molecules of a batched
        one: `batch` when given, else the shape's (the reduced config's
        16 or 4)."""
        spec = GNN_SHAPES[shape_id]
        if spec["kind"] == "full":
            if batch is not None:
                raise ValueError(f"{shape_id} is one full graph; it has no "
                                 "batch to cut")
            return None
        if batch is not None:
            return batch
        key = "batch_nodes" if spec["kind"] == "sampled" else "batch"
        return spec[key] if not reduced else (16 if key == "batch_nodes"
                                              else 4)

    def shape_geom(shape_id, batch=None):
        """(n_nodes, n_edges, d_feat, n_graphs) of the shape's padded
        batch: at full size node and edge counts round up to multiples of
        4,096 (the reference's padding for an even split over any
        data-parallel extent up to 512); padded entries are masked."""
        spec = GNN_SHAPES[shape_id]
        b = batch_of(shape_id, batch)
        if spec["kind"] == "sampled":
            from repro_torch.data.sampler import sampled_shape
            fo = spec["fanout"] if not reduced else (3, 2)
            n, e = sampled_shape(b, fo)
            d_feat, n_graphs = 128, 1
        elif spec["kind"] == "batched":
            n = b * spec["n_nodes"]
            e = b * spec["n_edges"]
            d_feat, n_graphs = None, b
        else:
            n = spec["n_nodes"] if not reduced else 64
            e = spec["n_edges"] if not reduced else 256
            d_feat = spec.get("d_feat")
            if reduced and d_feat:
                d_feat = min(d_feat, 32)
            n_graphs = 1
        if not reduced:
            n = -(-n // 4096) * 4096
            e = -(-e // 4096) * 4096
        return n, e, d_feat, n_graphs

    def init_fn_for(shape_id):
        """The init function (seed=0, dtype=float32) -> model for the
        shape's node-feature width."""
        _, _, d_feat, _ = shape_geom(shape_id)

        def init_fn(seed: int = 0, dtype=torch.float32):
            return gnn_init(cfg, d_feat, seed=seed, device=dev, dtype=dtype)
        return init_fn

    def train_step(model, opt_state, batch):
        """The model's loss (cross entropy or energy MSE), its gradients
        and one AdamW update. Returns (model, opt_state, {"loss", "gnorm",
        and the loss's metric})."""
        return _train_update(opt, model, opt_state,
                             lambda m: m.loss(batch))

    def input_specs(shape_id, batch: int | None = None):
        n, e, d_feat, n_graphs = shape_geom(shape_id, batch)
        cap = TRIPLET_CAPS[shape_id] if needs_triplets else 0
        return graph_data.graph_batch_specs(
            n, e, d_feat, n_graphs=n_graphs,
            with_triplets=needs_triplets, triplet_cap=cap)

    def make_inputs(shape_id, seed: int = 0, batch: int | None = None):
        """The reference's batch for `shape_id` (the same numpy draws and
        padding), as tensors on the device; `batch` cuts the seed nodes of
        a sampled shape or the molecules of a batched one (the draws then
        differ from the reference's)."""
        spec = GNN_SHAPES[shape_id]
        n, e, d_feat, n_graphs = shape_geom(shape_id, batch)
        cap = TRIPLET_CAPS[shape_id] if needs_triplets else 0
        if spec["kind"] == "batched":
            gb = graph_data.molecule_batch(
                n_graphs, spec["n_nodes"], spec["n_edges"], seed=seed,
                with_triplets=needs_triplets)
        elif spec["kind"] == "sampled":
            from repro_torch.core.graph import synthetic_labeled_graph
            from repro_torch.data.sampler import NeighborSampler
            bn = batch_of(shape_id, batch)
            fo = spec["fanout"] if not reduced else (3, 2)
            g = synthetic_labeled_graph(
                spec["n_nodes"] if not reduced else 500, 12.0, 4, seed=seed)
            smp = NeighborSampler(g.indptr, g.indices, d_feat=d_feat or 128,
                                  seed=seed)
            rng = np.random.default_rng(seed)
            gb = smp.sample(rng.integers(0, g.n, bn), fo)
            if needs_triplets:
                gb.triplets = graph_data.build_triplets(gb, cap_per_edge=cap)
        else:
            gb = graph_data.synth_full_graph(
                n, e // 2, d_feat or 16, seed=seed,
                with_triplets=needs_triplets, triplet_cap_per_edge=cap)
            # pad/trim symmetrized edges to the spec size
            gb = _fit_edges(gb, e, needs_triplets, cap)
        return _to_device(graph_data.batch_to_arrays(gb), dev)

    def model_flops(shape_id, batch: int | None = None):
        """The reference's count: n_layers · (per-edge · E + per-node · N)
        over the padded shape (cut to `batch` as make_inputs cuts it); the
        layers' forward products only."""
        n, e, d_feat, _ = shape_geom(shape_id, batch)
        c = cfg.d_hidden
        if cfg.model == "gatedgcn":
            per_edge = 2 * c * c * 3
            per_node = 2 * c * c * 2
        elif cfg.model == "nequip":
            lm = cfg.extra.get("l_max", 2)
            paths = len(NequIP.paths(lm))
            per_edge = paths * (2 * c * 9 + 2 * 8 * 32 + 2 * 32 * c)
            per_node = 2 * c * c * 2 * (lm + 1)
        elif cfg.model == "equiformer_v2":
            lm = cfg.extra.get("l_max", 6)
            n_coef = (lm + 1) ** 2
            so2 = sum(2 * ((lm + 1 - m) * c) ** 2 * (2 if m else 1)
                      for m in range(lm + 1))
            per_edge = so2 + 4 * n_coef * c * (2 * lm + 1)
            per_node = 2 * c * c * (lm + 1)
        else:  # dimenet
            cap = TRIPLET_CAPS[shape_id]
            nb = cfg.extra.get("n_bilinear", 8)
            per_edge = cap * (2 * nb * c * c) + 2 * c * c * 3
            per_node = 2 * c * c
        return float(cfg.n_layers) * (per_edge * e + per_node * n)

    return ModelBundle(arch=arch, cfg=cfg, family="gnn", device=dev,
                       init_fn=init_fn_for("molecule"), optimizer=opt,
                       init_caches=None,
                       steps={"train": train_step, "full": train_step,
                              "sampled": train_step, "batched": train_step},
                       input_specs=input_specs, make_inputs=make_inputs,
                       model_flops=model_flops, init_fn_for=init_fn_for)


def _fit_edges(gb, e_target, needs_triplets, cap):
    """Trim or pad (masked, at node 0) the edge arrays to e_target edges,
    and rebuild the triplets over them."""
    e = gb.edge_src.shape[0]
    if e >= e_target:
        gb.edge_src = gb.edge_src[:e_target]
        gb.edge_dst = gb.edge_dst[:e_target]
        gb.edge_mask = gb.edge_mask[:e_target]
    else:
        pad = e_target - e
        gb.edge_src = np.concatenate([gb.edge_src, np.zeros(pad, np.int32)])
        gb.edge_dst = np.concatenate([gb.edge_dst, np.zeros(pad, np.int32)])
        gb.edge_mask = np.concatenate([gb.edge_mask, np.zeros(pad, bool)])
    if needs_triplets:
        gb.triplets = graph_data.build_triplets(gb, cap_per_edge=cap)
    return gb


# =========================================================== recsys bundles
def _recsys_bundle(arch: str, cfg, reduced: bool, dev) -> ModelBundle:
    opt = AdamW(lr=1e-3)

    def init_fn(seed: int = 0, dtype=torch.float32):
        return bert4rec.init(cfg, seed=seed, device=dev, dtype=dtype)

    def train_step(model, opt_state, batch):
        """The cloze loss, its gradients and one AdamW update. Returns
        (model, opt_state, {"loss", "gnorm", "nll"})."""
        return _train_update(opt, model, opt_state,
                             lambda m: bert4rec.cloze_loss(m, batch, cfg))

    def serve_step(model, batch):
        return bert4rec.score_next(model, batch["ids"], cfg)

    def retrieval_step(model, batch):
        return bert4rec.score_candidates(model, batch["ids"],
                                         batch["candidate_ids"], cfg)

    def dims(shape_id, batch=None):
        spec = RECSYS_SHAPES[shape_id]
        b = spec["batch"]
        if reduced:
            b = min(b, 8)
        return spec["kind"], (b if batch is None else batch), cfg.seq_len

    def n_candidates(shape_id):
        n_cand = RECSYS_SHAPES[shape_id]["n_candidates"]
        return min(n_cand, 512) if reduced else n_cand

    def input_specs(shape_id):
        kind, b, s = dims(shape_id)
        if kind == "train":
            m = max(int(s * 0.15 * 1.3), 4)
            return {"ids": ((b, s), torch.int32),
                    "mask_idx": ((b, m), torch.int32),
                    "mask_targets": ((b, m), torch.int32),
                    "mask_valid": ((b, m), torch.bool)}
        if kind == "retrieval":
            return {"ids": ((b, s), torch.int32),
                    "candidate_ids": ((n_candidates(shape_id),),
                                      torch.int32)}
        return {"ids": ((b, s), torch.int32)}

    def make_inputs(shape_id, seed: int = 0, batch: int | None = None):
        """The reference's inputs for `shape_id` (the same numpy draws):
        cloze batches for train, Zipf histories for serve and retrieval,
        plus the candidate ids for retrieval; `batch` cuts the shape's batch
        (the draws then differ from the reference's)."""
        kind, b, s = dims(shape_id, batch)
        if kind == "train":
            return _to_device(recsys_synth.cloze_batch(
                b, s, cfg.n_items, seed=seed), dev)
        out = {"ids": recsys_synth.history_batch(b, s, cfg.n_items, seed)}
        if kind == "retrieval":
            rng = np.random.default_rng(seed)
            out["candidate_ids"] = rng.integers(
                1, cfg.n_items, (n_candidates(shape_id),)).astype(np.int32)
        return _to_device(out, dev)

    def model_flops(shape_id):
        """The reference's count: the encoder's per-token products and the
        scored rows against the item table (×3 for training)."""
        kind, b, s = dims(shape_id)
        d = cfg.embed_dim
        enc_tok = cfg.n_blocks * (8 * d * d + 2 * 2 * s * d)   # per token
        logit_row = 2 * d * cfg.n_items                        # per scored row
        if kind == "train":
            m = max(int(s * 0.15 * 1.3), 4)
            return 3.0 * b * (s * enc_tok + m * logit_row)
        if kind == "retrieval":
            n_cand = RECSYS_SHAPES[shape_id]["n_candidates"]
            return b * s * enc_tok + 2.0 * b * n_cand * d
        return float(b) * (s * enc_tok + logit_row)

    return ModelBundle(arch=arch, cfg=cfg, family="recsys", device=dev,
                       init_fn=init_fn, optimizer=opt, init_caches=None,
                       steps={"train": train_step, "serve": serve_step,
                              "retrieval": retrieval_step},
                       input_specs=input_specs, make_inputs=make_inputs,
                       model_flops=model_flops)
