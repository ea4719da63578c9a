"""The four GNN architectures on the shared GraphBatch substrate.

Each model is an `nn.Module` whose `named_parameters()` are the reference's
tree paths (its lists become `layers.<i>` / `blocks.<i>`), built from a
config and the shape's node-feature width:

    model = GNN_MODELS[cfg.model](cfg, d_feat, gen=gen, device=dev)
    out = model(batch)                  # logits or per-graph energies
    loss, metrics = model.loss(batch)   # differentiable

`batch` holds the tensors of `data.graph_data.batch_to_arrays`.
Node-classification shapes train GatedGCN on node_labels; the geometric
models (NequIP, EquiformerV2, DimeNet) regress per-graph energies. Each
layer (DimeNet: each interaction block) runs under
`torch.utils.checkpoint` when gradients are on, as the reference wraps it
in `jax.checkpoint`.

On a mesh (a DTensor batch: the policy splits nodes, edges and triplets
over every rank of the mesh flattened to one dim, parameters whole) the
forward runs on each rank's own rows as plain tensors (`_on_shards`), as
GSPMD partitions the reference: its gathers and sums by a node, edge or
triplet index (`core.gather_rows`, `core.segment_sum`, `segment_max`) are
the only steps that reach other ranks, through collectives, and the
output comes back a DTensor for the loss. No DTensor is indexed, viewed
or contracted in a layer: DTensor in some torch releases (2.11) places
none of these on a dim split over two mesh dims, and no flip at all.
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import constrain
from repro_torch.nn import core, equivariant as eq, gnn

__all__ = ["GatedGCN", "NequIP", "EquiformerV2", "DimeNet", "GNN_MODELS",
           "gnn_init"]


def _remat(fn, *args):
    """fn(*args) under a non-reentrant checkpoint when gradients are on.
    Inside `_on_shards` (args[0] a module whose parameters are this rank's
    local tensors) the recompute, which may run on another thread after
    the forward has put the module's DTensors back, runs on the same local
    tensors and rows."""
    if not torch.is_grad_enabled():
        return fn(*args)
    mesh = core.row_mesh()
    if mesh is None:
        return checkpoint(fn, *args, use_reentrant=False)
    local = dict(args[0].named_parameters())

    def run(*a):
        with core.shard_rows(mesh), _swapped(a[0], local):
            return fn(*a)
    return checkpoint(run, *args, use_reentrant=False)


@contextlib.contextmanager
def _swapped(model: nn.Module, params: dict):
    """model's parameters replaced by `params` (name → tensor) for the
    block, then put back."""
    saved = []
    for name, t in params.items():
        prefix, _, leaf = name.rpartition(".")
        sub = model.get_submodule(prefix) if prefix else model
        saved.append((sub, leaf, sub._parameters[leaf]))
        sub._parameters[leaf] = t
    try:
        yield
    finally:
        for sub, leaf, p in reversed(saved):
            sub._parameters[leaf] = p


def _on_shards(model: nn.Module, forward, batch: dict, out_rows: str):
    """forward(batch, rows): `rows` maps each input to its whole row count.
    On plain tensors, forward itself. On a DTensor batch (split along its
    first axis over a one-dim mesh, or whole), each rank runs forward on
    its own rows as plain tensors inside `core.shard_rows`, with the
    model's parameters (whole DTensors) swapped for their local tensors,
    whose gradients come back as the ranks' partial sums; the output, of
    batch[out_rows]'s row count, comes back a DTensor split along its
    first axis (whole where the count does not split evenly)."""
    rows = {k: v.shape[0] for k, v in batch.items()}
    mask = batch["node_mask"]
    if not isinstance(mask, DTensor):
        return forward(batch, rows)
    mesh = mask.device_mesh
    split = [k for k in ("node_mask", "edge_mask", "t_mask") if k in batch]
    if mesh.ndim != 1 or any(batch[k].placements != (Shard(0),)
                             for k in split):
        raise ValueError(f"a GNN batch on a mesh splits {split} along "
                         f"their first axis over a one-dim mesh, not "
                         f"{[batch[k].placements for k in split]} on "
                         f"{mesh} (policy.placement_mesh)")
    params = dict(model.named_parameters())
    if not all(isinstance(p, DTensor) for p in params.values()):
        raise ValueError("a GNN batch on a mesh needs the model placed on "
                         "it (policy.distribute_model)")
    local = {name: p.to_local(grad_placements=[Partial()])
             for name, p in params.items()}
    with core.shard_rows(mesh), _swapped(model, local):
        out = forward({k: v.to_local() for k, v in batch.items()}, rows)
    n = rows[out_rows]
    shape = (n,) + tuple(out.shape[1:])
    return DTensor.from_local(
        out, mesh, [Shard(0)] if n % mesh.size() == 0 else [Replicate()],
        run_check=False, shape=torch.Size(shape),
        stride=tuple(math.prod(shape[i + 1:]) for i in range(len(shape))))


def _edge_vectors(batch):
    pos = batch["positions"]
    vec = (core.gather_rows(pos, batch["edge_dst"])
           - core.gather_rows(pos, batch["edge_src"]))
    r = torch.sqrt(torch.clamp((vec ** 2).sum(-1), min=1e-12))
    return vec, r


def _graph_readout(node_scalars, graph_ids, n_graphs: int, node_mask):
    vals = torch.where(node_mask[:, None], node_scalars,
                       torch.zeros_like(node_scalars))
    return core.segment_sum(vals, graph_ids, n_graphs)


def _energy_mse(model, batch):
    pred = model(batch)[:, 0]
    mse = torch.mean((pred - batch["energies"]) ** 2)
    return mse, {"mse": mse}


def _irreps(feats0: torch.Tensor, l_max: int) -> dict:
    """{0: feats0 (N, C, 1), l: zeros (N, C, 2l+1)}."""
    n, c, _ = feats0.shape
    return {0: feats0, **{l: feats0.new_zeros((n, c, 2 * l + 1))
                          for l in range(1, l_max + 1)}}


def _dense_lastdim(p: core.Dense, f: torch.Tensor) -> torch.Tensor:
    """A channel-mixing Dense on (N, C, 2l+1) features."""
    return core.dense(p, f.transpose(1, 2)).transpose(1, 2)


# ===================================================================== GatedGCN
class GatedGCN(nn.Module):
    """16L d70 gated aggregator [arXiv:2003.00982]."""

    def __init__(self, cfg, d_feat: int | None = None, *,
                 gen: torch.Generator, device, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        d, d_in = cfg.d_hidden, d_feat or 16
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.embed_h = core.Dense(d_in, d, bias=True, **kw)
        self.embed_e = core.Dense(1, d, bias=True, **kw)
        self.layers = nn.ModuleList(gnn.GatedGCNLayer(d, **kw)
                                    for _ in range(cfg.n_layers))
        self.head = core.Dense(d, cfg.extra.get("n_classes", 16), bias=True,
                               **kw)

    def forward(self, batch):
        return _on_shards(self, self._forward, batch, "node_mask")

    def _forward(self, batch, rows):
        n = rows["node_mask"]
        if "node_feat" in batch:
            h = core.dense(self.embed_h, batch["node_feat"])
        else:
            d_in = self.embed_h.w.shape[0]
            h = core.dense(self.embed_h, nn.functional.one_hot(
                (batch["species"] % d_in).long(), d_in).float())
        _, r = _edge_vectors(batch)
        e = core.dense(self.embed_e, r[:, None])
        for lp in self.layers:
            h, e = _remat(gnn.gatedgcn_layer, lp, h, e, batch["edge_src"],
                          batch["edge_dst"], batch["edge_mask"], n)
        return core.dense(self.head, h)

    def loss(self, batch):
        logits = self(batch).float()
        labels = (batch["node_labels"] % logits.shape[-1]).long()
        logz = torch.logsumexp(logits, -1)
        gold = core.gold_logit(logits, labels)
        mask = batch["node_mask"]
        nll = torch.where(mask, logz - gold, torch.zeros_like(logz)).sum()
        nll = nll / torch.clamp(mask.sum(), min=1)
        return nll, {"nll": nll}


# ====================================================================== NequIP
@functools.lru_cache(maxsize=None)
def _gaunt(l1: int, l2: int, l3: int, device: str) -> torch.Tensor:
    return torch.from_numpy(eq.gaunt_tensor(l1, l2, l3)).to(device)


class NequIP(nn.Module):
    """E(3)-equivariant interatomic potential [arXiv:2101.03164]:
    l_max 2, Bessel radial basis, Gaunt tensor-product messages. Each layer
    is a ModuleDict {radial: {"l1_l2_l3": MLP}, self: {"l": Dense},
    mix: {"l": Dense}}."""

    def __init__(self, cfg, d_feat: int | None = None, *,
                 gen: torch.Generator, device, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        lm = cfg.extra.get("l_max", 2)
        c = cfg.d_hidden
        n_rbf = cfg.extra.get("n_rbf", 8)
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.embed = core.Embedding(cfg.extra.get("n_species", 16), c, **kw)
        self.layers = nn.ModuleList(nn.ModuleDict({
            "radial": nn.ModuleDict({
                f"{l1}_{l2}_{l3}": core.MLP((n_rbf, 32, c), bias=True, **kw)
                for (l1, l2, l3) in self.paths(lm)}),
            "self": nn.ModuleDict({str(l): core.Dense(c, c, **kw)
                                   for l in range(lm + 1)}),
            "mix": nn.ModuleDict({str(l): core.Dense(c, c, **kw)
                                  for l in range(lm + 1)}),
        }) for _ in range(cfg.n_layers))
        self.head = core.MLP((c, 32, 1), bias=True, **kw)

    @staticmethod
    def paths(lm: int) -> list:
        out = []
        for l1 in range(lm + 1):
            for l2 in range(lm + 1):
                for l3 in range(abs(l1 - l2), min(l1 + l2, lm) + 1):
                    if (l1 + l2 + l3) % 2 == 0:   # parity-allowed (Gaunt ≠ 0)
                        out.append((l1, l2, l3))
        return out

    def forward(self, batch):
        return _on_shards(self, self._forward, batch, "energies")

    def _forward(self, batch, rows):
        cfg = self.cfg
        lm = cfg.extra.get("l_max", 2)
        n = rows["node_mask"]
        vec, r = _edge_vectors(batch)
        rbf = eq.bessel_basis(r, cfg.extra.get("n_rbf", 8),
                              cfg.extra.get("cutoff", 5.0))     # (E, n_rbf)
        sh = eq.real_sph_harm(vec, lm)                           # l → (E, 2l+1)
        src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
        emask = batch["edge_mask"][:, None, None]
        dev = str(vec.device)

        def layer_fn(lp, feats):
            new = {l: _dense_lastdim(lp["self"][str(l)], f)
                   for l, f in feats.items()}
            for (l1, l2, l3) in self.paths(lm):
                w = core.mlp(lp["radial"][f"{l1}_{l2}_{l3}"], rbf)  # (E, C)
                # contract SH with the Gaunt tensor first: (E,m,o) stays small
                sh_g = torch.einsum("en,mno->emo", sh[l2],
                                    _gaunt(l1, l2, l3, dev))
                msg = constrain(torch.einsum(
                    "ecm,emo->eco", core.gather_rows(feats[l1], src), sh_g)
                    * w[:, :, None], "gnn_irreps")
                agg = constrain(core.segment_sum(
                    torch.where(emask, msg, torch.zeros_like(msg)), dst, n),
                    "gnn_irreps")
                new[l3] = new[l3] + _dense_lastdim(lp["mix"][str(l3)], agg)
            out = {0: nn.functional.silu(new[0])}
            for l in range(1, lm + 1):
                out[l] = new[l] * torch.sigmoid(new[0][..., :1])
            return {l: constrain(f, "gnn_irreps") for l, f in out.items()}

        feats = _irreps(core.embed(self.embed, batch["species"],
                                   self.embed.table.dtype)[:, :, None], lm)
        for lp in self.layers:
            feats = _remat(layer_fn, lp, feats)
        energy_per_node = core.mlp(self.head, feats[0][..., 0])
        return _graph_readout(energy_per_node, batch["graph_ids"],
                              rows["energies"], batch["node_mask"])

    def loss(self, batch):
        return _energy_mse(self, batch)


# ================================================================ EquiformerV2
class EquiformerV2(nn.Module):
    """Equivariant graph attention via eSCN SO(2) convolutions
    [arXiv:2306.12059]: per-edge Wigner rotation to the edge frame, per-|m|
    dense mixing, gated nonlinearity, alpha attention, rotation back. Each
    layer is a ModuleDict {so2: SO2Conv, alpha: MLP, out: {"l": Dense}}."""

    def __init__(self, cfg, d_feat: int | None = None, *,
                 gen: torch.Generator, device, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        lm = cfg.extra.get("l_max", 6)
        c = cfg.d_hidden
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.embed = core.Embedding(cfg.extra.get("n_species", 16), c, **kw)
        self.layers = nn.ModuleList(nn.ModuleDict({
            "so2": eq.SO2Conv(lm, c, c, **kw),
            "alpha": core.MLP((2 * c, c, cfg.extra.get("n_heads", 8)),
                              bias=True, **kw),
            "out": nn.ModuleDict({str(l): core.Dense(c, c, **kw)
                                  for l in range(lm + 1)}),
        }) for _ in range(cfg.n_layers))
        self.head = core.MLP((c, c, 1), bias=True, **kw)

    def forward(self, batch):
        return _on_shards(self, self._forward, batch, "energies")

    def _forward(self, batch, rows):
        cfg = self.cfg
        lm = cfg.extra.get("l_max", 6)
        c = cfg.d_hidden
        n = rows["node_mask"]
        vec, _ = _edge_vectors(batch)
        alpha_ang, beta_ang = eq.align_to_z_angles(vec)
        src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
        edge_mask = batch["edge_mask"]

        def layer_fn(lp, feats):
            edge_feats = {l: constrain(core.gather_rows(f, src),
                                       "gnn_irreps")
                          for l, f in feats.items()}
            rot = eq.rotate_to_edge_frame(edge_feats, alpha_ang, beta_ang, lm)
            mixed = {l: constrain(f, "gnn_irreps")
                     for l, f in eq.so2_conv(lp["so2"], rot, lm, c).items()}
            # gated nonlinearity: scalars gate all l>0
            gate = torch.sigmoid(mixed[0][..., 0])             # (E, C)
            mixed = {l: (nn.functional.silu(f) if l == 0
                         else f * gate[:, :, None]) for l, f in mixed.items()}
            # attention weights from invariant (m=0) channels
            inv = torch.cat([core.gather_rows(feats[0], dst)[..., 0],
                             mixed[0][..., 0]], dim=-1)
            a = core.mlp(lp["alpha"], inv)                     # (E, heads)
            a = gnn.segment_softmax(a, dst, n, edge_mask).mean(-1)   # (E,)
            mixed = {l: f * a[:, None, None] for l, f in mixed.items()}
            back = eq.rotate_to_edge_frame(mixed, alpha_ang, beta_ang, lm,
                                           inverse=True)
            out = {}
            for l, f in feats.items():
                b = back[l]
                agg = core.segment_sum(torch.where(
                    edge_mask[:, None, None], b, torch.zeros_like(b)), dst, n)
                out[l] = f + _dense_lastdim(lp["out"][str(l)], agg)
            return {l: constrain(f, "gnn_irreps") for l, f in out.items()}

        feats = _irreps(core.embed(self.embed, batch["species"],
                                   self.embed.table.dtype)[:, :, None], lm)
        for lp in self.layers:
            feats = _remat(layer_fn, lp, feats)
        e_node = core.mlp(self.head, feats[0][..., 0])
        return _graph_readout(e_node, batch["graph_ids"],
                              rows["energies"], batch["node_mask"])

    def loss(self, batch):
        return _energy_mse(self, batch)


# ===================================================================== DimeNet
class DimeNetBlock(nn.Module):
    """rbf_w, sbf_w Dense; bilinear (n_bil, C, C) ~ N(0, 1/C); msg_mlp
    (C, C, C) and update (C, C) MLPs."""

    def __init__(self, c: int, n_rbf: int, n_sph: int, n_bil: int, *,
                 gen: torch.Generator, device, dtype=torch.float32):
        super().__init__()
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.rbf_w = core.Dense(n_rbf, c, **kw)
        self.sbf_w = core.Dense(n_rbf * n_sph, n_bil, **kw)
        self.bilinear = nn.Parameter(core.normal_init(
            gen, (n_bil, c, c), 1.0 / math.sqrt(c), device=device,
            dtype=dtype))
        self.msg_mlp = core.MLP((c, c, c), bias=True, **kw)
        self.update = core.MLP((c, c), bias=True, **kw)


class DimeNet(nn.Module):
    """Directional message passing [arXiv:2003.03123]: Bessel RBF, spherical
    (radial × Legendre) triplet basis, bilinear interaction."""

    def __init__(self, cfg, d_feat: int | None = None, *,
                 gen: torch.Generator, device, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        c = cfg.d_hidden
        n_rbf = cfg.extra.get("n_radial", 6)
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.embed = core.Embedding(cfg.extra.get("n_species", 16), c, **kw)
        self.rbf_proj = core.Dense(n_rbf, c, **kw)
        self.edge_embed = core.MLP((3 * c, c), bias=True, **kw)
        self.blocks = nn.ModuleList(
            DimeNetBlock(c, n_rbf, cfg.extra.get("n_spherical", 7),
                         cfg.extra.get("n_bilinear", 8), **kw)
            for _ in range(cfg.n_layers))
        self.head = core.MLP((c, c, 1), bias=True, **kw)

    def forward(self, batch):
        return _on_shards(self, self._forward, batch, "energies")

    def _forward(self, batch, rows):
        cfg = self.cfg
        n_rbf = cfg.extra.get("n_radial", 6)
        n_sph = cfg.extra.get("n_spherical", 7)
        cutoff = cfg.extra.get("cutoff", 5.0)
        n = rows["node_mask"]
        src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
        vec, r = _edge_vectors(batch)
        rbf = eq.bessel_basis(r, n_rbf, cutoff)                 # (E, n_rbf)
        h = core.embed(self.embed, batch["species"], self.embed.table.dtype)
        m = core.mlp(self.edge_embed, torch.cat(
            [core.gather_rows(h, src), core.gather_rows(h, dst),
             core.dense(self.rbf_proj, rbf)], -1))                # (E, C)
        t_kj, t_ji = batch["t_kj"].long(), batch["t_ji"].long()
        t_mask = batch["t_mask"]
        # angle between edge (j→i) and (k→j)
        v_ji = core.gather_rows(vec, t_ji)
        v_kj = -core.gather_rows(vec, t_kj)
        cosang = (v_ji * v_kj).sum(-1) / torch.clamp(
            torch.linalg.vector_norm(v_ji, dim=-1)
            * torch.linalg.vector_norm(v_kj, dim=-1), min=1e-9)
        ang = eq.legendre_poly(torch.clamp(cosang, -1, 1), n_sph - 1)
        sbf = (eq.bessel_basis(core.gather_rows(r, t_kj), n_rbf,
                               cutoff)[:, :, None]
               * ang[:, None, :]).reshape(-1, n_rbf * n_sph)     # (T, ...)
        e_count = rows["edge_mask"]
        m = constrain(m, "gnn_nodes")

        def block_fn(bp, m):
            m_kj = core.gather_rows(core.mlp(bp.msg_mlp, m), t_kj)  # (T, C)
            w_s = core.dense(bp.sbf_w, sbf)                     # (T, n_bil)
            inter = torch.einsum(
                "tbd,tb->td", torch.einsum("tc,bcd->tbd", m_kj, bp.bilinear),
                w_s)
            inter = constrain(torch.where(t_mask[:, None], inter,
                                          torch.zeros_like(inter)),
                              "gnn_nodes")
            agg = core.segment_sum(inter, t_ji, e_count)
            return constrain(m + core.mlp(bp.update,
                                          agg * core.dense(bp.rbf_w, rbf)),
                             "gnn_nodes")

        for bp in self.blocks:
            m = _remat(block_fn, bp, m)
        node_e = gnn.scatter_sum(m, dst, n, batch["edge_mask"])
        e_node = core.mlp(self.head, node_e)
        return _graph_readout(e_node, batch["graph_ids"],
                              rows["energies"], batch["node_mask"])

    def loss(self, batch):
        return _energy_mse(self, batch)


GNN_MODELS = {"gatedgcn": GatedGCN, "nequip": NequIP,
              "equiformer_v2": EquiformerV2, "dimenet": DimeNet}


def gnn_init(cfg, d_feat: int | None = None, *, seed: int = 0, device,
             dtype=torch.float32) -> nn.Module:
    """`cfg.model`'s module for node features of width `d_feat` (None:
    species one-hots for GatedGCN), weights drawn from a torch.Generator
    seeded with `seed` on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        return GNN_MODELS[cfg.model](cfg, d_feat, gen=gen, device=device,
                                     dtype=dtype)
