"""Sharding policy: parameter partition specs and activation constraint
rules per (architecture family, shape kind, mesh) — the reference's
`repro.distributed.policy` over the port's parameter names.

  * LM: data parallel over (pod, data); Megatron tensor parallel over
    `model` for the FFN and the vocab always (d_ff and vocab chosen
    divisible); attention head-parallel only when both n_heads and
    n_kv_heads divide the model axis, otherwise the attention's weights
    replicate over `model` and shard (FSDP) over `data`.
  * MoE: expert parallel over `model` when the expert count divides it,
    else tensor parallel inside the experts (granite's 40 experts vs 16).
  * Decode: the KV cache sharded along S over `model` (long_500k: over
    data x model); each shard's decode partials merge by log-sum-exp
    (`nn.attention.GQA.decode`).
  * GNN: parameters replicated (they are small), nodes and edges sharded
    over every mesh axis: on a torch `DeviceMesh`, over the mesh
    flattened to one dim (`placement_mesh`).
  * BERT4Rec: the item table and the logits vocab-sharded over `model`.

The reference stacks a block's leaves over layers (a leading L); the port
has one module a layer (`blocks.<i>.attn.wk.w`), so a block leaf's spec
here is the reference's with the layer entry dropped. A mesh is read only
through `.axis_names` and `.shape` (a mapping of axis name to size), so a
`launch.mesh.MeshShape` plans for a production mesh with no devices; a
torch `DeviceMesh` is read through `launch.mesh.mesh_shape`.
`distribute_model` places a model's parameters by the plan.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import P, to_placements
from repro_torch.launch.mesh import mesh_shape

__all__ = ["param_pspecs", "batch_pspecs", "activation_rules", "dp_axes",
           "input_axes", "placement_mesh", "distribute_model",
           "distribute_inputs"]


def dp_axes(mesh) -> tuple:
    mesh = mesh_shape(mesh)
    axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    return axes if len(axes) > 1 else (axes[0] if axes else None,)


def _flat_axes(mesh) -> tuple:
    """All mesh axes — GNN graphs shard over the full fleet (the model
    axis would otherwise idle: GNN params are tiny and replicated)."""
    return tuple(mesh_shape(mesh).axis_names)


def input_axes(family: str, mesh) -> tuple:
    """The mesh axes that split a batch's leading dims: every axis for a
    GNN (nodes, edges and triplets over the whole fleet), the data-parallel
    axes otherwise."""
    return _flat_axes(mesh) if family == "gnn" else dp_axes(mesh)


def placement_mesh(family: str, mesh):
    """The torch `DeviceMesh` a family is placed on. A GNN's: `mesh`
    flattened to one dim over all its ranks (`DeviceMesh._flatten`, whose
    one axis is then `_flat_axes`), so a node, edge or triplet dim is split
    over one mesh dim; DTensor in some torch releases (2.11) mis-places
    views, einsums and indexes of a tensor dim split over two mesh dims.
    Every other family's: `mesh` itself."""
    if family != "gnn" or mesh.ndim == 1:
        return mesh
    return mesh._flatten()


def _divisible(n: int, mesh, axis: str) -> bool:
    return axis in mesh.axis_names and n % mesh.shape[axis] == 0


def _ref_name(name: str) -> str:
    """A port parameter name in the reference's path form:
    `blocks.3.attn.wq.w` → `blocks/attn/wq/w` (the layer index is the
    reference's stacked axis), `embed.table` → `embed/table`."""
    parts = name.split(".")
    if parts[0] == "blocks" and len(parts) > 1 and parts[1].isdigit():
        parts = parts[:1] + parts[2:]
    return "/".join(parts)


def _param_spec(name: str, shp: tuple, cfg, mesh) -> P:
    """The spec of one parameter of shape `shp` (no layer axis)."""
    tp = mesh.shape["model"] if "model" in mesh.axis_names else 1
    fam = cfg.family

    def spec(*dims):
        full = [None] * len(shp)
        for d, ax in dims:
            full[d] = ax
        return P(*full)

    if fam == "gnn":
        return P()   # small params: replicate
    # ---- embeddings / heads (vocab over model) ----------------------------
    if "embed/table" in name or name == "head/w":
        v_dim = 0 if "table" in name else 1
        if shp[v_dim] % tp == 0:
            return spec((v_dim, "model"))
        return P()
    if fam == "recsys":
        return P()
    # ---- MoE experts ------------------------------------------------------
    if "ffn/wi" in name or "ffn/wg" in name or "ffn/wo" in name:
        if len(shp) == 3:   # (E, d|f, f|d) MoE stack
            d_dim = 1 if "wo" not in name else 2
            if shp[0] % tp == 0:
                # EP over model + FSDP over data on the d_model dim
                sp = [(0, "model")]
                if _divisible(shp[d_dim], mesh, "data"):
                    sp.append((d_dim, "data"))
                return spec(*sp)
            # E not divisible (granite 40 vs 16): TP inside experts on the
            # expert-hidden dim f
            f_dim = 2 if "wo" not in name else 1
            sp = []
            if shp[f_dim] % tp == 0:
                sp.append((f_dim, "model"))
            if _divisible(shp[d_dim], mesh, "data"):
                sp.append((d_dim, "data"))
            return spec(*sp) if sp else P()
        # dense swiglu: wi/wg (d, f): f over model; wo (f, d): f over model
        if "wo" in name:
            if shp[0] % tp == 0:
                sp = [(0, "model")]
                if _divisible(shp[1], mesh, "data"):
                    sp.append((1, "data"))
                return spec(*sp)
            return P()
        if shp[1] % tp == 0:
            sp = [(1, "model")]
            if _divisible(shp[0], mesh, "data"):
                sp.append((0, "data"))
            return spec(*sp)
        return P()
    if "router" in name:
        return P()
    # ---- attention ----------------------------------------------------------
    if "attn/" in name:
        heads_ok = (cfg.attention != "mla"
                    and cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0)
        if name.endswith("/b") or "norm" in name:
            return P()
        if heads_ok and len(shp) == 2:
            if "wo" in name:
                return spec((0, "model"))
            return spec((1, "model"))
        # fallback: FSDP over data on the input dim
        if len(shp) == 2 and _divisible(shp[0], mesh, "data"):
            return spec((0, "data"))
        return P()
    # ---- norms / scalars ----------------------------------------------------
    return P()


def param_pspecs(model, cfg, mesh) -> dict:
    """{parameter name: P} for every parameter of `model` (an nn.Module,
    or a mapping of name to anything with `.shape`)."""
    mesh = mesh_shape(mesh)
    named = (model.named_parameters() if isinstance(model, torch.nn.Module)
             else model.items())
    return {name: _param_spec(_ref_name(name), tuple(p.shape), cfg, mesh)
            for name, p in named}


def batch_pspecs(family: str, shape_kind: str, mesh, *, batch: int = 0):
    mesh = mesh_shape(mesh)
    dp = dp_axes(mesh)
    dp1 = dp if (batch == 0 or batch % _size(mesh, dp) == 0) else None
    if family == "lm":
        if shape_kind in ("train", "prefill"):
            return {"tokens": P(dp1, None)}
        # decode: token (B,), lengths (B,)
        return {"token": P(dp1), "lengths": P(dp1)}
    if family == "gnn":
        return {"nodes": P(dp1), "edges": P(dp1)}
    # recsys
    return {"ids": P(dp1, None), "targets": P(dp1, None),
            "mask_positions": P(dp1, None)}


def _size(mesh, axes) -> int:
    mesh = mesh_shape(mesh)
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    n = 1
    for a in axes:
        if a is not None:
            n *= mesh.shape[a]
    return n


def activation_rules(cfg, mesh, shape_kind: str, *, batch: int = 0,
                     seq: int = 0) -> dict:
    """Logical-name → P rules for `sharding.constrain()`."""
    mesh = mesh_shape(mesh)
    dp = dp_axes(mesh)
    tp_ok = (getattr(cfg, "attention", "gqa") != "mla"
             and getattr(cfg, "n_heads", 0) % mesh.shape.get("model", 1) == 0
             and getattr(cfg, "n_kv_heads", 0) % mesh.shape.get("model", 1)
             == 0)
    dpb = dp if (batch == 0 or batch % _size(mesh, dp) == 0) else None
    sp = "model" if getattr(cfg, "seq_parallel", False) else None
    rules = {
        "act_btd": P(dpb, sp, None),
        "logits_btv": P(dpb, None, "model"),
        "logits_bv": P(dpb, "model"),
        "parts_bpv": P(dpb, "model", None),
        "q_bshd": P(dpb, None, "model", None) if tp_ok else None,
        "kv_bshd": P(dpb, None, "model", None) if tp_ok else None,
        "ffn_btf": P(dpb, None, "model"),
        "gnn_nodes": P(_flat_axes(mesh), None),
        "gnn_irreps": P(_flat_axes(mesh), None, None),
        "cp_qblocks": P(dpb, "model", None, None, None, None),
    }
    if getattr(cfg, "moe_experts", 0):
        e_alloc = max(getattr(cfg, "moe_pad_to", 0), cfg.moe_experts)
        ep_ok = e_alloc % mesh.shape.get("model", 1) == 0
        e_ax = "model" if ep_ok else None
        rules["moe_bsec"] = P(dpb, None, e_ax, None)
        rules["moe_becd"] = P(dpb, e_ax, None, None)
        rules["moe_becf"] = P(dpb, e_ax, None, "model" if not ep_ok else None)
    if shape_kind == "decode":
        if batch and batch % _size(mesh, dp) == 0:
            rules["cache_bsnd"] = P(dpb, "model", None, None)
            rules["mla_cache"] = P(dpb, "model", None)
        else:
            # long-context single sequence: shard the cache sequence over
            # data×model (pods replicate = serving replicas)
            seq_axes = tuple(a for a in ("data", "model")
                             if a in mesh.axis_names)
            rules["cache_bsnd"] = P(None, seq_axes, None, None)
            rules["mla_cache"] = P(None, seq_axes, None)
    return rules


def distribute_model(model: torch.nn.Module, cfg, mesh):
    """Replace every parameter of `model` by a DTensor over `mesh` (a torch
    `DeviceMesh`) placed by `param_pspecs`, in place; returns the model
    (the reference's `jax.device_put(params, shardings)`). Each rank keeps
    the shard of its own copy of the parameter, so ranks that built the
    model from one seed hold one model. A parameter that is a DTensor
    already (a block placed as it was drawn) stays as it is; a block alone
    is placed as it is inside the model (its names carry the same
    leaves)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    specs = param_pspecs(model, cfg, mesh)
    for name, p in list(model.named_parameters()):
        if isinstance(p, DTensor):
            continue
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        dt = distribute_tensor(p.detach(), mesh,
                               to_placements(specs[name], mesh),
                               src_data_rank=None)
        setattr(mod, leaf,
                torch.nn.Parameter(dt, requires_grad=p.requires_grad))
    return model


def distribute_inputs(inputs: dict, mesh, family: str) -> dict:
    """Each input a DTensor over `mesh` (a torch `DeviceMesh`), its leading
    dim split over `input_axes(family, mesh)` where it divides evenly, else
    whole (the reference's `leaf_pspec`). Each rank keeps its shard of its
    own copy, so ranks that made the batch from one seed hold one batch."""
    from torch.distributed.tensor import distribute_tensor
    axes = input_axes(family, mesh)
    n = _size(mesh, axes)
    out = {}
    for name, t in inputs.items():
        split = t.dim() >= 1 and t.shape[0] > 0 and t.shape[0] % n == 0
        spec = P(axes, *([None] * (t.dim() - 1))) if split else P()
        out[name] = distribute_tensor(t, mesh, to_placements(spec, mesh),
                                      src_data_rank=None)
    return out
