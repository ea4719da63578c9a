"""Checkpoints of tensor trees: npz payloads plus a JSON manifest, in the
reference's on-disk format (`repro.train.checkpoint`), so a checkpoint
written by either package loads in the other.

  * layout: <dir>/step_{step:010d}/{arrays.npz,manifest.json}; a leaf's key
    is its path in the tree (dict keys, sorted, and list indices) joined by
    "/";
  * atomic: written to <dir>/tmp.<step>, then os.replace'd into place;
  * keep-last-k garbage collection;
  * bfloat16 leaves are stored widened to float32 (npz has no bfloat16),
    with "bfloat16" in the manifest's dtypes; a load casts every leaf to
    its template's dtype;
  * restore onto any device: `device=` places every leaf there (the
    reference's `shardings=`), else each leaf goes to its template's device;
  * async: `CheckpointManager.maybe_save` copies the tree to host memory,
    then a background thread writes it; `wait()` joins;
  * multi-process discipline (the reference's multi-host gate): a DTensor
    leaf is saved as its whole tensor (gathered on every rank: call the
    save on every rank), and only rank 0 of the default process group
    writes; a restore reads the file on every rank and re-distributes each
    DTensor leaf onto its template's mesh and placements, so a checkpoint
    of a sharded run loads into one process and back.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed.sharding import full

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "CheckpointManager"]

_MANIFEST = "manifest.json"


def _flatten(tree, prefix=()) -> dict:
    """{"a/b/0": leaf} in the reference's order: dict keys sorted, then
    list and tuple indices."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, node in enumerate(tree):
            out.update(_flatten(node, prefix + (str(i),)))
        return out
    return {"/".join(prefix): tree}


def _unflatten(template, flat: dict, prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, flat, prefix + (str(i),))
                              for i, v in enumerate(template))
    return flat["/".join(prefix)]


def _rank() -> int:
    """This process's rank in the default group (0 without one)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _to_host(leaf: torch.Tensor) -> torch.Tensor:
    """A host copy of the leaf's whole value (a DTensor's gathered)."""
    return full(leaf.detach()).to("cpu", copy=True)


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the array to store, the dtype to record)."""
    t = full(leaf.detach()).cpu()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy(), name


def save_checkpoint(directory: str, step: int, tree, *, keep: int = 3,
                    extra: dict | None = None) -> str:
    """Write `tree` (nested dicts, lists and tuples of tensors) as step
    `step`; keep the newest `keep` steps. Returns the step's directory,
    or "" on a rank other than 0, which writes nothing (every rank takes
    part in gathering the tree's DTensor leaves)."""
    flat = {key: _to_numpy(leaf) for key, leaf in _flatten(tree).items()}
    if _rank() != 0:
        return ""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {key: a for key, (a, _) in flat.items()}
    dtypes = {key: d for key, (_, d) in flat.items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "keys": sorted(arrays),
                "extra": extra or {}, "dtypes": dtypes,
                "shapes": {k: list(v.shape) for k, v in arrays.items()}}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    if not steps:
        return None
    return int(steps[-1].split("_")[1])


def load_checkpoint(directory: str, template, *, step: int | None = None,
                    device=None):
    """Restore into the structure of `template` (a tree of tensors): each
    leaf in its template's dtype, on `device` if given, else on its
    template's device; a DTensor template's leaf distributed like it
    (each rank keeps its own shard of the whole array it read). Returns
    (tree, manifest); the newest step unless `step` is given."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    out = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, tmpl in _flatten(template).items():
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(tmpl.shape)}")
            if isinstance(tmpl, DTensor):
                out[key] = distribute_tensor(
                    torch.from_numpy(arr).to(device=tmpl.device,
                                             dtype=tmpl.dtype),
                    tmpl.device_mesh, tmpl.placements, src_data_rank=None)
            else:
                out[key] = torch.from_numpy(arr).to(
                    device=tmpl.device if device is None else device,
                    dtype=tmpl.dtype)
    return _unflatten(template, out), manifest


class CheckpointManager:
    """Async save + resume helper used by the trainer and the supervisor."""

    def __init__(self, directory: str, *, keep: int = 3,
                 interval_steps: int = 100):
        self.directory = directory
        self.keep = keep
        self.interval = interval_steps
        self._thread: threading.Thread | None = None

    def maybe_save(self, step: int, tree, *, extra=None, force=False):
        if not force and (step % self.interval != 0):
            return False
        self.wait()
        # snapshot before the async write: a copy, because a CPU tensor's
        # numpy() shares its memory and the next in-place update would
        # rewrite the checkpoint while it is being saved (every rank
        # gathers its DTensor leaves; only rank 0 writes)
        host_tree = _unflatten(tree, {
            k: _to_host(v) for k, v in _flatten(tree).items()})
        if _rank() != 0:
            return True
        self._thread = threading.Thread(
            target=save_checkpoint,
            args=(self.directory, step, host_tree),
            kwargs={"keep": self.keep, "extra": extra}, daemon=True)
        self._thread.start()
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_or_none(self, template, device=None):
        """(tree, manifest) of the newest step once a pending save has
        landed (rank 0's, on every rank of a process group), or
        (None, None) when there is none."""
        self.wait()
        import torch.distributed as dist
        if dist.is_initialized():
            dist.barrier()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return load_checkpoint(self.directory, template, step=step,
                               device=device)
