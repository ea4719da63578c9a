"""Architecture registry of the port: `--arch <id>` resolution.

Only the architectures the port serves are here; the JAX package's other
ids wait for the slices that ROADMAP.md (Queue 1) lists."""
from __future__ import annotations

from repro_torch.config import LMConfig
from . import qwen2_1_5b

__all__ = ["ARCHS", "get_config"]

ARCHS = {
    "qwen2-1.5b": (qwen2_1_5b.config, qwen2_1_5b.reduced),
}


def get_config(arch: str, *, reduced: bool = False) -> LMConfig:
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not ported yet (ported: "
                       f"{sorted(ARCHS)}); ROADMAP.md Queue 1 lists what "
                       "remains")
    full, red = ARCHS[arch]
    return red() if reduced else full()

