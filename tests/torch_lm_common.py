"""Helpers shared by the model tests of the port: the reference's reduced
weights of an LM architecture (qwen2-1.5b unless named) with seeded noise
on the biases and gains (`perturb_tree` for any reference tree), the
port's model on the same weights, and conversions to numpy (`flat_np`:
a reference tree as the port's dotted parameter names)."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.models.api import build_bundle as jax_build_bundle
from repro_torch.configs import registry
from repro_torch.models.convert import lm_params_from_jax
from repro_torch.nn import transformer as T

ARCH = "qwen2-1.5b"
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JNP_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def to_np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x).astype(np.float32)


def perturb_tree(tree, seed=0):
    """`tree` (a reference init) as numpy, with its zero biases ("b") and
    all-ones gains ("g") replaced by seeded noise, so a wrong mapping of
    any leaf shows."""
    rng = np.random.default_rng(seed + 1)

    def perturb(path, leaf):
        name = getattr(path[-1], "key", None)
        a = np.asarray(leaf)
        if name == "b":
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        elif name == "g":
            a = a + 0.2 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, tree)


def perturbed_params(seed=0, arch=ARCH):
    """The reference's init of `arch`'s reduced config, perturbed
    (`perturb_tree`)."""
    return perturb_tree(jax_build_bundle(arch, reduced=True).init_fn(
        jax.random.PRNGKey(seed)), seed)


def flat_np(tree) -> dict:
    """A reference tree (or gradient tree) as {dotted path: numpy array},
    list i as `<i>`: the port's parameter names."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[name] = np.asarray(leaf)
    return out


def port_model(tree, cfg=None):
    """The port's reduced model (or `cfg`'s) on the CPU with `tree`'s
    weights."""
    cfg = cfg or registry.get_config(ARCH, reduced=True)
    model = T.lm_init(cfg, seed=0, device="cpu")
    model.load_state_dict(lm_params_from_jax(tree, cfg), strict=True)
    return model


def port_grads(jgrads, cfg) -> dict:
    """The reference's gradient tree as the port's parameter names."""
    return {k: v.numpy() for k, v in lm_params_from_jax(jgrads, cfg).items()}
