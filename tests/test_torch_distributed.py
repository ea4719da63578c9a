"""The port's placement layer on four gloo CPU ranks over a (data, model) =
(2, 2) mesh, against one process and against the JAX package.

`tests/torch_dist_cases.py ranks` runs the ranks once for the module, in
a subprocess with a time limit (each rank joins its group with a timeout
and leaves it in `finally`). Held here:

- the MoE FFN on each rank's shard (qwen3-moe expert parallel on (2, 2),
  granite with 6 experts tensor parallel inside the experts on (1, 4)):
  two float32 steps' losses to one process's, relative 1e-5;
- reduced qwen2-1.5b trained 6 float32 steps on one batch by the policy:
  each step's loss equal to one process's to a relative 1e-5 (it reaches
  about 1e-7: the same products summed in another order across ranks),
  falling; the parameters after 6 steps to 1e-5; `wi` sharded on both
  dims;
- sharded bert4rec `score_next` (n_items 512): the unsharded values to
  1e-4 and the same indices, as the reference's
  `test_sharded_execution_8dev` holds its top-k;
- 4 decode steps over caches placed by the decode rules (GQA's sharded
  along B over data and S over model; MLA's along B), float32: the
  logits of the unsharded decode to 1e-5;
- `compressed_psum` / `compressed_allreduce_tree` over the data axis:
  the sum, in rank order, of the reference's
  `dequantize_int8(quantize_int8(x_r))` over the ranks of the group, on
  the same seeded numpy inputs, to 1e-6;
- a checkpoint of the distributed state: only rank 0 wrote, the restore
  re-placed every leaf, and the reference's `load_checkpoint` reads it.

And the training launcher under `torch.distributed.run` on 4 gloo ranks
with `--data-axis 2 --model-axis 2`: the reference's two lines, a falling
loss."""
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.train import checkpoint as jcheckpoint  # noqa: E402
from repro.train import compression as jcompression  # noqa: E402
from repro_torch.models.api import build_bundle  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_cases as cases  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    return env


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_dist_cases.py"),
         "ranks", str(out)], env=_env(), capture_output=True, text=True,
        timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    import json
    with open(out / "ranks.json") as f:
        res = json.load(f)
    res["arrays"] = dict(np.load(out / "ranks.npz"))
    res["dir"] = out
    return res


@pytest.fixture(scope="module")
def one_process():
    """The same 6 steps in one process, no mesh."""
    b = build_bundle("qwen2-1.5b", reduced=True, device="cpu")
    model = b.init_fn(0)
    state = b.optimizer.init(dict(model.named_parameters()))
    tokens = torch.from_numpy(cases.train_batch(b.cfg.vocab))
    losses, gnorms = [], []
    for _ in range(cases.STEPS):
        _, state, m = b.steps["train"](model, state, {"tokens": tokens},
                                       dtype=torch.float32)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    params = {k: v.detach().numpy() for k, v in model.named_parameters()}
    return {"losses": losses, "gnorms": gnorms, "params": params}


def test_the_mesh_is_two_by_two(ranks):
    assert ranks["mesh"] == {"data": 2, "model": 2}
    assert ranks["data_group"] == [0, 2]


def test_training_matches_one_process_step_by_step(ranks, one_process):
    got, want = ranks["train"]["losses"], one_process["losses"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    np.testing.assert_allclose(ranks["train"]["gnorms"],
                               one_process["gnorms"], rtol=1e-5, atol=0)
    assert all(b < a for a, b in zip(got, got[1:])), got


def test_parameters_after_training_match_one_process(ranks, one_process):
    for name, want in one_process["params"].items():
        np.testing.assert_allclose(ranks["arrays"][f"param/{name}"], want,
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("arch,override,placements", [
    ("qwen3-moe-30b-a3b", None, ["S(1)", "S(0)"]),
    ("granite-moe-3b-a800m", {"moe_experts": 6}, ["S(1)", "S(2)"])])
def test_moe_on_shards_matches_one_process(ranks, arch, override,
                                           placements):
    """Expert parallel (8 experts over model 2, mesh (2, 2)) and tensor
    parallel inside the experts (6 experts on model 4, mesh (1, 4)): two
    float32 steps' losses to a relative 1e-5."""
    got = ranks[f"moe/{arch}"]
    assert got["wi"] == placements
    b = build_bundle(arch, reduced=True, override=override, device="cpu")
    model = b.init_fn(0)
    state = b.optimizer.init(dict(model.named_parameters()))
    tokens = torch.from_numpy(cases.train_batch(b.cfg.vocab))
    want = []
    for _ in range(2):
        _, state, m = b.steps["train"](model, state, {"tokens": tokens},
                                       dtype=torch.float32)
        want.append(float(m["loss"]))
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5, atol=0)


def test_wi_is_sharded(ranks):
    wi = ranks["wi"]
    assert wi["placements"] == ["S(0)", "S(1)"]
    assert wi["local"] == [wi["shape"][0] // 2, wi["shape"][1] // 2]


def test_sharded_bert4rec_top_k_is_the_unsharded_one(ranks):
    b = build_bundle("bert4rec", reduced=True,
                     override={"n_items": cases.N_ITEMS}, device="cpu")
    model = b.init_fn(0)
    vals, idx = b.steps["serve"](model, b.make_inputs("serve_p99"))
    assert ranks["bert4rec_table_local"] == [cases.N_ITEMS // 2,
                                             b.cfg.embed_dim]
    np.testing.assert_allclose(ranks["arrays"]["bert4rec/values"],
                               vals.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ranks["arrays"]["bert4rec/indices"],
                                  idx.numpy())


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "minicpm3-4b"])
def test_sharded_cache_decode_matches_unsharded(ranks, arch):
    b = build_bundle(arch, reduced=True, device="cpu")
    model = b.init_fn(0)
    feed = {k: torch.from_numpy(v)
            for k, v in cases.decode_inputs(b.cfg.vocab).items()}
    caches = b.init_caches(cases.DECODE_BATCH, cases.DECODE_LEN,
                           dtype=torch.float32)
    want_pl = (["S(1)", "S(2)"] if arch == "qwen2-1.5b" else ["S(1)", "R"])
    assert ranks[f"{arch}/cache_placements"] == want_pl
    for i in range(cases.DECODE_STEPS):
        logits, caches = b.steps["decode"](model, caches, feed,
                                           dtype=torch.float32)
        np.testing.assert_allclose(ranks["arrays"][f"decode/{arch}/{i}"],
                                   logits.numpy(), rtol=0, atol=1e-5,
                                   err_msg=f"step {i}")
        feed = {"token": torch.argmax(logits, -1).to(torch.int32),
                "lengths": feed["lengths"] + 1}


def _reference_sum(key: str, group: list) -> np.ndarray:
    total = None
    for r in group:
        q, scale = jcompression.quantize_int8(
            jnp.asarray(cases.compression_inputs(r)[key]))
        part = np.asarray(jcompression.dequantize_int8(q, scale))
        total = part if total is None else total + part
    return total


def test_compressed_psum_is_the_reference_sum(ranks):
    got = ranks["arrays"]["psum/a"]
    np.testing.assert_allclose(got, _reference_sum("a", ranks["data_group"]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("key", ["a", "b"])
def test_compressed_allreduce_tree_is_the_reference_sum(ranks, key):
    got = ranks["arrays"][f"tree/{key}"]
    want = _reference_sum(key, ranks["data_group"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_checkpoint_rank_zero_writes_and_the_reference_reads(ranks):
    assert ranks["ckpt_written"] == [True, False, False, False]
    assert ranks["ckpt_restored_placements_equal"] is True
    assert ranks["ckpt_restored_equal"] is True
    ck = ranks["dir"] / "ckpt"
    assert sorted(os.listdir(ck)) == [f"step_{cases.STEPS:010d}"]
    params = {k[len("param/"):]: v for k, v in ranks["arrays"].items()
              if k.startswith("param/")}
    template = {"params": params,
                "opt": {"m": params, "v": params,
                        "step": np.zeros((), np.int32)}}
    tree, manifest = jcheckpoint.load_checkpoint(str(ck), template)
    assert manifest["step"] == cases.STEPS
    for name, want in params.items():
        np.testing.assert_array_equal(np.asarray(tree["params"][name]),
                                      want, err_msg=name)
    assert int(tree["opt"]["step"]) == cases.STEPS


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_train_launcher_under_torch_distributed_run(tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", "4", "--master-addr", "localhost",
           "--master-port", str(_free_port()),
           "-m", "repro_torch.launch.train", "--device", "cpu", "--steps",
           "3", "--data-axis", "2", "--model-axis", "2", "--ckpt-dir",
           str(tmp_path / "ckpt")]
    proc = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                          timeout=TIMEOUT_S, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(("mesh=", "loss "))]
    assert lines[0] == "mesh={'data': 2, 'model': 2} steps=3 restarts=0"
    m = re.fullmatch(r"loss (\S+) -> (\S+)", lines[1])
    assert m and float(m.group(2)) < float(m.group(1)), lines
