"""The port's dry run (`repro_torch.launch.dryrun`) and its trace
(`launch.roofline.StepTrace`, `collective_bytes`,
`parse_memory_analysis`) on fake process groups, in one subprocess with a
time limit (`tests/torch_dist_cases.py dryrun`): a group of 8 ranks on a
(4, 2) mesh and a group of 1 on (1, 1), reduced configs.

Held: the engine cell at (T, S, k) = (1024, 4096, 2) is ok with chips 8
and `dominant` one of the three terms (the reference's
`test_dryrun_small`); `collective_bytes` gives the exact output bytes by
kind of a known sequence of redistributes (the reference's parser test);
reduced qwen2-1.5b train, decode and prefill, bert4rec serve and the
four GNNs' train cells are ok on both meshes (a GNN on (4, 2) moves
bytes: its row all-gathers and partial-sum reduce-scatters); on (1, 1) no collective runs
and the FLOPs equal `count_flops` of the plain (undistributed) steps;
the prefill cell's argument bytes are the policy's local shard sizes."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("qwen2-1.5b", "train_4k"), ("qwen2-1.5b", "decode_32k"),
         ("qwen2-1.5b", "prefill_32k"), ("bert4rec", "serve_p99"),
         ("gatedgcn", "full_graph_sm")]
# each reduced GNN's cell beside gatedgcn's: their gathers and sums by node,
# edge or triplet index run on each rank's own rows (`core.gather_rows`,
# `core.segment_sum`), whose collectives the trace counts
GNN_CELLS = [("nequip", "molecule"), ("equiformer-v2", "molecule"),
             ("dimenet", "molecule")]
MESHES = {"4x2": 8, "1x1": 1}


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_dist_cases.py"),
         "dryrun", str(out)], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out / "dryrun.json") as f:
        return json.load(f)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_engine_cell_is_ok(dry, mesh):
    r = dry[f"engine/{mesh}"]
    assert r["ok"] and r["arch"] == "cemr-engine"
    assert r["chips"] == MESHES[mesh]
    assert r["shape"] == "T1024_S4096"
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert r["memory"]["argument_size_in_bytes"] > 0
    if mesh == "4x2":
        # the popcount summed over model: one all-reduce of (T / 4,) int32
        assert r["coll_breakdown"] == {"all-reduce": 1024 // 4 * 4}
    else:
        assert r["coll_breakdown"] == {}


def test_collective_bytes_of_known_redistributes(dry):
    # (16, 8) float32 [S(0) over data 4, S(1) over model 2] → gather over
    # model: out (4, 8); then over data: (16, 8); a partial sum over data
    # → S(0): reduce-scatter out (4, 8); a bf16 (16, 8) partial over
    # model → replicate: all-reduce out (16, 8)
    assert dry["collective_calls"] == [["all-gather", 128],
                                       ["all-gather", 512],
                                       ["reduce-scatter", 128],
                                       ["all-reduce", 256]]
    assert dry["collectives"] == {"all-gather": 640, "reduce-scatter": 128,
                                  "all-reduce": 256}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS + GNN_CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS + GNN_CELLS])
def test_reduced_cells_are_ok(dry, arch, shape, mesh):
    r = dry[f"{arch}/{shape}/{mesh}"]
    assert r["ok"] and r["chips"] == MESHES[mesh]
    assert r["mesh"] == dict(zip(("data", "model"),
                                 (4, 2) if mesh == "4x2" else (1, 1)))
    for key in ("argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes"):
        assert r["memory"][key] > 0, key
    assert r["memory"]["generated_code_size_in_bytes"] is None
    assert r["hbm_floor_per_device"] > 0
    assert r["roofline"]["hlo_flops"] > 0
    assert r["coll_bytes_per_dev"] == sum(r["coll_breakdown"].values())
    assert set(r["coll_breakdown"]) <= {"all-gather", "all-reduce",
                                        "reduce-scatter", "all-to-all",
                                        "collective-permute"}
    if mesh == "1x1":
        assert r["coll_breakdown"] == {}
    elif arch == "qwen2-1.5b" and shape == "train_4k":
        # the data-parallel gradient reduction and the tensor-parallel
        # activations both move bytes
        assert r["coll_breakdown"]["reduce-scatter"] > 0
        assert r["coll_breakdown"]["all-gather"] > 0
    elif (arch, shape) in GNN_CELLS + [("gatedgcn", "full_graph_sm")]:
        # node rows gathered for each edge, partial sums reduce-scattered
        # to the nodes' owners
        assert r["coll_breakdown"]["all-gather"] > 0
        assert r["coll_breakdown"]["reduce-scatter"] > 0


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
def test_one_by_one_flops_are_the_plain_steps(dry, shape):
    got = dry[f"qwen2-1.5b/{shape}/1x1"]["roofline"]["hlo_flops"]
    assert got == dry["plain_flops"][shape]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_argument_bytes_are_the_policys_local_shards(dry, mesh):
    r = dry[f"qwen2-1.5b/prefill_32k/{mesh}"]
    assert r["memory"]["argument_size_in_bytes"] == dry[
        f"policy_bytes/{mesh}"]


def test_dryrun_main_reports_and_exits_1_on_a_failed_cell(tmp_path):
    """`main` on a small engine cell over a fake group of 256; a cell
    that cannot run (an unknown shape) is reported and fails the run."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    code = ("import functools, sys\n"
            "from repro_torch.launch import dryrun\n"
            "dryrun.dryrun_engine_cell = functools.partial(\n"
            "    dryrun.dryrun_engine_cell, frontier_rows=1024, space=4096,\n"
            "    k_bwd=2)\n"
            "sys.exit(dryrun.main(sys.argv[1:]))\n")
    out = tmp_path / "rows.json"
    ok = subprocess.run([sys.executable, "-c", code, "--engine", "--out",
                         str(out)], env=env, capture_output=True, text=True,
                        timeout=300)
    assert ok.returncode == 0, ok.stderr[-3000:]
    assert "== dry-run: 1/1 cells traced ==" in ok.stdout
    rows = json.loads(out.read_text())
    assert rows[0]["chips"] == 256 and rows[0]["ok"]
    assert rows[0]["shape"] == "T1024_S4096"
    assert rows[0]["mesh"] == {"data": 16, "model": 16}
    # the cell is traced in a worker process of its own fake group
    bad = subprocess.run([sys.executable, "-c", code, "--arch", "gatedgcn",
                          "--shape", "no_such_shape"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert bad.returncode == 1, bad.stderr[-3000:]
    assert "== dry-run: 0/1 cells traced ==" in bad.stdout
