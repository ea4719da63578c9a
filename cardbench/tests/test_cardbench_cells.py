"""Each cell runs end to end on the CPU at a tiny size (the harness's look
for a card skipped) and gives a well-formed result line; the command
itself refuses to run without the card."""
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from cardbench import datasets, run
from cardbench.cell import load_cell

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_prints_a_well_formed_line(tiny_cell, name, trace):
    cell = tiny_cell(name)
    out = run.run_cell(cell, seed=2**33 + 7, seconds=0.3, trace=bool(trace),
                       device="cpu", t_start=time.time(), cache=False)
    res = json.loads(json.dumps(out["result"]))
    assert list(res)[:5] == RESULT_KEYS and list(res)[-1] == "compared"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert res["compared"] == {"wrong_answers": {"value": 0, "limit": 0}}
    names = {m["name"]: m["unit"] for m in
             (cell.per_layer if trace else cell.end_to_end)}
    assert set(res["metrics"]) <= set(names)
    for k, v in res["metrics"].items():
        assert v["unit"] == names[k] and isinstance(v["value"], float)
    if trace:
        assert {"supersteps_per_query", "compile_ms_per_query",
                "window_queries_per_s"} <= set(res["metrics"])
        assert res["metrics"]["window_queries_per_s"]["value"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == set(names)
        assert res["metrics"]["setup_s"]["value"] > 0


def test_the_replay_order_follows_the_seed(tiny_cell):
    import numpy as np
    cell = tiny_cell("dblp_synth.hot")
    sizes = np.array([4, 4, 8, 8, 16, 16, 8, 4])

    def first(seed, n=20):
        calls = run._calls(cell, datasets.replay_order(sizes, seed))
        return [next(calls)[0] for _ in range(n)]

    assert first(2**33 + 1) == first(2**33 + 1)
    assert first(2**33 + 1) != first(2**33 + 2)
    assert sorted(first(5, 8)) == list(range(8))


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "cardbench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_command_needs_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the harness it exits
    non-zero and prints no result, card or no card."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    proc = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_modules_are_named(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.forbidden_modules() == ["jaxlib"]
    monkeypatch.delitem(sys.modules, "jaxlib.xla_client")
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert "repro" not in run.forbidden_modules()


@pytest.mark.cuda
def test_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", "dblp_synth.hot",
         "--seed", "3", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
