"""The port's five examples (`examples/torch_*.py`) on the CPU.

- `torch_quickstart`: everything it prints and the figures its `main`
  returns (the Fig. 1 count and embeddings, the 2k-vertex graph's ref and
  vector counts, the ref engine's intersections and CEB hits, the vector
  engine's tiles and dedup ratio, the plan cache) equal the original
  `examples/quickstart.py`'s, which runs in a subprocess of its own
  (below) and whose printed figures are parsed;
- `torch_match_queries`: its per-query counts and the runtime's stats
  equal the reference `MatchQueueRuntime`'s on the same queries, run in
  that subprocess;
- the three model examples run their own assertions (the loss falls);
  each step they call is already held against the reference on carried
  weights (`test_torch_train.py`, `test_torch_recsys.py`,
  `test_torch_gnn_models.py`), so no case here repeats it;
- every example raises without a card unless `--device cpu` is given,
  and none imports jax or the JAX package.

The reference's vector engine imports `jax.experimental.enable_x64`,
which newer JAX releases no longer have: the subprocess sets
`jax.experimental.enable_x64 = jax.enable_x64` inside itself only, as
`tests/torch_reference.py` does. Counts and stats are compared exactly;
the dedup ratio as both sides print it (two decimals).
"""
import ast
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart", "torch_match_queries", "torch_serve_recsys",
            "torch_train_lm", "torch_gnn_train")
# a small match_queries workload whose counts differ from query to query
QUEUE = {"dataset": "human", "scale": 0.05, "n": 10, "size": 5,
         "limit": 100_000}

REFERENCE = r'''
import contextlib, io, json, runpy, sys
import jax, jax.experimental
if not hasattr(jax.experimental, "enable_x64"):
    jax.experimental.enable_x64 = jax.enable_x64
out = io.StringIO()
sys.argv = [sys.argv[1]]
with contextlib.redirect_stdout(out):
    runpy.run_path(sys.argv[0], run_name="__main__")
from repro.api import Dataset
from repro.runtime.queue import MatchQueueRuntime
args = json.loads(sys.stdin.read())
ds = Dataset.synthetic(args["dataset"], scale=args["scale"])
queries = [ds.random_query(args["size"], seed=s) for s in range(args["n"])]
rt = MatchQueueRuntime(ds, engine="vector", tile_rows=2048,
                       state_path=args["state"])
rt.submit(queries, limit=args["limit"])
results = rt.run(checkpoint_every=8)
print(json.dumps({"quickstart": out.getvalue(),
                  "results": {str(k): v for k, v in results.items()},
                  "stats": rt.stats,
                  "cache_info": str(rt.matcher.cache_info())}))
'''


def load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The original quickstart's output and the reference queue's
    results, from one subprocess."""
    state = tmp_path_factory.mktemp("reference") / "queue.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE,
         str(ROOT / "examples" / "quickstart.py")],
        input=json.dumps({**QUEUE, "state": str(state)}),
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def parse_quickstart(text: str) -> dict:
    """The figures the original quickstart prints."""
    fig1 = re.search(r"\[paper Fig\.1\] embeddings: (\d+) \(engine=(\w+)\)",
                     text)
    counts = re.search(r"ref=(\d+) vec=(\d+)", text)
    ref = re.search(r"ref intersections=(\d+) CEB hits=(\d+)", text)
    vec = re.search(r"vec tiles=(\d+) dedup_ratio=([\d.]+)", text)
    cache = re.search(r"plan cache: (CacheInfo\([^)]*\))", text)
    embeddings = [
        {int(u[1:]): int(v[1:]) for u, v in ast.literal_eval(line).items()}
        for line in text.splitlines() if line.startswith("   {")]
    return {"fig1_count": int(fig1[1]), "fig1_engine": fig1[2],
            "embeddings": embeddings,
            "ref_count": int(counts[1]), "vec_count": int(counts[2]),
            "ref_intersections": int(ref[1]), "ref_ceb_hits": int(ref[2]),
            "vec_tiles": int(vec[1]), "vec_dedup_ratio": vec[2],
            "cache_info": cache[1]}


def test_quickstart_matches_the_original(reference, capsys):
    got = load("torch_quickstart").main(["--device", "cpu"])
    printed = capsys.readouterr().out
    want = parse_quickstart(reference["quickstart"])
    assert got["device"] == "cpu"
    assert got["fig1_count"] == want["fig1_count"] == 3
    assert got["fig1_engine"] == want["fig1_engine"]
    assert sorted(map(sorted, (e.items() for e in got["embeddings"]))) == \
        sorted(map(sorted, (e.items() for e in want["embeddings"])))
    assert len(got["embeddings"]) == got["fig1_count"]
    for key in ("ref_count", "vec_count", "ref_intersections",
                "ref_ceb_hits", "vec_tiles"):
        assert got[key] == want[key], key
    assert got["ref_count"] == got["vec_count"]
    assert f"{got['vec_dedup_ratio']:.2f}" == want["vec_dedup_ratio"]
    assert str(got["cache_info"]) == want["cache_info"]
    # the explain text and every other line too, but for the device
    assert printed.replace(" on cpu", "") == reference["quickstart"]


def test_match_queries_matches_the_reference_queue(reference, tmp_path):
    state = tmp_path / "queue.json"
    got = load("torch_match_queries").main([
        "--dataset", QUEUE["dataset"], "--scale", str(QUEUE["scale"]),
        "--n-queries", str(QUEUE["n"]), "--query-size", str(QUEUE["size"]),
        "--limit", str(QUEUE["limit"]), "--state-path", str(state),
        "--device", "cpu"])
    assert {str(k): v for k, v in got["results"].items()} == \
        reference["results"]
    assert len(set(got["results"].values())) > 2
    assert got["stats"] == reference["stats"]
    assert str(got["cache_info"]) == reference["cache_info"]
    assert state.exists()


def test_match_queries_checkpoint_is_its_own():
    mod = load("torch_match_queries")
    assert mod.DEFAULT_STATE != "/tmp/cemr_queue.json"
    assert Path(mod.DEFAULT_STATE).parent == Path(tempfile.gettempdir())


def test_serve_recsys_scores_on_the_cpu():
    got = load("torch_serve_recsys").main(["--device", "cpu"])
    assert got["batches"] == 20 and len(got["top"]) == 20
    for vals, ids in got["top"]:
        assert vals.shape == ids.shape == (got["batch"], 10)
        assert bool((vals[:, :-1] >= vals[:, 1:]).all())
        assert all(len(set(row.tolist())) == 10 for row in ids)
    scores = got["retrieval_scores"]
    assert scores.shape[0] == 1 and bool(torch.isfinite(scores).all())
    assert got["requests_per_s"] > 0


def test_train_lm_lowers_the_loss_and_resumes(tmp_path):
    mod = load("torch_train_lm")
    args = ["--device", "cpu", "--steps", "8", "--batch", "2", "--seq",
            "16", "--ckpt-dir", str(tmp_path)]
    got = mod.main(args)
    assert got["steps_run"] == 8 and got["restarts"] == 0
    assert got["last_loss"] < got["first_loss"]
    # the checkpoint at step 8 leaves a second run nothing to train
    with pytest.raises(SystemExit, match="nothing to train"):
        mod.main(args)


@pytest.mark.parametrize("arch", ["nequip", "equiformer-v2", "gatedgcn",
                                  "dimenet"])
def test_gnn_train_lowers_the_loss(arch):
    got = load("torch_gnn_train").main(["--device", "cpu", "--arch", arch,
                                        "--steps", "10"])
    assert len(got["losses"]) == 10
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_need_a_card_unless_told_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load(name).main([])


def test_examples_import_neither_jax_nor_the_reference():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)"
                         r"(\.|\s))", re.M)
    for name in EXAMPLES:
        assert not pattern.search(
            (ROOT / "examples" / f"{name}.py").read_text()), name
    code = (
        "import runpy, sys\n"
        f"for name in {EXAMPLES!r}:\n"
        "    runpy.run_path(f'examples/{name}.py')\n"
        "sys.argv = ['torch_quickstart.py', '--device', 'cpu']\n"
        "runpy.run_path('examples/torch_quickstart.py', "
        "run_name='__main__')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
