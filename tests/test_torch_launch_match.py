"""The port's match launcher (`repro_torch.launch.serve --arch match`) on the
CPU: the closed-loop batch and the `--serve-loop` open loop over a small
synthetic dataset, their counts held against the JAX package's ref engine
on the same graph and `random_query` seeds."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.api import Dataset as RefDataset  # noqa: E402
from repro.api import Matcher as RefMatcher  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "match", "--device", "cpu", "--dataset", "yeast",
        "--scale", "0.1", "--query-size", "4", "--limit", "100000"]


def reference_counts(n_queries: int, *, scale=0.1, size=4) -> list[int]:
    ds = RefDataset.synthetic("yeast", scale=scale)
    m = RefMatcher(ds)
    return [m.count(ds.random_query(size, seed=s), engine="ref",
                    limit=100_000).count for s in range(n_queries)]


@pytest.mark.parametrize("engine", ["vector", "ref", "auto"])
def test_arch_match_counts_equal_the_reference_ref_engine(engine, capsys):
    assert serve.main(ARGS + ["--n-queries", "6", "--engine", engine]) == 0
    out = capsys.readouterr().out
    counts = [int(c) for c in
              re.search(r"^counts: \[(.*)\]$", out, re.M).group(1).split(",")]
    assert counts == reference_counts(6)
    assert re.search(r"on cpu in .* — (\d+) embeddings", out).group(1) == \
        str(sum(counts))
    if engine != "auto":
        assert f"'{engine}': 6" in out


def test_serve_loop_accounts_for_every_request(capsys):
    args = ARGS + ["--n-queries", "12", "--serve-loop",
                   "--qps", "200", "--workers", "0",
                   "--engine", "vector"]
    res = serve.serve_match_loop(serve.parse_args(args))
    s = res["summary"]
    assert s["failed"] == 0 and s["offered"] == 12
    assert s["offered"] == s["completed"] + s["shed"]
    # 12 distinct queries (seeds 0..11), request i asks query i
    want = reference_counts(12)
    done = {rid: c for rid, c in res["counts"].items() if c is not None}
    assert len(done) == s["completed"]
    assert all(c == want[rid] for rid, c in done.items())
    out = capsys.readouterr().out
    assert "failed 0" in out and "on cpu" in out


def test_launcher_runs_as_a_module_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *ARGS,
           "--n-queries", "6", "--serve-loop", "--workers", "1",
           "--qps", "100"]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    m = re.search(r"offered (\d+) @ .* completed (\d+) shed (\d+) "
                  r"failed (\d+)", proc.stdout)
    offered, completed, shed, failed = map(int, m.groups())
    assert failed == 0 and offered == completed + shed == 6
    assert "worker pool (1 workers)" in proc.stdout
