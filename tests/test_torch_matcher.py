"""repro_torch.api.Matcher end to end on the CPU, against the reference.

Counts are held against `repro.core.ref_engine.cemr_match` (numpy, in this
process) over the knob matrix; `VectorStats` against the reference
TileScheduler's, field for field, on the same plan, from one subprocess
(torch_reference.py) for the whole file."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_reference import (port_graph, reference_plan,  # noqa: E402
                             run_reference, workload)

from repro.api import Dataset as RefDataset  # noqa: E402
from repro.api import Matcher as RefMatcher  # noqa: E402
from repro.core.ref_engine import cemr_match  # noqa: E402
from repro_torch.api import Dataset, MatchOptions, Matcher  # noqa: E402
from repro_torch.core.engine import VectorEngine  # noqa: E402
from repro_torch.core.plan import plan_from_arrays  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKLOADS = ["fig1", "random0", "random1", "random2", "brother"]

# (workload, VectorEngine knobs) whose stats are held against the reference
# scheduler. tile_rows=8 splits even these small frontiers over many
# supersteps, so chunking, overlap and CER hits happen; "packing" packs
# sibling frontiers, and a second run of "failing" meets the failures the
# first one recorded.
STATS_CASES = (
    [(w, {"intersect": it, "tile_rows": 8})
     for w in WORKLOADS for it in ("jnp", "fused")]
    + [("brother", {"intersect": "jnp", "tile_rows": 8,
                    "use_failure_cache": False}),
       ("brother", {"intersect": "jnp", "tile_rows": 8, "overlap": False}),
       ("synthetic", {"intersect": "fused", "tile_rows": 16,
                      "cer_buffer_slots": 2, "failure_cache_slots": 1}),
       ("packing", {"intersect": "fused", "tile_rows": 8}),
       ("failing", {"intersect": "fused", "tile_rows": 8, "runs": 2,
                    "failure_cache_slots": 2})]
    # MatchOptions knobs that act before the engine (order_heuristic,
    # use_cv's thresholds, pack_tiles) or only on the ref engine (use_fs,
    # use_cer): through the Matcher on both sides (`options`)
    + [(w, {"options": {"engine": "vector", "tile_rows": 8,
                        "limit": 10 ** 9, **knob}})
       for w in ("random1", "brother")
       for knob in ({"use_cv": False}, {"use_fs": False},
                    {"use_cer": False}, {"order_heuristic": "ri"},
                    {"order_heuristic": "gql"}, {"pack_tiles": False})])


@pytest.fixture(scope="module")
def reference_stats():
    cases = [dict(kind="matcher", call="count", workload=w, **kw)
             if "options" in kw else dict(workload=w, **kw)
             for w, kw in STATS_CASES]
    return [r[0] if isinstance(r, list) else r
            for r in run_reference(cases)]


@pytest.mark.parametrize("use_dedup", [True, False])
@pytest.mark.parametrize("intersect", ["auto", "jnp", "pallas", "fused"])
@pytest.mark.parametrize("name", WORKLOADS)
def test_counts_match_cemr_match_over_the_knob_matrix(name, intersect,
                                                      use_dedup):
    query, data = workload(name)
    want = cemr_match(query, data).count
    m = Matcher(Dataset.from_graph(port_graph(data)), device="cpu")
    q = port_graph(query)
    for use_failure_cache in (True, False):
        for overlap in (True, False):
            out = m.count(q, engine="vector", intersect=intersect,
                          use_dedup=use_dedup,
                          use_failure_cache=use_failure_cache,
                          overlap=overlap)
            assert out.engine == "vector"
            assert out.count == want, (use_failure_cache, overlap)
            st = out.stats
            assert st.readbacks + st.overlapped_supersteps == st.supersteps


@pytest.mark.parametrize("case", range(len(STATS_CASES)),
                         ids=[f"{w}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for w, kw in STATS_CASES])
def test_vector_stats_match_the_reference_scheduler(case, reference_stats):
    name, knobs = STATS_CASES[case]
    want = reference_stats[case]
    if "options" in knobs:
        query, data = workload(name)
        out = Matcher(Dataset.from_graph(port_graph(data)),
                      device="cpu").count(port_graph(query),
                                          MatchOptions(**knobs["options"]))
        assert out.engine == "vector"
        assert out.count == want["count"]
        assert dataclasses.asdict(out.stats) == want["stats"]
        return
    knobs = dict(knobs)
    runs = knobs.pop("runs", 1)
    cs, an, plan = reference_plan(name)
    eng = VectorEngine(cs, an, device="cpu",
                       plan=plan_from_arrays(dataclasses.asdict(plan)),
                       **knobs)
    for _ in range(runs):
        res = eng.run(limit=10 ** 9)
    assert res.count == want["count"]
    assert res.timed_out == want["timed_out"]
    assert dataclasses.asdict(res.stats) == want["stats"]


def test_the_stats_cases_exercise_the_buffers(reference_stats):
    total = {k: sum(r["stats"][k] for r in reference_stats)
             for k in ("cer_hits", "fail_hits", "packed_tiles",
                       "overlapped_supersteps")}
    assert all(v > 0 for v in total.values()), total


@pytest.mark.parametrize("name", WORKLOADS + ["synthetic"])
def test_mesh_auto_equals_the_single_device_path(name):
    """mesh="auto" resolves to the single-device path on one device, as in
    the reference: the same count and every VectorStats field."""
    query, data = workload(name)
    ds = Dataset.from_graph(port_graph(data))
    q = port_graph(query)
    for intersect in ("auto", "fused"):
        # a Matcher each: a second run on one engine meets its ring buffers
        kw = dict(engine="vector", intersect=intersect, tile_rows=8)
        single = Matcher(ds, device="cpu").count(q, mesh=None, **kw)
        auto = Matcher(ds, device="cpu").count(q, mesh="auto", **kw)
        assert auto.count == single.count
        assert dataclasses.asdict(auto.stats) == \
            dataclasses.asdict(single.stats)
    outs = Matcher(ds, device="cpu").match_many([q, q], engine="vector",
                                                 mesh="auto")
    assert [o.count for o in outs] == [single.count] * 2


def test_auto_mesh_devices_equals_the_reference(monkeypatch):
    from repro.api.options import SHARD_AUTO_MIN_ROWS as REF_MIN_ROWS
    from repro.api.options import auto_mesh_devices as ref_auto
    from repro_torch.api.options import (SHARD_AUTO_MIN_ROWS,
                                         auto_mesh_devices)
    assert SHARD_AUTO_MIN_ROWS == REF_MIN_ROWS
    for rows in (None, 0, 100, REF_MIN_ROWS - 1, REF_MIN_ROWS, 10 ** 6):
        for n_devices in (0, 1, 2, 4, 8):
            for cpu_count in (1, 2, 4, 16):
                for platform in ("cpu", "gpu", "tpu"):
                    kw = dict(n_devices=n_devices, cpu_count=cpu_count,
                              platform=platform)
                    assert auto_mesh_devices(rows, **kw) == \
                        ref_auto(rows, **kw), (rows, kw)
    # a CUDA Matcher counts the visible cards: more than one, on a
    # workload big enough to shard, is a mesh over all of them
    m = Matcher(Dataset.from_graph(port_graph(workload("fig1")[1])),
                device="cpu")
    opts = MatchOptions(mesh="auto")
    assert m._resolve_mesh(opts, total_rows=10 ** 6) is None
    m.device = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert m._resolve_mesh(opts, total_rows=10 ** 6) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert m._resolve_mesh(opts, total_rows=100) is None
    mesh = m._resolve_mesh(opts, total_rows=10 ** 6)
    assert mesh.size == 4
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4))


def test_stream_and_explain_match_the_reference_api():
    query, data = workload("random2")
    ref = RefMatcher(RefDataset.from_graph(data))
    m = Matcher(Dataset.from_graph(port_graph(data)), device="cpu")
    q = port_graph(query)
    assert (m.explain(q, engine="vector")
            == ref.explain(query, engine="vector"))
    want = {tuple(sorted(e.items())) for e in ref.stream(query, engine="ref")}
    got = list(m.stream(q, engine="vector", tile_rows=8))
    assert len(got) == len(want)
    assert {tuple(sorted(e.items())) for e in got} == want
    assert len(list(m.stream(q, engine="vector", limit=5))) == 5
    info = m.cache_info()
    assert info.misses == 1 and info.hits >= 2 and info.size == 1


def test_auto_engine_and_ref_engine_match_the_reference():
    query, data = workload("brother")
    ref = RefMatcher(RefDataset.from_graph(data)).count(query)
    out = Matcher(Dataset.from_graph(port_graph(data)),
                  device="cpu").count(port_graph(query))
    assert (out.engine, out.count) == (ref.engine, ref.count) == ("ref", 144)


def test_matcher_runs_on_cuda_unless_told_cpu(monkeypatch):
    ds = Dataset.from_graph(port_graph(workload("fig1")[1]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        Matcher(ds)
    with pytest.raises(RuntimeError):
        Matcher(ds, device="cuda")
    assert Matcher(ds, device="cpu").device == torch.device("cpu")


def test_options_not_ported_raise():
    """Every option the reference accepts is accepted: an explicit mesh of
    2 or 4 lanes too. On one device mesh=4 is clamped to the single-device
    path, as the reference's `make_enum_mesh` clamps it: the same count
    and every VectorStats field as mesh=None."""
    assert MatchOptions(mesh=2).mesh == 2
    assert MatchOptions(mesh=4).mesh == 4
    assert MatchOptions(mesh=1).mesh == 1
    assert MatchOptions(mesh="auto").mesh == "auto"
    # the compat loop is ported: use_cer_buffer=False is a valid option
    assert MatchOptions(use_cer_buffer=False).use_cer_buffer is False
    with pytest.raises(ValueError):
        MatchOptions(intersect="bogus")
    query, data = workload("synthetic")
    ds = Dataset.from_graph(port_graph(data))
    q = port_graph(query)
    m = Matcher(ds, device="cpu")
    assert m._resolve_mesh(MatchOptions(mesh=4), total_rows=10 ** 6) is None
    kw = dict(engine="vector", tile_rows=8)
    single = Matcher(ds, device="cpu").count(q, mesh=None, **kw)
    four = Matcher(ds, device="cpu").count(q, mesh=4, **kw)
    assert four.count == single.count
    assert dataclasses.asdict(four.stats) == dataclasses.asdict(single.stats)
    outs = Matcher(ds, device="cpu").match_many([q, q], mesh=4, **kw)
    assert [o.count for o in outs] == [single.count] * 2


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "from repro_torch.api import Dataset, Matcher\n"
        "ds = Dataset.synthetic('yeast', scale=0.1)\n"
        "q = ds.random_query(size=4, seed=1)\n"
        "out = Matcher(ds, device='cpu').count(q, engine='vector')\n"
        "assert out.count > 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_sources_import_neither_jax_nor_the_reference():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)"
                         r"(\.|\s))", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_trace.py",
              ROOT / "chip_shard.py"]
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f
