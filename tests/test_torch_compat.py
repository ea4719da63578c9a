"""The torch port's stage-at-a-time compat loop (`use_cer_buffer=False`)
on the CPU, against the reference.

`TileScheduler._run_tiles` runs one dispatch per primitive, with the
per-tile bucketed CER compute (`_dedup_fn`, `_bucket_compute_fn`). Its
counts and every `VectorStats` field — `bucketed_tiles`, `dedup_keys_seen`,
`dedup_unique`, `device_steps`, and zeros for the failure cache and the
superstep readbacks — must equal the reference `_run_tiles`' on the same
plan, run in one subprocess for the whole file (torch_reference.py). The
reference runs with intersect="jnp"; the compat loop's stats do not
depend on the route, and the port runs each case on every route."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch_reference import (WORKLOADS, port_graph,  # noqa: E402
                             reference_plan, run_reference, workload)

from repro.core.ref_engine import cemr_match  # noqa: E402
from repro_torch.api import Dataset, MatchOptions, Matcher  # noqa: E402
from repro_torch.core.engine import VectorEngine  # noqa: E402
from repro_torch.core.plan import plan_from_arrays  # noqa: E402

KNOBS = [dict(tile_rows=8), dict(tile_rows=8, use_dedup=False),
         dict(tile_rows=256)]
CASES = [(w, kw) for w in WORKLOADS for kw in KNOBS]
ZERO_FIELDS = ("fail_hits", "fail_misses", "fail_inserts",
               "fail_pruned_rows", "readbacks", "overlapped_supersteps",
               "supersteps", "packed_tiles")


@pytest.fixture(scope="module")
def reference():
    return run_reference([dict(workload=w, use_cer_buffer=False,
                               intersect="jnp", **kw) for w, kw in CASES])


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{w}-" + "-".join(f"{k}={v}"
                                                 for k, v in kw.items())
                              for w, kw in CASES])
def test_compat_loop_matches_the_reference_run_tiles(case, reference):
    name, kw = CASES[case]
    want = reference[case]
    cs, an, plan = reference_plan(name)
    for intersect in ("jnp", "auto", "fused"):
        eng = VectorEngine(cs, an, device="cpu",
                           plan=plan_from_arrays(dataclasses.asdict(plan)),
                           use_cer_buffer=False, intersect=intersect, **kw)
        res = eng.run(limit=10 ** 9)
        assert res.count == want["count"], intersect
        assert res.timed_out == want["timed_out"]
        st = dataclasses.asdict(res.stats)
        assert st == want["stats"], intersect
        assert all(st[f] == 0 for f in ZERO_FIELDS)


def test_the_compat_cases_exercise_the_bucketed_cer(reference):
    total = {k: sum(r["stats"][k] for r in reference)
             for k in ("bucketed_tiles", "dedup_unique", "leaf_tiles",
                       "expansions")}
    assert all(v > 0 for v in total.values()), total


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_count_without_the_cer_buffer_matches_cemr_match(name):
    query, data = workload(name)
    m = Matcher(Dataset.from_graph(port_graph(data)), device="cpu")
    q = port_graph(query)
    want = cemr_match(query, data).count
    for use_dedup in (True, False):
        out = m.count(q, MatchOptions(engine="vector", use_cer_buffer=False,
                                      use_dedup=use_dedup, tile_rows=16))
        assert out.count == want
        assert out.stats.readbacks == out.stats.supersteps == 0
    # the compat loop honours the limit and the dispatch budget
    assert m.count(q, engine="vector", use_cer_buffer=False,
                   limit=2).count == min(2, want)
    capped = m.count(q, engine="vector", use_cer_buffer=False, budget=3)
    assert capped.stats.device_steps <= 4
