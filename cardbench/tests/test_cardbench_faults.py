"""A run whose timed path is broken underneath comes out not correct: one
answer altered where the engine or the superbatch produces it, half of a
superbatch's answers left out, and the distinct-vertices rule dropped only
past depth 4 of the plans (so only 8- and 16-vertex queries can overcount).
Each fault is planted in the program, the rest of the run is the harness's
own, on the CPU at a tiny size; the same run without the fault is correct.
The control (`control.py`: the reference in the program's place, with a
stated guarantee broken) goes through the same `run_cell` and comes out
not correct too."""
import dataclasses
import json
import time

import pytest

from cardbench import control, datasets, run
from cardbench.cell import ROOT
from repro_torch.core import engine as engine_mod
from repro_torch.core import scheduler as sched_mod


# the cells whose window calls Matcher.count, one query a call
COUNT_CELLS = [w["name"] for w in
               json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
               if w["traffic"].startswith("hot_")]
ALL_CELLS = [w["name"] for w in
             json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
DEEP = 4          # the fault below drops the rule at levels past this one


def _run(cell, seed=2**33 + 11, **kw):
    out = run.run_cell(cell, seed=seed, seconds=0.3, trace=False,
                       device="cpu", t_start=time.time(), cache=False, **kw)
    return out["result"], out["info"]


def _pool(cell):
    g, _ = datasets.load_graph(cell.config, cache=False)
    return datasets.query_pool(g, cell.traffic["pool"], cell.config)


@pytest.mark.parametrize("name", COUNT_CELLS)
def test_sound_run_is_correct(tiny_cell, name):
    cell = tiny_cell(name)
    assert _run(cell)[0]["correct"] is True


@pytest.mark.parametrize("name", COUNT_CELLS)
def test_an_answer_altered(tiny_cell, monkeypatch, name):
    cell = tiny_cell(name)
    n = {"runs": 0}
    orig = engine_mod.VectorEngine.run
    warm = len(_pool(cell))

    def altered(self, *a, **kw):
        res = orig(self, *a, **kw)
        n["runs"] += 1
        if n["runs"] == warm + 1:              # the window's first answer
            res.count += 1
        return res
    monkeypatch.setattr(engine_mod.VectorEngine, "run", altered)
    res = _run(cell)[0]
    assert res["correct"] is False and res["failed"] == 1
    assert res["compared"]["wrong_answers"]["value"] == 1


def test_an_answer_altered_in_a_superbatch(tiny_cell, monkeypatch):
    cell = tiny_cell("dblp_synth.batch", per_size=16)
    n = {"runs": 0}
    orig = sched_mod.SuperbatchScheduler.run

    def altered(self, *a, **kw):
        counts, st, timed_out = orig(self, *a, **kw)
        n["runs"] += 1
        return [counts[0] + 1] + list(counts[1:]), st, timed_out
    monkeypatch.setattr(sched_mod.SuperbatchScheduler, "run", altered)
    res = _run(cell)[0]
    assert n["runs"] > 0 and res["correct"] is False


def test_half_the_batch_left_out(tiny_cell, monkeypatch):
    cell = tiny_cell("dblp_synth.batch", per_size=16)
    assert _run(cell)[0]["correct"] is True
    orig = sched_mod.SuperbatchScheduler.run

    def halved(self, *a, **kw):
        counts, st, timed_out = orig(self, *a, **kw)
        return list(counts[:len(counts) // 2]), st, timed_out
    monkeypatch.setattr(sched_mod.SuperbatchScheduler, "run", halved)
    res = _run(cell)[0]
    assert res["correct"] is False and res["failed"] >= 1


@pytest.mark.parametrize("name", COUNT_CELLS)
def test_distinct_vertices_dropped_past_depth_four(tiny_cell, monkeypatch,
                                                   name):
    """The same-label clears of every extension past level DEEP left out:
    only a query of more than DEEP + 1 vertices can overcount, and the
    window's exact answers of 8 and 16 vertices have to show it."""
    cell = tiny_cell(name)
    _, info = _run(cell)
    sizes = {q: datasets.pool_sizes(_pool(cell))[int(q)]
             for q in info["counts"]}
    limit = int(cell.traffic["options"]["limit"])
    assert any(sizes[q] > DEEP + 1 and c < limit
               for q, c in info["counts"].items())
    orig = engine_mod.VectorEngine._make_compute_parts
    hit = {"stages": 0}

    def careless(self, si):
        stage = self._stages[si]
        if stage[0] != "extend" or stage[1].level <= DEEP or \
                not stage[1].same_label_idx_slots:
            return orig(self, si)
        hit["stages"] += 1
        self._stages[si] = ("extend", dataclasses.replace(
            stage[1], same_label_idx_slots=[]))
        try:
            return orig(self, si)
        finally:
            self._stages[si] = stage
    monkeypatch.setattr(engine_mod.VectorEngine, "_make_compute_parts",
                        careless)
    res, info2 = _run(cell)
    assert hit["stages"] > 0
    assert res["correct"] is False and res["failed"] >= 1
    assert res["attempted"] == info2["queries"]


@pytest.mark.parametrize("kind", ["injective", "clamp"])
@pytest.mark.parametrize("name", ALL_CELLS)
def test_control_in_the_programs_place_is_not_correct(tiny_cell, name,
                                                      kind):
    cell = tiny_cell(name)
    if kind == "clamp":           # the tiny graph's answers seldom reach
        cell.traffic["options"]["limit"] = cell.config["limit"] = 50
    out = control.run_control(cell, 2**33 + 3, kind, cache=False)
    assert out["correct"] is False and out["wrong_answers"] >= 1
    assert out["limit"] == 0 and out["answers"] >= out["pool"]
