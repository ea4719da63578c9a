"""The plain reference counts what the port counts, and its control (the
distinct-vertices rule dropped) does not."""
import json

import numpy as np
import pytest

from cardbench import datasets, reference
from repro_torch.api import Dataset, MatchOptions, Matcher
from repro_torch.core.graph import Graph


def _port(c):
    return Graph(labels=c.labels, indptr=c.indptr, indices=c.indices,
                 n_labels=c.n_labels)


@pytest.mark.parametrize("name,scale", [("dblp", 0.01), ("eu2005", 0.003),
                                        ("human", 1.0)])
@pytest.mark.parametrize("limit", [50, 100_000])
def test_reference_counts_equal_the_port(name, scale, limit):
    g = datasets.synthetic_graph(name, scale=scale)
    d = reference.DataIndex(g)
    m = Matcher(Dataset.from_graph(_port(g)), device="cpu")
    hit = under = 0
    for size in (4, 6, 8):
        for s in range(3):
            q = datasets.random_walk_query(g, size, 100 * size + s)
            want = reference.count(d, q, limit)
            got = m.count(_port(q), MatchOptions(limit=limit, tile_rows=256,
                                                 engine="vector")).count
            assert got == want, (size, s)
            hit += want == limit
            under += want < limit
    assert (hit if limit == 50 else under) > 0   # the limit hit, and not


def test_reference_on_a_triangle_and_a_path():
    # data: a 4-cycle 0-1-2-3 with chord 0-2, all one label
    src = np.array([0, 1, 2, 3, 0])
    dst = np.array([1, 2, 3, 0, 2])
    g = datasets._csr(4, src, dst, np.zeros(4, dtype=np.int32), 1)
    d = reference.DataIndex(g)
    tri = datasets._csr(3, np.array([0, 1, 2]), np.array([1, 2, 0]),
                        np.zeros(3, dtype=np.int32), 1)
    path = datasets._csr(3, np.array([0, 1]), np.array([1, 2]),
                         np.zeros(3, dtype=np.int32), 1)
    assert reference.count(d, tri, 1000) == 12      # 2 triangles x 3!
    # ordered paths a-b-c with a != c: sum over b of deg(b)(deg(b) - 1)
    assert reference.count(d, path, 1000) == 3 * 2 + 2 * 1 + 3 * 2 + 2 * 1
    assert reference.count(d, path, 5) == 5
    # homomorphisms also let a == c: sum over b of deg(b)^2
    assert reference.count(d, path, 1000, injective=False) == 9 + 4 + 9 + 4


def test_control_comes_out_not_correct():
    g = datasets.synthetic_graph("dblp", scale=0.01)
    d = reference.DataIndex(g)
    pool = datasets.query_pool(g, {"sizes": [8, 16], "per_size": 4,
                                   "pool_seed": 11}, {})
    wrong = sum(reference.count(d, q, 100_000) !=
                reference.count(d, q, 100_000, injective=False)
                for q in pool)
    assert wrong >= 1


def test_select_exact_finds_queries_under_the_limit(capsys):
    from cardbench import select_exact
    select_exact.main(["--config", "dblp_synth", "--sizes", "3", "--want",
                       "2",
                       "--limit", "500", "--seconds", "60", "--scale",
                       "0.01"])
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    g = datasets.synthetic_graph("dblp", scale=0.01, edges=1_049_866)
    d = reference.DataIndex(g)
    assert len(row["found"]) == 2
    for seed, c in row["found"]:
        assert reference.count(d, datasets.random_walk_query(g, 3, seed),
                               500) == c < 500
