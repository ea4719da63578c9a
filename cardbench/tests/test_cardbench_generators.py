"""The benchmark's generator copies give the port's graphs bit for bit."""
import numpy as np
import pytest

from cardbench import datasets
from repro_torch.core import graph as port


def _same(a, b):
    for f in ("labels", "indptr", "indices"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        assert np.array_equal(x, y), f
    assert a.n_labels == b.n_labels


@pytest.mark.parametrize("name,scale,seed", [
    ("dblp", 0.01, 0), ("eu2005", 0.003, 0), ("human", 1.0, 0),
    ("yeast", 0.5, 3), ("youtube", 0.002, 1)])
def test_synthetic_graph_matches_the_port(name, scale, seed):
    _same(datasets.synthetic_graph(name, scale=scale, seed=seed),
          port.synthetic_dataset(name, scale=scale, seed=seed))


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_random_walk_query_matches_the_port(size):
    g = datasets.synthetic_graph("dblp", scale=0.01)
    pg = port.synthetic_dataset("dblp", scale=0.01)
    for seed in (11 + 1000 * size, 2**33 + size):
        _same(datasets.random_walk_query(g, size, seed),
              port.random_walk_query(pg, size, seed))


def test_graph_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setattr(datasets, "CACHE_DIR", tmp_path)
    cfg = {"name": "dblp_synth", "dataset": "dblp", "scale": 0.01,
           "graph_seed": 0, "edges": 1_049_866}
    g, hit = datasets.load_graph(cfg)
    assert not hit and len(list(tmp_path.iterdir())) == 1
    g2, hit2 = datasets.load_graph(cfg)
    assert hit2
    _same(g, g2)


@pytest.mark.parametrize("name,scale", [("dblp", 1.0), ("dblp", 0.01),
                                        ("human", 1.0)])
def test_stated_edge_count_is_met_exactly(name, scale):
    n_full = datasets.DATASET_STATS[name][0]
    edges = 1_049_866 if name == "dblp" else 86_282
    g = datasets.synthetic_graph(name, scale=scale, edges=edges)
    want = round(edges * g.n / n_full)
    assert g.indices.shape[0] == 2 * want
    # a simple undirected graph: rows sorted, no loops, both directions
    rows = np.repeat(np.arange(g.n), g.degree)
    assert (rows != g.indices).all()
    key = rows * g.n + g.indices
    assert (np.diff(key) > 0).all()
    assert np.array_equal(np.sort(g.indices.astype(np.int64) * g.n + rows),
                          key)
    again = datasets.synthetic_graph(name, scale=scale, edges=edges)
    _same(g, again)


def test_query_pool_is_fixed_by_the_traffic():
    g = datasets.synthetic_graph("dblp", scale=0.01)
    spec = {"sizes": [4, 8], "per_size": 3, "pool_seed": 11, "exact": True}
    cfg = {"query_sizes": [4, 8, 16],
           "exact": [[8, 501], [16, 7], [4, 9]]}
    a = datasets.query_pool(g, spec, cfg)
    b = datasets.query_pool(g, spec, cfg)
    assert [q.n for q in a] == [4, 4, 4, 8, 8, 8, 8, 4]
    assert len(datasets.query_pool(g, dict(spec, exact=False), cfg)) == 6
    for x, y in zip(a, b):
        _same(x, y)
    with pytest.raises(ValueError):
        datasets.query_pool(g, dict(spec, sizes=[4, 24]), cfg)


@pytest.mark.parametrize("seed", [0, 2**33 + 5, 4_500_000_001])
def test_replay_order_spreads_the_sizes_through_a_pass(seed):
    sizes = np.array([4] * 16 + [8] * 16 + [16] * 16 + [8] * 4 + [16] * 4)
    order = datasets.replay_order(sizes, seed)
    assert sorted(order.tolist()) == list(range(sizes.shape[0]))
    seq = sizes[order]
    for s in (4, 8, 16):
        share = (sizes == s).mean()
        for k in (6, 12, 24, 39):          # every prefix keeps the shares
            assert abs((seq[:k] == s).sum() - share * k) <= 1.5
    assert not np.array_equal(order, datasets.replay_order(sizes, seed + 1))
