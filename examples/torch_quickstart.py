"""Quickstart on the torch port: match a query graph against a data graph
with CEMR through the `repro_torch.api` session layer (Dataset /
MatchOptions / Matcher), on the card unless `--device cpu` is given.

  PYTHONPATH=src python examples/torch_quickstart.py               # CUDA
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

from repro_torch.api import Dataset, MatchOptions, Matcher
from repro_torch.core import (build_graph, random_walk_query,
                              synthetic_labeled_graph)
from repro_torch.device import resolve_device


def fig1_graphs():
    """The paper's Figure-1 data graph and query graph."""
    data = build_graph(
        12,
        [(0, 1), (0, 2), (0, 3), (0, 7), (0, 8), (1, 2), (1, 3), (1, 7),
         (1, 8), (2, 4), (2, 5), (2, 6), (3, 6), (4, 9), (5, 10), (5, 9),
         (6, 10), (8, 10), (8, 11), (9, 11), (10, 11), (7, 2), (8, 3)],
        [0, 1, 2, 2, 3, 3, 3, 4, 4, 0, 0, 1])
    query = build_graph(
        7, [(0, 1), (0, 2), (0, 4), (1, 2), (1, 4), (2, 3), (3, 5), (4, 5),
            (4, 6), (5, 6)],
        [0, 1, 2, 3, 4, 0, 1])
    return data, query


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the card; without one, "
                         "an error)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    data, query = fig1_graphs()
    dataset = Dataset.from_graph(data, name="fig1")
    matcher = Matcher(dataset, device=dev)           # engine="auto"
    out = matcher.count(query)
    print(f"[paper Fig.1] embeddings: {out.count} (engine={out.engine}) "
          f"on {dev}")
    embeddings = []
    for m in matcher.stream(query):                  # explicit embeddings
        embeddings.append(dict(sorted(m.items())))
        print("  ", {f"u{k}": f"v{v}" for k, v in sorted(m.items())})
    print(matcher.explain(query))

    # a bigger synthetic workload: one session, both engines on one plan
    g = synthetic_labeled_graph(2000, 8.0, 8, seed=0)
    q = random_walk_query(g, 6, seed=1)
    session = Matcher(Dataset.from_graph(g), MatchOptions(limit=100_000),
                      device=dev)
    ref = session.count(q, engine="ref")
    vec = session.count(q, engine="vector", tile_rows=1024)
    print(f"\n[synthetic 2k-vertex graph] ref={ref.count} vec={vec.count} "
          f"(agree: {ref.count == vec.count})")
    print(f"  ref intersections={ref.stats.intersections} "
          f"CEB hits={ref.stats.ceb_hits}")
    print(f"  vec tiles={vec.stats.tiles} dedup_ratio="
          f"{vec.stats.dedup_ratio:.2f}")
    info = session.cache_info()
    print(f"  plan cache: {info}   (vec compiled from the cached ref plan)")
    return {"device": str(dev), "fig1_count": out.count,
            "fig1_engine": out.engine, "embeddings": embeddings,
            "ref_count": ref.count, "vec_count": vec.count,
            "ref_intersections": ref.stats.intersections,
            "ref_ceb_hits": ref.stats.ceb_hits,
            "vec_tiles": vec.stats.tiles,
            "vec_dedup_ratio": vec.stats.dedup_ratio, "cache_info": info}


if __name__ == "__main__":
    main()
