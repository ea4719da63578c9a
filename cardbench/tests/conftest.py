"""Shared fixtures: cells cut to a CPU-sized data graph and pool."""
import pytest

from cardbench.cell import load_cell

# data graphs of about this many vertices: small enough for the CPU, large
# enough that the tiny pools still leave some answers under the limit and
# some at it
TINY_VERTICES = 3_000


@pytest.fixture
def tiny_cell():
    """load_cell(name) with a tiny data graph, two queries of each size,
    the vector engine forced (auto picks the host DFS on graphs this
    small): the cell's own traffic otherwise."""
    def make(name: str, per_size: int = 2):
        cell = load_cell(name)
        cell.config["scale"] = min(1.0, TINY_VERTICES /
                                   cell.config["vertices"])
        cell.traffic["pool"]["per_size"] = per_size
        cell.traffic["options"]["engine"] = "vector"
        return cell
    return make
