"""The torch port's `repro_torch.core` package surface against
`repro.core`'s: the same exported names, the deprecated `cemr_match` /
`vector_match` shims (each warns once and returns the reference's
result), the per-candidate reference compiler, and the networkx oracle,
which must import without loading networkx."""
import dataclasses
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_reference import (port_graph, run_reference,  # noqa: E402
                             workload)

import repro.core as ref_core  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro.core.filtering_ref import \
    build_candidate_space_reference as ref_build  # noqa: E402
from repro_torch.core.filtering import build_data_index  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHIM_WORKLOADS = ["fig1", "random1", "brother", "synthetic"]
CS_WORKLOADS = ["fig1", "random0", "random1", "random2", "brother",
                "synthetic", "packing", "failing", "star", "clique6",
                "batch1:0", "batch1:4"]


@pytest.fixture(scope="module")
def reference_vector():
    """The reference VectorEngine's default run of each shim workload —
    what the reference `vector_match` computes."""
    return run_reference([dict(workload=w) for w in SHIM_WORKLOADS])


def test_all_equals_the_reference():
    assert core.__all__ == ref_core.__all__
    for name in core.__all__:
        assert callable(getattr(core, name)) or isinstance(
            getattr(core, name), type), name


def _warnings_of(fn, *args, **kwargs):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    return out, [w for w in caught
                 if issubclass(w.category, DeprecationWarning)]


@pytest.mark.parametrize("name", SHIM_WORKLOADS)
def test_cemr_match_shim_warns_once_and_equals_the_reference(name,
                                                             monkeypatch):
    monkeypatch.setattr(core, "_DEPRECATION_WARNED", set())
    query, data = workload(name)
    first, w1 = _warnings_of(core.cemr_match, port_graph(query),
                             port_graph(data))
    second, w2 = _warnings_of(core.cemr_match, port_graph(query),
                              port_graph(data))
    assert len(w1) == 1 and not w2
    assert "repro_torch.api.Matcher" in str(w1[0].message)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = ref_core.cemr_match(query, data)
    assert first.count == second.count == want.count
    assert dataclasses.asdict(first.stats).keys() == \
        dataclasses.asdict(want.stats).keys()


@pytest.mark.parametrize("i", range(len(SHIM_WORKLOADS)),
                         ids=SHIM_WORKLOADS)
def test_vector_match_shim_warns_once_and_equals_the_reference(
        i, reference_vector, monkeypatch):
    monkeypatch.setattr(core, "_DEPRECATION_WARNED", set())
    query, data = workload(SHIM_WORKLOADS[i])
    res, w1 = _warnings_of(core.vector_match, port_graph(query),
                           port_graph(data), device="cpu")
    _, w2 = _warnings_of(core.vector_match, port_graph(query),
                         port_graph(data), device="cpu")
    assert len(w1) == 1 and not w2
    want = reference_vector[i]
    assert res.count == want["count"]
    assert dataclasses.asdict(res.stats) == want["stats"]


def test_vector_match_shim_needs_the_card_unless_told_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    query, data = workload("fig1")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            core.vector_match(port_graph(query), port_graph(data))


def _assert_same_space(got, want):
    assert len(got.cand) == len(want.cand)
    for a, b in zip(got.cand, want.cand):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for field in ("adj_indptr", "adj_indices"):
        ga, wa = getattr(got, field), getattr(want, field)
        assert ga.keys() == wa.keys()
        for k in wa:
            assert ga[k].dtype == wa[k].dtype
            assert np.array_equal(ga[k], wa[k]), (field, k)


@pytest.mark.parametrize("name", CS_WORKLOADS)
def test_build_candidate_space_reference_equals_the_reference(name):
    query, data = workload(name)
    for rounds in (0, 3):
        want = ref_build(query, data, refine_rounds=rounds)
        q, d = port_graph(query), port_graph(data)
        got = core.build_candidate_space_reference(q, d, refine_rounds=rounds)
        _assert_same_space(got, want)
        # with a prebuilt index, and against the vectorized compiler
        _assert_same_space(core.build_candidate_space_reference(
            q, d, refine_rounds=rounds, index=build_data_index(d)), want)
        _assert_same_space(core.build_candidate_space(
            q, d, refine_rounds=rounds), want)


def test_oracle_imports_without_networkx_and_counts():
    code = ("import sys\n"
            "import repro_torch.core\n"
            "from repro_torch.core import oracle\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('networkx', 'torch', 'jax', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    pytest.importorskip("networkx")
    from repro.core.oracle import nx_count as ref_nx_count
    from repro_torch.core.oracle import nx_count, nx_embeddings
    for name in ("fig1", "random1", "brother"):
        query, data = workload(name)
        n = nx_count(port_graph(query), port_graph(data))
        assert n == ref_nx_count(query, data)
        assert n == len(nx_embeddings(port_graph(query), port_graph(data)))
