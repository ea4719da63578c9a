"""Plain torch versions of the bitmap kernels against the reference's jnp
versions and its Pallas kernels in interpret mode, bit for bit; the kernel
wrappers' dispatch and checks; the nvcc loader. The CUDA kernels
themselves run only on the card (the `cuda` marker)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.bitmap_intersect import (  # noqa: E402
    bitmap_intersect_pallas, fused_expand_intersect_pallas)
from repro_torch.kernels import bitmap_intersect as bi  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402


def _tables(rng, k, w, fill):
    out = []
    for _ in range(k):
        s = int(rng.integers(1, 40))
        if fill == "random":
            out.append(rng.integers(0, 2 ** 32, size=(s, w), dtype=np.uint32))
        else:
            out.append(np.full((s, w), 0 if fill == "zeros" else 0xFFFFFFFF,
                               np.uint32))
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _same(got, want):
    np.testing.assert_array_equal(got.numpy().view(np.uint32)
                                  if np.asarray(want).dtype == np.uint32
                                  else got.numpy(), np.asarray(want))


def _fused_case(k, w, k0, fill, seed, t_rows=24):
    rng = np.random.default_rng(seed)
    tabs = _tables(rng, k, w, fill)
    s_min = min(t.shape[0] for t in tabs)
    t_in = int(rng.integers(1, 9))
    idx = rng.integers(0, s_min, size=(t_in, k0)).astype(np.int32)
    rows = rng.integers(0, t_in, size=t_rows).astype(np.int32)
    bitpos = rng.integers(0, s_min, size=t_rows).astype(np.int32)
    # slot k0 reads bitpos, slots below k0 read parent columns
    slots = tuple(int(s) for s in rng.integers(0, k0 + 1, size=k))
    slots = (k0,) + slots[1:] if k0 not in slots else slots
    return tabs, idx, rows, bitpos, slots


@pytest.mark.parametrize("fill", ["random", "zeros", "ones"])
@pytest.mark.parametrize("w", [1, 5, 33])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_bitmap_intersect_plain_matches_reference_and_pallas(k, w, fill):
    rng = np.random.default_rng(k * 100 + w)
    tabs = _tables(rng, k, w, fill)
    idxs = np.stack([rng.integers(0, t.shape[0], 19) for t in tabs],
                    1).astype(np.int32)
    r, pop = bi.bitmap_intersect([_t(t) for t in tabs], torch.from_numpy(idxs))
    assert r.dtype == pop.dtype == torch.int32 and pop.shape == (19, 1)
    jt = tuple(jnp.asarray(t) for t in tabs)
    r_ref, pop_ref = jref.bitmap_intersect_ref(jt, jnp.asarray(idxs))
    _same(r, r_ref)
    _same(pop, pop_ref)
    r_pal, pop_pal = bitmap_intersect_pallas(jt, jnp.asarray(idxs),
                                             words_per_block=4,
                                             interpret=True)
    _same(r, r_pal)
    _same(pop, pop_pal)


@pytest.mark.parametrize("fill", ["random", "zeros", "ones"])
@pytest.mark.parametrize("k0", [0, 1, 3])
@pytest.mark.parametrize("k,w", [(1, 1), (2, 5), (3, 33), (4, 9)])
def test_fused_plain_matches_reference_and_pallas(k, w, k0, fill):
    tabs, idx, rows, bitpos, slots = _fused_case(k, w, k0, fill,
                                                 seed=k * 10 + w + k0)
    r, pop = bi.fused_expand_intersect(
        [_t(t) for t in tabs], torch.from_numpy(idx), torch.from_numpy(rows),
        torch.from_numpy(bitpos), slots)
    jt = tuple(jnp.asarray(t) for t in tabs)
    args = (jt, jnp.asarray(idx), jnp.asarray(rows), jnp.asarray(bitpos))
    r_ref, pop_ref = jref.fused_expand_intersect_ref(*args, slots=slots)
    _same(r, r_ref)
    _same(pop, pop_ref)
    r_pal, pop_pal = fused_expand_intersect_pallas(
        *args, slots=slots, words_per_block=8, interpret=True)
    _same(r, r_pal)
    _same(pop, pop_pal)


def test_plain_versions_clamp_out_of_range_rows_like_jnp():
    rng = np.random.default_rng(3)
    tabs = _tables(rng, 2, 3, "random")
    idxs = np.array([[-5, 0], [10 ** 6, 1], [0, 10 ** 6], [-10 ** 6, -1]],
                    np.int32)
    r, pop = ref.bitmap_intersect_ref([_t(t) for t in tabs],
                                      torch.from_numpy(idxs))
    r_ref, pop_ref = jref.bitmap_intersect_ref(
        tuple(jnp.asarray(t) for t in tabs), jnp.asarray(idxs))
    _same(r, r_ref)
    _same(pop, pop_ref)


@pytest.mark.parametrize("groups", [[[0]], [[0, 1]], [[0, 1, 2]],
                                    [[0], [1, 2], [3, 4, 5]]])
def test_leaf_count_ref_matches_reference(groups):
    rng = np.random.default_rng(len(groups))
    bms = [rng.integers(0, 2 ** 32, size=(11, 4), dtype=np.uint32)
           for _ in range(6)]
    got = ref.leaf_count_ref([_t(b) for b in bms], groups)
    want = jref.leaf_count_ref([jnp.asarray(b) for b in bms], groups)
    _same(got, want)


def test_ops_adapters_flatten_pop_and_keep_cpu_on_plain_versions():
    tabs, idx, rows, bitpos, slots = _fused_case(3, 5, 2, "random", seed=9)
    tt = [_t(t) for t in tabs]
    before = (bi.bitmap_intersect.launches, bi.fused_expand_intersect.launches)
    r, pop = ops.make_fused_expand_intersect_fn()(
        tt, torch.from_numpy(idx), torch.from_numpy(rows),
        torch.from_numpy(bitpos), slots)
    r2, pop2 = ref.fused_expand_intersect_ref(
        tt, torch.from_numpy(idx), torch.from_numpy(rows),
        torch.from_numpy(bitpos), slots=slots)
    assert pop.shape == (rows.shape[0],)
    assert torch.equal(r, r2) and torch.equal(pop, pop2[:, 0])
    idxs = torch.from_numpy(np.stack([rows % t.shape[0] for t in tabs], 1)
                            .astype(np.int32))
    r, pop = ops.make_intersect_fn()(tt, idxs)
    assert pop.shape == (rows.shape[0],)
    # CPU tensors never launch a kernel
    assert (bi.bitmap_intersect.launches,
            bi.fused_expand_intersect.launches) == before


def test_wrappers_reject_bad_inputs():
    t = torch.zeros((4, 2), dtype=torch.int32)
    ok = torch.zeros((3, 1), dtype=torch.int32)
    with pytest.raises(TypeError):
        bi.bitmap_intersect([t.to(torch.int64)], ok)
    with pytest.raises(TypeError):
        bi.bitmap_intersect([t], ok.to(torch.int64))
    with pytest.raises(TypeError):
        bi.bitmap_intersect([t, t], ok)                   # idxs not (T, k)
    with pytest.raises(ValueError):
        bi.bitmap_intersect([t, torch.zeros((4, 3), dtype=torch.int32)],
                            torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        bi.bitmap_intersect([t.t()], ok)                  # not contiguous
    with pytest.raises(ValueError):
        bi.bitmap_intersect([], ok)
    rows = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):                       # slot > K0
        bi.fused_expand_intersect([t], ok, rows, rows, [2])
    with pytest.raises(ValueError):
        bi.bitmap_intersect([t.to("meta")], ok.to("meta"))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_library(bi.LIBRARY)


def test_build_reuses_an_existing_library(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path)
    path = build.library_path(bi.LIBRARY)
    assert path.parent == tmp_path
    assert path == build.library_path(bi.LIBRARY)       # stable name
    path.write_bytes(b"")
    monkeypatch.setenv("PATH", str(tmp_path))            # no nvcc: no build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert build.build_library(bi.LIBRARY) == path


@pytest.mark.cuda
@pytest.mark.parametrize("k0", [0, 2])
def test_cuda_kernels_match_plain_versions(k0):
    """Both CUDA kernels against their plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the H100 via chip_smoke.py)")
    dev = torch.device("cuda")
    for k, w in [(1, 1), (2, 5), (3, 33), (4, 82)]:
        for fill in ("random", "zeros", "ones"):
            tabs, idx, rows, bitpos, slots = _fused_case(
                k, w, k0, fill, seed=k + w, t_rows=256)
            tt = [_t(t).to(dev) for t in tabs]
            args = (torch.from_numpy(idx).to(dev),
                    torch.from_numpy(rows).to(dev),
                    torch.from_numpy(bitpos).to(dev))
            got = bi.fused_expand_intersect(tt, *args, slots)
            want = ref.fused_expand_intersect_ref(tt, *args, slots=slots)
            assert all(torch.equal(g, x) for g, x in zip(got, want))
            idxs = torch.stack([args[1] % t.shape[0] for t in tt], 1)
            idxs = idxs.to(torch.int32).contiguous()
            got = bi.bitmap_intersect(tt, idxs)
            want = ref.bitmap_intersect_ref(tt, idxs)
            assert all(torch.equal(g, x) for g, x in zip(got, want))
