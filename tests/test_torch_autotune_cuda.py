"""Each word-block width of the bitmap kernels against the plain version
(which has no width), bit for bit, on the card (`cuda` marker; skips without
one). No JAX here, so it runs where the card is:
`python -m pytest -q -m cuda tests/test_torch_autotune_cuda.py`.
`chip_smoke.py` phase 3 holds the full grid."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import bitmap_intersect as bi  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("wpb", [32, 64, 128])
def test_cuda_every_width_matches_the_plain_version(wpb):
    """Each kernel instantiation against the plain version, bit for bit,
    on ragged widths around the passes' edges (chip_smoke.py runs the
    full grid)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the H100 via chip_smoke.py)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(wpb)
    for k, w in ((1, 1), (2, 31), (3, 82), (4, 129), (2, 257)):
        tt = [_t(rng.integers(0, 2 ** 32, (30 + 3 * j, w), dtype=np.uint32))
              .to(dev) for j in range(k)]
        idx = torch.from_numpy(rng.integers(-3, 40, (300, 4)).astype(
            np.int32)).to(dev)
        keys = idx.clamp(min=0)[:, :k].contiguous()
        slots = [j % 4 for j in range(k)]
        for got, want in (
                (bi.bitmap_intersect(tt, keys, words_per_block=wpb),
                 ref.bitmap_intersect_ref(tt, keys)),
                (bi.tile_intersect(tt, idx, slots, [3], words_per_block=wpb),
                 ref.tile_intersect_ref(tt, idx, slots, [3]))):
            assert all(torch.equal(g, x) for g, x in zip(got, want))
        r = _t(rng.integers(0, 2 ** 32, (300, w), dtype=np.uint32)).to(dev)
        for start in (0, 1000, 10 ** 6):
            args = (r, start, 256, idx, tt, slots, [4, 3])
            got = bi.expand_intersect(*args, words_per_block=wpb)
            want = ref.expand_intersect_ref(*args)
            assert all(torch.equal(g, x) for g, x in zip(got, want))
        rows = torch.from_numpy(rng.integers(0, 300, 256).astype(
            np.int32)).to(dev)
        got = bi.fused_expand_intersect(tt, idx, rows, rows, slots,
                                        words_per_block=wpb)
        want = ref.fused_expand_intersect_ref(tt, idx, rows, rows,
                                              slots=slots)
        assert all(torch.equal(g, x) for g, x in zip(got, want))
