"""repro_torch.core.bitops against repro.core.bitops, bit for bit.

Inputs are numpy arrays from a seed; the reference sees them as uint32,
the port as int32 tensors carrying the same bits."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.core import bitops as ref_bitops  # noqa: E402
from repro_torch.core import bitops  # noqa: E402


def _words(rng, shape, fill="random"):
    if fill == "zeros":
        return np.zeros(shape, np.uint32)
    if fill == "ones":
        return np.full(shape, 0xFFFFFFFF, np.uint32)
    a = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    if fill == "sparse":
        a &= rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
        a &= rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
    return a


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _same_bits(got, want):
    got = got.numpy()
    want = np.asarray(want)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fill", ["random", "sparse", "zeros", "ones"])
@pytest.mark.parametrize("shape", [(1, 1), (7, 3), (33, 17)])
def test_popcounts(fill, shape):
    a = _words(np.random.default_rng(shape[0] * 100 + shape[1]), shape, fill)
    _same_bits(bitops.popcount_words(_t(a)),
               ref_bitops.popcount_words(jnp.asarray(a)))
    got = bitops.row_popcount(_t(a))
    assert got.dtype == torch.int32
    _same_bits(got, ref_bitops.row_popcount(jnp.asarray(a)))


@pytest.mark.parametrize("n_words", [1, 3, 9])
def test_onehot_and_clear_bits(n_words):
    rng = np.random.default_rng(n_words)
    t = 40
    bm = _words(rng, (t, n_words), "sparse")
    # negative rows, both ends of the range, and bit 31 of a word
    idx = rng.integers(-40, 32 * n_words, size=t).astype(np.int32)
    idx[:4] = [-1, 0, 31, 32 * n_words - 1]
    _same_bits(bitops.onehot_word_mask(torch.from_numpy(idx), n_words),
               ref_bitops.onehot_word_mask(jnp.asarray(idx), n_words))
    _same_bits(bitops.clear_bit_rows(_t(bm), torch.from_numpy(idx)),
               ref_bitops.clear_bit_rows(jnp.asarray(bm), jnp.asarray(idx)))
    r, c = bitops.clear_bit_rows_count(_t(bm), torch.from_numpy(idx))
    r_ref, c_ref = ref_bitops.clear_bit_rows_count(jnp.asarray(bm),
                                                   jnp.asarray(idx))
    _same_bits(r, r_ref)
    assert c.dtype == torch.int32
    _same_bits(c, c_ref)


def test_nth_set_bit_including_rank_past_popcount():
    rng = np.random.default_rng(5)
    words = _words(rng, (200,))
    words[:3] = [0, 0xFFFFFFFF, 0x80000000]
    rank = rng.integers(0, 34, size=200).astype(np.int32)
    _same_bits(bitops.nth_set_bit(_t(words), torch.from_numpy(rank)),
               ref_bitops.nth_set_bit(jnp.asarray(words), jnp.asarray(rank)))


@pytest.mark.parametrize("fill", ["random", "sparse", "zeros", "ones"])
@pytest.mark.parametrize("t_rows,n_words,k", [(1, 1, 8), (5, 3, 16),
                                              (12, 4, 32)])
def test_expand_select(fill, t_rows, n_words, k):
    rng = np.random.default_rng(t_rows * 7 + n_words)
    bm = _words(rng, (t_rows, n_words), fill)
    bm[t_rows // 2] = 0                              # an empty middle row
    total = int(np.unpackbits(bm.view(np.uint8)).sum())
    # walk the whole selection in chunks, then start at and past the end
    for start in list(range(0, total + 1, k)) + [total, total + 3]:
        got = bitops.expand_select(_t(bm), start, k)
        want = ref_bitops.expand_select(jnp.asarray(bm), jnp.int32(start), k)
        for g, w in zip(got, want):
            _same_bits(g, w)
        assert got[0].dtype == got[1].dtype == torch.int32
        assert int(got[3]) == total
