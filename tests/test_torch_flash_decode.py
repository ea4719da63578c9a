"""The port's decode attention on the CPU against the reference: the plain
torch version and the split-and-combine plain version (the combine
kernel's) against `repro.kernels.ref.flash_decode_ref` and against the
Pallas kernel `flash_decode_pallas` in interpret mode; the wrapper's split
plan, route, dispatch and checks. The CUDA kernels themselves run only on
the card (the `cuda` marker).

Tolerances: float32 outputs 1e-5 (atol and rtol: both sides accumulate in
float32, in another order); bfloat16 outputs 2e-2 (both sides compute in
float32 from the same bfloat16 inputs and round once, so they differ by at
most one bfloat16 step, 2^-8 relative)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.distributed import context_parallel as jcp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_decode import flash_decode_pallas  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@jax.jit
def jref_ragged_and_full(q, k, v, lengths):
    """The oracle with the given lengths and with None, in one compile (the
    eager oracle would compile each of its ops anew for every shape)."""
    return (jref.flash_decode_ref(q, k, v, lengths),
            jref.flash_decode_ref(q, k, v))


def _case(b, h, hkv, s, d, q_dtype, kv_dtype, seed):
    """Torch tensors of the given dtypes and the same values for JAX;
    ragged lengths in [1, S] that hold 1 and S when B > 1."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, h, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, hkv, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, hkv, d), np.float32))
    q, k, v = q.to(q_dtype), k.to(kv_dtype), v.to(kv_dtype)
    lens = rng.integers(1, s + 1, b)
    if b > 1:
        lens[:2] = (1, s)
    lengths = torch.from_numpy(lens.astype(np.int32))
    jx = [jnp.asarray(x.float().numpy()).astype(JNP[x.dtype])
          for x in (q, k, v)]
    return (q, k, v, lengths), (*jx, jnp.asarray(lens.astype(np.int32)))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("s", [1, 17, 128, 200])
@pytest.mark.parametrize("h,hkv", [(4, 2), (12, 2), (4, 4)])
@pytest.mark.parametrize("b", [1, 3])
def test_plain_version_matches_reference_and_pallas(b, h, hkv, s, d, dtype):
    """Every shape against the oracle, with ragged lengths and with None,
    and in float32 against the Pallas kernel (each shape costs the
    interpreter half a second of compiling, so bfloat16 meets the kernel in
    the mixed-dtype test instead)."""
    (q, k, v, lengths), (jq, jk, jv, jl) = _case(
        b, h, hkv, s, d, dtype, dtype, seed=b * 1000 + h * 100 + s + d)
    out = fd.flash_decode(q, k, v, lengths)
    assert out.dtype == dtype and out.shape == (b, h, d)
    want, want_full = jref_ragged_and_full(jq, jk, jv, jl)
    _close(out, want, dtype)
    _close(fd.flash_decode(q, k, v), want_full, dtype)
    if dtype == torch.float32:
        _close(out, flash_decode_pallas(jq, jk, jv, jl, interpret=True),
               dtype)


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_bf16_and_mixed_dtypes_match_reference_and_pallas(q_dtype, kv_dtype):
    """bfloat16 and mixed dtypes, as the serving path has them (bfloat16 q
    over a float32 or bfloat16 cache), at S = 200, where the Pallas kernel
    pads the cache to two S-blocks; the output takes q's dtype."""
    (q, k, v, lengths), (jq, jk, jv, jl) = _case(
        3, 12, 2, 200, 64, q_dtype, kv_dtype, seed=5)
    out = fd.flash_decode(q, k, v, lengths)
    assert out.dtype == q_dtype
    _close(out, jref_ragged_and_full(jq, jk, jv, jl)[0], q_dtype)
    _close(out, flash_decode_pallas(jq, jk, jv, jl, interpret=True),
           q_dtype)


def test_empty_row_gives_nan_as_the_reference_does():
    """lengths[b] == 0 is outside the contract: both versions give NaN for
    that row and leave the others alone."""
    (q, k, v, _), (jq, jk, jv, _) = _case(2, 4, 2, 9, 16, torch.float32,
                                          torch.float32, seed=3)
    lengths = torch.tensor([0, 9], dtype=torch.int32)
    out = fd.flash_decode(q, k, v, lengths)
    want = np.asarray(jref.flash_decode_ref(jq, jk, jv,
                                            jnp.asarray([0, 9], jnp.int32)))
    assert torch.isnan(out[0]).all() and np.isnan(want[0]).all()
    _close(out[1], want[1], torch.float32)


def test_ops_dispatch_and_launch_count_on_the_cpu():
    (q, k, v, lengths), _ = _case(3, 4, 2, 17, 16, torch.float32,
                                  torch.float32, seed=1)
    fd.reset_launches()
    want = ref.flash_decode_ref(q, k, v, lengths)
    for use_kernel in (True, False):
        got = ops.decode_attention(q, k, v, lengths, use_kernel=use_kernel)
        assert torch.equal(got, want)
    assert fd.flash_decode.launches == 0      # the CPU launches no kernel
    assert fd.flash_decode.launches_by_route == dict.fromkeys(fd.ROUTES, 0)
    assert fd.flash_decode.launches_by_kernel == dict.fromkeys(fd.KERNELS, 0)


def _boundary_lengths(chunk, s):
    """Lengths at and around the chunk boundaries, clamped into [1, S]:
    1, chunk - 1, chunk, chunk + 1, 2 * chunk and S."""
    lens = [1, chunk - 1, chunk, chunk + 1, 2 * chunk, s]
    return np.clip(np.asarray(lens), 1, s).astype(np.int32)


SPLIT_S = 300


@pytest.mark.parametrize("chunk", [1, 7, 16, 128, SPLIT_S + 5],
                         ids=lambda c: f"chunk{c}")
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (12, 2), (16, 2), (32, 1)],
                         ids=lambda x: str(x))
def test_split_version_matches_reference_and_pallas(h, hkv, chunk):
    """The split-and-combine plain version over chunks of 1, 7, 16, 128
    and more than S positions, G in {1, 2, 6, 8, 32}, lengths at the chunk
    boundaries: against the port's plain version, the JAX oracle (with the
    lengths and with None) and the Pallas kernel in interpret mode."""
    (q, k, v, _), (jq, jk, jv, _) = _case(6, h, hkv, SPLIT_S, 16,
                                          torch.float32, torch.float32,
                                          seed=h * 10 + hkv)
    lens = _boundary_lengths(chunk, SPLIT_S)
    lengths, jl = torch.from_numpy(lens), jnp.asarray(lens)
    got = ref.flash_decode_split_ref(q, k, v, lengths, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (6, h, 16)
    want, want_full = jref_ragged_and_full(jq, jk, jv, jl)
    _close(got, want, torch.float32)
    _close(got, ref.flash_decode_ref(q, k, v, lengths), torch.float32)
    _close(ref.flash_decode_split_ref(q, k, v, chunk=chunk), want_full,
           torch.float32)
    _close(got, flash_decode_pallas(jq, jk, jv, jl, interpret=True),
           torch.float32)


@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)],
    ids=["bf16-bf16", "bf16-f32"])
def test_split_version_in_bf16_matches_reference(q_dtype, kv_dtype):
    """The two serving dtype pairs: the split version rounds once, to q's
    dtype, as the oracle does."""
    (q, k, v, _), (jq, jk, jv, _) = _case(6, 12, 2, SPLIT_S, 64, q_dtype,
                                          kv_dtype, seed=11)
    lens = _boundary_lengths(16, SPLIT_S)
    got = ref.flash_decode_split_ref(q, k, v, torch.from_numpy(lens),
                                     chunk=16)
    assert got.dtype == q_dtype
    _close(got, jref_ragged_and_full(jq, jk, jv, jnp.asarray(lens))[0],
           q_dtype)


def test_split_version_gives_nan_for_an_empty_row():
    """lengths[b] == 0: every chunk is empty, the merge is 0/0 = NaN, as
    the oracle's all-masked softmax gives; the other rows are unharmed."""
    (q, k, v, _), (jq, jk, jv, _) = _case(2, 4, 2, 9, 16, torch.float32,
                                          torch.float32, seed=3)
    lengths = torch.tensor([0, 9], dtype=torch.int32)
    want = np.asarray(jref.flash_decode_ref(jq, jk, jv,
                                            jnp.asarray([0, 9], jnp.int32)))
    for chunk in (1, 4, 9):
        out = ref.flash_decode_split_ref(q, k, v, lengths, chunk=chunk)
        assert torch.isnan(out[0]).all()
        _close(out[1], want[1], torch.float32)


@pytest.mark.parametrize("shape", [
    (32, 12, 2, 32_772, 128), (4, 12, 2, 24, 128), (3, 12, 2, 32_768, 128),
    (1, 4, 2, 1, 16), (3, 4, 4, 200, 64), (2, 32, 1, 4096, 128),
    (1, 64, 2, 1 << 20, 256)], ids=str)
def test_split_plan_covers_s_and_sizes_the_workspace(shape):
    """The chunks cover S exactly once (the last one may be short), the
    workspace is (B, H, n_chunks, D + 2) exactly when there is more than
    one chunk, and a split chunk is a power of two in [128, 2048]."""
    b, h, hkv, s, d = shape
    chunk, n_chunks, ws = fd.split_plan(b, h, hkv, s, d)
    assert chunk * (n_chunks - 1) < s <= chunk * n_chunks
    if n_chunks == 1:
        assert ws is None and chunk == s
    else:
        assert ws == (b, h, n_chunks, d + 2)
        assert chunk & (chunk - 1) == 0 and 128 <= chunk <= 2048


def test_split_plan_at_the_paths_shapes():
    """decode_32k (one layer at batch 32): chunks of 1,024 positions, 33
    of them, 2,112 CTAs and a 6.6 MB workspace; the serve loop's
    24-position cache: one chunk, no workspace. The plan takes shapes
    only, so the same shapes always give the same plan whatever the
    lengths."""
    assert fd.split_plan(32, 12, 2, 32_772, 128) == (1024, 33,
                                                     (32, 12, 33, 130))
    assert 32 * 12 * 33 * 130 * 4 == 6_589_440
    assert fd.split_plan(4, 12, 2, 24, 128) == (24, 1, None)


def test_split_plan_at_the_long_context_shapes():
    """One long row of a 2-KV-head cache aims at 128 CTAs, chunks capped
    at 2,048: the long_500k layer (B 1, S 524,292) in 257 chunks of 2,048
    (514 CTAs, workspace (1, 12, 257, 130), 1.6 MB), the first block of
    its 4-lane split (S 131,073) in 65. A grid of 3 columns keeps the
    2,048-CTA aim: at S 131,073, 1,025 chunks of 128 (the combine's
    many-row case on the card)."""
    assert fd.split_plan(1, 12, 2, 524_292, 128) == (2048, 257,
                                                     (1, 12, 257, 130))
    assert fd.split_plan(1, 12, 2, 131_073, 128) == (2048, 65,
                                                     (1, 12, 65, 130))
    assert fd.split_plan(1, 12, 3, 131_073, 128) == (128, 1025,
                                                     (1, 12, 1025, 130))


def _block_rows(q, k, v, lengths, n, block):
    """The partial rows of n blocks of `block` positions, stacked as the
    merge takes them: (B, H, n, D + 2)."""
    return torch.stack([fd.flash_decode_partials(q, k[:, o:o + block],
                                                 v[:, o:o + block], lengths,
                                                 o)
                        for o in range(0, n * block, block)], dim=2)


@pytest.mark.parametrize("n", [1, 2, 7, 16, 17, 33, 64, 65, 128, 129, 257,
                               512, 513, 1025])
def test_merge_of_n_rows_matches_reference(n):
    """The merge of n rows a (b, h), at the row counts where the combine's
    warps a CTA change (a warp for every 16 rows up to 8) and past them:
    the partials of n blocks of 3 positions of one cache, merged,
    equal the JAX oracle over the whole cache at a full and a ragged
    length."""
    s = 3 * n
    (q, k, v, _), (jq, jk, jv, _) = _case(2, 4, 2, s, 16, torch.float32,
                                          torch.float32, seed=n)
    lens = np.asarray([s, 1 + (s * 5) // 7], np.int32)
    rows = _block_rows(q, k, v, torch.from_numpy(lens), n, 3)
    assert rows.shape == (2, 4, n, 18)
    want = jref.flash_decode_ref(jq, jk, jv, jnp.asarray(lens))
    _close(fd.flash_decode_merge(rows, torch.float32), want, torch.float32)


def test_merge_reads_rows_that_start_at_an_odd_float():
    """Rows in a contiguous view that starts one float into its buffer (4
    bytes past an 8-byte boundary) merge as their copy does, and as the
    JAX oracle over the cache."""
    n = 40
    (q, k, v, lengths), (jq, jk, jv, jl) = _case(2, 4, 2, 3 * n, 16,
                                                 torch.float32,
                                                 torch.float32, seed=16)
    rows = _block_rows(q, k, v, lengths, n, 3)
    view = torch.empty(rows.numel() + 1)[1:].view(rows.shape)
    view.copy_(rows)
    assert view.is_contiguous() and view.data_ptr() % 8 == 4
    got = fd.flash_decode_merge(view, torch.float32)
    torch.testing.assert_close(got, fd.flash_decode_merge(rows,
                                                          torch.float32))
    _close(got, jref.flash_decode_ref(jq, jk, jv, jl), torch.float32)


MANY_CHUNK, MANY_S = 4, 4 * 1030         # 1,030 chunks


def test_split_version_at_over_1000_chunks_matches_reference_and_pallas():
    """The plain split-and-combine over 1,030 chunks of 4 positions at
    lengths 1, chunk - 1, chunk + 1 and S (in the first three rows all
    chunks but the first one or two are empty): against the JAX oracle
    (with the lengths and with None) and the Pallas kernel in interpret
    mode."""
    (q, k, v, _), (jq, jk, jv, _) = _case(4, 4, 2, MANY_S, 16,
                                          torch.float32, torch.float32,
                                          seed=13)
    lens = np.asarray([1, MANY_CHUNK - 1, MANY_CHUNK + 1, MANY_S], np.int32)
    got = ref.flash_decode_split_ref(q, k, v, torch.from_numpy(lens),
                                     chunk=MANY_CHUNK)
    want, want_full = jref_ragged_and_full(jq, jk, jv, jnp.asarray(lens))
    _close(got, want, torch.float32)
    _close(ref.flash_decode_split_ref(q, k, v, chunk=MANY_CHUNK),
           want_full, torch.float32)
    _close(got, flash_decode_pallas(jq, jk, jv, jnp.asarray(lens),
                                    interpret=True), torch.float32)


def test_merge_of_over_1000_rows_with_only_the_last_one_holding_positions():
    """1,030 chunk rows of which only the last holds positions (the
    others are the empty row (0, -inf, 0)): the merge equals the JAX
    oracle over the last chunk alone; with NaN in the empty rows' acc it
    is the same, since an empty row's acc is never used."""
    (q, k, v, _), (jq, jk, jv, _) = _case(2, 4, 2, MANY_S, 16,
                                          torch.float32, torch.float32,
                                          seed=14)
    last = MANY_S - MANY_CHUNK
    none = torch.zeros(2, dtype=torch.int32)
    rows = [fd.flash_decode_partials(q, k[:, c0:c0 + MANY_CHUNK],
                                     v[:, c0:c0 + MANY_CHUNK],
                                     none if c0 < last else None, c0)
            for c0 in range(0, MANY_S, MANY_CHUNK)]
    parts = torch.stack(rows, dim=2)
    assert parts.shape == (2, 4, 1030, 18)
    assert torch.isinf(parts[:, :, :-1, -2]).all()
    want = jref.flash_decode_ref(jq, jk[:, last:], jv[:, last:])
    _close(fd.flash_decode_merge(parts, torch.float32), want, torch.float32)
    parts[:, :, :-1, :16] = float("nan")
    _close(fd.flash_decode_merge(parts, torch.float32), want, torch.float32)


def test_over_1000_empty_chunks_give_nan_and_the_empty_partial():
    """Length 0 over 1,030 chunks: the split version gives NaN, as the
    JAX oracle does; the partials of the whole cache as one block are
    exactly (0, -inf, 0), where the reference's `_local_partials` carries
    (0, -1e30, 0); their merge, and the merge of 1,030 empty rows, is
    NaN."""
    (q, k, v, _), (jq, jk, jv, _) = _case(2, 4, 2, MANY_S, 16,
                                          torch.float32, torch.float32,
                                          seed=15)
    none = torch.zeros(2, dtype=torch.int32)
    got = ref.flash_decode_split_ref(q, k, v, none, chunk=MANY_CHUNK)
    want = np.asarray(jref.flash_decode_ref(jq, jk, jv,
                                            jnp.zeros(2, jnp.int32)))
    assert torch.isnan(got).all() and np.isnan(want).all()
    part = fd.flash_decode_partials(q, k, v, none, 0)
    m, l, o = jcp._local_partials(jq, jk, jv, jnp.zeros(2, jnp.int32), 0,
                                  0.25)
    assert (np.asarray(m) == -1e30).all() and (np.asarray(l) == 0).all()
    assert (np.asarray(o) == 0).all()
    assert torch.isinf(part[..., -2]).all() and (part[..., -2] < 0).all()
    assert (part[..., -1] == 0).all() and (part[..., :-2] == 0).all()
    rows = part[:, :, None].expand(2, 4, 1030, 18).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.isnan(fd.flash_decode_merge(part[:, :, None],
                                                 dtype)).all()
        assert torch.isnan(fd.flash_decode_merge(rows, dtype)).all()


def test_route_is_decided_by_dtypes_shape_and_alignment():
    """The tensor-core route takes bfloat16 q and cache with D a multiple
    of 16 and a 16-byte aligned cache; everything else takes the CUDA
    cores."""
    def tensors(q_dtype, kv_dtype, d, offset=0):
        q = torch.zeros(2, 4, d, dtype=q_dtype)
        flat = torch.zeros(2 * 8 * 2 * d + offset, dtype=kv_dtype)
        k = flat[offset:].view(2, 8, 2, d)
        return q, k, k
    bf, f32 = torch.bfloat16, torch.float32
    assert fd.route(*tensors(bf, bf, 128)) == "tensor_core"
    assert fd.route(*tensors(bf, bf, 48)) == "tensor_core"
    assert fd.route(*tensors(bf, bf, 40)) == "cuda_core"
    assert fd.route(*tensors(bf, f32, 128)) == "cuda_core"
    assert fd.route(*tensors(f32, bf, 128)) == "cuda_core"
    assert fd.route(*tensors(f32, f32, 128)) == "cuda_core"
    assert fd.route(*tensors(bf, bf, 128, offset=1)) == "cuda_core"
    assert set(fd.ROUTES) == {"tensor_core", "cuda_core"}


def test_wrapper_rejects_what_the_kernel_does_not_take():
    (q, k, v, lengths), _ = _case(3, 4, 2, 17, 16, torch.float32,
                                  torch.float32, seed=2)
    with pytest.raises(ValueError):
        fd.flash_decode(q[:, :3], k, v, lengths)            # H % Hkv != 0
    with pytest.raises(ValueError):
        fd.flash_decode(q, k, v[:, :5], lengths)            # k, v differ
    with pytest.raises(ValueError):
        fd.flash_decode(q[..., :8], k, v, lengths)          # D differs
    big = torch.zeros(1, 2, fd.MAX_HEAD_DIM + 1)
    with pytest.raises(ValueError):
        fd.flash_decode(big, torch.zeros(1, 4, 1, fd.MAX_HEAD_DIM + 1),
                        torch.zeros(1, 4, 1, fd.MAX_HEAD_DIM + 1))
    with pytest.raises(TypeError):
        fd.flash_decode(q.double(), k, v, lengths)
    with pytest.raises(TypeError):
        fd.flash_decode(q, k, v.bfloat16(), lengths)
    with pytest.raises(TypeError):
        fd.flash_decode(q, k, v, lengths.long())
    with pytest.raises(ValueError):
        fd.flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                        v, lengths)
    with pytest.raises(ValueError):
        fd.flash_decode(q.to("meta"), k.to("meta"), v.to("meta"),
                        lengths.to("meta"))


def test_library_is_named_by_its_source():
    path = build.library_path(fd.LIBRARY)
    assert path.parent == build.build_dir()
    assert path.name.startswith("libflash_decode-") and path.suffix == ".so"
    assert (build.CSRC / "flash_decode.cu").exists()


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16],
                         ids=["q32", "q16"])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16],
                         ids=["kv32", "kv16"])
def test_cuda_kernel_matches_plain_version(q_dtype, kv_dtype):
    """The CUDA kernels against their plain version on the card, G = 8 and
    G = 32 included, and with lengths at the chunk boundaries of the
    split the wrapper picks (at (1, 12, 3, 131,073): 1,025 chunks of 128,
    most of them empty at the short lengths); each call launches the split
    kernel, and the combine when the plan has more than one chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the H100 via chip_smoke.py)")
    dev = torch.device("cuda")
    for b, h, hkv, s, d in [(1, 4, 2, 1, 16), (3, 12, 2, 200, 64),
                            (3, 4, 4, 17, 128), (2, 12, 2, 4096, 128),
                            (2, 16, 2, 1000, 128), (2, 32, 1, 600, 64),
                            (1, 12, 3, 131_073, 128)]:
        (q, k, v, lengths), _ = _case(b, h, hkv, s, d, q_dtype, kv_dtype,
                                      seed=s + d)
        q, k, v, lengths = (x.to(dev) for x in (q, k, v, lengths))
        chunk, n_chunks, _ = fd.split_plan(b, h, hkv, s, d)
        edges = _boundary_lengths(chunk, s)
        # every boundary length on some row: b rows at a time
        edge_rows = [torch.from_numpy(np.resize(np.roll(edges, -i), b))
                     .to(dev) for i in range(0, len(edges), b)]
        for lens in (lengths, None, *edge_rows):
            fd.reset_launches()
            got = fd.flash_decode(q, k, v, lens)
            assert fd.flash_decode.launches_by_kernel == {
                "split": 1, "combine": int(n_chunks > 1)}
            want = ref.flash_decode_ref(q, k, v, lens)
            torch.cuda.synchronize()
            tol = TOL[q_dtype]
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 17, 128])
def test_cuda_merge_of_rows_at_an_odd_float_matches_plain_version(d):
    """The combine over rows in a contiguous view that starts 4 bytes past
    an 8-byte boundary (its scalar reads, also at an even D), against the
    plain merge on the same rows, at 600 rows a (b, h)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the H100 via chip_smoke.py)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(d)
    shape = (2, 3, 600, d + 2)
    rows = torch.empty(int(np.prod(shape)) + 1, device=dev)[1:].view(shape)
    rows.copy_(torch.randn(shape, generator=gen, device=dev))
    rows[..., -1].abs_()
    assert rows.is_contiguous() and rows.data_ptr() % 8 == 4
    for dtype in (torch.float32, torch.bfloat16):
        got = fd.flash_decode_merge(rows, dtype)
        want = ref.flash_decode_merge_ref(rows, dtype)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
