"""The port's decode attention on the CPU against the reference: the plain
torch version against `repro.kernels.ref.flash_decode_ref` and against the
Pallas kernel `flash_decode_pallas` in interpret mode; the wrapper's
dispatch and checks. The CUDA kernel itself runs only on the card (the
`cuda` marker).

Tolerances: float32 outputs 1e-5 (atol and rtol: both sides accumulate in
float32, in another order); bfloat16 outputs 2e-2 (both sides compute in
float32 from the same bfloat16 inputs and round once, so they differ by at
most one bfloat16 step, 2^-8 relative)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

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
    """The CUDA kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the H100 via chip_smoke.py)")
    dev = torch.device("cuda")
    for b, h, hkv, s, d in [(1, 4, 2, 1, 16), (3, 12, 2, 200, 64),
                            (3, 4, 4, 17, 128), (2, 12, 2, 4096, 128)]:
        (q, k, v, lengths), _ = _case(b, h, hkv, s, d, q_dtype, kv_dtype,
                                      seed=s + d)
        q, k, v, lengths = (x.to(dev) for x in (q, k, v, lengths))
        for lens in (lengths, None):
            got = fd.flash_decode(q, k, v, lens)
            want = ref.flash_decode_ref(q, k, v, lens)
            torch.cuda.synchronize()
            tol = TOL[q_dtype]
            torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                       rtol=tol)
