"""repro_torch — the CEMR matcher ported to PyTorch and CUDA (H100).

A second package beside the JAX reference `repro`, with the same layout
(`core/`, `kernels/`, `api/`). It imports torch and numpy, never jax and
nothing of `repro`:

    from repro_torch.api import Dataset, Matcher

    ds = Dataset.synthetic("human", scale=1.0)
    m = Matcher(ds)                        # the card; device="cpu" for CPU
    out = m.count(ds.random_query(size=8, seed=7))

The extension hot loop runs in hand-written CUDA kernels for sm_90a
(`kernels/csrc/bitmap_intersect.cu`), built by nvcc at first use.
"""
