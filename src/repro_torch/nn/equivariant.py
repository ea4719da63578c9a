"""Equivariant building blocks: real spherical harmonics, SO(3) rotation
matrices in the real-SH basis, Gaunt (real Clebsch-Gordan) tensors, and the
eSCN SO(2) convolution used by EquiformerV2.

The eSCN trick turns the O(L⁶) tensor-product contraction into per-|m|
dense products after rotating each edge frame so the edge lies on +z;
rotations decompose as
    D(R) = X⁻ · Dz(β) · X⁺ · Dz(α)
where Dz is the cheap per-edge (cos, sin) block rotation and X± = D(Rx(∓π/2))
are fixed matrices, fitted once by least squares on real-SH evaluations.

The fixed tables are numpy, copies of the JAX package's functions, so their
arrays are identical: `_assoc_legendre`, `real_sph_harm(..., xp=np)`,
`rotation_matrices_real_sh`, `x_rot_matrices` and `gaunt_tensor`. The
per-edge functions (`real_sph_harm` on tensors, `dz_apply`,
`align_to_z_angles`, `rotate_to_edge_frame`, `SO2Conv`, `bessel_basis`,
`legendre_poly`) are torch. At the poles (an edge along ±z) they give the
reference's values: sinθ is floored at 1e-6, atan2(0, 0) = 0, and the
clip before arccos keeps z/r = ±1 (± rounding) at β = 0 or π.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

__all__ = ["real_sph_harm", "rotation_matrices_real_sh", "x_rot_matrices",
           "gaunt_tensor", "dz_apply", "align_to_z_angles",
           "rotate_to_edge_frame", "SO2Conv", "so2_conv", "bessel_basis",
           "legendre_poly"]


class _TorchOps:
    """The numpy functions that `_assoc_legendre` and `real_sph_harm` call,
    on tensors."""
    sqrt = staticmethod(torch.sqrt)
    cos = staticmethod(torch.cos)
    sin = staticmethod(torch.sin)
    ones_like = staticmethod(torch.ones_like)
    arctan2 = staticmethod(torch.atan2)

    @staticmethod
    def maximum(x, floor):
        return torch.clamp(x, min=floor)

    @staticmethod
    def stack(xs, axis):
        return torch.stack(xs, dim=axis)


# ------------------------------------------------------- spherical harmonics
def _assoc_legendre(l_max: int, z, xp):
    """Associated Legendre P_l^m(z) (including Condon-Shortley phase) for
    0 ≤ m ≤ l ≤ l_max. Returns dict (l, m) → array like z. Standard stable
    recurrences; z = cosθ."""
    p: dict[tuple[int, int], object] = {(0, 0): xp.ones_like(z)}
    s = xp.sqrt(xp.maximum(1.0 - z * z, 1e-12))  # sinθ
    for m in range(1, l_max + 1):
        p[(m, m)] = (-(2 * m - 1)) * s * p[(m - 1, m - 1)]
    for m in range(0, l_max):
        p[(m + 1, m)] = (2 * m + 1) * z * p[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            p[(l, m)] = (((2 * l - 1) * z * p[(l - 1, m)]
                          - (l + m - 1) * p[(l - 2, m)]) / (l - m))
    return p


def _factorial(n: int) -> float:
    out = 1.0
    for i in range(2, n + 1):
        out *= i
    return out


def real_sph_harm(vec, l_max: int, xp=None):
    """Real spherical harmonics of unit vectors.

    vec: (..., 3) — normalized internally; a tensor, or a numpy array with
    `xp=np`. Returns dict l → (..., 2l+1) ordered m = -l..l. Orthonormal on
    the sphere."""
    xp = _TorchOps if xp is None else xp
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    r = xp.sqrt(xp.maximum(x * x + y * y + z * z, 1e-24))
    x, y, z = x / r, y / r, z / r
    phi = xp.arctan2(y, x)
    pl = _assoc_legendre(l_max, z, xp)
    out = {}
    for l in range(l_max + 1):
        cols = []
        for m in range(-l, l + 1):
            am = abs(m)
            norm = np.sqrt((2 * l + 1) / (4 * np.pi)
                           * _factorial(l - am) / _factorial(l + am))
            sqrt2 = np.sqrt(2)
            if xp is _TorchOps:       # numpy scalars do not multiply tensors
                norm, sqrt2 = float(norm), float(sqrt2)
            if m == 0:
                cols.append(norm * pl[(l, 0)])
            elif m > 0:
                cols.append(sqrt2 * norm * pl[(l, m)] * xp.cos(m * phi))
            else:
                cols.append(sqrt2 * norm * pl[(l, am)] * xp.sin(am * phi))
        out[l] = xp.stack(cols, axis=-1)
    return out


# --------------------------------------------------------- rotation matrices
def rotation_matrices_real_sh(rot: np.ndarray, l_max: int) -> list[np.ndarray]:
    """D_l with Y_l(R v) = D_l(R) @ Y_l(v), fitted by least squares over
    random unit vectors (exact: real SH of degree l span an R-invariant
    (2l+1)-dim space)."""
    rng = np.random.default_rng(12345)
    n = 16 * (l_max + 1) ** 2
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    y = real_sph_harm(v, l_max, xp=np)
    yr = real_sph_harm(v @ rot.T, l_max, xp=np)
    out = []
    for l in range(l_max + 1):
        d, *_ = np.linalg.lstsq(y[l], yr[l], rcond=None)
        out.append(d.T.astype(np.float32))   # yr = y @ d  ⇒  D = d.T
    return out


@functools.lru_cache(maxsize=None)
def x_rot_matrices(l_max: int):
    """X± = D_l(Rx(∓π/2)) per l (fixed conjugators for Dy via Dz)."""
    cx = np.array([[1, 0, 0], [0, 0, 1], [0, -1, 0]], np.float64)  # Rx(-90°)
    cxi = cx.T
    xm = rotation_matrices_real_sh(cx, l_max)
    xp_ = rotation_matrices_real_sh(cxi, l_max)
    return xm, xp_


@functools.lru_cache(maxsize=None)
def _x_rot_tensors(l_max: int, device: str):
    xm, xp_ = x_rot_matrices(l_max)
    return ([torch.from_numpy(a).to(device) for a in xm],
            [torch.from_numpy(a).to(device) for a in xp_])


def dz_apply(feats: torch.Tensor, ang: torch.Tensor, l: int,
             sign: float = 1.0) -> torch.Tensor:
    """Apply D_l(Rz(sign·ang)) to (..., 2l+1) real-SH coefficients.
    Rz mixes (m, −m) pairs: cheap per-edge rotation."""
    if l == 0:
        return feats
    m = torch.arange(1, l + 1, dtype=torch.float32, device=feats.device)
    c = torch.cos(m * sign * ang[..., None])        # (..., l)
    s = torch.sin(m * sign * ang[..., None])
    neg = feats[..., :l].flip(-1)                   # m = -1..-l
    pos = feats[..., l + 1:]                        # m = +1..+l
    zero = feats[..., l:l + 1]
    new_pos = c * pos - s * neg
    new_neg = s * pos + c * neg
    return torch.cat([new_neg.flip(-1), zero, new_pos], dim=-1)


def align_to_z_angles(vec: torch.Tensor):
    """(α, β) with Rz(−α) then Ry(−β) mapping vec → ẑ."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    r = torch.sqrt(torch.clamp(x * x + y * y + z * z, min=1e-24))
    alpha = torch.atan2(y, x)
    beta = torch.acos(torch.clamp(z / r, -1.0, 1.0))
    return alpha, beta


def rotate_to_edge_frame(feats: dict, alpha: torch.Tensor,
                         beta: torch.Tensor, l_max: int,
                         inverse: bool = False) -> dict:
    """Rotate per-edge SH features so the edge direction becomes +z
    (inverse=False) or back (inverse=True). feats: dict l → (E, C, 2l+1)."""
    xm, xp_ = _x_rot_tensors(l_max, str(alpha.device))
    a = alpha[:, None]
    b = beta[:, None]
    out = {}
    for l, f in feats.items():
        if l == 0:
            out[l] = f
            continue
        xm_l, xp_l = xm[l].to(f.dtype), xp_[l].to(f.dtype)
        if not inverse:
            # D(R⁻¹) = D(Ry(−β)) · D(Rz(−α));  Ry(θ) = X⁻·Rz(θ)·X⁺
            g = dz_apply(f, a, l, sign=-1.0)
            g = torch.einsum("ecm,nm->ecn", g, xp_l)
            g = dz_apply(g, b, l, sign=-1.0)
            g = torch.einsum("ecm,nm->ecn", g, xm_l)
        else:
            g = torch.einsum("ecm,nm->ecn", f, xp_l)
            g = dz_apply(g, b, l, sign=1.0)
            g = torch.einsum("ecm,nm->ecn", g, xm_l)
            g = dz_apply(g, a, l, sign=1.0)
        out[l] = g
    return out


# --------------------------------------------------------------- Gaunt / CG
@functools.lru_cache(maxsize=None)
def gaunt_tensor(l1: int, l2: int, l3: int) -> np.ndarray:
    """G[m1, m2, m3] = ∫ Y_l1^m1 Y_l2^m2 Y_l3^m3 dΩ (real SH), computed by
    exact quadrature (Gauss-Legendre in cosθ × trapezoid in φ — exact for
    band-limited integrands). The real-CG coupling used by the NequIP-style
    tensor product."""
    n_theta = l1 + l2 + l3 + 2
    n_phi = 2 * (l1 + l2 + l3) + 3
    zs, wts = np.polynomial.legendre.leggauss(n_theta)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    z_grid, p_grid = np.meshgrid(zs, phis, indexing="ij")
    s_grid = np.sqrt(1 - z_grid ** 2)
    vec = np.stack([s_grid * np.cos(p_grid), s_grid * np.sin(p_grid), z_grid],
                   axis=-1).reshape(-1, 3)
    w = (np.broadcast_to(wts[:, None], z_grid.shape).reshape(-1)
         * (2 * np.pi / n_phi))
    lm = max(l1, l2, l3)
    y = real_sph_harm(vec, lm, xp=np)
    g = np.einsum("na,nb,nc,n->abc", y[l1], y[l2], y[l3], w)
    g[np.abs(g) < 1e-10] = 0.0
    return g.astype(np.float32)


# ------------------------------------------------------------------ SO2 conv
class SO2Conv(nn.Module):
    """eSCN SO(2) convolution: in the edge-aligned frame, a rotation-
    equivariant linear map is block-diagonal in |m|; for each m it mixes the
    (c, l≥m) coefficients of the +m and −m columns via a complex-structured
    pair of weight matrices. Parameters w{m}_r (and w{m}_i for m > 0),
    (n_l·c_in, n_l·c_out) with n_l = l_max + 1 − m, ~ N(0, 1/(c_in·n_l))."""

    def __init__(self, l_max: int, c_in: int, c_out: int, *,
                 gen: torch.Generator, device, dtype=torch.float32):
        super().__init__()
        for m in range(l_max + 1):
            n_l = l_max + 1 - m
            scale = 1.0 / math.sqrt(c_in * n_l)
            for part in ("r", "i") if m else ("r",):
                x = torch.randn((n_l * c_in, n_l * c_out), generator=gen,
                                device=device, dtype=torch.float32)
                setattr(self, f"w{m}_{part}",
                        nn.Parameter((x * scale).to(dtype)))


def so2_conv(p: SO2Conv, feats: dict, l_max: int, c_out: int) -> dict:
    """feats: dict l → (E, C, 2l+1) in the edge frame. Returns the same
    structure with c_out channels (the reference's `SO2Conv.apply`)."""
    e = feats[0].shape[0]
    cols = {l: [None] * (2 * l + 1) for l in range(l_max + 1)}
    for m in range(l_max + 1):
        ls = list(range(m, l_max + 1))
        xp_col = torch.cat([feats[l][..., l + m].reshape(e, -1) for l in ls],
                           dim=-1)
        if m == 0:
            y = (xp_col @ p.w0_r).reshape(e, len(ls), c_out)
            for i, l in enumerate(ls):
                cols[l][l] = y[:, i]
            continue
        xn_col = torch.cat([feats[l][..., l - m].reshape(e, -1) for l in ls],
                           dim=-1)
        wr, wi = getattr(p, f"w{m}_r"), getattr(p, f"w{m}_i")
        yp = (xp_col @ wr - xn_col @ wi).reshape(e, len(ls), c_out)
        yn = (xp_col @ wi + xn_col @ wr).reshape(e, len(ls), c_out)
        for i, l in enumerate(ls):
            cols[l][l + m] = yp[:, i]
            cols[l][l - m] = yn[:, i]
    return {l: torch.stack(c, dim=-1) for l, c in cols.items()}


# ------------------------------------------------------------- radial bases
def bessel_basis(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """DimeNet/NequIP radial basis: sqrt(2/c)·sin(nπr/c)/r with cosine
    cutoff envelope."""
    r = torch.clamp(r, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    basis = (math.sqrt(2.0 / cutoff)
             * torch.sin(n * math.pi * r[..., None] / cutoff) / r[..., None])
    env = 0.5 * (torch.cos(math.pi * torch.clamp(r / cutoff, max=1.0)) + 1.0)
    return basis * env[..., None]


def legendre_poly(z: torch.Tensor, l_max: int) -> torch.Tensor:
    """P_l(z) for l = 0..l_max → (..., l_max+1) (DimeNet angular basis)."""
    outs = [torch.ones_like(z)]
    if l_max >= 1:
        outs.append(z)
    for l in range(2, l_max + 1):
        outs.append(((2 * l - 1) * z * outs[l - 1]
                     - (l - 1) * outs[l - 2]) / l)
    return torch.stack(outs, dim=-1)
