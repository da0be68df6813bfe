"""Chromatic-aberration + drift warping of images and spot coordinates.

The counterpart of ``imageanalysis3_tpu/ops/warp.py``.  Behavior targets
(reference ImageAnalysis3):
  * image warp               io_tools/load.py:421-460 (meshgrid + chromatic
    profile + drift -> map_coordinates, mode='nearest'; trilinear here)
  * spot-coordinate warp     correction_tools/chromatic.py:41-115
    (corr = coords - poly_shift + drift)
  * polynomial basis         correction_tools/chromatic.py:415-438
    (combinations_with_replacement monomials)
  * constants fitting        corrections.py:885-1008 (lstsq per dimension)

The image warps are the JAX package's arithmetic: an 8-tap trilinear gather
with edge clamping, an exact per-axis two-tap form for a constant drift,
and, with chromatic constants, its separable approximation (a z pass, then
an x and a y pass, the chromatic shifts clipped to +-max_chromatic_shift),
written as direct two-tap gathers where the JAX package selects among
shifted copies: the same taps and the same blend.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import torch

from .filters import full_f32_matmul


def monomial_exponents(ndim: int, max_order: int) -> Tuple[Tuple[int, ...], ...]:
    """Exponent tuples in the reference's basis order
    (combinations_with_replacement per total order)."""
    exps = []
    for order in range(max_order + 1):
        for combo in itertools.combinations_with_replacement(
                range(ndim), order):
            e = [0] * ndim
            for d in combo:
                e[d] += 1
            exps.append(tuple(e))
    return tuple(exps)


def polynomial_basis(coords: torch.Tensor, max_order: int) -> torch.Tensor:
    """(N, ndim) coords -> (N, n_monomials) design matrix."""
    cols = []
    for e in monomial_exponents(coords.shape[-1], max_order):
        c = torch.ones(coords.shape[:-1], dtype=coords.dtype,
                       device=coords.device)
        for d, p in enumerate(e):
            if p:
                c = c * coords[..., d] ** p
        cols.append(c)
    return torch.stack(cols, dim=-1)


def evaluate_poly_shifts(coords: torch.Tensor, constants: torch.Tensor,
                         max_order: int,
                         ref_center: torch.Tensor) -> torch.Tensor:
    """Per-dimension polynomial shift at `coords` (N, 3) -> (N, 3), the
    product in full f32 (the reference: HIGHEST)."""
    X = polynomial_basis(coords - ref_center[None], max_order)
    with full_f32_matmul():
        return torch.einsum("nm,dm->nd", X, constants)


def warp_spot_coords(coords: torch.Tensor, constants: torch.Tensor,
                     ref_center: torch.Tensor, drift: torch.Tensor,
                     max_order: int = 2) -> torch.Tensor:
    """corr = coords - poly_shift(coords - ref_center) + drift
    (reference correction_tools/chromatic.py:93-104)."""
    shifts = evaluate_poly_shifts(coords, constants, max_order, ref_center)
    return coords - shifts + drift


def lstsq_min_norm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least-squares solution of `a` (M, N) x = `b` (M,) or (M, K) by SVD,
    the minimum-norm one when `a` is rank-deficient: ``jnp.linalg.lstsq``
    with its default cut-off (singular values below eps * max(M, N) * s_max
    dropped).  ``torch.linalg.lstsq`` on CUDA has only the QR-based
    ``gels``, which assumes full rank, so it would differ from the JAX
    package whenever there are fewer pairs than monomials."""
    m, n = a.shape
    rcond = float(torch.finfo(a.dtype).eps) * max(m, n)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    keep = (s > 0) & (s >= rcond * s[0])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    col = b[:, None] if b.dim() == 1 else b
    with full_f32_matmul():
        x = vt.T @ (s_inv[:, None] * (u.T @ col))
    return x[:, 0] if b.dim() == 1 else x


def normalized_lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`lstsq_min_norm` with each column of `a` scaled to unit RMS
    before the solve and the solution scaled back after: a polynomial design
    matrix mixes scales from 1 to (FOV/2)^order, hopeless in f32 as it
    stands."""
    scale = torch.sqrt((a * a).mean(dim=0)).clamp_min(1e-12)
    sol = lstsq_min_norm(a / scale[None], b)
    return sol / (scale if sol.dim() == 1 else scale[:, None])


def fit_chromatic_constants(tar_pts: torch.Tensor, ref_pts: torch.Tensor,
                            ref_center: torch.Tensor,
                            max_order: int = 2) -> torch.Tensor:
    """Least-squares fit of the shift polynomial from matched spot pairs
    (reference corrections.py:885-1008, the per-dimension lstsq batched
    into one solve): shift = tar - ref = X(ref - ref_center) @ c_d.
    Returns (3, n_monomials).  The columns are normalised for the solve, as
    the JAX package does."""
    X = polynomial_basis(ref_pts - ref_center[None], max_order)
    return normalized_lstsq(X, tar_pts - ref_pts).T


# ---------------------------------------------------------------------------
# Trilinear image warp
# ---------------------------------------------------------------------------


def _trilinear_gather(im: torch.Tensor, zf: torch.Tensor, xf: torch.Tensor,
                      yf: torch.Tensor) -> torch.Tensor:
    """Sample `im` (Z, X, Y) at float coords with edge clamping
    (scipy map_coordinates mode='nearest', order=1): the 8 taps blended
    along y, then x, then z."""
    Z, X, Y = im.shape
    zf = zf.clamp(0.0, Z - 1.0)
    xf = xf.clamp(0.0, X - 1.0)
    yf = yf.clamp(0.0, Y - 1.0)
    z0 = torch.floor(zf)
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    wz = zf - z0
    wx = xf - x0
    wy = yf - y0
    z0 = z0.to(torch.int64)
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    z1 = (z0 + 1).clamp_max(Z - 1)
    x1 = (x0 + 1).clamp_max(X - 1)
    y1 = (y0 + 1).clamp_max(Y - 1)
    flat = im.reshape(-1)

    def tap(zi, xi, yi):
        return flat[(zi * X + xi) * Y + yi]

    c00 = tap(z0, x0, y0) * (1 - wy) + tap(z0, x0, y1) * wy
    c01 = tap(z0, x1, y0) * (1 - wy) + tap(z0, x1, y1) * wy
    c10 = tap(z1, x0, y0) * (1 - wy) + tap(z1, x0, y1) * wy
    c11 = tap(z1, x1, y0) * (1 - wy) + tap(z1, x1, y1) * wy
    c0 = c00 * (1 - wx) + c01 * wx
    c1 = c10 * (1 - wx) + c11 * wx
    return c0 * (1 - wz) + c1 * wz


def trilinear_map_coordinates(im: torch.Tensor,
                              coords: torch.Tensor) -> torch.Tensor:
    """``scipy.ndimage.map_coordinates(im, coords, order=1,
    mode='nearest')``: `coords` (3, ...) float sample positions."""
    coords = coords.to(torch.float32)
    return _trilinear_gather(im.to(torch.float32), coords[0], coords[1],
                             coords[2])


def _shift_along(v: torch.Tensor, axis: int, shift: int) -> torch.Tensor:
    """``v`` taken at ``clip(arange(n) + shift, 0, n - 1)`` along `axis`."""
    n = v.shape[axis]
    idx = (torch.arange(n, device=v.device) + shift).clamp(0, n - 1)
    return v.index_select(axis, idx)


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def warp_image_drift(im: torch.Tensor, drift) -> torch.Tensor:
    """out(x) = im(x - drift), edge-clamped: exact trilinear for a constant
    shift, factorised into three per-axis two-tap blends of
    integer-shifted copies (reference io_tools/load.py:437-453 with the
    chromatic profile off)."""
    out = im.to(torch.float32)
    d_all = -_as_f32(drift, "cpu")
    for ax in range(3):
        i0 = torch.floor(d_all[ax])
        w = d_all[ax] - i0              # a 0-dim f32 tensor, as in JAX
        a = _shift_along(out, ax, int(i0))
        b = _shift_along(out, ax, int(i0) + 1)
        out = a * (1.0 - w) + b * w
    return out


def _axis_warp_field(v: torch.Tensor, axis: int, base_drift: torch.Tensor,
                     frac_field: torch.Tensor) -> torch.Tensor:
    """1-D linear resample along `axis` of a (B, X, Y) slab batch: `v`
    sampled at coord + base_drift + frac_field.  The integer part of the
    (0-dim, host) `base_drift` moves the slab as a whole; each pixel then
    blends its two taps at ``clip(i + floor(q))`` and the next, q =
    frac_field + the drift's fractional part."""
    n = v.shape[axis]
    di = torch.floor(base_drift)
    v = _shift_along(v, axis, int(di))
    q = frac_field + (base_drift - di)
    q0f = torch.floor(q)
    w = q - q0f
    shape = [1] * v.ndim
    shape[axis] = n
    k0 = torch.arange(n, device=v.device).reshape(shape) \
        + q0f.to(torch.int64)
    return (v.gather(axis, k0.clamp(0, n - 1)) * (1.0 - w)
            + v.gather(axis, (k0 + 1).clamp(0, n - 1)) * w)


#: pixels of the chromatic shift field evaluated at a time (its basis holds
#: 10 floats a pixel: 670 MB at this size, four 2048 x 2048 planes)
PLANE_PIXELS = 1 << 24


def warp_image(im: torch.Tensor, drift, constants=None, ref_center=None,
               max_order: int = 2,
               max_chromatic_shift: int = 4) -> torch.Tensor:
    """Resample `im` at (identity + chromatic_shift - drift).

    Reference io_tools/load.py:437-453: the warped image is ``im`` sampled
    at ``coords + chromatic_profile(coords) - drift``.  ``constants=None``
    warps by the drift alone (:func:`warp_image_drift`, exact trilinear).
    With constants, the JAX package's separable approximation: per output
    plane, a z pass (a per-pixel two-tap blend between planes), then an x
    and a y pass (:func:`_axis_warp_field`), each chromatic shift clipped
    to +-`max_chromatic_shift` px.  The shift field is evaluated a batch of
    whole planes at a time, at most :data:`PLANE_PIXELS` pixels a batch.
    The drift's integer parts are read on the host once.
    """
    imf = im.to(torch.float32)
    if constants is None:
        return warp_image_drift(imf, drift)
    dev = imf.device
    Z, X, Y = imf.shape
    neg = -_as_f32(drift, "cpu")
    constants = _as_f32(constants, dev)
    ref_center = _as_f32(ref_center, dev)
    mcs = float(int(max_chromatic_shift))
    dzi = torch.floor(neg[0])
    dz_rem = neg[0] - dzi
    dzi = int(dzi)
    xg = torch.arange(X, dtype=torch.float32, device=dev)
    yg = torch.arange(Y, dtype=torch.float32, device=dev)
    xx, yy = torch.meshgrid(xg, yg, indexing="ij")
    xy = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)
    pix = torch.arange(X * Y, device=dev).reshape(1, X, Y)
    flat = imf.reshape(-1)
    out = torch.empty_like(imf)
    step = max(1, PLANE_PIXELS // (X * Y))
    for z0 in range(0, Z, step):
        zs = torch.arange(z0, min(z0 + step, Z), device=dev)
        b = len(zs)
        coords = torch.cat([zs.to(torch.float32).repeat_interleave(X * Y)
                            [:, None], xy.repeat(b, 1)], dim=1)
        shifts = evaluate_poly_shifts(coords, constants, max_order,
                                      ref_center)
        del coords
        sz, sx, sy = (shifts[:, d].reshape(b, X, Y).clamp(-mcs, mcs)
                      for d in range(3))
        # z pass: each pixel blends its two planes around z + dzi + q
        q = sz + dz_rem
        q0f = torch.floor(q)
        w = q - q0f
        zk = zs[:, None, None] + dzi + q0f.to(torch.int64)
        v = (flat[zk.clamp(0, Z - 1) * (X * Y) + pix] * (1.0 - w)
             + flat[(zk + 1).clamp(0, Z - 1) * (X * Y) + pix] * w)
        # x, y passes on the planes
        v = _axis_warp_field(v, 1, neg[1], sx)
        out[z0:z0 + b] = _axis_warp_field(v, 2, neg[2], sy)
    return out
