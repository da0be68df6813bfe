"""Chromatic-aberration + drift correction of spot coordinates.

The counterpart of the coordinate half of ``imageanalysis3_tpu/ops/warp.py``.
Behavior targets (reference ImageAnalysis3):
  * spot-coordinate warp     correction_tools/chromatic.py:41-115
    (corr = coords - poly_shift + drift)
  * polynomial basis         correction_tools/chromatic.py:415-438
    (combinations_with_replacement monomials)
  * constants fitting        corrections.py:885-1008 (lstsq per dimension)
"""

from __future__ import annotations

import itertools
from typing import Tuple

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
