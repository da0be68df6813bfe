"""Chromatic-aberration + drift correction of spot coordinates.

The counterpart of the coordinate half of ``imageanalysis3_tpu/ops/warp.py``.
Behavior targets (reference ImageAnalysis3):
  * spot-coordinate warp     correction_tools/chromatic.py:41-115
    (corr = coords - poly_shift + drift)
  * polynomial basis         correction_tools/chromatic.py:415-438
    (combinations_with_replacement monomials)
"""

from __future__ import annotations

import itertools
from typing import Tuple

import torch


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
    """Per-dimension polynomial shift at `coords` (N, 3) -> (N, 3)."""
    X = polynomial_basis(coords - ref_center[None], max_order)
    return torch.einsum("nm,dm->nd", X, constants)


def warp_spot_coords(coords: torch.Tensor, constants: torch.Tensor,
                     ref_center: torch.Tensor, drift: torch.Tensor,
                     max_order: int = 2) -> torch.Tensor:
    """corr = coords - poly_shift(coords - ref_center) + drift
    (reference correction_tools/chromatic.py:93-104)."""
    shifts = evaluate_poly_shifts(coords, constants, max_order, ref_center)
    return coords - shifts + drift
