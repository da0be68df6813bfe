"""The plain reference's fit with each spot's pixels in other orders.

A fit depends on the order of its spot's pixels only through the rounding
of its sums: the LM's g and H (``torch.einsum``, which cuBLAS reduces in an
order it does not state), its costs and its start.  A well-conditioned fit
moves by an ulp when that order changes; an ill-conditioned one (a blend of
close spots in a flat cost valley) follows an LM path that the rounding
steers, and lands up to ~0.7 px away on the DNA-MERFISH scene.  No
implementation of the same float32 arithmetic pins such a spot down, so
the check holds the program's centres only on the spots no other order
moves.

Such a spot also moves its neighbours: each Jacobi round refits a
contested spot with its neighbours' reconstructions (seeds within 2r)
subtracted, so a neighbour that lands elsewhere moves it in turn (on the
DNA-MERFISH scene by up to 0.17 px, where the other orders moved that
spot itself by under 5e-4 px).  The effect travels a neighbour a round.

`OrderedRound` is `ReferenceRound` with each data channel seeded once and
fitted three times from those seeds: as gathered, with every spot's pixels
reversed, and rotated by half, nothing else changed.  After `run`,
`decided` (F, N) names the spots whose validity or centre (beyond ORDER_PX
in any coordinate) another order changes, and every spot within
``n_max_iter`` neighbour steps of one in the fit's neighbour lists; `run`
returns the fit as gathered, the reference's own.
"""

from __future__ import annotations

import contextlib

import torch

from . import gaussian_fit
from .gaussian_fit import iter_fit_seed_points, neighbor_lists
from .round import ReferenceRound, RoundOut
from .seeding import get_seeds

#: the other orders of a spot's pixels
ORDERS = ("reversed", "rotated")
#: a spot's fit is decided by the order when another order moves its
#: centre beyond this (px): 4 float32 ulps at 1024-2048 px, where a
#: well-conditioned fit moves by at most one
ORDER_PX = 5e-4


def permutation(way: str, p: int, device) -> torch.Tensor:
    """The pixel order `way` of a spot's `p` gathered pixels."""
    if way == "reversed":
        return torch.arange(p - 1, -1, -1, device=device)
    if way == "rotated":
        return torch.roll(torch.arange(p, device=device), p // 2)
    raise ValueError(f"no pixel order {way!r}")


@contextlib.contextmanager
def pixel_order(way):
    """Inside, the fit gathers every spot's pixels, coordinates and mask in
    `way`'s order (None: as gathered)."""
    plain = gaussian_fit.gather_ball_plain
    if way is None:
        yield
        return

    def gather(im, seeds, radius):
        pixels, coords, inb = plain(im, seeds, radius)
        perm = permutation(way, pixels.shape[1], pixels.device)
        return pixels[:, perm], coords[:, perm], inb[:, perm]

    gaussian_fit.gather_ball_plain = gather
    try:
        yield
    finally:
        gaussian_fit.gather_ball_plain = plain


def with_neighbours(decided: torch.Tensor, nidx: torch.Tensor,
                    nmask: torch.Tensor, steps: int) -> torch.Tensor:
    """`decided` (N,) and every spot within `steps` steps of one in the
    neighbour lists (`nidx`, `nmask` (N, K), as ``neighbor_lists``)."""
    for _ in range(steps):
        decided = decided | (decided[nidx] & nmask).any(dim=1)
    return decided


class OrderedRound(ReferenceRound):

    def run(self, raw: torch.Tensor, spectra: torch.Tensor) -> RoundOut:
        self._decided = []
        out = super().run(raw, spectra)
        self.decided = torch.stack(self._decided)
        return out

    def fit(self, im: torch.Tensor, th_seed: float):
        """ReferenceRound.fit, then the same seeds fitted in ORDERS."""
        s, f = self.cfg["seed"], self.cfg["fit"]
        seeds = get_seeds(
            im, max_num_seeds=s["max_num_seeds"], th_seed=th_seed,
            gfilt_size=s["gfilt_size"],
            background_gfilt_size=s["background_gfilt_size"],
            filt_size=s["filt_size"], min_edge_distance=s["min_edge_distance"],
            use_dynamic_th=s["use_dynamic_th"],
            dynamic_niters=s["dynamic_niters"],
            min_dynamic_seeds=s["min_dynamic_seeds"],
            cand_capacity=s["cand_capacity"], pyramid_bg=s["pyramid_bg"])
        coords = seeds.coords.to(torch.float32)
        fits = []
        for way in (None,) + ORDERS:
            with pixel_order(way):
                res = iter_fit_seed_points(
                    im, coords, seeds.valid,
                    radius=f["radius"], min_w=f["min_w"], max_w=f["max_w"],
                    init_w=f["init_w"],
                    min_delta_center=f["min_delta_center"],
                    max_delta_center=f["max_delta_center"],
                    lm_iters=f["lm_iters"], n_max_iter=f["n_max_iter"],
                    max_dist_th=f["max_dist_th"],
                    max_neighbors=f["max_neighbors"])
            fits.append((res.spots, res.valid))
        spots, valid = fits[0]
        decided = torch.zeros_like(valid)
        for sp, va in fits[1:]:
            decided |= (va != valid) | (valid & (
                (sp[:, 1:4] - spots[:, 1:4]).abs() > ORDER_PX).any(dim=1))
        nidx, nmask = neighbor_lists(coords, seeds.valid.to(torch.bool),
                                     max_neighbors=f["max_neighbors"],
                                     radius=f["radius"])
        self._decided.append(with_neighbours(decided, nidx, nmask,
                                             f["n_max_iter"]))
        return spots, valid
