"""Chromosome candidate detection inside segmented nuclei.

The counterpart of ``imageanalysis3_tpu/segmentation/chromosome.py``.
Behavior targets (reference ImageAnalysis3):
  * candidate finding          segmentation_tools/chromosome.py:51-486
    (find_candidate_chromosomes[_in_nucleus] / select_candidate_
    chromosomes: seed/label the chromosome-paint image inside nucleus
    masks, lower the threshold adaptively until each cell reaches its
    expected chromosome count)
  * FOV orchestration          classes/field_of_view.py:1936-2341

Candidates come from the local-max seeding (``ops.seeding.get_seeds``; its
dynamic threshold decay is the adaptive loop, computed in one pass);
nucleus gating is a gather on the device, and the per-nucleus selection
runs on the host.  At the default ``background_gfilt_size=10.0`` the
background blur's radius is 40, above what the seeding kernels take, so
``get_seeds`` runs its plain PyTorch classifier here, as the JAX package's
does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from ..ops.seeding import get_seeds


def assign_seeds_to_nuclei(labels: torch.Tensor, coords: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """Nucleus label at each seed position (0 outside; -1 invalid)."""
    labels = torch.as_tensor(labels, device=coords.device)
    z = coords[:, 0].clamp(0, labels.shape[0] - 1).long()
    x = coords[:, 1].clamp(0, labels.shape[1] - 1).long()
    y = coords[:, 2].clamp(0, labels.shape[2] - 1).long()
    lab = labels[z, x, y].to(torch.int32)
    return torch.where(torch.as_tensor(valid, device=coords.device), lab,
                       torch.full_like(lab, -1))


def find_candidate_chromosomes(chrom_im, nucleus_labels,
                               expected_per_nucleus: int = 2,
                               th_seed: float = 300.0,
                               max_candidates: int = 1024,
                               dynamic_niters: int = 12,
                               gfilt_size: float = 0.75,
                               background_gfilt_size: float = 10.0,
                               min_separation: float = 3.0,
                               device=None
                               ) -> Tuple[np.ndarray, np.ndarray,
                                          Dict[int, int]]:
    """Chromosome centers inside nuclei -> (coords (N, 3), nucleus label
    per candidate, per-nucleus counts).

    Per-cell adaptive thresholding, as in the reference's per-cell loop
    (segmentation_tools/chromosome.py:51-486) that lowers each cell's
    threshold until that cell reaches its expected chromosome count —
    but computed from ONE seeding pass instead of per-cell reruns: the
    dynamic threshold decays to its deepest level (all candidates down to
    th_seed * 1/n_lvl are extracted brightest-first with their heights),
    and the per-nucleus selection keeps each nucleus's brightest
    `expected_per_nucleus` candidates.  Each nucleus's implicit threshold
    is therefore the height of its own k-th brightest candidate — a dim
    nucleus keeps its dim-but-real foci instead of being starved by a
    global (median-nucleus) level, and a nucleus with fewer than
    `expected_per_nucleus` candidates above the floor keeps what it has.

    `min_separation`: candidates closer than this (in voxels, z-weighted
    equally) to an already-kept brighter candidate of the same nucleus
    are treated as the same focus and skipped (the reference merges such
    seeds by connected-component relabeling + erosion; a radius test on
    brightest-first candidates is the seed-based equivalent).

    NumPy inputs go to `device` (default the CUDA card); tensors stay
    where they are.
    """
    im = as_tensor(chrom_im, device).to(torch.float32)
    seeds = get_seeds(im, max_num_seeds=max_candidates, th_seed=th_seed,
                      gfilt_size=gfilt_size,
                      background_gfilt_size=background_gfilt_size,
                      use_dynamic_th=True, dynamic_niters=dynamic_niters,
                      # unreachable target -> decay to the deepest level,
                      # so every per-cell threshold choice stays available
                      min_dynamic_seeds=max_candidates,
                      remove_hot_pixel=False)
    nuc = assign_seeds_to_nuclei(nucleus_labels, seeds.coords,
                                 seeds.valid).cpu().numpy()
    inside = nuc > 0
    coords = seeds.coords.cpu().numpy()[inside]
    labels = nuc[inside]
    heights = seeds.heights.cpu().numpy()[inside]

    keep = np.zeros(len(coords), bool)
    counts: Dict[int, int] = {}
    for l in np.unique(labels):
        idx = np.where(labels == l)[0]
        order = idx[np.argsort(-heights[idx])]     # brightest first
        kept: list = []
        for i in order:
            if len(kept) >= expected_per_nucleus:
                break
            if kept and min_separation > 0:
                d = np.linalg.norm(
                    coords[kept].astype(np.float64) - coords[i], axis=1)
                if np.min(d) < min_separation:
                    continue                        # same focus as a kept
            kept.append(i)
        keep[kept] = True
        counts[int(l)] = len(kept)
    return coords[keep], labels[keep], counts


def select_candidate_chromosomes(cand_chrom_coords: np.ndarray,
                                 spots_list,
                                 cand_spot_intensity_th: float = 0.5,
                                 good_chr_loss_th: float = 0.4,
                                 device=None
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Screen candidate chromosome centers by decoded-spot support.

    Behavior target: select_candidate_chromosomes
    (segmentation_tools/chromosome.py:363-408, driven by
    classes/field_of_view.py:2273-2341): assign each round's
    intensity-screened spots to their nearest remaining chromosome; a
    chromosome's loss is the fraction of rounds that assigned it ZERO
    spots; repeatedly remove the single worst chromosome while any loss
    exceeds ``good_chr_loss_th`` (spots re-assign to the survivors each
    iteration).

    The spot->chromosome distance matrix (f32 ``‖a − b‖``) is computed
    ONCE on `device` (default the CUDA card) for all candidates; each
    removal round is then an argmin (first minimum) over the shrinking
    active set of that fixed matrix on the host (the reference recomputes
    all assignments per removal).

    ``spots_list``: per-round spot arrays, reference layout
    (height, z, x, y, ...).  Returns (selected coords, kept-index mask
    into the input candidates).
    """
    coords = np.atleast_2d(np.asarray(cand_chrom_coords, np.float64))
    n_chr = len(coords)
    if n_chr == 0:
        return coords, np.zeros(0, bool)
    rounds = []
    for spots in spots_list:
        s = np.atleast_2d(np.asarray(spots, np.float64))
        if s.size == 0:
            rounds.append(np.zeros((0, 3)))
            continue
        rounds.append(s[s[:, 0] >= cand_spot_intensity_th][:, 1:4])
    n_rounds = len(rounds)
    if n_rounds == 0:
        return coords, np.ones(n_chr, bool)
    # one device pass: distances of every screened spot to every candidate
    flat = np.concatenate([r for r in rounds], axis=0) \
        if any(len(r) for r in rounds) else np.zeros((0, 3))
    round_of = np.concatenate([np.full(len(r), k) for k, r in
                               enumerate(rounds)]) \
        if len(flat) else np.zeros(0, int)
    if len(flat):
        dev = resolve_device(device)
        diff = (torch.as_tensor(flat.astype(np.float32), device=dev)[:, None]
                - torch.as_tensor(coords.astype(np.float32),
                                  device=dev)[None])
        d = torch.sqrt((diff * diff).sum(dim=-1)).cpu().numpy()
    else:
        d = np.zeros((0, n_chr), np.float32)

    active = np.ones(n_chr, bool)
    while active.any():
        if len(flat):
            dm = np.where(active[None, :], d, np.inf)
            assign = np.argmin(dm, axis=1)
            # has_spot[k, r]: round r assigned >= 1 spot to chromosome k
            has_spot = np.zeros((n_chr, n_rounds), bool)
            has_spot[assign, round_of] = True
            loss = 1.0 - has_spot.mean(axis=1)
        else:
            loss = np.ones(n_chr)
        loss[~active] = -1.0
        worst = int(np.argmax(loss))
        if loss[worst] <= good_chr_loss_th:
            break
        active[worst] = False
    return coords[active], active
