"""The DNA-MERFISH scene of the benchmark: one field of view imaged over
hybridisation rounds whose data channels carry the bits of a pair-unique
combinatorial codebook, rendered on the device from the run's seed.

Frozen copies of the port's ``synthetic.make_e2e_codebook``,
``make_e2e_scene`` and ``E2EScene.round_stack`` (bench_e2e.py's scene), so
that a change to the program cannot move the inputs.  The renderer and the
noise are ``scene.py``'s frozen ones (the splat in float64).  Changes from
the originals: every draw comes from the run's seed (the layout's one
generator, each channel's distractor heights and noise, each round's bead
noise), where the originals fix 42, 7000 + bit, 3000 + bit and 1000 +
round; and the numbers come from the configuration's ``scene`` section.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .scene import noisy_uint16, render_spots, rng_of, sample_spot_params, \
    sub_seed


def make_codebook(rng: np.random.Generator, n_chr: int, n_per_chr: int,
                  n_bits: int, n_on: int) -> Tuple[dict, List[tuple]]:
    """A pair-unique `n_on`-bit codebook (every bit pair names at most one
    region) as columns ``id``, ``name``, ``chr`` and one a bit, "1".."B",
    and the on-bits of each region."""
    rows, used = [], set()
    tries = 0
    while len(rows) < n_chr * n_per_chr and tries < 200_000:
        tries += 1
        on = tuple(sorted(rng.choice(n_bits, n_on, replace=False)))
        pairs = {(a, b) for i, a in enumerate(on) for b in on[i + 1:]}
        if pairs & used:
            continue
        used |= pairs
        rows.append(on)
    if len(rows) < n_chr * n_per_chr:
        raise RuntimeError("codebook packing failed")
    columns = {"id": np.arange(len(rows)) + 100,
               "name": np.array([f"reg{i}" for i in range(len(rows))]),
               "chr": np.array([f"chr{c + 1}" for c in range(n_chr)
                                for _ in range(n_per_chr)])}
    for b in range(n_bits):
        columns[str(b + 1)] = np.array([int(b in on) for on in rows])
    return columns, rows


class CodebookScene:
    """Rounds of (data channels..., beads) stacks.  Round r's data channel
    c images bit r * n_data + c: the planted spots of every (region,
    homolog) whose code has that bit, and the round's distractors; the
    bead channel the same beads every round.  A round's content moves by
    its integer drift (round 0: none, the reference round).  `p` is the
    configuration's ``scene`` section; the channels not named
    `drift_idx` are the data channels, in order."""

    def __init__(self, p: dict, shape, n_channels: int, drift_idx: int,
                 n_rounds: int, seed: int):
        self.p, self.shape, self.seed = p, tuple(int(s) for s in shape), \
            int(seed)
        self.n_channels, self.drift_idx = int(n_channels), int(drift_idx)
        self.data_idx = [c for c in range(n_channels) if c != drift_idx]
        self.n_rounds = int(n_rounds)
        n_data = len(self.data_idx)
        lo = p["layout"]
        rng = rng_of(seed, 11)
        n_bits = self.n_rounds * n_data
        self.codebook, self.rows = make_codebook(
            rng, p["n_chr"], p["n_per_chr"], n_bits, p["n_on"])
        n_h = p["n_homologs"]
        territories = {}
        for k, (c, h) in enumerate((c, h) for c in range(p["n_chr"])
                                   for h in range(n_h)):
            gx, gy = divmod(k, lo["grid_cols"])
            territories[(c, h)] = np.array([lo["center_z"],
                                            lo["origin"] + gx * lo["pitch"],
                                            lo["origin"] + gy * lo["pitch"]])
        self.truth: Dict[tuple, np.ndarray] = {}
        for c in range(p["n_chr"]):
            for h in range(n_h):
                steps = rng.normal(0, 1, (p["n_per_chr"], 3)) * list(
                    lo["step"])
                walk = territories[(c, h)] + np.cumsum(steps, axis=0)
                walk[:, 0] = np.clip(walk[:, 0], *lo["z_clip"])
                walk[:, 1:] = np.clip(walk[:, 1:], *lo["xy_clip"])
                self.truth[(c, h)] = walk
        bit_spots = {b: [] for b in range(n_bits)}
        for gi, on in enumerate(self.rows):
            c, r = divmod(gi, p["n_per_chr"])
            for h in range(n_h):
                pos = self.truth[(c, h)][r]
                for b in on:
                    bit_spots[b].append(pos + rng.normal(0, lo["jitter"], 3))
        self.bit_spots = {b: np.asarray(v, np.float64).reshape(-1, 3)
                          for b, v in bit_spots.items()}
        self.beads = sample_spot_params(
            self.shape, p["beads"], rng, min_separation=p["bead_separation"],
            height_range=tuple(p["bead_heights"]), sigma_jitter=0.0)
        self.drifts = np.vstack([np.zeros(3), rng.uniform(
            -lo["drift_max"], lo["drift_max"], (self.n_rounds - 1, 3))]
        ).round()
        mz, mxy, nd = lo["margin_z"], lo["margin_xy"], p["distractors"]
        self.distractors = {
            (r, ci): np.column_stack([
                rng.uniform(mz, self.shape[0] - mz, nd),
                rng.uniform(mxy, self.shape[1] - mxy, nd),
                rng.uniform(mxy, self.shape[2] - mxy, nd)])
            for r in range(self.n_rounds) for ci in range(n_data)}
        self.chromatic = np.zeros((self.n_channels, 3, 10), np.float32)

    def illumination(self) -> Optional[np.ndarray]:
        """No flat-field profile: the scene plants no vignette."""
        return None

    def bit(self, r: int, ci: int) -> int:
        """The 1-based codebook bit that round r's data channel ci images."""
        return r * len(self.data_idx) + self.data_idx.index(ci) + 1

    def round_stack(self, r: int, device) -> torch.Tensor:
        """Round r's raw (C, Z, X, Y) uint16 stack on `device`."""
        p, d = self.p, self.drifts[r]
        out = torch.empty((self.n_channels,) + self.shape, dtype=torch.uint16,
                          device=device)
        for ci in range(self.n_channels):
            if ci == self.drift_idx:
                im = render_spots(self.shape, self.beads["centers"] + d,
                                  self.beads["heights"],
                                  background=p["bead_background"],
                                  device=device)
                out[ci] = noisy_uint16(im, sub_seed(self.seed, 14, r),
                                       p["bead_read_noise"])
                del im
                continue
            b = self.bit(r, ci) - 1
            spots = self.bit_spots[b]
            dis = self.distractors[(r, self.data_idx.index(ci))]
            base, swing = p["spot_heights"]
            heights = np.concatenate([
                base + swing * np.sin(np.arange(len(spots))),
                rng_of(self.seed, 12, b).uniform(
                    *p["distractor_heights"], len(dis))])
            im = render_spots(self.shape, np.vstack([spots, dis]) + d,
                              heights, background=p["spot_background"],
                              device=device)
            out[ci] = noisy_uint16(im, sub_seed(self.seed, 13, b),
                                   p["read_noise"])
            del im
        return out
