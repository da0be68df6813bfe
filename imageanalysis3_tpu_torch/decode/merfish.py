"""MERFISH combinatorial decoding: candidate spots -> spot tuples -> regions.

The counterpart of ``imageanalysis3_tpu/decode/merfish.py`` (codebook
tables, neighbour search, pair enumeration and scoring, greedy selection,
tuple completion and the ``MerfishDecoder`` front door).  Behavior target:
reference classes/decode.py, Merfish_Decoder (:163-531, :1900-2070).

The JAX package's device programs become eager tensor code on the
decoder's device: the neighbour search is a blockwise |a|^2 + |b|^2 - 2ab
distance table with the k nearest per row (f32 products written out, so no
TF32 matmul can touch them), pair scores are empirical CDFs by sort +
searchsorted, and the greedy selection's ``lax.while_loop`` is a host loop
over ``active.any()`` (O(log) rounds, one synchronisation each).  The group
QC functions (merfish.py:478-663) follow: seeding groups, unused spots,
nearest-unused invalid pairs (one full-f32 |a|^2 + |b|^2 - 2ab product per
row block), the random invalid pairs (host NumPy, the same generator calls
in the same order), self-scores against both populations, and the
per-channel normalization and chromatic recentering (``index_add_`` where
the JAX package scatters with ``.at[].add``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.filters import full_f32_matmul
from .scoring import generate_cdf_scores, sort_ref_values

DEFAULT_SEARCH_TH_NM = 250.0   # reference default_search_th (decode.py:20)


# ---------------------------------------------------------------------------
# Codebook (host-side, tiny)
# ---------------------------------------------------------------------------


class Codebook(NamedTuple):
    """Dense codebook tables.

    matrix: (G, B) 0/1; ids: (G,) region ids; bit_values: (B,) the bit
    labels matching candidate spots' `bits`; pair_region: (B, B) int32
    region id decoded by each bit pair (-1 invalid, ties: first code wins,
    matching the reference's first-seen dict insert).
    """

    matrix: np.ndarray
    ids: np.ndarray
    bit_values: np.ndarray
    pair_region: np.ndarray

    @property
    def n_on_bits(self) -> int:
        return int(self.matrix.sum(1).max())

    def on_bits_of(self, region_id: int) -> np.ndarray:
        g = int(np.where(self.ids == region_id)[0][0])
        return self.bit_values[self.matrix[g] > 0]


def build_codebook(matrix: np.ndarray, ids: Optional[Sequence[int]] = None,
                   bit_values: Optional[Sequence[int]] = None) -> Codebook:
    """Codebook tables from a (G, B) on-bit matrix
    (reference _find_valid_pairs_in_codebook, decode.py:177-205)."""
    matrix = np.asarray(matrix)
    g, b = matrix.shape
    ids = np.asarray(ids if ids is not None else np.arange(g), np.int32)
    bit_values = np.asarray(
        bit_values if bit_values is not None else np.arange(b), np.int32)
    pair_region = np.full((b, b), -1, np.int32)
    for gi in range(g):
        on = np.where(matrix[gi] > 0)[0]
        for i in range(len(on)):
            for j in range(i + 1, len(on)):
                a, c = on[i], on[j]
                if pair_region[a, c] < 0:
                    pair_region[a, c] = ids[gi]
                    pair_region[c, a] = ids[gi]
    return Codebook(matrix=matrix.astype(np.int8), ids=ids,
                    bit_values=bit_values, pair_region=pair_region)


def region_bit_matrix(codebook: Codebook) -> np.ndarray:
    """(max_region_id+1, B) on-bit lookup by region id (a row of zeros for
    unused ids) for membership tests."""
    out = np.zeros((int(codebook.ids.max()) + 1, codebook.matrix.shape[1]),
                   np.int8)
    for gi, rid in enumerate(codebook.ids):
        out[rid] = codebook.matrix[gi]
    return out


# ---------------------------------------------------------------------------
# Neighbour search (blockwise brute force)
# ---------------------------------------------------------------------------


def _nearest_k(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices of the k smallest entries of each row, ascending, ties
    by lower index (jax.lax.top_k's order on -d2)."""
    _, idx = torch.topk(d2, k, dim=1, largest=False, sorted=False)
    idx = torch.sort(idx, dim=1).values
    order = torch.sort(d2.gather(1, idx), dim=1, stable=True).indices
    return idx.gather(1, order)


def find_neighbors(positions: torch.Tensor, valid: torch.Tensor,
                   radius: float, k: int = 24,
                   block: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-spot up-to-k neighbours within `radius` -> (idx (N, k) int64,
    ok (N, k) bool).

    positions: (N, 3) nm.  Squared distances are |a|^2 + |b|^2 - 2ab per
    row block, as the JAX package computes them (the replacement for the
    reference KDTree, decode.py:207-241); self-pairs excluded.
    """
    n = positions.shape[0]
    k = min(k, max(n - 1, 1))
    pos = torch.where(valid[:, None], positions, 1e9)
    sq = (pos * pos).sum(dim=1)
    cols = torch.arange(n, device=pos.device)
    idx_out, ok_out = [], []
    for start in range(0, n, block):
        a = pos[start:start + block]
        dot = (a[:, None, 0] * pos[None, :, 0] + a[:, None, 1] * pos[None, :, 1]
               + a[:, None, 2] * pos[None, :, 2])
        d2 = sq[start:start + block, None] + sq[None, :] - 2.0 * dot
        rows = cols[start:start + block]
        d2 = torch.where(rows[:, None] == cols[None, :], float("inf"), d2)
        d2 = torch.where(valid[None, :], d2, float("inf"))
        idx = _nearest_k(d2, k)
        idx_out.append(idx)
        ok_out.append(d2.gather(1, idx) <= radius * radius)
    idx = torch.cat(idx_out)
    ok = torch.cat(ok_out) & valid[:, None]
    return idx, ok


# ---------------------------------------------------------------------------
# Pair enumeration + scoring
# ---------------------------------------------------------------------------


class PairTable(NamedTuple):
    """Masked (N*K,) candidate-pair table."""

    i: torch.Tensor          # first spot index
    j: torch.Tensor          # second spot index
    region: torch.Tensor     # decoded region id
    ok: torch.Tensor         # validity
    score: torch.Tensor      # final score (filled by score_pairs)


def build_pairs(nb_idx: torch.Tensor, nb_ok: torch.Tensor,
                bit_index: torch.Tensor,
                pair_region: torch.Tensor) -> PairTable:
    """Enumerate valid bit pairs from the neighbour table (reference
    decode.py:225-236: keep pairs whose bit pair is in the codebook).
    `bit_index`: (N,) codebook bit index per spot."""
    n, k = nb_idx.shape
    i = torch.arange(n, device=nb_idx.device).repeat_interleave(k)
    j = nb_idx.reshape(-1)
    ok = nb_ok.reshape(-1) & (j > i)        # dedupe (i<j)
    region = pair_region[bit_index[i], bit_index[j]]
    ok = ok & (region >= 0)
    return PairTable(i=i, j=j, region=torch.where(ok, region, -1), ok=ok,
                     score=torch.zeros(n * k, dtype=torch.float32,
                                       device=nb_idx.device))


def _empirical_cdf(values: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """P(X <= v) over the valid population (sort + searchsorted)."""
    n_ok = ok.sum().clamp_min(1)
    s = torch.sort(torch.where(ok, values, float("inf"))).values
    ranks = torch.searchsorted(s, values.contiguous(), right=True)
    return (ranks.to(torch.float32) / n_ok).clamp(1e-4, 1.0)


def score_pairs(pairs: PairTable, spots: torch.Tensor,
                positions: torch.Tensor, intensity_factor: float = 1.0,
                inner_dist_factor: float = -1.0) -> PairTable:
    """Population-CDF scores (reference generate_score_metrics
    decode.py:1900-1930 + generate_scores :2018-2043):
    final = f_int * log cdf(mean intensity) + f_dist * log cdf(distance).
    Reference defaults: intensity_factor=1, inner_dist_factor=-1 — bright
    and compact wins."""
    ints = spots[:, 0]
    mean_int = 0.5 * (ints[pairs.i] + ints[pairs.j])
    d = torch.linalg.norm(positions[pairs.i] - positions[pairs.j], dim=1)
    int_cdf = _empirical_cdf(mean_int, pairs.ok)
    d_cdf = _empirical_cdf(d, pairs.ok)
    score = (intensity_factor * torch.log(int_cdf)
             + (-inner_dist_factor)
             * torch.log1p(-d_cdf.clamp(0.0, 1.0 - 1e-4)))
    return pairs._replace(score=torch.where(pairs.ok, score,
                                            float("-inf")))


# ---------------------------------------------------------------------------
# Greedy usage-capped selection + on-bit completion
# ---------------------------------------------------------------------------


class SpotGroups(NamedTuple):
    """Selected tuples, fixed capacity (P, T)."""

    spot_idx: torch.Tensor    # (P, T) int64, -1 padded
    region: torch.Tensor      # (P,) int32, -1 for unused rows
    n_spots: torch.Tensor     # (P,) int32
    ok: torch.Tensor          # (P,) bool
    spot_usage: torch.Tensor  # (N,) int32
    n_selected: Optional[torch.Tensor] = None  # () greedy-selected pairs
    dropped: Optional[torch.Tensor] = None     # () lost to the capacity


def select_pairs(pairs: PairTable, n_spots: int,
                 capacity: Optional[int] = None) -> SpotGroups:
    """Best-first non-overlapping pair selection (reference
    select_spot_tuples first iteration, decode.py:420-430): walk pairs by
    descending score, keep a pair iff both its spots are still unused.

    As in the JAX package, sequential best-first matching runs as parallel
    locally greedy matching: each round takes every active pair that is
    the best-ranked pair at both its endpoints (ranks are unique: a stable
    sort breaks score ties by pair index), then deactivates pairs touching
    used spots.  The rounds run on the host, one synchronisation each.

    ``capacity=None`` sizes the output at n_spots // 2: nothing is dropped.
    A smaller capacity reports the overflow in `dropped`.
    """
    n_pairs = pairs.score.shape[0]
    dev = pairs.score.device
    if capacity is None:
        capacity = max(1, n_spots // 2)
    capacity = min(capacity, n_pairs)
    order = torch.argsort(-pairs.score, stable=True)
    rank = torch.empty(n_pairs, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n_pairs, device=dev)
    big = 2 ** 30
    sel = torch.zeros(n_pairs, dtype=torch.bool, device=dev)
    used = torch.zeros(n_spots, dtype=torch.bool, device=dev)
    active = pairs.ok.clone()
    while bool(active.any()):
        key = torch.where(active, rank, big)
        best = torch.full((n_spots,), big, dtype=torch.int64, device=dev)
        best.scatter_reduce_(0, pairs.i, key, "amin")
        best.scatter_reduce_(0, pairs.j, key, "amin")
        take = active & (key <= best[pairs.i]) & (key <= best[pairs.j])
        sel |= take
        used[pairs.i[take]] = True
        used[pairs.j[take]] = True
        active &= ~used[pairs.i] & ~used[pairs.j]
    n_selected = sel.sum().to(torch.int32)

    # compact the selected pairs (best-ranked first) into `capacity` rows
    vals, idx = torch.topk(torch.where(sel, -rank, -big), capacity)
    got = vals > -big
    oi = torch.where(got, pairs.i[idx], -1)
    oj = torch.where(got, pairs.j[idx], -1)
    o_reg = torch.where(got, pairs.region[idx], -1)
    usage = torch.zeros(n_spots, dtype=torch.int32, device=dev)
    ones = got.to(torch.int32)
    usage.index_add_(0, torch.where(got, oi, 0), ones)
    usage.index_add_(0, torch.where(got, oj, 0), ones)
    return SpotGroups(spot_idx=torch.stack([oi, oj], dim=1), region=o_reg,
                      n_spots=torch.where(got, 2, 0).to(torch.int32),
                      ok=got, spot_usage=usage, n_selected=n_selected,
                      dropped=n_selected - got.sum().to(torch.int32))


def complete_tuples(groups: SpotGroups, nb_idx: torch.Tensor,
                    nb_ok: torch.Tensor, bit_index: torch.Tensor,
                    region_bits: torch.Tensor, positions: torch.Tensor,
                    max_tuple_size: int = 4,
                    max_usage: int = 1) -> SpotGroups:
    """Upgrade selected pairs with their codes' missing on-bits (reference
    select_spot_tuples third iteration, decode.py:462-517): for each group,
    scan the neighbours of its members for unused spots carrying a missing
    bit; add the nearest-to-centroid one per round."""
    p, t_cap = groups.spot_idx.shape
    dev = groups.spot_idx.device
    spot_idx = torch.cat([groups.spot_idx, torch.full(
        (p, max_tuple_size - t_cap), -1, dtype=groups.spot_idx.dtype,
        device=dev)], dim=1)
    usage = groups.spot_usage.clone()
    n, k = nb_idx.shape
    rows = torch.arange(p, device=dev)
    reg = groups.region.clamp(0, region_bits.shape[0] - 1).long()
    for _ in range(max_tuple_size - 2):
        mem = spot_idx.clamp(0, n - 1)
        mem_ok = spot_idx >= 0
        cand = nb_idx[mem].reshape(p, -1)
        cand_ok = (nb_ok[mem] & mem_ok[..., None]).reshape(p, -1)
        cand_bit = bit_index[cand]
        # bit needed: on-bit of the region not yet present in the tuple
        have = torch.zeros((p, region_bits.shape[1]), dtype=torch.int32,
                           device=dev)
        have.scatter_reduce_(1, bit_index[mem], mem_ok.to(torch.int32),
                             "amax")
        needed = (region_bits[reg] > 0) & (have == 0)
        cand_needed = needed.gather(1, cand_bit)
        cand_free = usage[cand] < max_usage
        dup = (cand[:, :, None] == spot_idx[:, None, :]).any(dim=2)
        good = cand_ok & cand_needed & cand_free & ~dup & groups.ok[:, None]
        # nearest to the group's centroid wins
        cnt = mem_ok.sum(dim=1, keepdim=True).clamp_min(1)
        centroid = torch.where(mem_ok[..., None], positions[mem],
                               0.0).sum(dim=1) / cnt
        d = torch.linalg.norm(positions[cand] - centroid[:, None], dim=-1)
        d = torch.where(good, d, float("inf"))
        best = d.argmin(dim=1)                       # first of equals
        best_d = d.gather(1, best[:, None])[:, 0]
        new_spot = cand[rows, best]
        slot = mem_ok.sum(dim=1)                     # first free slot
        can_add = torch.isfinite(best_d) & (slot < max_tuple_size)
        # intra-round contention: one add per spot per round (nearest
        # claim wins, group index breaks ties), as the JAX package does
        tgt = torch.where(can_add, new_spot, 0)
        seg_d = torch.full((n,), float("inf"), device=dev).scatter_reduce(
            0, tgt, torch.where(can_add, best_d, float("inf")), "amin")
        is_best = can_add & (best_d <= seg_d[new_spot])
        seg_g = torch.full((n,), p, dtype=torch.int64, device=dev) \
            .scatter_reduce(0, tgt, torch.where(is_best, rows, p), "amin")
        can_add = is_best & (seg_g[new_spot] == rows)
        col = slot.clamp(0, max_tuple_size - 1)
        spot_idx[rows, col] = torch.where(can_add, new_spot,
                                          spot_idx[rows, col])
        usage.index_add_(0, tgt, can_add.to(torch.int32))
        if not bool(can_add.any()):
            break
    n_sp = (spot_idx >= 0).sum(dim=1).to(torch.int32)
    return SpotGroups(spot_idx=spot_idx, region=groups.region,
                      n_spots=torch.where(groups.ok, n_sp, 0),
                      ok=groups.ok, spot_usage=usage,
                      n_selected=groups.n_selected, dropped=groups.dropped)


# ---------------------------------------------------------------------------
# Front door
# ---------------------------------------------------------------------------


class MerfishDecoder:
    """Decode candidate spots against a codebook.

    Owns the (tiny) codebook tables; `decode` runs the pair search,
    selection and completion on the decoder's device (the CUDA card unless
    `device` says otherwise).  Spots: (N, 11) natural rows; `bits`: (N,)
    bit labels matching the codebook's bit_values; positions are zxy *
    pixel_sizes (reference Spots3D.to_positions).
    """

    def __init__(self, codebook: Codebook,
                 pixel_size_nm=(200.0, 108.0, 108.0),
                 search_th: float = DEFAULT_SEARCH_TH_NM,
                 intensity_factor: float = 1.0,
                 inner_dist_factor: float = -1.0, device=None):
        self.device = resolve_device(device)
        self.codebook = codebook
        self.pixel_size = np.asarray(pixel_size_nm, np.float32)
        self.search_th = float(search_th)
        self.intensity_factor = float(intensity_factor)
        self.inner_dist_factor = float(inner_dist_factor)
        self._region_bits = region_bit_matrix(codebook)
        # bit label -> codebook column
        self._bit_lut = {int(b): i for i, b in enumerate(codebook.bit_values)}

    def bit_index_of(self, bits: np.ndarray) -> np.ndarray:
        return np.asarray([self._bit_lut[int(b)] for b in bits], np.int64)

    def decode(self, spots: np.ndarray, bits: np.ndarray,
               valid: Optional[np.ndarray] = None,
               k_neighbors: int = 24,
               pair_capacity: Optional[int] = None,
               max_usage: int = 1_000_000,
               bucket: Optional[int] = None) -> SpotGroups:
        """Pair selection always enforces spot uniqueness; `max_usage`
        bounds spot reuse during tuple completion only (reference
        select_spot_tuples defaults max_usage=inf, decode.py:372).

        ``bucket`` rounds the spot count up to a multiple of this with
        `valid=False` padding rows, as the JAX package does to share one
        compiled program per bucket; the port compiles nothing, but the
        padded shapes keep its outputs comparable with the JAX package's.
        Padding rows come back with ``ok=False``."""
        dev = self.device
        spots = np.asarray(spots, np.float32)
        bits = np.asarray(bits)
        n = spots.shape[0]
        valid = (np.ones(n, bool) if valid is None
                 else np.asarray(valid, bool))
        if bucket and n % bucket:
            pad = bucket - n % bucket
            spots = np.pad(spots, ((0, pad), (0, 0)))
            valid = np.pad(valid, (0, pad))           # False padding
            # any in-codebook bit label keeps the LUT lookup happy;
            # valid=False keeps the rows out of every neighbour search
            bits = np.concatenate([
                bits, np.full(pad, self.codebook.bit_values[0], np.int64)])
            n = spots.shape[0]
        spots_t = torch.as_tensor(spots, device=dev)
        valid_t = torch.as_tensor(valid, device=dev)
        positions = spots_t[:, 1:4] * torch.as_tensor(self.pixel_size,
                                                      device=dev)[None]
        bit_index = torch.as_tensor(self.bit_index_of(bits), device=dev)

        nb_idx, nb_ok = find_neighbors(positions, valid_t, self.search_th,
                                       k=k_neighbors)
        pairs = build_pairs(nb_idx, nb_ok, bit_index, torch.as_tensor(
            self.codebook.pair_region, device=dev))
        pairs = score_pairs(pairs, spots_t, positions, self.intensity_factor,
                            self.inner_dist_factor)
        groups = select_pairs(pairs, n, capacity=pair_capacity)
        return complete_tuples(
            groups, nb_idx, nb_ok, bit_index,
            torch.as_tensor(self._region_bits, device=dev), positions,
            max_tuple_size=self.codebook.n_on_bits, max_usage=max_usage)


# ---------------------------------------------------------------------------
# Group QC: seeding groups, unused spots, invalid-pair negative controls
# (reference Merfish_Decoder.find_seeding_groups/find_unused_spots/
# collect_invalid_pairs/generate_reference, decode.py:641-691;
# DNA_Merfish_Decoder.generate_random_invalid_pairs :1314-1342;
# calculate_self_scores :1087-1117)
# ---------------------------------------------------------------------------


def find_seeding_groups(groups: SpotGroups,
                        num_cand_per_region: int = 2) -> torch.Tensor:
    """(P,) mask of groups whose every member spot is claimed by at most
    `num_cand_per_region` groups -- the unambiguous "seeding" groups the
    homolog initialization trusts (reference find_seeding_groups,
    decode.py:641-653)."""
    usage = groups.spot_usage[groups.spot_idx.clamp_min(0)]      # (P, T)
    member = groups.spot_idx >= 0
    ok_members = torch.where(member, usage <= num_cand_per_region,
                             True).all(dim=1)
    return groups.ok & ok_members


def find_unused_spots(groups: SpotGroups,
                      valid: torch.Tensor) -> torch.Tensor:
    """(N,) mask of candidate spots no selected group claimed (reference
    find_unused_spots, decode.py:656-664)."""
    return valid & (groups.spot_usage == 0)


def collect_invalid_pairs(positions: torch.Tensor, unused: torch.Tensor):
    """Nearest-neighbor pairs among unused spots -> (i, j, ok), int32 /
    int32 / bool.

    The negative-control population for tuple self-scoring (reference
    collect_invalid_pairs, decode.py:667-672: each unused spot pairs with
    its nearest unused neighbor).  d^2 = |a|^2 + |b|^2 - 2ab as the JAX
    package computes it, the product in full float32, 4096 rows at a time
    so the (N, N) table is never held whole."""
    n, block = positions.shape[0], 4096
    sq = (positions * positions).sum(dim=1)
    cols = torch.arange(n, device=positions.device)
    j_out, min_out = [], []
    for start in range(0, n, block):
        a = positions[start:start + block]
        with full_f32_matmul():
            dot = a @ positions.T
        d2 = sq[start:start + block, None] + sq[None, :] - 2.0 * dot
        rows = cols[start:start + block]
        both = unused[start:start + block, None] & unused[None, :]
        d2 = torch.where(both & (rows[:, None] != cols[None, :]), d2,
                         float("inf"))
        j_out.append(d2.argmin(dim=1))
        min_out.append(d2.amin(dim=1))
    j = torch.cat(j_out).to(torch.int32)
    ok = unused & torch.isfinite(torch.cat(min_out))
    return cols.to(torch.int32), j, ok


def generate_random_invalid_pairs(bit_index: np.ndarray,
                                  valid: np.ndarray,
                                  pair_region: np.ndarray,
                                  total_num: int = 2000,
                                  rng: Optional[np.random.Generator] = None
                                  ):
    """Sample spot pairs whose bit pair decodes to NOTHING -> (i, j) host
    arrays (reference generate_random_invalid_pairs, decode.py:1314-1342:
    spread `total_num` samples evenly over the invalid bit pairs,
    skipping pairs whose bits lack enough spots).  Host NumPy: the same
    generator calls in the same order as the JAX package's."""
    if rng is None:
        rng = np.random.default_rng(0)
    bit_index, valid = np.asarray(bit_index), np.asarray(valid)
    n_bits = pair_region.shape[0]
    invalid_bit_pairs = [(a, b) for a in range(n_bits)
                         for b in range(a + 1, n_bits)
                         if pair_region[a, b] < 0]
    rng.shuffle(invalid_bit_pairs)
    if not invalid_bit_pairs:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    per_pair = int(np.ceil(total_num / len(invalid_bit_pairs)))
    spots_of_bit = {b: np.flatnonzero((bit_index == b) & valid)
                    for b in range(n_bits)}
    ii, jj = [], []
    for a, b in invalid_bit_pairs:
        if len(ii) >= total_num:
            break
        sa, sb = spots_of_bit[a], spots_of_bit[b]
        if len(sa) < per_pair or len(sb) < per_pair:
            continue
        ii.extend(rng.choice(sa, per_pair))
        jj.extend(rng.choice(sb, per_pair))
    return (np.asarray(ii[:total_num], np.int32),
            np.asarray(jj[:total_num], np.int32))


def group_reference_metrics(groups: SpotGroups, spots: torch.Tensor,
                            positions: torch.Tensor):
    """Per-group (mean intensity, min internal distance, ok) -- the
    reference populations for self-scoring (reference generate_reference,
    decode.py:684-691, intensity_metric='mean', dist_metric='min')."""
    idx = groups.spot_idx.clamp_min(0).long()                     # (P, T)
    member = (groups.spot_idx >= 0) & groups.ok[:, None]
    cnt = member.sum(dim=1).clamp_min(1)
    mean_int = torch.where(member, spots[idx, 0], 0.0).sum(dim=1) / cnt
    pos = positions[idx]                                          # (P, T, 3)
    d = torch.sqrt(((pos[:, :, None] - pos[:, None]) ** 2).sum(dim=-1))
    t = idx.shape[1]
    pair_ok = (member[:, :, None] & member[:, None]
               & ~torch.eye(t, dtype=torch.bool, device=idx.device))
    min_d = torch.where(pair_ok, d, float("inf")).amin(dim=(1, 2))
    has_pair = pair_ok.any(dim=2).any(dim=1)
    return (mean_int, torch.where(has_pair, min_d, float("nan")),
            groups.ok & has_pair)


def pair_metrics(spots: torch.Tensor, positions: torch.Tensor,
                 i: torch.Tensor, j: torch.Tensor, ok: torch.Tensor):
    """(mean intensity, distance) of explicit spot pairs."""
    i, j = i.long(), j.long()
    mean_int = 0.5 * (spots[i, 0] + spots[j, 0])
    d = torch.sqrt(((positions[i] - positions[j]) ** 2).sum(dim=-1))
    nan = float("nan")
    return torch.where(ok, mean_int, nan), torch.where(ok, d, nan)


def tuple_self_scores(groups: SpotGroups, spots: torch.Tensor,
                      positions: torch.Tensor,
                      invalid_i: Optional[torch.Tensor] = None,
                      invalid_j: Optional[torch.Tensor] = None,
                      invalid_ok: Optional[torch.Tensor] = None,
                      intensity_factor: float = 1.0,
                      inner_dist_factor: float = -1.0) -> torch.Tensor:
    """Self-scores of selected groups against their own population, with
    an optional invalid-pair negative control (reference
    calculate_self_scores, decode.py:1087-1117):
    score = f_dist * cdf_log_odds(min internal dist)
          + f_int * cdf_log_odds(mean intensity), where the log odds
    compare each metric's rank in the valid population against its rank
    in the invalid-pair population (scoring.generate_cdf_scores)."""
    ints, dists, ok = group_reference_metrics(groups, spots, positions)
    pos_i, cnt_i = sort_ref_values(ints, ok)
    pos_d, cnt_d = sort_ref_values(dists, ok)
    neg_i = neg_d = ncnt_i = ncnt_d = None
    if invalid_i is not None:
        neg_ints, neg_dists = pair_metrics(spots, positions, invalid_i,
                                           invalid_j, invalid_ok)
        neg_i, ncnt_i = sort_ref_values(neg_ints)
        neg_d, ncnt_d = sort_ref_values(neg_dists)
    int_sc = generate_cdf_scores(ints, pos_i, cnt_i, neg_i, ncnt_i)
    dist_sc = generate_cdf_scores(dists, pos_d, cnt_d, neg_d, ncnt_d)
    score = intensity_factor * int_sc + inner_dist_factor * dist_sc
    return torch.where(ok, score, float("-inf"))


# ---------------------------------------------------------------------------
# Candidate preparation: per-channel normalization + chromatic recentering
# (reference normalize_ch_2_channels :1832-1851,
# refine_chromatic_by_channel_center :1853-1876,
# adjust_spots_by_chromatic_center :1878-1898)
# ---------------------------------------------------------------------------


def _channel_sums(values: torch.Tensor, channel_idx: torch.Tensor,
                  valid: torch.Tensor, n_channels: int):
    """(per-channel sums of `values` (N, ...), per-channel valid counts)."""
    ch = channel_idx.long()
    sums = torch.zeros((n_channels,) + values.shape[1:],
                       device=values.device).index_add_(0, ch, values)
    cnts = torch.zeros(n_channels, device=values.device).index_add_(
        0, ch, valid.to(torch.float32))
    return sums, cnts


def normalize_intensities_by_channel(spots: torch.Tensor,
                                     channel_idx: torch.Tensor,
                                     valid: torch.Tensor,
                                     n_channels: int) -> torch.Tensor:
    """Divide each spot's height by its channel's mean intensity
    (reference normalize_ch_2_channels, decode.py:1832-1851)."""
    sums, cnts = _channel_sums(torch.where(valid, spots[:, 0], 0.0),
                               channel_idx, valid, n_channels)
    mean = sums / cnts.clamp_min(1.0)
    out = spots.clone()
    out[:, 0] = spots[:, 0] / mean[channel_idx.long()].clamp_min(1e-12)
    return out


def adjust_spots_by_chromatic_center(spots: torch.Tensor,
                                     channel_idx: torch.Tensor,
                                     valid: torch.Tensor,
                                     n_channels: int,
                                     ref_channel_idx: int = 0
                                     ) -> torch.Tensor:
    """Residual chromatic refinement: translate every channel's spot
    cloud so its centroid matches the reference channel's (reference
    adjust_spots_by_chromatic_center, decode.py:1878-1898; the dict-keyed
    refine_chromatic_by_channel_center :1853-1876 is the same operation).
    """
    sums, cnts = _channel_sums(
        torch.where(valid[:, None], spots[:, 1:4], 0.0), channel_idx, valid,
        n_channels)
    centers = sums / cnts.clamp_min(1.0)[:, None]
    shift = centers - centers[ref_channel_idx][None]
    out = spots.clone()
    out[:, 1:4] = spots[:, 1:4] - shift[channel_idx.long()]
    return out
