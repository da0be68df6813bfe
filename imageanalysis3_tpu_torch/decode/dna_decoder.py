"""DNA MERFISH decoding front door: candidate spots -> homolog traces.

The counterpart of ``imageanalysis3_tpu/decode/dna_decoder.py``.  Behavior
target: reference classes/decode.py DNA_Merfish_Decoder +
batch_decode_BB_like (:694-2199): decode candidate spots against a
chromosome-annotated codebook (pair search + tuple selection), then per
chromosome initialize homolog centers ("BB"), iteratively assign decoded
groups to homologs, and summarize per-homolog zxy traces.

The codebook is any mapping of columns with `id`, per-bit columns and a
`chr` column (a dict of NumPy arrays; no pandas).  Decoding runs on the
decoder's device, the CUDA card unless `device` says otherwise.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .. import tracing
from ..config import DEFAULT_PIXEL_SIZE_NM
from ..device import resolve_device
from ..tracing import StageTimes
from .homolog import HomologResult, _np, decode_chromosome_homologs
from .merfish import MerfishDecoder, SpotGroups
from .new_decoder import codebook_dataframe_to_tables


class DNAMerfishDecoder:
    """Decode a cell's candidate spots into per-chromosome homolog traces.

    Parameters mirror batch_decode_BB_like (classes/decode.py:2139-2199):
    `codebook` must carry `id` + per-bit columns and a `chr` column;
    `keep_ratio_th` gates cells with too few candidates.
    """

    def __init__(self, codebook: Mapping,
                 pixel_sizes=DEFAULT_PIXEL_SIZE_NM,
                 pair_search_radius: float = 250.0,
                 num_homologs: int = 2,
                 keep_ratio_th: float = 0.5, device=None):
        if "chr" not in codebook.keys():
            raise ValueError("codebook needs a `chr` column for homolog "
                             "decoding")
        self.device = resolve_device(device)
        self.codebook, self.meta = codebook_dataframe_to_tables(codebook)
        self.region_2_chr = {int(rid): str(ch) for rid, ch in
                             zip(self.codebook.ids, self.meta["chr"])}
        self.pixel_sizes = np.asarray(pixel_sizes, np.float32)
        self.num_homologs = int(num_homologs)
        self.keep_ratio_th = float(keep_ratio_th)
        self.decoder = MerfishDecoder(self.codebook,
                                      pixel_size_nm=pixel_sizes,
                                      search_th=pair_search_radius,
                                      device=self.device)
        self.stage_seconds: Dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def decode(self, spots: np.ndarray, bits: np.ndarray,
               spot_bucket: Optional[int] = 4096,
               group_bucket: Optional[int] = 256,
               **assign_kwargs) -> Optional[Dict[str, HomologResult]]:
        """Full pipeline: tuples -> per-chromosome homolog assignment.

        Returns chr name -> HomologResult (zxys (H, R_chr, 3) nm), or None
        when the cell has too few candidates (reference keep_ratio gate,
        decode.py:2158-2160).

        Padding, as the JAX package pads to bound its compile count:
        `spot_bucket` rounds the candidate count up with invalid rows and
        `group_bucket` rounds each chromosome's group count up with
        ``ok=False`` rows.  The port compiles nothing; the padded shapes
        keep its outputs comparable with the JAX package's.

        `stage_seconds` records `tuples` (pair search + select + tuple
        completion) and `homolog` (all per-chromosome E/M assignments),
        each ending in a device synchronisation.  While the timing record
        records (``tracing``), a ``decode`` span holds a ``tuples`` and a
        ``homolog`` span, the candidates and the decoded groups as
        attributes, and counts the decode's waits on the card.
        """
        spots = np.asarray(spots, np.float32)
        min_needed = (self.num_homologs * self.codebook.matrix.sum()
                      * self.keep_ratio_th)
        if len(spots) < min_needed:
            return None
        times = StageTimes()
        with tracing.span(tracing.DECODE, candidates=len(spots)) as span:
            with times.stage("tuples"), tracing.span("tuples"):
                groups = self.decoder.decode(spots, bits, bucket=spot_bucket)
                self._sync()
            self.stage_seconds = times.summary()
            with times.stage("homolog"), tracing.span("homolog"):
                out = self._assign_homologs(spots, groups, spot_bucket,
                                            group_bucket, assign_kwargs)
                self._sync()
            span.set(groups=self.n_groups)
        self.stage_seconds = times.summary()
        self.chr_2_homologs = out
        return out

    def _assign_homologs(self, spots, groups, spot_bucket, group_bucket,
                         assign_kwargs) -> Dict[str, HomologResult]:
        """Every chromosome's homolog E/M over the decoded groups."""
        self.spot_groups = groups
        if spot_bucket and len(spots) % spot_bucket:
            # match the decoder's padded spot table (padding rows are
            # never members of any ok group)
            spots = np.pad(spots, ((0, spot_bucket
                                    - len(spots) % spot_bucket), (0, 0)))
        ok = _np(groups.ok)
        self.n_groups = int(ok.sum())
        regions = _np(groups.region)
        spot_idx = _np(groups.spot_idx)
        n_spots = _np(groups.n_spots)
        out: Dict[str, HomologResult] = {}
        for chr_name in sorted(set(self.region_2_chr.values())):
            chr_rids = [rid for rid, c in self.region_2_chr.items()
                        if c == chr_name]
            sel = ok & np.isin(regions, chr_rids)
            k = int(sel.sum())
            if k < 2 * self.num_homologs:
                continue
            pad = ((group_bucket - k % group_bucket) % group_bucket
                   if group_bucket else 0)

            def _take(a, fill=0):
                a = a[sel]
                if pad:
                    a = np.concatenate([
                        a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
                return a

            rid_sel = _take(regions, fill=int(regions[sel][0]))
            sub = SpotGroups(spot_idx=_take(spot_idx, fill=-1),
                             region=rid_sel, n_spots=_take(n_spots),
                             ok=_take(ok, fill=False),
                             spot_usage=groups.spot_usage)
            out[chr_name] = decode_chromosome_homologs(
                sub, spots, rid_sel, pixel_size_nm=self.pixel_sizes,
                n_homologs=self.num_homologs, device=self.device,
                **assign_kwargs)
        return out

    def summarize_zxys_all_chromosomes(self) -> Tuple[np.ndarray, list]:
        """Stack per-homolog traces over chromosomes -> ((sum_R*H, 3)
        zxys, labels ['chr_homolog', ...]) in decode order (reference
        summarize_zxys_all_chromosomes, decode.py:1214-1285)."""
        zxys, labels = [], []
        for chr_name, res in self.chr_2_homologs.items():
            arr = _np(res.zxys)
            for h in range(arr.shape[0]):
                zxys.append(arr[h])
                labels.extend([f"{chr_name}_{h}"] * arr.shape[1])
        return (np.concatenate(zxys) if zxys else np.zeros((0, 3)),
                labels)


def batch_decode(cells: Dict, codebook: Mapping, **kwargs) -> Dict:
    """Decode many cells: cell id -> {'spots': (N, 11), 'bits': (N,)}
    (reference batch_decode_BB_like looping over cell files)."""
    dec = DNAMerfishDecoder(codebook, **{
        k: v for k, v in kwargs.items()
        if k in ("pixel_sizes", "pair_search_radius", "num_homologs",
                 "keep_ratio_th", "device")})
    assign_kwargs = {k: v for k, v in kwargs.items()
                     if k in ("max_iters", "flag_diff_th", "weights",
                              "score_th_percentile", "n_neighbors")}
    return {cid: dec.decode(payload["spots"], payload["bits"],
                            **assign_kwargs)
            for cid, payload in cells.items()}
