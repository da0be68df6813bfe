"""Decode front doors over spot tables: codebook tables, SpotDecoder
(combinatorial) and SpotMapper (sequential).

The counterpart of ``imageanalysis3_tpu/decode/new_decoder.py``.  Behavior
targets (reference classes/new_decoder.py):
  * codebook tables (reference _load_codebook, classes/decode.py:163-176)
  * SpotDecoder (:19-407): candidate-spot table + codebook table -> pair
    search -> usage-capped tuple selection -> persisted spot-group table
  * SpotMapper (:408-556): sequential ("unique") codes -- match bits to
    single-on-bit codebook rows, keep the candidate spots of matched bits,
    annotate genomic region info

Every table is a column mapping (a dict of NumPy columns; a pandas
DataFrame works too), so the core needs no pandas; the ``*_dataframe``
methods are the pandas view at the edge.  Persistence goes through
``io.spots.save_table_hdf5``: the JAX package's HDF5 layout where h5py
imports, ``.npy`` columns where it does not.  Decoding runs the port's
``MerfishDecoder`` on its device (the CUDA card unless ``device="cpu"``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..io.spots import (SPOT3D_COLUMNS, Table, column, load_table_hdf5,
                        n_rows, save_table_hdf5, spot_groups_to_table,
                        table_to_cand_spots, to_dataframe)
from .merfish import Codebook, MerfishDecoder, SpotGroups, build_codebook

DEFAULT_META_COLS = ("name", "id", "chr", "chr_order")


def codebook_dataframe_to_tables(codebook: Mapping,
                                 meta_cols: Sequence[str]
                                 = DEFAULT_META_COLS
                                 ) -> Tuple[Codebook, Dict[str, np.ndarray]]:
    """Codebook columns -> (Codebook tables, meta columns).

    Bit columns are every non-meta column, in the mapping's order; values
    > 0 are on-bits.  A bit column named by an integer ("1", "2", ...)
    carries that bit label, any other name its position."""
    columns = list(codebook.keys())
    meta_lower = {m.lower() for m in meta_cols}
    meta = [c for c in columns if str(c).lower() in meta_lower]
    bit_cols = [c for c in columns if c not in meta]
    matrix = np.stack([np.asarray(codebook[c]) for c in bit_cols], axis=1)
    n_rows_ = matrix.shape[0]
    ids = (np.asarray(codebook["id"], np.int64) if "id" in columns
           else np.arange(n_rows_))
    bit_values = []
    for c in bit_cols:
        try:
            bit_values.append(int(c))
        except (TypeError, ValueError):
            bit_values.append(len(bit_values))
    cb = build_codebook((matrix > 0).astype(np.int8), ids=ids,
                        bit_values=bit_values)
    return cb, {c: np.asarray(codebook[c]) for c in meta}


def _first(table: Mapping, name: str):
    if name in list(table.keys()) and n_rows(table):
        return column(table, name)[0]
    return None


class SpotDecoder:
    """Combinatorial decoding over candidate-spot tables (reference
    SpotDecoder, classes/new_decoder.py:19-407)."""

    def __init__(self, cand_spots: Mapping, codebook: Mapping,
                 save_file: Optional[str] = None,
                 search_th: float = 250.0,
                 pixel_sizes=(200.0, 108.0, 108.0),
                 auto: bool = True, verbose: bool = False, device=None,
                 **decode_kwargs):
        self.cand_spots_table = cand_spots
        self.codebook_table = codebook
        self.save_file = save_file
        self.verbose = verbose
        self.codebook, self.codebook_meta = codebook_dataframe_to_tables(
            codebook)
        (self.cand_spots, self.bits, self.channels,
         _px) = table_to_cand_spots(cand_spots)
        self.decoder = MerfishDecoder(self.codebook,
                                      pixel_size_nm=pixel_sizes,
                                      search_th=search_th, device=device)
        self.spot_groups: Optional[SpotGroups] = None
        self._decode_kwargs = decode_kwargs
        if auto:
            self.run()

    def run(self) -> SpotGroups:
        """Pair search + tuple selection + completion (reference
        _search_candidate_pairs + _select_spot_tuples)."""
        self.spot_groups = self.decoder.decode(
            self.cand_spots, self.bits, **self._decode_kwargs)
        return self.spot_groups

    def groups_table(self) -> Table:
        if self.spot_groups is None:
            self.run()
        return spot_groups_to_table(
            self.spot_groups, self.cand_spots, self.bits,
            fov_id=_first(self.cand_spots_table, "fov_id"),
            cell_id=_first(self.cand_spots_table, "cell_id"))

    def groups_dataframe(self):
        """:meth:`groups_table` as a DataFrame (imports pandas)."""
        return to_dataframe(self.groups_table())

    def save(self) -> None:
        """Persist cand spots + decoded groups (reference _save,
        classes/new_decoder.py:316-391)."""
        if not self.save_file:
            raise ValueError("no save_file configured")
        save_table_hdf5(self.cand_spots_table, self.save_file,
                        "cand_spots", mode="a")
        save_table_hdf5(self.groups_table(), self.save_file,
                        "spot_groups", mode="a")

    @classmethod
    def load_groups(cls, save_file: str) -> Table:
        """The saved spot-group table (a DataFrame: ``to_dataframe``)."""
        return load_table_hdf5(save_file, "spot_groups")


class SpotMapper:
    """Sequential ('unique') bit-to-region mapping (reference SpotMapper,
    classes/new_decoder.py:408-556).  The mapped table drops the unmapped
    rows and numbers the rest from 0 (a DataFrame's index is not kept)."""

    def __init__(self, cand_spots: Mapping, codebook: Mapping,
                 save_file: Optional[str] = None,
                 auto: bool = True, verbose: bool = False):
        self.cand_spots_table = cand_spots
        self.codebook_table = codebook
        self.save_file = save_file
        self.verbose = verbose
        if auto:
            self.run()

    def run(self) -> Table:
        cb, meta = codebook_dataframe_to_tables(self.codebook_table)
        # sequential codes: exactly one on-bit per row
        self.bit_2_region: Dict[int, dict] = {}
        for gi in range(len(cb.matrix)):
            on = np.where(cb.matrix[gi] > 0)[0]
            if len(on) != 1:
                continue
            bit = int(cb.bit_values[on[0]])
            info = {"region_id": int(cb.ids[gi])}
            if "name" in meta:
                name = str(meta["name"][gi])
                info["region_name"] = name
                # 'chr:start-end' names annotate genomic coordinates
                if ":" in name and "-" in name.split(":")[-1]:
                    chrom, span = name.split(":")
                    start, end = span.split("-")[:2]
                    info.update(chr=chrom, start=float(start),
                                end=float(end))
            self.bit_2_region[bit] = info
        bits = column(self.cand_spots_table, "bit")
        keep = np.asarray([int(b) in self.bit_2_region for b in bits], bool)
        table: Table = {c: column(self.cand_spots_table, c)[keep]
                        for c in self.cand_spots_table.keys()}
        infos = [self.bit_2_region[int(b)] for b in bits[keep]]
        table["region_id"] = np.asarray([i["region_id"] for i in infos],
                                        np.int64)
        for col in ("region_name", "chr", "start", "end"):
            if any(col in v for v in self.bit_2_region.values()):
                # a region without the value reads NaN, as in pandas
                vals = [i.get(col, np.nan) for i in infos]
                if col in ("start", "end"):
                    table[col] = np.asarray(vals, np.float64)
                elif any(not isinstance(v, str) for v in vals):
                    table[col] = np.asarray(vals, object)
                else:
                    table[col] = np.asarray(vals, str)
        self.filtered_spots = table
        if self.save_file:
            save_table_hdf5(table, self.save_file, "sequential_spots")
        return table

    @property
    def filtered_spots_df(self):
        """:attr:`filtered_spots` as a DataFrame (imports pandas)."""
        return to_dataframe(self.filtered_spots)

    def spots_by_region(self) -> Dict[int, np.ndarray]:
        """region id -> (n, 11) float32 rows, ready for
        build_candidate_table."""
        rid = self.filtered_spots["region_id"]
        rows = np.stack([self.filtered_spots[c] for c in SPOT3D_COLUMNS],
                        axis=1).astype(np.float32) if len(rid) else \
            np.zeros((0, 11), np.float32)
        return {int(r): rows[rid == r] for r in np.unique(rid)}
