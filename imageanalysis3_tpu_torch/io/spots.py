"""Spot-table interchange: spot arrays <-> column tables <-> files.

The counterpart of ``imageanalysis3_tpu/io/spots.py``.  Behavior targets
(reference io_tools/spots.py:1-375):
  * column schema                Spot3D_infos = [height, z, x, y,
    background, sigma_z, sigma_x, sigma_y, sin_t, sin_p, eps] plus
    fov_id / cell_id / bit / channel / uid / pixel_{z,x,y}
  * cell spots -> table          FovCell2Spots_2_DataFrame (:27-85)
  * table -> cand spots          CellSpotsDf_2_CandSpots (:16-25)
  * decoded tuples <-> table     SpotTuple_2_Dict / Dataframe_2_SpotGroups
    (:88-375), in long format (one row per tuple member, keyed by
    group_id)

Two layers.  The core works on column tables: a ``dict`` of NumPy columns
in the JAX package's column order, or any mapping from column names to
columns (a pandas DataFrame included).  Its functions carry the JAX names
with ``table`` for ``dataframe`` (``spots_to_table``,
``table_to_cand_spots``, ...) and need no pandas.  The facade keeps the
JAX names and returns ``pd.DataFrame``; it imports pandas inside each
function, so it runs only where pandas is installed.

Files: ``save_table_hdf5`` / ``load_table_hdf5`` write and read the JAX
package's columnar HDF5 layout exactly (a group per table, one dataset per
column, ``attrs["columns"]``, strings as ``S64``) where h5py imports;
where it does not (or for an existing directory) the table is a directory
of ``.npy`` columns with a JSON index of its attributes, the NumPy backend
of ``io/store.py``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT_PIXEL_SIZE_NM
from ..device import host_array, resolve_device
from .store import _NpyFile, _h5py, store_backend

#: the 11 natural spot parameters (reference Spot3D_infos)
SPOT3D_COLUMNS = ["height", "z", "x", "y", "background", "sigma_z",
                  "sigma_x", "sigma_y", "sin_t", "sin_p", "eps"]
PIXEL_COLUMNS = ["pixel_z", "pixel_x", "pixel_y"]

Table = Dict[str, np.ndarray]


def n_rows(table: Mapping) -> int:
    """Row count of a column table (0 without columns)."""
    for c in table.keys():
        return len(table[c])
    return 0


def column(table: Mapping, name) -> np.ndarray:
    """One column of a table as a NumPy array."""
    return np.asarray(table[name])


def _broadcast(value, n: int, keep=None) -> np.ndarray:
    """A scalar (None included) repeated n times, or an array's rows
    (filtered by `keep` when it has one entry per unfiltered row)."""
    if isinstance(value, torch.Tensor):
        value = host_array(value)
    if value is None or np.ndim(value) == 0:
        return np.full(n, value)
    arr = np.asarray(value)
    if keep is not None and len(arr) == len(keep):
        arr = arr[keep]
    return arr


def to_dataframe(table: Mapping):
    """The pandas view of a column table (imports pandas)."""
    import pandas as pd

    return pd.DataFrame({c: column(table, c) for c in table.keys()})


# ---------------------------------------------------------------------------
# The core: column tables
# ---------------------------------------------------------------------------


def spots_to_table(spots, bits: Optional[Sequence] = None,
                   channels: Optional[Sequence] = None,
                   valid=None, fov_id=None, cell_id=None, uid=None,
                   pixel_sizes=DEFAULT_PIXEL_SIZE_NM) -> Table:
    """(N, 11) spot rows -> the reference's cand-spots columns.  `fov_id`,
    `cell_id` and `uid` are one value for every row or one per row."""
    spots = np.atleast_2d(np.asarray(host_array(spots), np.float64))
    keep = None
    if valid is not None:
        keep = np.asarray(host_array(valid), bool)
        spots = spots[keep]
        bits = None if bits is None else np.asarray(host_array(bits))[keep]
        channels = (None if channels is None
                    else np.asarray(channels)[keep])
    n = len(spots)
    table: Table = {"fov_id": _broadcast(fov_id, n, keep),
                    "cell_id": _broadcast(cell_id, n, keep)}
    for k, c in enumerate(SPOT3D_COLUMNS):
        table[c] = spots[:, k].copy()
    table["bit"] = (np.asarray(host_array(bits)) if bits is not None
                    else np.full(n, -1))
    table["channel"] = (np.asarray(channels).astype(str)
                        if channels is not None else np.full(n, ""))
    table["uid"] = _broadcast(uid, n, keep)
    for c, v in zip(PIXEL_COLUMNS, pixel_sizes):
        table[c] = np.full(n, float(v))
    return table


def table_to_cand_spots(table: Mapping
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """Table -> ((N, 11) float32 spots, bits, channels, pixel_sizes)
    (reference CellSpotsDf_2_CandSpots, io_tools/spots.py:16-25)."""
    n = n_rows(table)
    names = list(table.keys())
    spots = (np.stack([column(table, c) for c in SPOT3D_COLUMNS], axis=1)
             .astype(np.float32) if n else np.zeros((0, 11), np.float32))
    bits = column(table, "bit") if "bit" in names else np.full(n, -1)
    channels = (column(table, "channel").astype(str) if "channel" in names
                else np.full(n, ""))
    if set(PIXEL_COLUMNS) <= set(names) and n:
        px = np.asarray([column(table, c)[0] for c in PIXEL_COLUMNS],
                        np.float32)
    else:
        px = np.asarray(DEFAULT_PIXEL_SIZE_NM, np.float32)
    return spots, bits, channels, px


def spot_groups_to_table(groups, spots, bits=None, fov_id=None,
                         cell_id=None, homolog_flags=None,
                         pixel_sizes=DEFAULT_PIXEL_SIZE_NM) -> Table:
    """Decoded SpotGroups -> long table, one row per tuple member.

    Columns: fov_id, cell_id, group_id, region_id, homolog, member (index
    within the tuple), spot_index (into the cand-spot table), the 11 spot
    parameters and bit, then the pixel sizes.  Without a member the table
    holds the pixel-size columns alone, as the JAX package's DataFrame."""
    ok = host_array(groups.ok).astype(bool)
    idx = host_array(groups.spot_idx).astype(np.int64)
    region = host_array(groups.region)
    spots = np.asarray(host_array(spots))
    gi = np.nonzero(ok)[0]
    sel = idx[gi]
    has = sel >= 0
    rows, _ = np.nonzero(has)
    si = sel[has]
    member = (np.cumsum(has, axis=1) - 1)[has]
    n = len(si)
    table: Table = {}
    if n:
        table["fov_id"] = np.full(n, fov_id)
        table["cell_id"] = np.full(n, cell_id)
        table["group_id"] = gi[rows].astype(np.int64)
        table["region_id"] = region[gi][rows].astype(np.int64)
        table["homolog"] = (np.asarray(host_array(homolog_flags))[gi][rows]
                            .astype(np.int64) if homolog_flags is not None
                            else np.full(n, -1, np.int64))
        table["member"] = member.astype(np.int64)
        table["spot_index"] = si
        rows_sp = spots[si].astype(np.float64)
        for k, c in enumerate(SPOT3D_COLUMNS):
            table[c] = rows_sp[:, k].copy()
        table["bit"] = (np.asarray(host_array(bits))[si].astype(np.int64)
                        if bits is not None else np.full(n, -1, np.int64))
    for c, v in zip(PIXEL_COLUMNS, pixel_sizes):
        table[c] = np.full(n, float(v))
    return table


def table_to_spot_groups(table: Mapping, capacity: Optional[int] = None,
                         device=None):
    """Long group table -> the port's ``decode.merfish.SpotGroups`` on
    `device` (default the card), inverse of :func:`spot_groups_to_table`
    (reference Dataframe_2_SpotGroups, io_tools/spots.py:300-375)."""
    from ..decode.merfish import SpotGroups

    dev = resolve_device(device)
    n = n_rows(table)
    gid = column(table, "group_id") if n else np.zeros(0, np.int64)
    gids, sizes = np.unique(gid, return_counts=True)
    t = capacity or (int(sizes.max()) if n else 1)
    p = len(gids)
    spot_idx = np.full((p, t), -1, np.int64)
    region = np.full(p, -1, np.int32)
    n_spots = np.zeros(p, np.int32)
    if n:
        order = np.lexsort((column(table, "member"), gid))
        k = np.searchsorted(gids, gid[order])
        first = np.searchsorted(gid[order], gids)
        pos = np.arange(n) - first[k]
        region[:] = column(table, "region_id")[order][first]
        take = pos < t
        spot_idx[k[take], pos[take]] = column(table, "spot_index")[order][
            take]
        n_spots[:] = np.minimum(sizes, t)
    n_total = int(column(table, "spot_index").max()) + 1 if n else 0
    t_ = lambda a: torch.as_tensor(a, device=dev)
    return SpotGroups(spot_idx=t_(spot_idx), region=t_(region),
                      n_spots=t_(n_spots), ok=t_(np.ones(p, bool)),
                      spot_usage=t_(np.zeros(n_total, np.int32)))


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def open_table_file(path: str, mode: str = "r",
                    backend: Optional[str] = None):
    """An HDF5 file (h5py) or a ``.npy`` directory (`backend` as
    ``io.store.store_backend`` picks it: an existing directory opens as
    ``"npy"``, otherwise h5py where it imports), closed on exit."""
    if store_backend(backend, path) == "h5py":
        fh = _h5py().File(path, mode)
    else:
        fh = _NpyFile(path, mode)
    try:
        yield fh
    finally:
        fh.close()


def is_group(node) -> bool:
    """Whether a node of an open table file is a group."""
    return hasattr(node, "keys")


def write_table(fh, key: str, table: Mapping) -> None:
    """Write a table under `key` of an open file, replacing what is
    there: one dataset per column, strings as utf-8 ``S64`` bytes."""
    if key in fh:
        del fh[key]
    g = fh.create_group(key)
    names = list(table.keys())
    g.attrs["columns"] = names
    for c in names:
        v = np.asarray(table[c])
        if v.dtype == object or v.dtype.kind in "US":
            v = np.array(["" if x is None else str(x) for x in v],
                         dtype="S64")
        g.create_dataset(str(c), data=v)


def read_table(fh, key: str) -> Table:
    """The table under `key` of an open file (strings decoded)."""
    g = fh[key]
    out: Table = {}
    for c in list(g.attrs["columns"]):
        v = g[str(c)][:]
        if v.dtype.kind == "S":
            v = v.astype(str)
        out[c] = v
    return out


def save_table_hdf5(table: Mapping, path: str, key: str, mode: str = "a",
                    backend: Optional[str] = None) -> None:
    """Columnar persistence of a table under `key` (the JAX package's
    pandas.to_hdf stand-in; ``.npy`` columns where h5py is missing)."""
    with open_table_file(path, mode, backend) as fh:
        write_table(fh, key, table)


def load_table_hdf5(path: str, key: str,
                    backend: Optional[str] = None) -> Table:
    with open_table_file(path, "r", backend) as fh:
        return read_table(fh, key)


# ---------------------------------------------------------------------------
# The facade: pandas DataFrames (pandas imported inside each function)
# ---------------------------------------------------------------------------


def spots_to_dataframe(spots, bits=None, channels=None, valid=None,
                       fov_id=None, cell_id=None, uid=None,
                       pixel_sizes=DEFAULT_PIXEL_SIZE_NM):
    """:func:`spots_to_table` as a DataFrame."""
    return to_dataframe(spots_to_table(spots, bits, channels, valid, fov_id,
                                       cell_id, uid, pixel_sizes))


def dataframe_to_cand_spots(df):
    """:func:`table_to_cand_spots` of a DataFrame."""
    return table_to_cand_spots(df)


def spot_groups_to_dataframe(groups, spots, bits=None, fov_id=None,
                             cell_id=None, homolog_flags=None,
                             pixel_sizes=DEFAULT_PIXEL_SIZE_NM):
    """:func:`spot_groups_to_table` as a DataFrame."""
    return to_dataframe(spot_groups_to_table(groups, spots, bits, fov_id,
                                             cell_id, homolog_flags,
                                             pixel_sizes))


def dataframe_to_spot_groups(df, capacity: Optional[int] = None,
                             device=None):
    """:func:`table_to_spot_groups` of a DataFrame."""
    return table_to_spot_groups(df, capacity, device)


def save_dataframe_hdf5(df, path: str, key: str, mode: str = "a",
                        backend: Optional[str] = None) -> None:
    """:func:`save_table_hdf5` of a DataFrame."""
    save_table_hdf5(df, path, key, mode, backend)


def load_dataframe_hdf5(path: str, key: str,
                        backend: Optional[str] = None):
    """:func:`load_table_hdf5` as a DataFrame."""
    return to_dataframe(load_table_hdf5(path, key, backend))


def spaligner_to_chr_homologs(cell_data_df, codebook_df,
                              info_names=("fov_id", "cell_id", "uid"),
                              fill_blank: bool = True):
    """Convert an spAligner-style per-cell DataFrame into chr -> list of
    homolog traces (reference spAligner_2_chr2homologList,
    io_tools/aligner.py:3-39).

    `cell_data_df` carries one row per fitted locus with columns ``chr``
    (may be 'chr1' or '1'), ``fiberidx`` (homolog index), ``hyb``
    (within-chromosome region order) and ``z_um/x_um/y_um``.  With
    ``fill_blank``, each homolog becomes a dense (R_chr, 3) trace with NaN
    rows for unobserved regions, sized from the codebook.  Returns
    (chr_2_homolog_list, info_dict) where info_dict collects the unique
    value of each requested metadata column.  DataFrames in, as in the
    JAX package."""
    chr_2_homologs = {}
    cb_chr = codebook_df["chr"].astype(str)
    for chr_name in np.unique(cell_data_df["chr"].astype(str)):
        chrom = chr_name.split("chr")[1] if "chr" in chr_name else chr_name
        n_regions = int(np.sum(cb_chr == chrom))
        sub = cell_data_df[cell_data_df["chr"].astype(str) == chr_name]
        homologs = []
        for fbr in np.unique(sub["fiberidx"]):
            fiber = sub[sub["fiberidx"] == fbr].sort_values("hyb")
            inds = fiber["hyb"].to_numpy(int)
            coords = fiber[["z_um", "x_um", "y_um"]].to_numpy(float)
            if fill_blank:
                full = np.full((n_regions, 3), np.nan)
                full[inds] = coords
                homologs.append(full)
            else:
                homologs.append(coords)
        chr_2_homologs[chrom] = homologs
    info = {}
    for name in info_names:
        if name in cell_data_df.columns:
            info[name] = np.unique(cell_data_df[name])[0]
    return chr_2_homologs, info
