"""Cell metadata tables: label volume -> per-cell locations, frame
translation, multi-FOV merging.

The counterpart of ``imageanalysis3_tpu/analysis/cell_locations.py``
(reference meta_tools/cell_locations.py:13-245,
meta_tools/global_alignments.py:4-9).

Tables are column mappings (a ``dict`` of NumPy columns in the JAX
package's column order, or a pandas DataFrame, which is a mapping of its
columns), as in ``io/spots.py``; the ``*_dataframe`` facades return
``pd.DataFrame`` and import pandas inside.  A label volume's cells are
measured in one pass on the device: counts, coordinate sums, minima and
maxima of every cell by ``scatter_reduce`` over a few planes at a time,
where the JAX package makes one ``np.where`` a cell.  The sums are of
integer coordinates in float64, so they are exact and the centres equal
NumPy's means.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from ..config import DEFAULT_PIXEL_SIZE_NM
from ..decode.scoring import norm
from ..device import as_tensor, host_array, resolve_device

f64 = torch.float64

_AXES = ("z", "x", "y")
Table = Dict[str, np.ndarray]

#: voxels one pass of the cell measurement reads at most
_CHUNK_VOXELS = 1 << 26


def _n_rows(table: Mapping) -> int:
    for c in table.keys():
        return len(table[c])
    return 0


def _columns(table: Mapping) -> Table:
    return {c: np.asarray(table[c]) for c in table.keys()}


def segmentation_to_cell_locations(labels, fov_id: int = 0,
                                   pixel_sizes=DEFAULT_PIXEL_SIZE_NM,
                                   device=None) -> Table:
    """Label volume -> per-cell location table (um, FOV-centre origin):
    fov_id, cell_id, volume, center_{z,x,y}, min_/max_{z,x,y}."""
    lab = as_tensor(labels, device)
    dev = lab.device
    shape = tuple(int(s) for s in lab.shape)
    plane = shape[1] * shape[2]
    ids = torch.unique(lab)
    ids = ids[ids > 0].to(torch.int64)
    k = ids.numel()
    if k == 0:
        return {}
    cnt = torch.zeros(k, dtype=torch.int64, device=dev)
    sums = torch.zeros((3, k), dtype=f64, device=dev)
    lo = torch.full((3, k), np.iinfo(np.int64).max, dtype=torch.int64,
                    device=dev)
    hi = torch.full((3, k), -1, dtype=torch.int64, device=dev)
    step = max(1, _CHUNK_VOXELS // plane)
    for z0 in range(0, shape[0], step):
        blk = lab[z0:z0 + step].reshape(-1)
        where = torch.nonzero(blk > 0)[:, 0]
        slot = torch.searchsorted(ids, blk[where].to(torch.int64))
        axes = (z0 + where // plane, (where // shape[2]) % shape[1],
                where % shape[2])
        cnt.scatter_add_(0, slot, torch.ones_like(slot))
        for a, coord in enumerate(axes):
            sums[a].scatter_add_(0, slot, coord.to(f64))
            lo[a].scatter_reduce_(0, slot, coord, "amin")
            hi[a].scatter_reduce_(0, slot, coord, "amax")
    size = np.asarray(shape, float)
    px_um = np.asarray(pixel_sizes, float) / 1000.0
    n = host_array(cnt)
    center = (host_array(sums).T / n[:, None] - size / 2) * px_um
    lo = (host_array(lo).T.astype(float) - size / 2) * px_um
    hi = (host_array(hi).T.astype(float) + 1 - size / 2) * px_um
    table: Table = {"fov_id": np.full(k, int(fov_id), np.int64),
                    "cell_id": host_array(ids).astype(np.int64),
                    "volume": n.astype(np.int64)}
    for name, vals in (("center", center), ("min", lo), ("max", hi)):
        for i, a in enumerate(_AXES):
            table[f"{name}_{a}"] = vals[:, i]
    return table


def load_position_file(path: str) -> Table:
    """Stage position table from a 'position.txt' file (comma-separated
    x,y per FOV row, no header) -> columns x, y (integer columns stay
    int64, as pandas reads them)."""
    with open(path) as fh:
        rows = [line.strip().split(",") for line in fh if line.strip()]
    cols = list(zip(*rows)) if rows else [(), ()]
    out: Table = {}
    for name, vals in zip(("x", "y"), cols):
        try:
            out[name] = np.asarray([int(v) for v in vals], np.int64)
        except ValueError:
            out[name] = np.asarray([float(v) for v in vals], np.float64)
    return out


def translate_cell_locations(table: Mapping,
                             fov_position_um: Sequence[float]) -> Table:
    """Shift a FOV's table into the global stage frame: fov_position_um is
    the FOV centre's stage coordinate (z, x, y) in um."""
    out = _columns(table)
    pos = np.asarray(fov_position_um, float)
    for i, a in enumerate(_AXES):
        for col in (f"center_{a}", f"min_{a}", f"max_{a}"):
            if col in out:
                out[col] = out[col] + pos[i]
    return out


def merge_cell_locations(tables: List[Mapping],
                         duplicate_distance_um: float = 5.0,
                         device=None) -> Table:
    """Concatenate stage-frame tables, dropping later-FOV cells whose
    centres lie within `duplicate_distance_um` of an earlier kept cell
    (float64 distances on the device)."""
    dev = resolve_device(device)
    kept: List[Table] = []
    centers: List[torch.Tensor] = []
    for t in tables:
        if not _n_rows(t):
            continue
        cols = _columns(t)
        c = torch.as_tensor(np.stack([cols[f"center_{a}"] for a in _AXES],
                                     axis=1).astype(np.float64), device=dev)
        if centers:
            prev = torch.cat(centers)
            dist = norm(c[:, None, :] - prev[None, :, :])
            keep = dist.amin(dim=1) > duplicate_distance_um
        else:
            keep = torch.ones(c.shape[0], dtype=torch.bool, device=dev)
        k = host_array(keep)
        kept.append({name: v[k] for name, v in cols.items()})
        centers.append(c[keep])
    if not kept:
        return {}
    names = list(kept[0])
    return {name: np.concatenate([t[name] for t in kept]) for name in names}


def _frame(table: Mapping):
    import pandas as pd

    return pd.DataFrame({c: np.asarray(table[c]) for c in table.keys()})


def segmentation_to_cell_locations_dataframe(labels, fov_id: int = 0,
                                             pixel_sizes=DEFAULT_PIXEL_SIZE_NM,
                                             device=None):
    """:func:`segmentation_to_cell_locations` as a DataFrame (the JAX
    package's return type; imports pandas)."""
    return _frame(segmentation_to_cell_locations(labels, fov_id,
                                                  pixel_sizes, device))


def load_position_file_dataframe(path: str):
    """:func:`load_position_file` as a DataFrame (imports pandas)."""
    return _frame(load_position_file(path))


def translate_cell_locations_dataframe(df, fov_position_um):
    """:func:`translate_cell_locations` as a DataFrame (imports pandas)."""
    return _frame(translate_cell_locations(df, fov_position_um))


def merge_cell_locations_dataframe(tables, duplicate_distance_um: float = 5.0,
                                   device=None):
    """:func:`merge_cell_locations` as a DataFrame (imports pandas)."""
    return _frame(merge_cell_locations(tables, duplicate_distance_um,
                                       device))
