"""Distance maps from picked chromatin traces.

The counterpart of ``imageanalysis3_tpu/analysis/distmap.py``.  Behavior
target: reference ``Cell_Data._generate_distance_map``
(classes/__init__.py:4123-4273): picked zxy (px) scaled by
``_distance_zxy`` nm, then ``squareform(pdist(zxys))`` per cell;
population medians across cells.  Traces are fixed-width tensors with NaN
for missing regions; the pairwise map is one broadcast subtraction per
batch, and the population median is the NaN-aware averaging median of
``ops.filters.nanquantile`` (a sort along the cells, so no element limit).
"""

from __future__ import annotations

import torch

from ..config import DEFAULT_PIXEL_SIZE_NM
from ..decode.scoring import pixel_sizes
from ..ops.filters import nanquantile


def spots_to_zxy_nm(spots: torch.Tensor,
                    pixel_size_nm=DEFAULT_PIXEL_SIZE_NM) -> torch.Tensor:
    """(..., 11) spot rows -> (..., 3) zxy in nm."""
    return spots[..., 1:4] * pixel_sizes(pixel_size_nm, spots.device)


def distance_map(zxys: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) traces (nm; NaN = missing) -> (..., N, N) euclidean
    distance maps."""
    d = zxys[..., :, None, :] - zxys[..., None, :, :]
    return torch.sqrt((d * d).sum(dim=-1))


def median_distance_map(zxys_batch: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) traces -> (N, N) median distance map ignoring NaNs."""
    return nanquantile(distance_map(zxys_batch), 0.5, dim=0)


def contact_map(zxys_batch: torch.Tensor,
                threshold_nm: float = 500.0) -> torch.Tensor:
    """(B, N, 3) traces -> (N, N) contact frequency below threshold."""
    maps = distance_map(zxys_batch)
    ok = torch.isfinite(maps)
    contacts = (maps < threshold_nm) & ok
    return (contacts.sum(dim=0, dtype=torch.float32)
            / ok.sum(dim=0, dtype=torch.float32).clamp_min(1.0))
