"""Codebook-encoding helpers: on-bit lists <-> code matrices, hybridization
ordering overlap.

The port's copy of ``imageanalysis3_tpu/library/encoding.py``, host NumPy
with no tensors, kept here so the port never imports the JAX package.

Behavior targets (reference ImageAnalysis3):
  * convert_bits_to_matrix       library_tools/encoding.py:3-8
  * calculate_closest_overlap    library_tools/encoding.py:9-26
  * fasta writing                library_tools/LibraryTools.py:37-45 (fastawrite)

Host-side NumPy — codebook design is an offline workload (SURVEY §2.10);
the decode-time codebook matmul lives in decode/merfish.py.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import numpy as np


def convert_bits_to_matrix(bits: Sequence[Sequence[int]]) -> np.ndarray:
    """On-bit lists -> (n_codes, n_bits) codebook matrix of +1/-1.

    Row i carries +1 at code i's on-bits and -1 elsewhere; the bit axis
    spans 0..max(on-bit) (reference library_tools/encoding.py:3-8).
    """
    rows = [np.asarray(b, dtype=np.int64) for b in bits]
    if not rows:
        return np.zeros((0, 0), np.int32)
    n_bits = int(max(int(r.max()) for r in rows if r.size)) + 1
    out = np.full((len(rows), n_bits), -1, np.int32)
    for i, r in enumerate(rows):
        out[i, r] = 1
    return out


def calculate_closest_overlap(code_list: Sequence[Sequence[int]],
                              code: Sequence[int],
                              location: int) -> float:
    """Distance from `location` to the nearest already-placed code
    sharing a bit with `code`.

    Used when ordering codes across hybridization rounds so codes
    sharing a readout bit land far apart (reference
    library_tools/encoding.py:9-26): for each bit of `code`, find the
    closest row of `code_list` containing that bit — rows at or after
    `location` count as one slot farther (the insertion shifts them
    back) — and return the minimum over bits.  Bits absent from
    `code_list` contribute len(code_list)+1; an empty list returns inf.
    """
    if location > len(code_list) or location < 0:
        raise ValueError(f"invalid location {location} for "
                         f"{len(code_list)} placed codes")
    if len(code_list) == 0:
        return float("inf")
    arr = np.asarray(code_list)
    dists: List[float] = []
    for b in code:
        match = np.where((arr == b).any(axis=1))[0] if arr.ndim == 2 \
            else np.where(arr == b)[0]
        if match.size == 0:
            dists.append(len(code_list) + 1)
            continue
        d = np.abs(match - location).astype(np.float64)
        d[match >= location] += 1
        dists.append(float(d.min()))
    return float(np.nanmin(dists))


def write_fasta(path: str, records: Dict[str, str] | Iterable,
                append: bool = False, width: int = 0) -> None:
    """Write `{name: seq}` (or (name, seq) pairs) as FASTA
    (reference LibraryTools.fastawrite, library_tools/LibraryTools.py:
    37-45).  ``width`` > 0 wraps sequence lines."""
    items = records.items() if isinstance(records, dict) else records
    with open(path, "a" if append else "w") as fh:
        for name, seq in items:
            fh.write(f">{name}\n")
            if width and width > 0:
                for i in range(0, len(seq), width):
                    fh.write(seq[i:i + width] + "\n")
            else:
                fh.write(seq + "\n")
