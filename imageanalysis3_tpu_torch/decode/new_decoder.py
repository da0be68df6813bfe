"""Codebook tables from a column mapping.

The counterpart of ``imageanalysis3_tpu/decode/new_decoder.py``'s
``codebook_dataframe_to_tables`` (reference _load_codebook,
classes/decode.py:163-176).  It takes any mapping from column names to
column values (a dict of NumPy arrays or lists; a DataFrame works too) and
needs no pandas.  The DataFrame facades of that module (``SpotDecoder``,
``SpotMapper``) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

from .merfish import Codebook, build_codebook

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
    n_rows = matrix.shape[0]
    ids = (np.asarray(codebook["id"], np.int64) if "id" in columns
           else np.arange(n_rows))
    bit_values = []
    for c in bit_cols:
        try:
            bit_values.append(int(c))
        except (TypeError, ValueError):
            bit_values.append(len(bit_values))
    cb = build_codebook((matrix > 0).astype(np.int8), ids=ids,
                        bit_values=bit_values)
    return cb, {c: np.asarray(codebook[c]) for c in meta}
