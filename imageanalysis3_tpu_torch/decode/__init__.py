"""Decoding: candidate spots -> MERFISH spot tuples -> homolog traces.

The counterpart of the end-to-end half of ``imageanalysis3_tpu/decode``:
``merfish`` (pair search, greedy selection, tuple completion), ``homolog``
(BB init and E/M homolog assignment), ``new_decoder``
(``codebook_dataframe_to_tables``) and ``dna_decoder`` (the per-cell front
door).  Picking, scoring and the MERFISH group QC functions are not ported
yet.
"""

from .dna_decoder import DNAMerfishDecoder, batch_decode
from .homolog import (HomologResult, assign_groups_to_homologs,
                      decode_chromosome_homologs, init_homolog_centers)
from .merfish import (Codebook, MerfishDecoder, SpotGroups, build_codebook,
                      complete_tuples, find_neighbors, select_pairs)
from .new_decoder import codebook_dataframe_to_tables

__all__ = [
    "DNAMerfishDecoder", "batch_decode", "HomologResult",
    "assign_groups_to_homologs", "decode_chromosome_homologs",
    "init_homolog_centers", "Codebook", "MerfishDecoder", "SpotGroups",
    "build_codebook", "complete_tuples", "find_neighbors", "select_pairs",
    "codebook_dataframe_to_tables",
]
