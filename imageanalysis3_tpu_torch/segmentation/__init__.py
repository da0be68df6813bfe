"""Segmentation: chromosome candidates inside nuclei (nuclei labelling and
the learned segmenter are not ported yet)."""

from .chromosome import (assign_seeds_to_nuclei, find_candidate_chromosomes,
                         select_candidate_chromosomes)

__all__ = ["assign_seeds_to_nuclei", "find_candidate_chromosomes",
           "select_candidate_chromosomes"]
