"""Decoding and picking: candidate spots -> MERFISH spot tuples -> homolog
traces, and candidate tables -> picked chromosome traces.

The counterpart of ``imageanalysis3_tpu/decode``: ``merfish`` (pair search, greedy selection, tuple
completion, group QC and negative controls), ``homolog`` (BB init and E/M
homolog assignment), ``new_decoder`` (codebook tables, ``SpotDecoder``
and ``SpotMapper`` over spot tables), ``picker`` (``SpotPicker``, the
score-based iterative picker over decoded tables),
``dna_decoder`` (the per-cell front door), ``scoring`` (linear and CDF
spot scores), ``picking`` (naive, DP and EM pickers, merging and
assignment), ``checking`` (picked-spot screens) and
``population_picking`` (population-reference EM).
"""

from .checking import check_picked_spots, filter_candidate_spots
from .dna_decoder import DNAMerfishDecoder, batch_decode
from .homolog import (HomologResult, assign_groups_to_homologs,
                      decode_chromosome_homologs, init_homolog_centers)
from .merfish import (Codebook, MerfishDecoder, SpotGroups,
                      adjust_spots_by_chromatic_center, build_codebook,
                      collect_invalid_pairs, complete_tuples, find_neighbors,
                      find_seeding_groups, find_unused_spots,
                      generate_random_invalid_pairs, group_reference_metrics,
                      normalize_intensities_by_channel, pair_metrics,
                      select_pairs, tuple_self_scores)
from .new_decoder import (SpotDecoder, SpotMapper,
                          codebook_dataframe_to_tables)
from .picker import (SpotPicker, batch_pick_spots, cdf_scores,
                     prepare_score_metrics_by_chr)
from .picking import (EMPickResult, assign_spots_to_chromosomes,
                      build_candidate_table, dynamic_pick_spots,
                      em_pick_spots, em_pick_spots_exclusive,
                      em_pick_spots_for_chromosomes, merge_spot_lists,
                      naive_pick_spots, take_trace)
from .population_picking import (PopulationEMResult, PopulationPickResult,
                                 PopulationReference, chromosome_center_dists,
                                 cum_val, em_pick_spots_in_population,
                                 evaluate_differences,
                                 generate_reference_from_population,
                                 local_center_dists, pick_spots_by_intensities,
                                 pick_spots_by_scores,
                                 screen_rna_based_on_refs, spots_to_hzxys)
from .scoring import (ChromRefArrays, ChromRefStats, candidate_neighbor_dists,
                      cdf_distance_score, cdf_intensity_score,
                      chromosomal_spot_scores, chromosome_ref_arrays,
                      chromosome_ref_stats, cum_prob, exp_distance_scores,
                      generate_cdf_scores, intensity_score,
                      linear_distance_score, local_centers,
                      log_distance_scores, neighboring_dists,
                      normalize_intensities, radius_of_gyration,
                      score_candidates, sort_ref_values)

__all__ = [
    "DNAMerfishDecoder", "batch_decode", "HomologResult",
    "assign_groups_to_homologs", "decode_chromosome_homologs",
    "init_homolog_centers", "Codebook", "MerfishDecoder", "SpotGroups",
    "build_codebook", "complete_tuples", "find_neighbors", "select_pairs",
    "codebook_dataframe_to_tables", "SpotDecoder", "SpotMapper",
    "SpotPicker", "batch_pick_spots", "cdf_scores",
    "prepare_score_metrics_by_chr",
    "find_seeding_groups", "find_unused_spots", "collect_invalid_pairs",
    "generate_random_invalid_pairs", "group_reference_metrics",
    "pair_metrics", "tuple_self_scores", "normalize_intensities_by_channel",
    "adjust_spots_by_chromatic_center",
    "naive_pick_spots", "dynamic_pick_spots", "em_pick_spots",
    "em_pick_spots_for_chromosomes", "em_pick_spots_exclusive",
    "build_candidate_table", "take_trace", "EMPickResult",
    "merge_spot_lists", "assign_spots_to_chromosomes",
    "check_picked_spots", "filter_candidate_spots",
    "ChromRefStats", "chromosome_ref_stats", "score_candidates",
    "local_centers", "neighboring_dists", "linear_distance_score",
    "intensity_score", "ChromRefArrays", "chromosome_ref_arrays",
    "chromosomal_spot_scores", "radius_of_gyration", "cum_prob",
    "cdf_distance_score", "cdf_intensity_score", "generate_cdf_scores",
    "log_distance_scores", "exp_distance_scores", "normalize_intensities",
    "sort_ref_values", "candidate_neighbor_dists",
    "pick_spots_by_intensities", "pick_spots_by_scores",
    "em_pick_spots_in_population", "generate_reference_from_population",
    "chromosome_center_dists", "local_center_dists", "spots_to_hzxys",
    "cum_val", "PopulationReference", "PopulationPickResult",
    "PopulationEMResult", "evaluate_differences", "screen_rna_based_on_refs",
]
