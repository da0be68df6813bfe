"""Polymer post-analysis of spots and picked chromatin traces: distance
maps, domains, compartments, structure, genome-wide summaries, cell
locations, population statistics, spot partitioning and trace
conditioning (the ``imageanalysis3_tpu/analysis`` package).

The package-level names carry the JAX package's meanings:
``contact_map`` is ``structure.contact_map`` (the boolean map of one
distance map; the contact frequency over a population of traces is
``distmap.contact_map``), and ``normalize_center_spots`` is
``postanalysis.normalize_center_spots`` (the JAX package imports the
``compartments`` one first and then this one, which wins)."""

from .distmap import spots_to_zxy_nm, distance_map, median_distance_map
from .domains import (sliding_window_dist, find_peaks_1d,
                      candidate_domain_boundaries, domain_pdists,
                      merge_domains, basic_domain_calling, find_matched_starts,
                      insulation_domain_calling, arrowhead_transform,
                      iterative_domain_calling,
                      sliding_window_domain_calling,
                      contact_correlation_domain_calling,
                      merge_domain_by_contact_correlation,
                      neighboring_distance,
                      domain_stat, domain_neighboring_stats)
from .compartments import (ab_axis_projection, spots_to_density,
                           compartment_scores, ab_compartment_eigenscore,
                           winsorize, randomize_index_dict,
                           density_overlaps)
from .partition import (count_genes, find_coordinate_intensities,
                        spots_to_intensity, spots_to_labels,
                        translate_label_image, translate_volume)
from .structure import (contact_map, domain_contact_freq,
                        inter_domain_interactions, loop_out_scores,
                        call_loop_outs, genome_distance_summary,
                        interdomain_likelihood,
                        iterative_interdomain_calling)
from .population import (load_bed, region_overlap_fraction,
                         assign_compartments_from_domains,
                         CellTypeClassifier)
from .postanalysis import (is_in_hull, hull_distance,
                           bootstrap_spots_in_domain,
                           bootstrap_regions_in_domain,
                           region_genomic_scaling, score_from_density,
                           local_maximum_in_density,
                           normalize_center_spots)
from .traces import (nan_gaussian_filter, interp1dnan, interpolate_chr,
                     extract_sequences)
from .genome import (sort_chr, summarize_chr_pair, genome_summary_dict,
                     generate_plot_order, generate_plot_chr_edges,
                     assemble_dist_dict_to_matrix, contact_prob,
                     center_chr_traces, merge_chr_traces,
                     find_interaction_groups, chr_to_density_clouds)
from .cell_locations import (load_position_file,
                             segmentation_to_cell_locations,
                             translate_cell_locations,
                             merge_cell_locations)

__all__ = [
    "spots_to_zxy_nm", "distance_map", "median_distance_map",
    "sliding_window_dist", "find_peaks_1d", "candidate_domain_boundaries",
    "domain_pdists", "merge_domains", "basic_domain_calling",
    "find_matched_starts",
    "insulation_domain_calling", "arrowhead_transform",
    "iterative_domain_calling", "sliding_window_domain_calling",
    "contact_correlation_domain_calling",
    "merge_domain_by_contact_correlation", "neighboring_distance",
    "domain_stat", "domain_neighboring_stats",
    "normalize_center_spots", "ab_axis_projection", "spots_to_density",
    "compartment_scores", "ab_compartment_eigenscore",
    "winsorize", "randomize_index_dict", "density_overlaps",
    "spots_to_labels", "spots_to_intensity", "count_genes",
    "translate_label_image",
    "contact_map", "domain_contact_freq", "inter_domain_interactions",
    "loop_out_scores", "call_loop_outs", "genome_distance_summary",
    "interdomain_likelihood", "iterative_interdomain_calling",
    "load_bed", "region_overlap_fraction",
    "assign_compartments_from_domains", "CellTypeClassifier",
    "is_in_hull", "hull_distance", "bootstrap_spots_in_domain",
    "bootstrap_regions_in_domain", "region_genomic_scaling",
    "score_from_density", "local_maximum_in_density",
    "nan_gaussian_filter", "interp1dnan", "interpolate_chr",
    "extract_sequences",
    "load_position_file",
    "segmentation_to_cell_locations", "translate_cell_locations",
    "merge_cell_locations",
    "sort_chr", "summarize_chr_pair", "genome_summary_dict",
    "generate_plot_order", "generate_plot_chr_edges",
    "assemble_dist_dict_to_matrix", "contact_prob",
    "center_chr_traces", "merge_chr_traces", "find_interaction_groups",
    "chr_to_density_clouds",
    "find_coordinate_intensities", "translate_volume",
]
