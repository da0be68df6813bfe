"""Post-analysis of spots and picked chromatin traces: spot partitioning
into segmented cells, trace conditioning and distance maps (the
``partition``, ``traces`` and ``distmap`` modules of
``imageanalysis3_tpu/analysis``)."""

from .distmap import (contact_map, distance_map, median_distance_map,
                      spots_to_zxy_nm)
from .partition import (count_genes, find_coordinate_intensities,
                        spots_to_intensity, spots_to_labels,
                        translate_label_image, translate_volume)
from .traces import (extract_sequences, interp1dnan, interpolate_chr,
                     nan_gaussian_filter)

__all__ = ["spots_to_zxy_nm", "distance_map", "median_distance_map",
           "contact_map", "spots_to_labels", "spots_to_intensity",
           "find_coordinate_intensities", "count_genes",
           "translate_label_image", "translate_volume",
           "nan_gaussian_filter", "interp1dnan", "interpolate_chr",
           "extract_sequences"]
