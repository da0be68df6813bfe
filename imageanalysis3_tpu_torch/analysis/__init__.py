"""Polymer post-analysis of picked chromatin traces: distance maps so far
(the first module of ``imageanalysis3_tpu/analysis``)."""

from .distmap import (contact_map, distance_map, median_distance_map,
                      spots_to_zxy_nm)

__all__ = ["spots_to_zxy_nm", "distance_map", "median_distance_map",
           "contact_map"]
