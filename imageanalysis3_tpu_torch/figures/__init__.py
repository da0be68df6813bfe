"""Figure tools: distance maps, domains, projections, decode statistics.

The counterpart of ``imageanalysis3_tpu/figures``, with the same names.
Behavior targets (reference figure_tools/):
  * distance-map rendering     figure_tools/distmap.py:17-155
  * domain boundary overlay    figure_tools/domain.py (plot_boundaries)
  * image projections          figure_tools/image.py:27-190
  * decode statistics          figure_tools/plot_decode.py:66+
  * partition / segmentation   figure_tools/plot_{partition,segmentation}.py
  * interactive curation       visual_tools.py:510-905 (imshow_mark_3d_v2),
                               domain_tools/manual.py:13-233 (mark_boundaries)

Matplotlib only (Agg-safe), imported inside the functions: the package
imports where matplotlib is missing, and its colormaps (``myReds`` ...
``myGreens_r``) are built on first access.  Tensors on any device come to
the host before drawing; ``SpotBrowser`` seeds and fits on its device
(the CUDA card unless ``device="cpu"``).  The interactive tools are
event-driven matplotlib classes whose every mutation is also a plain
method, so they run headless (tests, scripted curation) and
interactively (notebooks) from the same code path.
"""

from . import color
from .color import (transparent_cmap, black_gradient, transparent_gradient,
                    normalize_color)
from .interactive import SpotBrowser, BoundaryMarker
from .plots import (plot_distance_map, plot_boundaries, plot_projection,
                    plot_decode_stats, plot_spot_overlay,
                    plot_segmentation_labels, plot_cell_spot_counts,
                    plot_boundary_probability,
                    plot_genome_wide_distance_map,
                    remove_cap, extract_spot_crops, plot_spot_crops)
from .render3d import (normalize_center_spots,
                       chromosome_structure_3d_rendering,
                       visualize_chromosome_3d_cloud, spots_to_density)

_COLORMAPS = ("myReds", "myBlues", "myGreens",
              "myReds_r", "myBlues_r", "myGreens_r")

__all__ = ["plot_distance_map", "plot_boundaries", "plot_projection",
           "plot_decode_stats", "plot_spot_overlay",
           "plot_segmentation_labels", "plot_cell_spot_counts",
           "plot_boundary_probability", "plot_genome_wide_distance_map",
           "remove_cap", "extract_spot_crops", "plot_spot_crops",
           "normalize_center_spots", "chromosome_structure_3d_rendering",
           "visualize_chromosome_3d_cloud", "spots_to_density",
           "SpotBrowser", "BoundaryMarker", *_COLORMAPS,
           "transparent_cmap", "black_gradient", "transparent_gradient",
           "normalize_color"]


def __getattr__(name):
    """The colormaps, built by ``color`` on first access."""
    if name in _COLORMAPS:
        return getattr(color, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
