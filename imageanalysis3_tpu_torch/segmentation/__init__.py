"""Segmentation: DAPI nuclei labelling and label screens, chromosome
candidates inside nuclei, and the learned segmenters -- a 3D UNet with
cellpose-style flow dynamics and training (``learned``) and cellpose's
CPnet (the submodule ``cellpose_net``)."""

from .nuclei import (shape_ratio, screen_labels, split_oversized_nuclei,
                     otsu_threshold, segment_nuclei, segment_cells,
                     propagate_labels, label_sizes, merge_z_layer_masks,
                     interpolate_z_masks)
from .chromosome import (find_candidate_chromosomes,
                         assign_seeds_to_nuclei,
                         select_candidate_chromosomes)
from .learned import (init_unet_params, unet_apply, masks_from_flows,
                      follow_flows, labels_to_flows, fit_unet,
                      segment_cells_learned, segment_fov_learned,
                      save_weights, load_weights)

__all__ = ["shape_ratio", "screen_labels", "split_oversized_nuclei",
           "otsu_threshold", "segment_nuclei", "segment_cells",
           "propagate_labels", "label_sizes", "merge_z_layer_masks",
           "interpolate_z_masks", "find_candidate_chromosomes",
           "assign_seeds_to_nuclei", "select_candidate_chromosomes",
           "init_unet_params", "unet_apply",
           "masks_from_flows", "follow_flows", "labels_to_flows",
           "fit_unet", "segment_cells_learned", "segment_fov_learned",
           "save_weights",
           "load_weights"]
