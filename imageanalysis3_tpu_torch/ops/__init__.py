"""Numerical ops on tensors; six of them carry hand-written CUDA kernels
(``seed_kernels``: seed_pyramid, seed_classify, dual_blur, level_stencil;
``lm_kernel``: lm_fit; ``gather_kernel``: gather_cubes, whose cube and ball
entries count as its launches) beside their plain PyTorch versions."""

from . import gather_kernel, lm_kernel, seed_kernels
from .cell_fitting import (fit_spots_around_centers,
                           fit_spots_by_segmentation, fit_spots_in_crops,
                           segmentation_bounding_boxes)
from .corrections import (bleedthrough_unmix, correct_channel_stack,
                          deinterleave_stack, illumination_correct,
                          remove_hot_pixels, z_shift_correct)
from .drift import (align_image, consensus_drift, fft3d_from2d,
                    generate_drift_crops, prepare_ref_spectrum,
                    subpixel_phase_correlation,
                    subpixel_phase_correlation_prepared)
from .filters import (counting_median, gaussian_deconvolution,
                      gaussian_filter, gaussian_highpass, maximum_filter,
                      minimum_filter)
from .gaussian_fit import (FitResult, find_image_background, fit_fov_image,
                           get_centers, gfit_fast, iter_fit_seed_points,
                           select_sparse_centers)
from .matching import (accumulate_sequential_drifts, align_beads,
                       align_manual_points, check_paired_centers,
                       find_paired_centers, fit_matched_centers,
                       generate_recombined_spots, rigid_transform_from_points,
                       select_matched_spots, translate_spot_coordinates)
from .profiles import (IlluminationProfiler, counting_quantile,
                       fit_spot_pair_regressions, generate_bleed_profile,
                       generate_chromatic_constants, invert_mixing_profile)
from .seeding import Seeds, get_seeds
from .legacy_fit import (fit_multi_gaussian, fit_seed_points_base,
                         fitsinglegaussian_fixed_width, get_seed_points_base,
                         get_STD_centers)
from .warp import (fit_chromatic_constants, trilinear_map_coordinates,
                   warp_image, warp_image_drift, warp_spot_coords)

__all__ = [
    "remove_hot_pixels", "z_shift_correct", "illumination_correct",
    "bleedthrough_unmix", "correct_channel_stack", "deinterleave_stack",
    "subpixel_phase_correlation", "generate_drift_crops",
    "consensus_drift", "align_image", "fft3d_from2d",
    "prepare_ref_spectrum", "subpixel_phase_correlation_prepared",
    "gaussian_filter", "maximum_filter", "minimum_filter",
    "gaussian_highpass", "gaussian_deconvolution", "counting_median",
    "iter_fit_seed_points", "fit_fov_image", "get_centers",
    "select_sparse_centers", "find_image_background", "FitResult",
    "gfit_fast", "find_paired_centers", "check_paired_centers",
    "align_beads", "accumulate_sequential_drifts",
    "rigid_transform_from_points", "align_manual_points",
    "translate_spot_coordinates", "select_matched_spots",
    "generate_recombined_spots", "fit_matched_centers",
    "IlluminationProfiler", "generate_bleed_profile",
    "generate_chromatic_constants", "counting_quantile",
    "fit_spot_pair_regressions", "invert_mixing_profile", "get_seeds",
    "Seeds", "get_seed_points_base", "fitsinglegaussian_fixed_width",
    "fit_seed_points_base", "get_STD_centers", "fit_multi_gaussian",
    "warp_image", "warp_image_drift", "warp_spot_coords",
    "fit_chromatic_constants", "trilinear_map_coordinates",
    "kernel_launches", "reset_kernel_launches",
    "segmentation_bounding_boxes", "fit_spots_in_crops",
    "fit_spots_by_segmentation", "fit_spots_around_centers",
]


def kernel_launches() -> dict:
    """Launch count of each CUDA kernel since the last reset."""
    return {**seed_kernels.launches, "lm_fit": lm_kernel.launches,
            "gather_cubes": gather_kernel.launches}


def reset_kernel_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in seed_kernels.launches:
        seed_kernels.launches[name] = 0
    lm_kernel.launches = 0
    gather_kernel.launches = 0
