"""Host-side I/O: .dax movies (NumPy on the host, a native fused loader),
experiment metadata, the per-FOV result store (h5py or NumPy files),
spot tables (column mappings, saved as h5py or NumPy files), crops,
microscope geometry and correction profiles."""

from .color_usage import (ColorUsage, find_hyb_folders, load_chip_data,
                          load_color_usage, load_encoding_scheme,
                          load_gene_info, load_region_positions,
                          load_rna_info, match_enhancers_to_dna,
                          match_gene_to_dna, match_peaks_to_regions,
                          match_rna_to_dna)
from .crop import ImageCrop3D, generate_neighboring_crop
from .dax import (DaxMetadata, RawFrameWindow, channel_start_frames,
                  get_num_frames_and_colors, interleave_channels,
                  raw_frame_window, read_channel_crops, read_dax,
                  read_dax_window, read_inf, read_raw_window,
                  remove_dax_channels, resample_window, split_channels,
                  write_dax)
from .microscope import (load_position_file, microscope_correct_image,
                         microscope_translate_spots, read_microscope_json)
from .native_loader import (load_dax_channels, native_loader_available,
                            split_channels_native)
from .profiles_io import load_correction_profile, save_correction_profile
from .spots import (PIXEL_COLUMNS, SPOT3D_COLUMNS, dataframe_to_cand_spots,
                    dataframe_to_spot_groups, load_dataframe_hdf5,
                    load_table_hdf5, save_dataframe_hdf5, save_table_hdf5,
                    spaligner_to_chr_homologs, spot_groups_to_dataframe,
                    spot_groups_to_table, spots_to_dataframe, spots_to_table,
                    table_to_cand_spots, table_to_spot_groups)
from .store import (FLAG_CORRECTED, FLAG_EMPTY, FLAG_RAW, AsyncFovWriter,
                    FovStore, store_backend)

__all__ = [
    "DaxMetadata", "read_inf", "read_dax", "write_dax", "split_channels",
    "interleave_channels", "get_num_frames_and_colors",
    "channel_start_frames", "RawFrameWindow", "raw_frame_window",
    "read_raw_window", "read_dax_window", "read_channel_crops",
    "resample_window", "remove_dax_channels", "load_dax_channels",
    "split_channels_native", "native_loader_available",
    "ColorUsage", "load_color_usage", "find_hyb_folders",
    "load_encoding_scheme", "load_region_positions",
    "load_rna_info", "load_gene_info", "load_chip_data",
    "match_peaks_to_regions", "match_rna_to_dna", "match_gene_to_dna",
    "match_enhancers_to_dna",
    "FovStore", "AsyncFovWriter", "FLAG_EMPTY", "FLAG_RAW",
    "FLAG_CORRECTED", "store_backend",
    "ImageCrop3D", "generate_neighboring_crop",
    "load_correction_profile", "save_correction_profile",
    "read_microscope_json", "microscope_correct_image", "load_position_file",
    "microscope_translate_spots",
    "SPOT3D_COLUMNS", "PIXEL_COLUMNS", "spots_to_table",
    "table_to_cand_spots", "spot_groups_to_table", "table_to_spot_groups",
    "save_table_hdf5", "load_table_hdf5",
    "spots_to_dataframe", "dataframe_to_cand_spots",
    "spot_groups_to_dataframe", "dataframe_to_spot_groups",
    "save_dataframe_hdf5", "load_dataframe_hdf5",
    "spaligner_to_chr_homologs",
]
