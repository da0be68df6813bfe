"""File formats of the package: .dax movies (NumPy on the host, a native
fused loader) and correction profiles."""

from .dax import (DaxMetadata, RawFrameWindow, channel_start_frames,
                  get_num_frames_and_colors, interleave_channels,
                  raw_frame_window, read_channel_crops, read_dax,
                  read_dax_window, read_inf, read_raw_window,
                  remove_dax_channels, resample_window, split_channels,
                  write_dax)
from .native_loader import (load_dax_channels, native_loader_available,
                            split_channels_native)
from .profiles_io import load_correction_profile, save_correction_profile

__all__ = [
    "DaxMetadata", "read_inf", "read_dax", "write_dax", "split_channels",
    "interleave_channels", "get_num_frames_and_colors",
    "channel_start_frames", "RawFrameWindow", "raw_frame_window",
    "read_raw_window", "read_dax_window", "read_channel_crops",
    "resample_window", "remove_dax_channels", "load_dax_channels",
    "split_channels_native", "native_loader_available",
    "load_correction_profile", "save_correction_profile",
]
