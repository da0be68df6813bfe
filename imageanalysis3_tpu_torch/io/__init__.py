"""File formats of the package: correction profiles so far."""

from .profiles_io import load_correction_profile, save_correction_profile

__all__ = ["load_correction_profile", "save_correction_profile"]
