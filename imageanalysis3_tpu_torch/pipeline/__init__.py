"""Pipeline orchestration: per-FOV round processing."""

from .fov import FovPipeline, RoundResult

__all__ = ["FovPipeline", "RoundResult"]
