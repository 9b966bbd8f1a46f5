"""Graph kernels of the port (scikit-learn-style fit/transform)."""

from .base import Kernel
from .histogram import VertexHistogram, EdgeHistogram
from .pyramid_match import PyramidMatch
from .weisfeiler_lehman import WeisfeilerLehman

__all__ = [
    "Kernel",
    "VertexHistogram",
    "EdgeHistogram",
    "PyramidMatch",
    "WeisfeilerLehman",
]
