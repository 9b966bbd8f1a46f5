"""Synthetic dataset generation.  The TU-format loader arrives with the
port's ``datasets/base.py``."""

from .testing import generate_dataset

__all__ = ["generate_dataset"]
