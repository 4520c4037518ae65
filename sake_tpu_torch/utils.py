"""Small numerics utilities."""

from __future__ import annotations


def coloring(x, mean, std):
    """De-standardize predictions: ``std * x + mean``."""
    return std * x + mean
