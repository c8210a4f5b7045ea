"""Core ops: colorspace, DCT, ranking, modulation."""

from . import colorspace, dct, modulation, ranking

__all__ = ["colorspace", "dct", "modulation", "ranking"]
