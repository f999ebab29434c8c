"""Copy of `cometbft_tpu/privval/__init__.py` in the port."""

from .file import FilePV, DoubleSignError, PrivValidator

__all__ = ["FilePV", "DoubleSignError", "PrivValidator"]
