"""Copy of `cometbft_tpu/node/__init__.py` in the port."""

from .node import Node, load_genesis, save_genesis

__all__ = ["Node", "load_genesis", "save_genesis"]
