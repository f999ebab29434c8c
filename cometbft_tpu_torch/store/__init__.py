"""Copy of `cometbft_tpu/store/__init__.py` in the port."""

from .blockstore import BlockStore  # noqa: F401
