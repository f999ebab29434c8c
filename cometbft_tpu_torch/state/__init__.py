"""Copy of `cometbft_tpu/state/__init__.py` in the port."""

from .state import State  # noqa: F401
from .execution import BlockExecutor  # noqa: F401
