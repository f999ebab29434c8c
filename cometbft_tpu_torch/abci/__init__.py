"""Copy of `cometbft_tpu/abci/__init__.py` in the port."""

from .application import (  # noqa: F401
    Application, BaseApplication, RequestFinalizeBlock, ResponseFinalizeBlock,
    ExecTxResult, ValidatorUpdate, CheckTxResult, ResponseInfo,
    ResponseCommit, CODE_TYPE_OK,
)
from .kvstore import KVStoreApplication  # noqa: F401
