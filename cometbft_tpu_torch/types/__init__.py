"""Copy of `cometbft_tpu/types/__init__.py` in the port."""

from .block import (  # noqa: F401
    BlockID, PartSetHeader, CommitSig, Commit, Header, Block, Data,
    BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL,
)
from .vote import Vote, PREVOTE_TYPE, PRECOMMIT_TYPE, PROPOSAL_TYPE  # noqa: F401
from .validator import Validator, ValidatorSet  # noqa: F401
from .proto import Timestamp  # noqa: F401
