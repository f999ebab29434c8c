"""The light client and its verifying RPC proxy (port of
`cometbft_tpu/light/`). `PEER_ERRORS` are the light layer's errors that
the rpc_servers (a primary or a witness) can cause; statesync's anchor
and the proxy treat only these as the peers' fault. The JAX package has
no such list: its callers catch every exception."""

from ..types.validation import CommitVerificationError
from .client import LightClient, TrustOptions, LightClientError
from .types import LightBlock, LightBlockError, SignedHeader
from .store import LightStore
from .provider import Provider, BlockStoreProvider, ProviderError
from .verifier import VerificationError

# a commit that does not verify at the trust root is CommitVerificationError
PEER_ERRORS = (LightClientError, ProviderError, VerificationError,
               LightBlockError, CommitVerificationError)

__all__ = ["LightClient", "TrustOptions", "LightClientError", "LightBlock",
           "SignedHeader", "LightStore", "Provider", "BlockStoreProvider"]
