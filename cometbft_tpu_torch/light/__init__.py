"""The light client (port of `cometbft_tpu/light/`; the verifying RPC
proxy, `light/rpc.py`, is not ported yet: ROADMAP.md Queue 1, the
host-only layers)."""

from .client import LightClient, TrustOptions, LightClientError
from .types import LightBlock, SignedHeader
from .store import LightStore
from .provider import Provider, BlockStoreProvider

__all__ = ["LightClient", "TrustOptions", "LightClientError", "LightBlock",
           "SignedHeader", "LightStore", "Provider", "BlockStoreProvider"]
