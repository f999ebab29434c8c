"""JSON-RPC: the server and its routes, the HTTP client and the JSON
codecs (copy of `cometbft_tpu/rpc/` in the port). `rpc/websocket.py`
and `rpc/grpc.py` are not ported yet (ROADMAP.md Queue 1 item 11.2)."""

from .server import RPCServer, RPCEnvironment
from .client import RPCClient

__all__ = ["RPCServer", "RPCEnvironment", "RPCClient"]
