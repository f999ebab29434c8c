"""The JSON-RPC client's error (reference rpc/client/http/http.go), which
the light client's HTTP provider catches.

From `cometbft_tpu/rpc/client.py`; its `RPCClient` is not ported yet
(ROADMAP.md Queue 1: the host-only layers). The HTTP provider takes any
object with that class's `commit(height)` and `call(method, **params)`.
"""


class RPCClientError(Exception):
    pass
