"""JSON-RPC HTTP client (reference rpc/client/http/http.go).

Copy of `cometbft_tpu/rpc/client.py` in the port."""

from __future__ import annotations

import json
import urllib.request
from typing import Any, Dict, Optional


class RPCClientError(Exception):
    pass


class RPCClient:
    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._url = f"http://{host}:{port}/"
        self._timeout = timeout
        self._next_id = 0

    def call(self, method: str, **params) -> Any:
        self._next_id += 1
        body = json.dumps({"jsonrpc": "2.0", "id": self._next_id,
                           "method": method, "params": params}).encode()
        req = urllib.request.Request(
            self._url, data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self._timeout) as resp:
            out = json.loads(resp.read())
        if "error" in out and out["error"]:
            raise RPCClientError(
                f"{out['error'].get('code')}: {out['error'].get('message')}")
        return out.get("result")

    # conveniences mirroring rpc/client/http
    def status(self) -> Dict:
        return self.call("status")

    def block(self, height: Optional[int] = None) -> Dict:
        return self.call("block", **({"height": height}
                                     if height is not None else {}))

    def broadcast_tx_sync(self, tx: bytes) -> Dict:
        return self.call("broadcast_tx_sync", tx=tx.hex())

    def commit(self, height: Optional[int] = None) -> Dict:
        return self.call("commit", **(
            {} if height is None else {"height": height}))

    def header(self, height: Optional[int] = None) -> Dict:
        return self.call("header", **(
            {} if height is None else {"height": height}))

    def abci_query_prove(self, path: str, data: bytes) -> Dict:
        return self.call("abci_query", path=path, data=data.hex(),
                         prove=True)

    def abci_query(self, path: str, data: bytes) -> Dict:
        return self.call("abci_query", path=path, data=data.hex())

    def validators(self, height: Optional[int] = None) -> Dict:
        return self.call("validators", **({"height": height}
                                          if height is not None else {}))

    def tx_search(self, query: str, limit: int = 100) -> Dict:
        # per_page must track limit: the route paginates at 30 by
        # default, which would silently truncate a limit=100 caller
        return self.call("tx_search", query=query, limit=limit,
                         per_page=min(int(limit or 30), 100))
