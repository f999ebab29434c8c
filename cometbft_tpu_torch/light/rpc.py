"""Light RPC proxy: a JSON-RPC endpoint whose answers are verified
against light-client-checked headers before being returned (reference
light/rpc/client.go Client + light/proxy/proxy.go Proxy).

The verifying client forwards reads to a full node and proves them:
- `abci_query` demands a merkle proof and checks it against the
  light-verified app hash (header at query-height+1 — the app hash in a
  header is the result of executing the PREVIOUS block, reference
  light/rpc/client.go ABCIQueryWithOptions);
- `block` / `commit` / `header` check the primary's bytes hash to the
  light-verified header for that height;
- `validators` must hash to the verified header's validators_hash.

The proof leaf contract for `abci_query` is the injective
`0x01 || len(key)_u32be || key || value` form of
`KVStoreApplication.kv_leaf`; apps with provable state expose the same
shape (the reference's analog is its registered merkle ProofRuntime op
set).

Copy of `cometbft_tpu/light/rpc.py` in the port. What differs:
- the light client inside runs on the caller's device (`LightClient(...,
  device=)`, default cuda), and the `commit` route's signature check
  runs on it too;
- that check's catch is narrowed to the commit's own faults
  (`CommitVerificationError`, `ValueError`); the JAX package turns any
  exception into `VerificationFailed`, which would hide a kernel fault;
- `LightProxy` answers a read whose error is not the primary's or a
  witness's fault (`PEER_ERRORS`, a transport error, a malformed answer)
  with -32603 as before, and keeps it in `LightProxy.fatal`: the `light`
  command then stops and exits 1;
- `build_light_proxy` is the `light` command's construction (trust root,
  providers, client, proxy), shared by the command and `chip_smoke.py`.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..crypto.merkle import AbsenceProof
from ..rpc.client import RPCClient, RPCClientError
from ..rpc.codec import (commit_from_json, header_from_json,
                         proof_from_json, validator_set_from_json)
from ..rpc.server import RPCError, RPCServer
from ..types.validation import CommitVerificationError
from . import PEER_ERRORS as LIGHT_PEER_ERRORS
from .client import LightClient


class VerificationFailed(Exception):
    pass


# what the primary or a witness can cause: a refused answer, the light
# client refusing a header, an error answer
PEER_ERRORS = ((VerificationFailed,) + LIGHT_PEER_ERRORS +
               (RPCClientError,))


class VerifyingClient:
    """reference light/rpc/client.go Client."""

    def __init__(self, light: LightClient, primary: RPCClient):
        self.light = light
        self.primary = primary

    # --- verified reads -------------------------------------------------------

    def abci_query(self, path: str, data: bytes) -> Dict:
        r = self.primary.abci_query_prove(path, data)
        if r.get("code", 0) != 0:
            return r
        value = bytes.fromhex(r.get("value", ""))
        height = int(r.get("height", 0))
        try:
            proof = proof_from_json(r.get("proof"))
        except (ValueError, KeyError, TypeError) as e:
            raise VerificationFailed(f"malformed proof: {e}")
        if proof is None or height <= 0:
            # a proofless empty value is the key-hiding attack the
            # reference rejects via VerifyAbsence (light/rpc/client.go:
            # 149,182) — never pass it through as a normal OK result
            raise VerificationFailed(
                "primary returned no proof"
                + (" (unverified absence)" if not value else ""))
        lb = self.light.verify_light_block_at_height(height + 1)
        from ..abci.kvstore import KVStoreApplication
        if not value:
            self._verify_absence(proof, lb.header.app_hash, data, height)
            return r
        if isinstance(proof, AbsenceProof):
            raise VerificationFailed(
                "primary sent an absence proof with a non-empty value")
        leaf = KVStoreApplication.kv_leaf(data, value)
        if not proof.verify(lb.header.app_hash, leaf):
            raise VerificationFailed(
                f"query proof does not match app hash at {height + 1}")
        return r

    @staticmethod
    def _verify_absence(proof, app_hash: bytes, data: bytes,
                        height: int) -> None:
        """Check an AbsenceProof really brackets `data`: both neighbors
        are adjacent leaves of the verified tree, the left one sorts
        before the key (or is the index-0 height sentinel for the
        proven height), the right one after it (or the left neighbor is
        the final leaf). Reference analog: light/rpc/client.go:182
        VerifyAbsence over the registered proof runtime."""
        from ..abci.kvstore import KVStoreApplication
        if not isinstance(proof, AbsenceProof):
            raise VerificationFailed(
                "empty value requires an absence proof")
        if not proof.verify_adjacent(app_hash):
            raise VerificationFailed(
                "absence proof neighbors not adjacent in verified tree")
        left_kv = KVStoreApplication.parse_kv_leaf(proof.left_leaf)
        if proof.left.index == 0:
            sentinel = b"\x00" + height.to_bytes(8, "big")
            if proof.left_leaf != sentinel:
                raise VerificationFailed(
                    "absence proof left sentinel is not the height leaf")
        elif left_kv is None or left_kv[0] >= data:
            raise VerificationFailed(
                "absence proof left neighbor does not sort before key")
        if proof.right is not None:
            right_kv = KVStoreApplication.parse_kv_leaf(proof.right_leaf)
            if right_kv is None or right_kv[0] <= data:
                raise VerificationFailed(
                    "absence proof right neighbor does not sort after key")

    def block(self, height: Optional[int] = None) -> Dict:
        r = self.primary.block(height)
        hdr = header_from_json(r["block"]["header"])
        lb = self.light.verify_light_block_at_height(hdr.height)
        if hdr.hash() != lb.header.hash():
            raise VerificationFailed(
                f"primary block header at {hdr.height} does not match "
                f"verified header")
        if bytes.fromhex(r["block_id"]["hash"]) != lb.header.hash():
            raise VerificationFailed("primary block_id mismatch")
        # the header hash only pins the header; the tx list must hash to
        # its data_hash or the primary can attach forged transactions
        from ..types.block import Data
        txs = [bytes.fromhex(t) for t in r["block"]["data"]["txs"]]
        if Data(txs).hash() != lb.header.data_hash:
            raise VerificationFailed(
                "primary block txs do not hash to the verified data_hash")
        return r

    def header(self, height: Optional[int] = None) -> Dict:
        r = self.primary.header(height)
        hdr = header_from_json(r["header"])
        lb = self.light.verify_light_block_at_height(hdr.height)
        if hdr.hash() != lb.header.hash():
            raise VerificationFailed("header mismatch")
        return r

    def commit(self, height: Optional[int] = None) -> Dict:
        r = self.primary.commit(height)
        sh = r["signed_header"]
        hdr = header_from_json(sh["header"])
        commit = commit_from_json(sh["commit"])
        lb = self.light.verify_light_block_at_height(hdr.height)
        if hdr.hash() != lb.header.hash():
            raise VerificationFailed("commit header mismatch")
        if commit.block_id.hash != lb.header.hash():
            raise VerificationFailed("commit is for a different block")
        # a consumer uses this as a signed-header source, so the
        # signatures themselves must carry 2/3 of the verified set —
        # block-id equality alone would relay forged signature lists
        from ..types import validation
        try:
            validation.verify_commit_light(
                self.light.chain_id, lb.validator_set, commit.block_id,
                hdr.height, commit, device=self.light.device)
        except (CommitVerificationError, ValueError) as e:
            raise VerificationFailed(f"commit signatures invalid: {e}")
        return r

    def validators(self, height: Optional[int] = None) -> Dict:
        # page through (bounded, height-pinned): the hash check below
        # needs the FULL set at ONE height
        from .provider import fetch_all_validators
        r = fetch_all_validators(self.primary, height=height)
        vals = validator_set_from_json(r)
        h = int(r.get("block_height", 0))
        if h <= 0:
            raise VerificationFailed("primary omitted block_height")
        lb = self.light.verify_light_block_at_height(h)
        if vals.hash() != lb.header.validators_hash:
            raise VerificationFailed(
                "primary validators do not hash to verified header")
        return r

    # --- passthroughs (unverifiable by nature) -------------------------------

    def status(self) -> Dict:
        return self.primary.status()

    def broadcast_tx_sync(self, tx: bytes) -> Dict:
        return self.primary.broadcast_tx_sync(tx)


class LightProxy:
    """reference light/proxy/proxy.go: the verifying client served back
    out as a JSON-RPC endpoint (same server conventions as rpc/server)."""

    def __init__(self, client: VerifyingClient, host: str = "127.0.0.1",
                 port: int = 0):
        c = client
        self.client = client
        # the first error of a read that is not the peers' fault (a
        # kernel build, launch or canary fault), else None
        self.fatal: Optional[BaseException] = None
        proxy = self

        def _wrap(fn):
            def call(**kw):
                try:
                    return fn(**kw)
                except VerificationFailed as e:
                    raise RPCError(-32001, f"verification failed: {e}")
                except PEER_ERRORS + (OSError, KeyError, TypeError,
                                      ValueError):
                    raise
                except Exception as e:
                    if proxy.fatal is None:
                        proxy.fatal = e
                    raise
            return call

        methods = {
            "health": lambda: {},
            "status": _wrap(lambda: c.status()),
            "abci_query": _wrap(
                lambda path="", data="", prove=True:
                c.abci_query(path, bytes.fromhex(data))),
            "block": _wrap(
                lambda height=None: c.block(_h(height))),
            "header": _wrap(
                lambda height=None: c.header(_h(height))),
            "commit": _wrap(
                lambda height=None: c.commit(_h(height))),
            "validators": _wrap(
                lambda height=None: c.validators(_h(height))),
            "broadcast_tx_sync": _wrap(
                lambda tx="": c.broadcast_tx_sync(bytes.fromhex(tx))),
        }
        self._server = RPCServer(None, host, port, methods=methods)
        self.addr = self._server.addr

    def start(self) -> None:
        self._server.start()

    def stop(self) -> None:
        self._server.stop()


def _h(height) -> Optional[int]:
    return None if height is None else int(height)


def _rpc(addr: str) -> RPCClient:
    host, _, port = addr.rpartition(":")
    return RPCClient(host or "127.0.0.1", int(port))


def build_light_proxy(chain_id: str, primary: str, witnesses: List[str],
                      laddr: str = "127.0.0.1:0", trusted_height: int = 0,
                      trusted_hash: str = "",
                      trust_period: int = 168 * 3600,
                      device=None) -> LightProxy:
    """The `light` command's proxy, not started (reference
    cmd/cometbft/commands/light.go): a light client trusting
    `trusted_height`/`trusted_hash` (or, with no height, the primary's
    latest header: trust on first use, explicitly insecure) over the
    primary and witness RPC addresses ("host:port"), on `device`, behind
    a `VerifyingClient` served at `laddr`. Errors building the trust root
    propagate."""
    from ..db.kv import MemDB
    from .client import TrustOptions
    from .provider import HTTPProvider
    from .store import LightStore
    rpc = _rpc(primary)
    if trusted_height:
        t_height, t_hash = trusted_height, bytes.fromhex(trusted_hash)
    else:
        st = rpc.status()
        t_height = st["sync_info"]["latest_block_height"]
        t_hash = bytes.fromhex(st["sync_info"]["latest_block_hash"])
    light = LightClient(
        chain_id, TrustOptions(trust_period, t_height, t_hash),
        HTTPProvider(chain_id, rpc),
        [HTTPProvider(chain_id, _rpc(w)) for w in witnesses if w],
        LightStore(MemDB()), device=device)
    lhost, _, lport = laddr.rpartition(":")
    return LightProxy(VerifyingClient(light, rpc), lhost or "127.0.0.1",
                      int(lport or 0))
