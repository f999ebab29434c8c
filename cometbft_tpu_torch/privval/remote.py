"""Remote signer: consensus signing over a socket
(reference privval/signer_client.go, signer_listener_endpoint.go,
signer_server.go — the HSM/isolated-key deployment shape).

The SIGNER process owns the key and DIALS the validator node (the
reference's listener/dialer split where the node listens); the node's
`SignerClient` satisfies the PrivValidator protocol, so ConsensusState
cannot tell it from a FilePV. The double-sign guard lives with the key,
in the signer process.

Wire: uvarint length || u8 method || JSON body over a SecretConnection
(authenticated encryption, same stack as p2p).

Copy of `cometbft_tpu/privval/remote.py` in the port, over the port's
`p2p/conn.SecretConnection` (the same wire, so a port `SignerClient`
serves a JAX-package `SignerServer` and the reverse). What differs:
`SignerServer.stop()` shuts its connection down and joins its thread,
and `SignerClient.close()` shuts the link down before closing it (a
close alone does not wake a blocked read).
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Optional

from ..crypto.keys import Ed25519PrivKey, Ed25519PubKey
from ..p2p.conn import SecretConnection
from ..types.block import BlockID, PartSetHeader
from ..types.proto import Timestamp
from ..types.vote import Proposal, Vote, PRECOMMIT_TYPE
from .file import DoubleSignError, FilePV

_M_PUBKEY = 1
_M_SIGN_VOTE = 2
_M_SIGN_PROPOSAL = 3
_M_PING = 4


def _send(sc: SecretConnection, method: int, body: dict) -> None:
    sc.send_message(bytes([method]) + json.dumps(body).encode())


def _recv(sc: SecretConnection):
    raw = sc.recv_message()
    return raw[0], json.loads(raw[1:] or b"{}")


def _vote_to_json(v: Vote) -> dict:
    return {"type": v.type_, "height": v.height, "round": v.round,
            "bid_hash": v.block_id.hash.hex(),
            "bid_total": v.block_id.parts.total,
            "bid_parts": v.block_id.parts.hash.hex(),
            "ts": [v.timestamp.seconds, v.timestamp.nanos],
            "val_addr": v.validator_address.hex(),
            "val_idx": v.validator_index,
            "extension": v.extension.hex()}


def _vote_from_json(d: dict) -> Vote:
    return Vote(type_=d["type"], height=d["height"], round=d["round"],
                block_id=BlockID(bytes.fromhex(d["bid_hash"]),
                                 PartSetHeader(d["bid_total"],
                                               bytes.fromhex(d["bid_parts"]))),
                timestamp=Timestamp(*d["ts"]),
                validator_address=bytes.fromhex(d["val_addr"]),
                validator_index=d["val_idx"],
                extension=bytes.fromhex(d.get("extension", "")))


def _proposal_to_json(p: Proposal) -> dict:
    return {"height": p.height, "round": p.round,
            "pol_round": p.pol_round,
            "bid_hash": p.block_id.hash.hex(),
            "bid_total": p.block_id.parts.total,
            "bid_parts": p.block_id.parts.hash.hex(),
            "ts": [p.timestamp.seconds, p.timestamp.nanos]}


def _proposal_from_json(d: dict) -> Proposal:
    return Proposal(height=d["height"], round=d["round"],
                    pol_round=d["pol_round"],
                    block_id=BlockID(
                        bytes.fromhex(d["bid_hash"]),
                        PartSetHeader(d["bid_total"],
                                      bytes.fromhex(d["bid_parts"]))),
                    timestamp=Timestamp(*d["ts"]))


class SignerServer:
    """Runs beside the key: wraps a FilePV, dials the node, serves
    signing requests (reference privval/signer_server.go)."""

    def __init__(self, pv: FilePV, host: str, port: int,
                 conn_key: Optional[Ed25519PrivKey] = None):
        self.pv = pv
        self._addr = (host, port)
        self._conn_key = conn_key or Ed25519PrivKey.generate()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._raw: Optional[socket.socket] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._serve,
                                        name="signer-server", daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        try:
            raw = socket.create_connection(self._addr, timeout=10)
        except OSError:
            return
        self._raw = raw
        if self._stop.is_set():
            raw.close()
            return
        # the connect timeout must not persist: idle gaps between sign
        # requests are normal and a recv timeout here kills the signer
        raw.settimeout(None)
        try:
            sc = SecretConnection(raw, self._conn_key)
        except (ConnectionError, OSError):
            raw.close()
            return
        try:
            self._serve_requests(sc)
        finally:
            sc.close()

    def _serve_requests(self, sc: SecretConnection) -> None:
        while not self._stop.is_set():
            try:
                method, body = _recv(sc)
            except (ConnectionError, OSError):
                return
            if method == _M_PUBKEY:
                _send(sc, method,
                      {"pub_key": self.pv.get_pub_key().bytes_().hex()})
            elif method == _M_SIGN_VOTE:
                vote = _vote_from_json(body["vote"])
                try:
                    self.pv.sign_vote(
                        body["chain_id"], vote,
                        sign_extension=body.get("sign_extension", False))
                    _send(sc, method, {
                        "sig": vote.signature.hex(),
                        "ext_sig": vote.extension_signature.hex()})
                except DoubleSignError as e:
                    _send(sc, method, {"error": str(e)})
            elif method == _M_SIGN_PROPOSAL:
                prop = _proposal_from_json(body["proposal"])
                try:
                    self.pv.sign_proposal(body["chain_id"], prop)
                    _send(sc, method, {"sig": prop.signature.hex()})
                except DoubleSignError as e:
                    _send(sc, method, {"error": str(e)})
            elif method == _M_PING:
                _send(sc, method, {})

    def stop(self) -> None:
        """Ends the link and joins the serving thread."""
        self._stop.set()
        if self._raw is not None:
            try:
                self._raw.shutdown(socket.SHUT_RDWR)  # wakes its recv
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10)


class SignerClient:
    """PrivValidator over the socket (reference privval/signer_client.go
    + the node-side listener endpoint): listens for the signer dialing
    in, then forwards sign requests."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 conn_key: Optional[Ed25519PrivKey] = None,
                 accept_timeout: float = 30.0):
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(1)
        self.addr = self._listener.getsockname()
        self._conn_key = conn_key or Ed25519PrivKey.generate()
        self._accept_timeout = accept_timeout
        self._sc: Optional[SecretConnection] = None
        self._lock = threading.Lock()

    def _conn(self) -> SecretConnection:
        if self._sc is None:
            self._listener.settimeout(self._accept_timeout)
            raw, _ = self._listener.accept()
            self._sc = SecretConnection(raw, self._conn_key)
        return self._sc

    def _call(self, method: int, body: dict) -> dict:
        with self._lock:
            sc = self._conn()
            _send(sc, method, body)
            got, resp = _recv(sc)
            if got != method:
                raise ConnectionError("out-of-order signer response")
            return resp

    # --- PrivValidator --------------------------------------------------------

    def get_pub_key(self) -> Ed25519PubKey:
        return Ed25519PubKey(
            bytes.fromhex(self._call(_M_PUBKEY, {})["pub_key"]))

    def sign_vote(self, chain_id: str, vote: Vote,
                  sign_extension: bool = False) -> None:
        resp = self._call(_M_SIGN_VOTE, {
            "chain_id": chain_id, "vote": _vote_to_json(vote),
            "sign_extension": sign_extension})
        if "error" in resp:
            raise DoubleSignError(resp["error"])
        vote.signature = bytes.fromhex(resp["sig"])
        vote.extension_signature = bytes.fromhex(resp.get("ext_sig", ""))
        if sign_extension and vote.type_ == PRECOMMIT_TYPE and \
                not vote.block_id.is_nil() and not vote.extension_signature:
            # an extension-unsigned precommit would be silently rejected
            # by every peer — surface the signer misconfiguration here
            raise ConnectionError(
                "signer did not return an extension signature")

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        resp = self._call(_M_SIGN_PROPOSAL, {
            "chain_id": chain_id,
            "proposal": _proposal_to_json(proposal)})
        if "error" in resp:
            raise DoubleSignError(resp["error"])
        proposal.signature = bytes.fromhex(resp["sig"])

    def close(self) -> None:
        if self._sc is not None:
            try:
                self._sc._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sc.close()
        self._listener.close()
