"""In-process key-value example application (reference
abci/example/kvstore/kvstore.go) — the standard fake backend for engine
tests and benchmarks.

Tx formats:
  "key=value"                   store a pair
  "val:<pubkey_hex>!<power>"    validator power update

Copy of `cometbft_tpu/abci/kvstore.py` (the port keeps its own).
"""

from __future__ import annotations

import hashlib
import json
from typing import List, Optional, Tuple

from ..crypto import merkle
from .application import (
    BaseApplication, CheckTxResult, ExecTxResult, RequestFinalizeBlock,
    ResponseCommit, ResponseFinalizeBlock, ResponseInfo, Snapshot,
    ValidatorUpdate, CODE_TYPE_OK,
)

CODE_TYPE_INVALID_FORMAT = 1

VALIDATOR_PREFIX = b"val:"


class KVStoreApplication(BaseApplication):
    def __init__(self):
        self.state: dict = {}
        self.pending_updates: List[ValidatorUpdate] = []
        self.last_height = 0
        self.last_app_hash = b""
        self.staged: dict | None = None
        # previous committed snapshot: the newest state whose app hash
        # already appears in a STORED header (state at H-1 hashes into
        # header H; the tip state's hash only lands in header H+1) —
        # what provable queries are answered from. One attribute so a
        # reader on the RPC thread can't tear (state, height) apart
        # while commit() swaps them on the consensus thread.
        self._prev: tuple | None = None
        # height -> captured snapshot blob; replaced wholesale (never
        # mutated in place) so snapshot-connection readers see a
        # consistent dict without locks
        self._snapshot_blobs: dict = {}

    # --- helpers -------------------------------------------------------------

    @staticmethod
    def kv_leaf(key: bytes, value: bytes) -> bytes:
        """Injective leaf encoding: tag byte + length-prefixed key.
        (A `key || 0x00 || value` form would be forgeable — a key
        containing 0x00 lets a lying primary prove a different split of
        the same bytes as some other pair.)"""
        return b"\x01" + len(key).to_bytes(4, "big") + key + value

    @classmethod
    def _state_leaves(cls, state: dict, height: int) -> List[bytes]:
        """Leaf 0 (tag 0x00) commits the height; then one kv_leaf per
        sorted entry. The merkle root IS the app hash, so any key's
        presence (and value) is provable against a light-verified header
        — what the light RPC proxy's verified `abci_query` checks
        (reference light/rpc/client.go ABCIQueryWithOptions + proof ops;
        provable state is the app's contract there too)."""
        leaves = [b"\x00" + height.to_bytes(8, "big")]
        leaves.extend(cls.kv_leaf(k.encode(), state[k].encode())
                      for k in sorted(state))
        return leaves

    def _compute_app_hash(self, state: dict, height: int) -> bytes:
        return merkle.hash_from_byte_slices(
            self._state_leaves(state, height))

    @staticmethod
    def is_validator_tx(tx: bytes) -> bool:
        return tx.startswith(VALIDATOR_PREFIX)

    # --- mempool -------------------------------------------------------------

    @staticmethod
    def _unwrap(tx: bytes) -> bytes:
        """App-visible payload: signed-envelope txs (ingest/tx.py) shed
        their authentication header — the envelope is admission-layer
        concern, the app's tx grammar is unchanged. A malformed
        envelope surfaces as an invalid-format payload (the ingest
        pipeline rejects those before the app when enabled)."""
        from ..ingest.tx import MalformedTx, unwrap_payload
        try:
            return unwrap_payload(tx)
        except MalformedTx:
            return tx

    def check_tx(self, tx: bytes) -> CheckTxResult:
        tx = self._unwrap(tx)
        if self.is_validator_tx(tx):
            try:
                self._parse_validator_tx(tx)
                return CheckTxResult(code=CODE_TYPE_OK, gas_wanted=1)
            except ValueError as e:
                return CheckTxResult(code=CODE_TYPE_INVALID_FORMAT,
                                     log=str(e))
        if b"=" not in tx:
            return CheckTxResult(code=CODE_TYPE_INVALID_FORMAT,
                                 log="tx must be key=value")
        return CheckTxResult(code=CODE_TYPE_OK, gas_wanted=1)

    def _parse_validator_tx(self, tx: bytes) -> ValidatorUpdate:
        body = tx[len(VALIDATOR_PREFIX):].decode()
        if "!" not in body:
            raise ValueError(
                "val tx must be val:<pubkey_hex>!<power>[!<pop_hex>]")
        pk_hex, rest = body.split("!", 1)
        pop = b""
        if "!" in rest:
            power_s, pop_hex = rest.split("!", 1)
            pop = bytes.fromhex(pop_hex)
        else:
            power_s = rest
        pk = bytes.fromhex(pk_hex)
        if len(pk) == 32:
            if pop:
                raise ValueError("ed25519 keys take no proof of possession")
            return ValidatorUpdate("ed25519", pk, int(power_s))
        if len(pk) == 48:
            # compressed-G1 bls12_381 pubkey: a mid-chain BLS admission
            # MUST ship its PoP or aggregation is rogue-key-unsound
            # (genesis keys are admitted via GenesisDoc.bls_pops)
            if len(pop) != 96:
                raise ValueError(
                    "bls12_381 validator tx needs a 96-byte proof of "
                    "possession: val:<pk_hex>!<power>!<pop_hex>")
            return ValidatorUpdate("bls12_381", pk, int(power_s), pop)
        raise ValueError("pubkey must be 32 (ed25519) or 48 (bls) bytes")

    # --- consensus -----------------------------------------------------------

    def init_chain(self, chain_id, initial_height, validators,
                   app_state_bytes):
        if app_state_bytes:
            self.state = json.loads(app_state_bytes)
        return [], self._compute_app_hash(self.state, 0)

    def info(self) -> ResponseInfo:
        return ResponseInfo(data="kvstore-tpu", version="1",
                            last_block_height=self.last_height,
                            last_block_app_hash=self.last_app_hash)

    def process_proposal(self, txs, height) -> bool:
        return all(self.check_tx(tx).code == CODE_TYPE_OK for tx in txs)

    def finalize_block(self, req: RequestFinalizeBlock
                       ) -> ResponseFinalizeBlock:
        state = dict(self.state)
        results, updates = [], []
        for tx in req.txs:
            tx = self._unwrap(tx)
            if self.is_validator_tx(tx):
                try:
                    upd = self._parse_validator_tx(tx)
                except ValueError as e:
                    results.append(ExecTxResult(
                        code=CODE_TYPE_INVALID_FORMAT, log=str(e)))
                    continue
                updates.append(upd)
                results.append(ExecTxResult(data=tx))
            elif b"=" in tx:
                k, v = tx.split(b"=", 1)
                state[k.decode(errors="replace")] = v.decode(errors="replace")
                results.append(ExecTxResult(data=tx))
            else:
                results.append(ExecTxResult(code=CODE_TYPE_INVALID_FORMAT,
                                            log="tx must be key=value"))
        app_hash = self._compute_app_hash(state, req.height)
        self.staged = state
        self.last_height = req.height
        self.last_app_hash = app_hash
        self.pending_updates = updates
        return ResponseFinalizeBlock(tx_results=results,
                                     validator_updates=updates,
                                     app_hash=app_hash)

    @property
    def prev_state(self) -> dict | None:
        return self._prev[0] if self._prev else None

    @property
    def prev_height(self) -> int:
        return self._prev[1] if self._prev else 0

    def commit(self) -> ResponseCommit:
        if self.staged is not None:
            self._prev = (self.state, self.last_height - 1)
            self.state = self.staged
            self.staged = None
            if self.last_height % self.SNAPSHOT_INTERVAL == 0:
                # capture an interval snapshot (reference kvstore.go
                # snapshot_interval): advertising the live tip instead
                # would race the restorer's light anchor — header H+1
                # doesn't exist yet when the snapshot IS the tip, and
                # re-discovery would chase the tip forever.
                # Copy-on-write + single assignment: the snapshot
                # connection reads this dict from another thread (same
                # no-tear discipline as _prev above)
                blobs = dict(self._snapshot_blobs)
                blobs[self.last_height] = self._snapshot_blob()
                for h in sorted(blobs)[:-self.SNAPSHOT_KEEP]:
                    del blobs[h]
                self._snapshot_blobs = blobs
        return ResponseCommit(retain_height=0)

    def query(self, path: str, data: bytes) -> tuple[int, bytes]:
        if path == "/store" or path == "":
            v = self.state.get(data.decode(errors="replace"))
            return CODE_TYPE_OK, (v.encode() if v is not None else b"")
        return 1, b"unknown path"

    def query_prove(self, path: str, data: bytes
                    ) -> Tuple[int, bytes, int, Optional[merkle.Proof]]:
        """(code, value, height, inclusion proof) answered from the
        previous committed snapshot, whose app hash is already inside a
        stored header — the proof verifies against
        header(height+1).app_hash (the reference's light/rpc client
        checks query proofs at exactly that offset)."""
        # snapshot once: commit() on the consensus thread swaps the
        # snapshot concurrently with RPC-thread queries
        prev = self._prev
        prev_state, prev_height = prev if prev else (None, 0)
        if prev_state is None or path not in ("/store", ""):
            code, value = self.query(path, data)
            return code, value, self.last_height, None
        key = data.decode(errors="replace")
        v = prev_state.get(key)
        if v is None or key.encode() != data:
            # second clause: a lossily-decoded (invalid UTF-8) query can
            # alias a stored key; byte-level bracketing below still
            # proves `data` itself is absent from the leaf set
            return (CODE_TYPE_OK, b"", prev_height,
                    self._absence_proof(prev_state, prev_height, data))
        value = v.encode()
        leaves = self._state_leaves(prev_state, prev_height)
        idx = leaves.index(self.kv_leaf(data, value))
        _root, proofs = merkle.proofs_from_byte_slices(leaves)
        return CODE_TYPE_OK, value, prev_height, proofs[idx]

    @classmethod
    def _absence_proof(cls, state: dict, height: int, data: bytes
                       ) -> merkle.AbsenceProof:
        """Prove `data` is NOT a key: inclusion of the two adjacent
        leaves bracketing its sorted position. The height leaf at index
        0 is the left sentinel (every kv key sorts after it); a missing
        right neighbor is provable because Proof.total pins the tree
        size. UTF-8 preserves code-point order, so the str sort of
        `_state_leaves` and the byte-level bisect here agree."""
        import bisect
        ekeys = [k.encode() for k in sorted(state)]
        pos = bisect.bisect_left(ekeys, data)  # count of keys < data
        leaves = cls._state_leaves(state, height)
        _root, proofs = merkle.proofs_from_byte_slices(leaves)
        li = pos               # kv leaf j sits at tree index j+1
        ri = pos + 1 if pos < len(ekeys) else None
        return merkle.AbsenceProof(
            proofs[li], leaves[li],
            proofs[ri] if ri is not None else None,
            leaves[ri] if ri is not None else None)

    @staticmethod
    def parse_kv_leaf(leaf: bytes) -> Optional[Tuple[bytes, bytes]]:
        """(key, value) from a kv_leaf, or None if not one (e.g. the
        height sentinel leaf). Inverse of `kv_leaf` — used by verifying
        clients to check absence-proof neighbors bracket the query."""
        if len(leaf) < 5 or leaf[0] != 0x01:
            return None
        klen = int.from_bytes(leaf[1:5], "big")
        if len(leaf) < 5 + klen:
            return None
        return leaf[5:5 + klen], leaf[5 + klen:]

    # --- statesync snapshots (reference kvstore.go snapshot support) ---------

    SNAPSHOT_CHUNK_SIZE = 1 << 16
    SNAPSHOT_INTERVAL = 5   # capture every N commits (kvstore.go analog)
    SNAPSHOT_KEEP = 2       # retain the most recent K interval snapshots

    def _snapshot_blob(self) -> bytes:
        return json.dumps({"state": {k: self.state[k]
                                     for k in sorted(self.state)},
                           "height": self.last_height},
                          separators=(",", ":")).encode()

    def list_snapshots(self) -> List[Snapshot]:
        """The retained interval snapshots, blobs captured at commit
        time — chunks must stay byte-stable while later blocks commit,
        or the restorer's hash check fails. An app that has not crossed
        an interval yet serves nothing (the reference behaves the same
        before its first interval); writing a fallback capture HERE
        would mutate the dict from the snapshot-connection thread and
        re-introduce the advertise-the-live-tip anchor race commit()
        exists to avoid."""
        if self.last_height == 0:
            return []
        blobs = self._snapshot_blobs  # atomic ref: see commit()
        out = []
        for h in sorted(blobs, reverse=True):
            blob = blobs[h]
            n = max(1, (len(blob) + self.SNAPSHOT_CHUNK_SIZE - 1)
                    // self.SNAPSHOT_CHUNK_SIZE)
            out.append(Snapshot(height=h, format=1, chunks=n,
                                hash=hashlib.sha256(blob).digest()))
        return out

    def load_snapshot_chunk(self, height: int, format_: int,
                            chunk: int) -> bytes:
        blob = self._snapshot_blobs.get(height)
        if blob is None:
            return b""  # unknown snapshot: restorer will RETRY elsewhere
        lo = chunk * self.SNAPSHOT_CHUNK_SIZE
        return blob[lo:lo + self.SNAPSHOT_CHUNK_SIZE]

    def offer_snapshot(self, snapshot: Snapshot, app_hash: bytes) -> str:
        if snapshot.format != 1 or snapshot.chunks < 1:
            return "REJECT_FORMAT"
        self._restore = {"snapshot": snapshot, "chunks": [],
                         "app_hash": app_hash}
        return "ACCEPT"

    def apply_snapshot_chunk(self, index: int, chunk: bytes,
                             sender: str) -> str:
        r = getattr(self, "_restore", None)
        if r is None:
            return "ABORT"
        # position by index: sources may re-deliver or reorder chunks
        # (the reference chunk queue slots by index the same way)
        if index < len(r["chunks"]):
            return "ACCEPT"  # duplicate: already have it
        if index > len(r["chunks"]):
            return "RETRY_SNAPSHOT"  # gap: restart this snapshot
        r["chunks"].append(chunk)
        if len(r["chunks"]) < r["snapshot"].chunks:
            return "ACCEPT"
        blob = b"".join(r["chunks"])
        if hashlib.sha256(blob).digest() != r["snapshot"].hash:
            self._restore = None
            return "RETRY_SNAPSHOT"
        d = json.loads(blob)
        state, height = d["state"], d["height"]
        if self._compute_app_hash(state, height) != r["app_hash"]:
            # light-client-verified app hash disagrees: poisoned snapshot
            self._restore = None
            return "REJECT_SNAPSHOT"
        self.state = state
        self.last_height = height
        self.last_app_hash = r["app_hash"]
        self._prev = None  # pre-restore snapshot no longer provable
        self._restore = None
        return "COMPLETE"
