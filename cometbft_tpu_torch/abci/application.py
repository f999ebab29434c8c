"""ABCI: the application interface (reference
abci/types/application.go:9-35 — the 14-method surface — and the request/
response payloads the engine actually consumes).

In-process applications implement `Application`; remote apps connect via
the socket server (abci/server.py). `BaseApplication` provides no-op
defaults exactly like the reference's BaseApplication (:42).

Copy of `cometbft_tpu/abci/application.py` (the port keeps its own).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Protocol

from ..types.proto import Timestamp

CODE_TYPE_OK = 0


@dataclass
class ValidatorUpdate:
    """reference abci/types.pb PubKeyBytes+Power update. A BLS key
    admitted mid-chain must carry its proof of possession in `pop`
    (aggregation is unsound against rogue-key choices without one —
    aggsig/aggregate.py); ed25519 updates leave it empty."""
    pub_key_type: str
    pub_key_bytes: bytes
    power: int
    pop: bytes = b""


@dataclass
class ExecTxResult:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    gas_wanted: int = 0
    gas_used: int = 0

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK

    def encode(self) -> bytes:
        """Deterministic encoding for last_results_hash: the reference
        strips everything EXCEPT code, data, gas_wanted and gas_used
        (abci/types/types.go:201-208 DeterministicExecTxResult; proto
        fields 1, 2, 5, 6 of ExecTxResult) before merkle-hashing
        (types/results.go NewResults/Hash)."""
        from ..types import proto
        return (proto.f_varint(1, self.code)
                + proto.f_bytes(2, self.data)
                + proto.f_varint(5, self.gas_wanted)
                + proto.f_varint(6, self.gas_used))


@dataclass
class CheckTxResult:
    code: int = CODE_TYPE_OK
    log: str = ""
    gas_wanted: int = 0


@dataclass
class ResponseInfo:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""


@dataclass
class RequestFinalizeBlock:
    txs: List[bytes]
    height: int
    time: Timestamp
    proposer_address: bytes
    hash: bytes = b""
    next_validators_hash: bytes = b""
    decided_last_commit_votes: List[tuple] = dc_field(default_factory=list)


@dataclass
class ResponseFinalizeBlock:
    tx_results: List[ExecTxResult] = dc_field(default_factory=list)
    validator_updates: List[ValidatorUpdate] = dc_field(default_factory=list)
    app_hash: bytes = b""
    consensus_param_updates: Optional[dict] = None

    def encode(self) -> bytes:
        """Node-local persistence form (reference
        state/store.go SaveFinalizeBlockResponse — stored per height so
        crash recovery / handshake replay can reconstruct results)."""
        import json
        return json.dumps({
            "tx_results": [{"code": r.code, "data": r.data.hex(),
                            "log": r.log, "gas_wanted": r.gas_wanted,
                            "gas_used": r.gas_used}
                           for r in self.tx_results],
            "validator_updates": [
                {"type": u.pub_key_type, "pub_key": u.pub_key_bytes.hex(),
                 "power": u.power, "pop": u.pop.hex()}
                for u in self.validator_updates],
            "app_hash": self.app_hash.hex(),
        }).encode()

    @classmethod
    def decode(cls, raw: bytes) -> "ResponseFinalizeBlock":
        import json
        d = json.loads(raw)
        return cls(
            tx_results=[ExecTxResult(r["code"], bytes.fromhex(r["data"]),
                                     r["log"], r["gas_wanted"], r["gas_used"])
                        for r in d["tx_results"]],
            validator_updates=[
                ValidatorUpdate(u["type"], bytes.fromhex(u["pub_key"]),
                                u["power"],
                                bytes.fromhex(u.get("pop", "")))
                for u in d["validator_updates"]],
            app_hash=bytes.fromhex(d["app_hash"]))


@dataclass
class ResponseCommit:
    retain_height: int = 0


@dataclass
class Snapshot:
    """reference abci Snapshot message (statesync.proto): an app-level
    checkpoint advertised to catching-up peers."""
    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes = b""


class Application(Protocol):
    """reference abci/types/application.go:9-35."""

    # info/query connection
    def info(self) -> ResponseInfo: ...
    def query(self, path: str, data: bytes) -> tuple[int, bytes]: ...
    def query_prove(self, path: str, data: bytes
                    ) -> tuple[int, bytes, int, object]: ...

    # mempool connection
    def check_tx(self, tx: bytes) -> CheckTxResult: ...

    # consensus connection
    def init_chain(self, chain_id: str, initial_height: int,
                   validators: List[ValidatorUpdate],
                   app_state_bytes: bytes) -> tuple[List[ValidatorUpdate],
                                                    bytes]: ...
    def prepare_proposal(self, txs: List[bytes], max_tx_bytes: int,
                         local_last_commit=None) -> List[bytes]:
        """local_last_commit: [(validator_index, address, extension)]
        from the previous height's extended commit when vote extensions
        are enabled (reference abci RequestPrepareProposal
        .local_last_commit.votes[].vote_extension), else None."""
    def process_proposal(self, txs: List[bytes], height: int) -> bool: ...
    def finalize_block(self, req: RequestFinalizeBlock
                       ) -> ResponseFinalizeBlock: ...
    def commit(self) -> ResponseCommit: ...

    # vote extensions
    def extend_vote(self, height: int, round_: int) -> bytes: ...
    def verify_vote_extension(self, height: int, addr: bytes,
                              ext: bytes) -> bool: ...

    # snapshot connection
    def list_snapshots(self) -> list: ...
    def offer_snapshot(self, snapshot, app_hash: bytes) -> str: ...
    def load_snapshot_chunk(self, height: int, format_: int,
                            chunk: int) -> bytes: ...
    def apply_snapshot_chunk(self, index: int, chunk: bytes,
                             sender: str) -> str: ...


class BaseApplication:
    """No-op defaults (reference abci/types/application.go:42-108)."""

    def info(self) -> ResponseInfo:
        return ResponseInfo()

    def query(self, path: str, data: bytes) -> tuple[int, bytes]:
        return CODE_TYPE_OK, b""

    def query_prove(self, path: str, data: bytes
                    ) -> tuple[int, bytes, int, object]:
        """(code, value, height, proof-or-None); apps without provable
        state answer proofless (verifying clients then reject them)."""
        code, value = self.query(path, data)
        return code, value, self.info().last_block_height, None

    def check_tx(self, tx: bytes) -> CheckTxResult:
        return CheckTxResult()

    def init_chain(self, chain_id, initial_height, validators,
                   app_state_bytes):
        return [], b""

    def prepare_proposal(self, txs, max_tx_bytes,
                         local_last_commit=None):
        out, total = [], 0
        for tx in txs:
            total += len(tx)
            if max_tx_bytes >= 0 and total > max_tx_bytes:
                break
            out.append(tx)
        return out

    def process_proposal(self, txs, height) -> bool:
        return True

    def finalize_block(self, req: RequestFinalizeBlock
                       ) -> ResponseFinalizeBlock:
        return ResponseFinalizeBlock(
            tx_results=[ExecTxResult() for _ in req.txs])

    def commit(self) -> ResponseCommit:
        return ResponseCommit()

    def extend_vote(self, height, round_) -> bytes:
        return b""

    def verify_vote_extension(self, height, addr, ext) -> bool:
        return True

    def list_snapshots(self):
        return []

    def offer_snapshot(self, snapshot, app_hash) -> str:
        return "ABORT"

    def load_snapshot_chunk(self, height, format_, chunk) -> bytes:
        return b""

    def apply_snapshot_chunk(self, index, chunk, sender) -> str:
        return "ABORT"
