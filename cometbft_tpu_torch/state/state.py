"""Replicated state: the deterministic snapshot between blocks
(reference state/state.go — validators, params, last-block info,
last-results), plus genesis bootstrapping (types/genesis.go).

Copy of `cometbft_tpu/state/state.py` (the port keeps its own).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field, replace
from typing import List, Optional

from ..crypto import merkle
from ..crypto.keys import Ed25519PubKey, pubkey_from_type_bytes
from ..types import proto
from ..types.block import Block, BlockID, Commit, Data, Header
from ..types.proto import Timestamp
from ..types.validator import Validator, ValidatorSet


@dataclass
class ConsensusParams:
    """Minimal on-chain params (reference types/params.go): block size
    caps and evidence windows; hashed into Header.consensus_hash."""
    max_block_bytes: int = 22_020_096   # 21MB, types/params.go
    max_gas: int = -1
    evidence_max_age_num_blocks: int = 100_000
    evidence_max_age_seconds: int = 172_800
    evidence_max_bytes: int = 1_048_576
    pbts_enable_height: int = 0
    # ABCI vote extensions activate at this height; 0 = disabled
    # (reference types/params.go ABCIParams.VoteExtensionsEnableHeight)
    vote_extensions_enable_height: int = 0
    # PBTS synchrony bounds (reference types/params.go:119-121 Synchrony
    # Params, defaults :193-198): a proposal's timestamp is accepted iff
    # receive_time ∈ [ts - precision, ts + message_delay + precision]
    synchrony_precision_ns: int = 500_000_000         # 500ms
    synchrony_message_delay_ns: int = 2_000_000_000   # 2s

    def extensions_enabled(self, height: int) -> bool:
        return (self.vote_extensions_enable_height > 0
                and height >= self.vote_extensions_enable_height)

    def pbts_enabled(self, height: int) -> bool:
        """reference types/params.go:82 FeatureParams.PbtsEnabled."""
        return (self.pbts_enable_height > 0
                and height >= self.pbts_enable_height)

    def synchrony_in_round(self, round_: int) -> tuple:
        """(precision_ns, message_delay_ns) with message_delay grown 10%
        per round (reference types/params.go:124-139 InRound) so a
        network slower than the configured bound still eventually
        accepts a correct proposer's timestamp."""
        return (self.synchrony_precision_ns,
                int((1.1 ** round_) * self.synchrony_message_delay_ns))

    def hash(self) -> bytes:
        """Wire-normative digest: sha256 over proto(HashedParams) which
        holds ONLY {1: block_max_bytes, 2: block_max_gas} (reference
        types/params.go:383-401, proto/cometbft/types/v1/params.proto:88).
        consensus_hash sits inside the signed header, so this must match
        the reference byte-for-byte."""
        import hashlib
        enc = (proto.f_varint(1, self.max_block_bytes)
               + proto.f_varint(2, self.max_gas))
        return hashlib.sha256(enc).digest()


@dataclass
class GenesisDoc:
    """reference types/genesis.go."""
    chain_id: str
    validators: List[Validator]
    genesis_time: Timestamp = dc_field(default_factory=Timestamp)
    initial_height: int = 1
    consensus_params: ConsensusParams = dc_field(
        default_factory=ConsensusParams)
    app_state: bytes = b""
    app_hash: bytes = b""
    # BLS proofs of possession, pubkey bytes -> PoP signature: the
    # consensus-visible channel admitting genesis BLS keys to the
    # aggregate-commit path (docs/AGGSIG.md "PoP policy"). Verified at
    # State.from_genesis; a key with a bad/missing PoP still
    # validates votes per-signature but can never join an aggregate.
    bls_pops: dict = dc_field(default_factory=dict)


@dataclass
class State:
    """reference state/state.go:36-90."""
    chain_id: str
    initial_height: int
    last_block_height: int
    last_block_id: BlockID
    last_block_time: Timestamp
    validators: ValidatorSet         # valset for height last_block_height+1
    next_validators: ValidatorSet    # valset for height +2
    last_validators: ValidatorSet    # valset that signed last_block
    last_height_validators_changed: int
    consensus_params: ConsensusParams
    last_results_hash: bytes
    app_hash: bytes
    version_block: int = 11
    version_app: int = 0

    @classmethod
    def from_genesis(cls, gen: GenesisDoc) -> "State":
        """reference state/state.go MakeGenesisState."""
        if gen.bls_pops:
            # verify-and-register the genesis proofs of possession in
            # one batched multi-pairing (idempotent + process-cached,
            # so every node/restart in a process pays it once)
            from ..aggsig.aggregate import register_pops_batch
            register_pops_batch(gen.bls_pops)
        vals = ValidatorSet(gen.validators)
        return cls(
            chain_id=gen.chain_id,
            initial_height=gen.initial_height,
            last_block_height=0,
            last_block_id=BlockID(),
            last_block_time=gen.genesis_time,
            validators=vals.copy(),
            next_validators=vals.copy_increment_proposer_priority(1),
            last_validators=ValidatorSet([]),
            last_height_validators_changed=gen.initial_height,
            consensus_params=gen.consensus_params,
            last_results_hash=merkle.hash_from_byte_slices([]),
            app_hash=gen.app_hash,
        )

    def copy(self) -> "State":
        return replace(
            self,
            validators=self.validators.copy(),
            next_validators=self.next_validators.copy(),
            last_validators=self.last_validators.copy())

    def make_block(self, height: int, txs: List[bytes], last_commit: Commit,
                   proposer_address: bytes,
                   timestamp: Optional[Timestamp] = None,
                   evidence: Optional[list] = None) -> Block:
        """reference state/state.go:233-263."""
        from ..types.evidence import EvidenceList
        if timestamp is None:
            if height == self.initial_height:
                # first block carries the genesis time
                # (reference state/validation.go:139-145)
                timestamp = self.last_block_time
            else:
                if self.consensus_params.pbts_enabled(height):
                    # PBTS: the proposer stamps its own canonical clock;
                    # validators judge it against receive time
                    # (reference internal/consensus/state.go:1243 +
                    # types/proposal.go:85-103)
                    timestamp = Timestamp.now()
                else:
                    # BFT time: weighted median of the last commit
                    # (reference types/block.go:922 MedianTime)
                    timestamp = (last_commit.median_time(
                        self.last_validators) or Timestamp.now())
                # block time is strictly increasing
                # (reference state/validation.go:122)
                floor = (self.last_block_time.seconds * 1_000_000_000
                         + self.last_block_time.nanos + 1)
                have = timestamp.seconds * 1_000_000_000 + timestamp.nanos
                if have < floor:
                    timestamp = Timestamp(floor // 1_000_000_000,
                                          floor % 1_000_000_000)
        data = Data(txs=list(txs))
        evidence = list(evidence or [])
        header = Header(
            version_block=self.version_block,
            version_app=self.version_app,
            chain_id=self.chain_id,
            height=height,
            time=timestamp,
            last_block_id=self.last_block_id,
            last_commit_hash=last_commit.hash(),
            data_hash=data.hash(),
            validators_hash=self.validators.hash(),
            next_validators_hash=self.next_validators.hash(),
            consensus_hash=self.consensus_params.hash(),
            app_hash=self.app_hash,
            last_results_hash=self.last_results_hash,
            evidence_hash=EvidenceList(evidence).hash(),
            proposer_address=proposer_address,
        )
        return Block(header=header, data=data, evidence=evidence,
                     last_commit=last_commit)


class StateStore:
    """Persistent state (reference state/store.go): the current State plus
    per-height FinalizeBlock responses and validator sets."""

    _KEY_STATE = b"statestore:state"

    def __init__(self, db, retain_abci_responses: bool = True):
        self._db = db
        # [storage] discard_abci_responses (reference config/config.go
        # StorageConfig): dropping them reclaims space but disables the
        # /block_results RPC for those heights
        self._retain_abci = retain_abci_responses

    def save(self, state: State) -> None:
        self._db.set(self._KEY_STATE, _state_to_json(state))
        # index validator sets by height for light client / evidence lookups
        self._db.set(b"vals:" + (state.last_block_height + 1).to_bytes(8, "big"),
                     _valset_to_json(state.validators))

    def load(self) -> Optional[State]:
        raw = self._db.get(self._KEY_STATE)
        return _state_from_json(raw) if raw is not None else None

    def load_validators(self, height: int) -> Optional[ValidatorSet]:
        raw = self._db.get(b"vals:" + height.to_bytes(8, "big"))
        return _valset_from_json(raw) if raw is not None else None

    def save_finalize_block_response(self, height: int, resp_bytes: bytes
                                     ) -> None:
        if not self._retain_abci:
            return
        self._db.set(b"abci:" + height.to_bytes(8, "big"), resp_bytes)

    def load_finalize_block_response(self, height: int) -> Optional[bytes]:
        return self._db.get(b"abci:" + height.to_bytes(8, "big"))

    def prune(self, retain_height: int) -> int:
        """Delete validator sets below retain_height (reference
        state/store.go PruneStates — the store owns its key layout).
        FinalizeBlock responses are deliberately NOT touched: they are
        pruned only by the data companion's results retain height
        (`prune_abci_responses`, reference PruneABCIResponses) or never
        stored at all under [storage] discard_abci_responses. Iterates
        only existing keys, so repeated calls are O(newly-prunable)."""
        prefix = b"vals:"
        end = prefix + retain_height.to_bytes(8, "big")
        deletes = [k for k, _v in self._db.iterate(prefix, end)]
        if deletes:
            self._db.write_batch([], deletes)
        return len(deletes)

    def save_companion_retain_heights(self, d: dict) -> None:
        """Persist the pruning-service retain heights (reference
        state/store.go saveCompanionBlockRetainHeight et al.) so a
        restart doesn't silently forget the data companion's prune
        opinions."""
        self._db.set(b"companion_retain", json.dumps(d).encode())

    def load_companion_retain_heights(self) -> dict:
        raw = self._db.get(b"companion_retain")
        return json.loads(raw) if raw else {}

    def prune_abci_responses(self, retain_height: int) -> int:
        """Delete only FinalizeBlock responses below retain_height
        (reference state/store.go PruneABCIResponses — driven by the
        data companion's block-results retain height, independent of
        block/state pruning)."""
        prefix = b"abci:"
        end = prefix + retain_height.to_bytes(8, "big")
        deletes = [k for k, _v in self._db.iterate(prefix, end)]
        if deletes:
            self._db.write_batch([], deletes)
        return len(deletes)


def _valset_to_json(vs: ValidatorSet) -> bytes:
    # key type stored per validator (absent == ed25519, so every state
    # written before BLS valsets existed still loads): a BLS valset
    # round-tripped through the store must come back as BLS keys, not
    # be silently re-typed
    prop = vs.get_proposer()
    return json.dumps({
        "validators": [
            {"pub_key": v.pub_key.bytes_().hex(),
             "type": v.pub_key.type_(),
             "power": v.voting_power,
             "priority": v.proposer_priority}
            for v in vs.validators],
        "proposer": prop.pub_key.bytes_().hex() if prop else None,
        "proposer_type": prop.pub_key.type_() if prop else None,
    }).encode()


def _valset_from_json(raw: bytes) -> ValidatorSet:
    d = json.loads(raw)
    vals = [Validator(
                pubkey_from_type_bytes(v.get("type", "ed25519"),
                                       bytes.fromhex(v["pub_key"])),
                v["power"], v["priority"])
            for v in d["validators"]]
    vs = ValidatorSet.__new__(ValidatorSet)
    vs.validators = vals
    vs._by_address = {v.address: i for i, v in enumerate(vals)}
    vs._total = None
    vs.proposer = None
    if d["proposer"] is not None:
        addr = pubkey_from_type_bytes(
            d.get("proposer_type") or "ed25519",
            bytes.fromhex(d["proposer"])).address()
        idx = vs._by_address.get(addr)
        vs.proposer = vals[idx] if idx is not None else None
    return vs


def _state_to_json(s: State) -> bytes:
    return json.dumps({
        "chain_id": s.chain_id,
        "initial_height": s.initial_height,
        "last_block_height": s.last_block_height,
        "last_block_id": {
            "hash": s.last_block_id.hash.hex(),
            "total": s.last_block_id.parts.total,
            "parts_hash": s.last_block_id.parts.hash.hex()},
        "last_block_time": [s.last_block_time.seconds,
                            s.last_block_time.nanos],
        "validators": _valset_to_json(s.validators).decode(),
        "next_validators": _valset_to_json(s.next_validators).decode(),
        "last_validators": _valset_to_json(s.last_validators).decode(),
        "last_height_validators_changed": s.last_height_validators_changed,
        "last_results_hash": s.last_results_hash.hex(),
        "app_hash": s.app_hash.hex(),
        "version_block": s.version_block,
        "version_app": s.version_app,
        "consensus_params": {
            "max_block_bytes": s.consensus_params.max_block_bytes,
            "max_gas": s.consensus_params.max_gas,
            "evidence_max_age_num_blocks":
                s.consensus_params.evidence_max_age_num_blocks,
            "evidence_max_age_seconds":
                s.consensus_params.evidence_max_age_seconds,
            "evidence_max_bytes": s.consensus_params.evidence_max_bytes,
            "pbts_enable_height": s.consensus_params.pbts_enable_height,
            "vote_extensions_enable_height":
                s.consensus_params.vote_extensions_enable_height,
            "synchrony_precision_ns":
                s.consensus_params.synchrony_precision_ns,
            "synchrony_message_delay_ns":
                s.consensus_params.synchrony_message_delay_ns,
        },
    }).encode()


def _state_from_json(raw: bytes) -> State:
    from ..types.block import PartSetHeader
    d = json.loads(raw)
    bid = BlockID(bytes.fromhex(d["last_block_id"]["hash"]),
                  PartSetHeader(d["last_block_id"]["total"],
                                bytes.fromhex(d["last_block_id"]["parts_hash"])))
    return State(
        chain_id=d["chain_id"],
        initial_height=d["initial_height"],
        last_block_height=d["last_block_height"],
        last_block_id=bid,
        last_block_time=Timestamp(*d["last_block_time"]),
        validators=_valset_from_json(d["validators"].encode()),
        next_validators=_valset_from_json(d["next_validators"].encode()),
        last_validators=_valset_from_json(d["last_validators"].encode()),
        last_height_validators_changed=d["last_height_validators_changed"],
        consensus_params=ConsensusParams(**d["consensus_params"]),
        last_results_hash=bytes.fromhex(d["last_results_hash"]),
        app_hash=bytes.fromhex(d["app_hash"]),
        version_block=d["version_block"],
        version_app=d["version_app"],
    )
