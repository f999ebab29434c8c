"""Bidirectional JSON codecs for the RPC wire — full-fidelity header,
commit, and validator-set forms so remote consumers (light client HTTP
provider, verifying proxy) can reconstruct hash-identical types
(reference rpc/core serializes the same structures through
cometbft/api JSON; fidelity is what makes `/commit` usable as a light
block source).

Copy of `cometbft_tpu/rpc/codec.py` in the port (the port keeps its own).
"""

from __future__ import annotations

from typing import Optional

from ..crypto.keys import Ed25519PubKey, pubkey_from_type_bytes
from ..crypto.merkle import AbsenceProof, Proof
from ..types.block import BlockID, Commit, CommitSig, Header, PartSetHeader
from ..types.proto import Timestamp
from ..types.validator import Validator, ValidatorSet


def block_id_json(bid: BlockID) -> dict:
    return {"hash": bid.hash.hex(),
            "parts": {"total": bid.parts.total,
                      "hash": bid.parts.hash.hex()}}


def block_id_from_json(d: dict) -> BlockID:
    return BlockID(bytes.fromhex(d.get("hash", "")),
                   PartSetHeader(d.get("parts", {}).get("total", 0),
                                 bytes.fromhex(
                                     d.get("parts", {}).get("hash", ""))))


def ts_json(t: Timestamp) -> list:
    return [t.seconds, t.nanos]


def ts_from_json(v) -> Timestamp:
    return Timestamp(int(v[0]), int(v[1]))


def header_json(h: Header) -> dict:
    return {
        "version": {"block": h.version_block, "app": h.version_app},
        "chain_id": h.chain_id, "height": h.height,
        "time": ts_json(h.time),
        "last_block_id": block_id_json(h.last_block_id),
        "last_commit_hash": h.last_commit_hash.hex(),
        "data_hash": h.data_hash.hex(),
        "validators_hash": h.validators_hash.hex(),
        "next_validators_hash": h.next_validators_hash.hex(),
        "consensus_hash": h.consensus_hash.hex(),
        "app_hash": h.app_hash.hex(),
        "last_results_hash": h.last_results_hash.hex(),
        "evidence_hash": h.evidence_hash.hex(),
        "proposer_address": h.proposer_address.hex(),
    }


def header_from_json(d: dict) -> Header:
    ver = d.get("version", {})
    return Header(
        version_block=ver.get("block", 0), version_app=ver.get("app", 0),
        chain_id=d["chain_id"], height=int(d["height"]),
        time=ts_from_json(d["time"]),
        last_block_id=block_id_from_json(d["last_block_id"]),
        last_commit_hash=bytes.fromhex(d["last_commit_hash"]),
        data_hash=bytes.fromhex(d["data_hash"]),
        validators_hash=bytes.fromhex(d["validators_hash"]),
        next_validators_hash=bytes.fromhex(d["next_validators_hash"]),
        consensus_hash=bytes.fromhex(d["consensus_hash"]),
        app_hash=bytes.fromhex(d["app_hash"]),
        last_results_hash=bytes.fromhex(d["last_results_hash"]),
        evidence_hash=bytes.fromhex(d["evidence_hash"]),
        proposer_address=bytes.fromhex(d["proposer_address"]))


def commit_json(c: Commit) -> dict:
    return {"height": c.height, "round": c.round,
            "block_id": block_id_json(c.block_id),
            "signatures": [
                {"block_id_flag": s.block_id_flag,
                 "validator_address": s.validator_address.hex(),
                 "timestamp": ts_json(s.timestamp),
                 "signature": s.signature.hex()}
                for s in c.signatures]}


def commit_from_json(d: dict) -> Commit:
    return Commit(
        height=int(d["height"]), round=int(d["round"]),
        block_id=block_id_from_json(d["block_id"]),
        signatures=[
            CommitSig(block_id_flag=s["block_id_flag"],
                      validator_address=bytes.fromhex(
                          s["validator_address"]),
                      timestamp=ts_from_json(s["timestamp"]),
                      signature=bytes.fromhex(s["signature"]))
            for s in d.get("signatures", [])])


def validator_set_json(vals: ValidatorSet) -> dict:
    prop = vals.get_proposer()
    return {"validators": [
                {"address": v.address.hex(),
                 "pub_key": {"type": v.pub_key.type_(),
                             "value": v.pub_key.bytes_().hex()},
                 "voting_power": v.voting_power,
                 "proposer_priority": v.proposer_priority}
                for v in vals.validators],
            "proposer": prop.address.hex() if prop else ""}


def validator_set_from_json(d: dict) -> ValidatorSet:
    vals = []
    for v in d.get("validators", []):
        pk = v["pub_key"]
        if isinstance(pk, dict):
            pub = pubkey_from_type_bytes(pk["type"],
                                         bytes.fromhex(pk["value"]))
        else:  # legacy hex form = ed25519
            pub = Ed25519PubKey(bytes.fromhex(pk))
        vals.append(Validator(pub, int(v["voting_power"]),
                              int(v.get("proposer_priority", 0))))
    return ValidatorSet(vals)


def proof_json(p) -> Optional[dict]:
    """Inclusion Proof or AbsenceProof → JSON (absence is tagged so a
    verifying client can never mistake one for the other)."""
    if p is None:
        return None
    if isinstance(p, AbsenceProof):
        return {"absence": {
            "left": proof_json(p.left), "left_leaf": p.left_leaf.hex(),
            "right": proof_json(p.right),
            "right_leaf": (p.right_leaf.hex()
                           if p.right_leaf is not None else None)}}
    return {"total": p.total, "index": p.index,
            "leaf_hash": p.leaf_hash.hex(),
            "aunts": [a.hex() for a in p.aunts]}


def proof_from_json(d: Optional[dict]):
    """JSON → Proof | AbsenceProof | None. Malformed input raises
    (callers on verify paths treat that as verification failure)."""
    if not d:
        return None
    if "absence" in d:
        a = d["absence"]
        left = proof_from_json(a["left"])
        if not isinstance(left, Proof):
            raise ValueError("absence proof missing left neighbor")
        right = proof_from_json(a.get("right"))
        if right is not None and not isinstance(right, Proof):
            # a nested absence object would crash verify_adjacent with
            # AttributeError instead of failing verification
            raise ValueError("absence proof right neighbor must be a "
                             "plain inclusion proof")
        rl = a.get("right_leaf")
        return AbsenceProof(left, bytes.fromhex(a["left_leaf"]),
                            right,
                            bytes.fromhex(rl) if rl is not None else None)
    return Proof(int(d["total"]), int(d["index"]),
                 bytes.fromhex(d["leaf_hash"]),
                 [bytes.fromhex(a) for a in d["aunts"]])
