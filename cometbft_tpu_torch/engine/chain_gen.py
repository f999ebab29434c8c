"""Deterministic chain generator: runs the real executor + signs real
commits — the in-process fixture for blocksync tests and the headline
benchmark (the role reference internal/consensus/wal_generator.go and
test/e2e's generator play).

Port of `cometbft_tpu/engine/chain_gen.py`: RFC 8032 signing is
deterministic and every hash and sign-bytes encoder is a copy, so
`generate_chain(seed)` gives the JAX package's chain byte for byte. The
executor that applies the generated blocks verifies each last commit on
`device=` (default cuda), aggregated commits too (their pairing
equation through `aggsig`'s kernels). `ChainLightProvider` serves the
chain to the light client. Validators sign with ed25519 or BLS keys, as
in the JAX package: a mixed-curve set is built by hand and its commits
signed with `sign_commit`, which takes any key type.
`ChainSealSource` serves the chain's aggregated seals to
`sealsync.SealAdopter`.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field as dc_field
from typing import Callable, Dict, List, Optional, Tuple

from ..abci.application import Application
from ..abci.kvstore import KVStoreApplication
from ..crypto.keys import Ed25519PrivKey
from ..engine.blocksync import PeerSource
from ..state.execution import BlockExecutor
from ..state.state import GenesisDoc, State
from ..types import proto
from ..types.block import (
    Block, BlockID, Commit, CommitSig, BLOCK_ID_FLAG_COMMIT)
from ..types.proto import Timestamp
from ..types.validator import Validator
from ..types.vote import Vote, PRECOMMIT_TYPE


@dataclass
class GeneratedChain:
    chain_id: str
    genesis: GenesisDoc
    blocks: List[Block]                  # heights 1..N
    block_ids: List[BlockID]
    seen_commits: List[Commit]           # commit sealing each height
    keys: Dict[bytes, Ed25519PrivKey]    # address -> key
    valsets: List = dc_field(default_factory=list)  # signer set per height

    def max_height(self) -> int:
        return len(self.blocks)


def make_genesis(n_validators: int, chain_id: str = "tpu-chain",
                 seed: int = 1, power: Optional[List[int]] = None,
                 key_type: str = "ed25519"
                 ) -> Tuple[GenesisDoc, Dict[bytes, Ed25519PrivKey]]:
    rng = random.Random(seed)
    pops = {}
    if key_type == "bls12_381":
        # genesis proofs of possession: verified + registered by
        # State.from_genesis, admitting the keys to aggregation
        from ..aggsig.aggregate import deterministic_keys_with_pops
        keys, pops = deterministic_keys_with_pops(n_validators, rng)
    elif key_type == "ed25519":
        keys = [Ed25519PrivKey(bytes(rng.randrange(256)
                                     for _ in range(32)))
                for _ in range(n_validators)]
    else:
        # the JAX package signs with ed25519 keys for any type but BLS
        raise ValueError(f"make_genesis makes ed25519 or BLS keys, not "
                         f"{key_type!r}")
    vals = [Validator(k.pub_key(), power[i] if power else 10)
            for i, k in enumerate(keys)]
    gen = GenesisDoc(chain_id=chain_id, validators=vals,
                     genesis_time=Timestamp(1_700_000_000, 0),
                     bls_pops=pops)
    return gen, {k.pub_key().address(): k for k in keys}


def sign_commit(chain_id: str, height: int, round_: int, block_id: BlockID,
                valset, keys: Dict[bytes, Ed25519PrivKey],
                base_time: int = 1_700_000_000,
                uniform_ts: bool = False) -> Commit:
    """All validators precommit for the block (reference
    types/vote_set.go MakeExtendedCommit path, minus extensions).
    uniform_ts stamps every precommit with the same timestamp — all
    signers then share ONE canonical message, the shape that collapses
    an aggregated commit to a single pairing group (a co-timed quorum;
    BFT time under a virtual clock behaves the same way)."""
    sigs = []
    for i, val in enumerate(valset.validators):
        ts = Timestamp(base_time + height, 0 if uniform_ts else i)
        vote = Vote(type_=PRECOMMIT_TYPE, height=height, round=round_,
                    block_id=block_id, timestamp=ts,
                    validator_address=val.address, validator_index=i)
        key = keys[val.address]
        sigs.append(CommitSig(BLOCK_ID_FLAG_COMMIT, val.address, ts,
                              key.sign(vote.sign_bytes(chain_id))))
    return Commit(height=height, round=round_, block_id=block_id,
                  signatures=sigs)


def generate_chain(n_blocks: int, n_validators: int = 4,
                   chain_id: str = "tpu-chain", seed: int = 1,
                   app_factory: Callable[[], Application] = KVStoreApplication,
                   txs_per_block: int = 2,
                   val_tx_heights: Optional[Dict[int, bytes]] = None,
                   extra_keys: Optional[List[Ed25519PrivKey]] = None,
                   key_type: str = "ed25519",
                   aggregate: bool = False, device=None) -> GeneratedChain:
    """Build a valid chain by executing blocks through the real
    BlockExecutor (on `device`, default cuda). `val_tx_heights` maps
    height -> raw val-update tx to exercise validator-set changes
    mid-chain (provide the matching signing keys via `extra_keys`).
    key_type="bls12_381" signs with BLS keys (genesis PoPs included);
    aggregate=True additionally folds each commit into the
    AggregatedCommit seal (uniform timestamps, so the whole commit is
    one pairing group)."""
    gen, keys = make_genesis(n_validators, chain_id, seed,
                             key_type=key_type)
    for k in extra_keys or []:
        keys[k.pub_key().address()] = k
    state = State.from_genesis(gen)
    app = app_factory()
    app.init_chain(chain_id, gen.initial_height,
                   [], b"")
    executor = BlockExecutor(app, device=device)

    blocks: List[Block] = []
    block_ids: List[BlockID] = []
    commits: List[Commit] = []
    valsets: List = []
    last_commit = Commit()
    for h in range(1, n_blocks + 1):
        txs = [f"k{h}-{i}=v{h}-{i}".encode() for i in range(txs_per_block)]
        if val_tx_heights and h in val_tx_heights:
            txs.append(val_tx_heights[h])
        proposer = state.validators.get_proposer()
        block = state.make_block(
            h, txs, last_commit, proposer.address,
            timestamp=Timestamp(1_700_000_000 + h, 0))
        block_id = BlockID(block.hash(), block.make_part_set().header)
        commit = sign_commit(chain_id, h, 0, block_id, state.validators,
                             keys, uniform_ts=aggregate)
        if aggregate:
            from ..types.agg_commit import maybe_aggregate
            commit = maybe_aggregate(commit, state.validators)
        valsets.append(state.validators.copy())
        state, _ = executor.apply_block(state, block_id, block)
        blocks.append(block)
        block_ids.append(block_id)
        commits.append(commit)
        last_commit = commit
    return GeneratedChain(chain_id=chain_id, genesis=gen, blocks=blocks,
                          block_ids=block_ids, seen_commits=commits,
                          keys=keys, valsets=valsets)


class ChainLightProvider:
    """Light-client provider over a GeneratedChain (the mock-provider
    analog, reference light/provider/mock) — shared by the light tests
    and the chip smoke's light-client phase."""

    def __init__(self, chain: GeneratedChain):
        self.chain = chain

    def chain_id(self) -> str:
        return self.chain.chain_id

    def light_block(self, height: int):
        from ..light.provider import ErrLightBlockNotFound
        from ..light.types import LightBlock, SignedHeader
        if height == 0:
            height = self.chain.max_height()
        if not (1 <= height <= self.chain.max_height()):
            raise ErrLightBlockNotFound(str(height))
        blk = self.chain.blocks[height - 1]
        return LightBlock(
            SignedHeader(blk.header, self.chain.seen_commits[height - 1]),
            self.chain.valsets[height - 1].copy())


class LocalChainSource:
    """PeerSource over a generated chain — the in-memory peer
    (reference test doubles in internal/blocksync/pool_test.go)."""

    def __init__(self, chain: GeneratedChain,
                 corrupt_heights: Dict[int, str] | None = None):
        self.chain = chain
        self.corrupt = corrupt_heights or {}
        self.banned: List[int] = []

    def max_height(self) -> int:
        # can serve a synthetic sealing commit for the tip via next_block
        return self.chain.max_height()

    def fetch(self, height: int):
        if height == self.chain.max_height() + 1:
            # synthesize an empty successor carrying the tip's seen commit,
            # so the tip itself can be sealed (the live protocol uses the
            # pool's two-block peek; a real peer at tip serves its seen
            # commit the same way)
            tip_commit = self.chain.seen_commits[-1]
            blk = Block(header=_sealing_header(self.chain),
                        last_commit=tip_commit)
            return blk, BlockID()
        if not (1 <= height <= self.chain.max_height()):
            return None
        block = self.chain.blocks[height - 1]
        if height in self.corrupt:
            block = _corrupt_block(block, self.corrupt[height])
        return block, self.chain.block_ids[height - 1]

    def ban(self, height: int) -> None:
        """A ban routes away from the faulty peer — everything is served
        clean afterwards (the blamed height only localizes the report)."""
        self.banned.append(height)
        self.corrupt.clear()


class ChainSealSource:
    """sealsync.SealSource over a generated chain — the in-memory seal
    provider for tests and the chip smoke's seal-sync phase. Corrupt
    modes:

      "sig"     flip a byte of the tip seal's aggregate signature
                (structural/point-level rejection at marshal)
      "bitmap"  deep forgery: aggregate only n-1 real signatures but
                keep the full-coverage bitmap — structure-valid,
                voting-power tally passes, the PAIRING is what rejects

    Forgeries are only served at heights in `corrupt_heights` (serve
    the tip: interior forgeries are caught earlier and cheaper by the
    host hash-chain binding). ban() clears corruption, modeling the
    retry landing on the honest peer."""

    def __init__(self, chain: GeneratedChain,
                 corrupt_heights: Dict[int, str] | None = None):
        self.chain = chain
        self.corrupt = corrupt_heights or {}
        self.banned: List[int] = []

    def max_height(self) -> int:
        return self.chain.max_height()

    def fetch_seals(self, start: int, count: int):
        from ..sealsync.chain import SealTuple
        from ..types.agg_commit import AggregatedCommit
        out = []
        for h in range(start, min(start + count,
                                  self.chain.max_height() + 1)):
            commit = self.chain.seen_commits[h - 1]
            if not isinstance(commit, AggregatedCommit):
                break
            if h in self.corrupt:
                commit = _forge_seal(self.chain, commit,
                                     self.corrupt[h])
            header = self.chain.blocks[h - 1].header
            valset = None
            pops: Dict[bytes, bytes] = {}
            if h > 1 and header.validators_hash != \
                    self.chain.blocks[h - 2].header.validators_hash:
                valset = self.chain.valsets[h - 1].copy()
                pops = _valset_pops(self.chain, valset)
            out.append(SealTuple(h, header, commit, valset, pops))
        return out

    def ban(self, height: int) -> None:
        self.banned.append(height)
        self.corrupt.clear()


def _valset_pops(chain: GeneratedChain, valset) -> Dict[bytes, bytes]:
    from ..aggsig.aggregate import pop_prove
    pops: Dict[bytes, bytes] = {}
    for v in valset.validators:
        if v.pub_key.type_() != "bls12_381":
            continue
        priv = chain.keys.get(v.address)
        if priv is not None:
            pops[v.pub_key.bytes_()] = pop_prove(priv)
    return pops


def _forge_seal(chain: GeneratedChain, commit, mode: str):
    """A forged aggregated seal: "sig" flips a byte of the aggregate
    signature; "bitmap" aggregates only n-1 real signatures but keeps
    the full-coverage bitmap (the pairing rejects it)."""
    import dataclasses
    if mode == "sig":
        return dataclasses.replace(
            commit, agg_sig=commit.agg_sig[:1]
            + bytes([commit.agg_sig[1] ^ 1]) + commit.agg_sig[2:])
    if mode == "bitmap":
        from ..aggsig.aggregate import aggregate_signatures
        vals = chain.valsets[commit.height - 1]
        # uniform timestamps -> one canonical message for every lane
        msg = commit.vote_sign_bytes(chain.chain_id, 0)
        sigs = [chain.keys[v.address].sign(msg)
                for v in vals.validators[:-1]]
        return dataclasses.replace(commit,
                                   agg_sig=aggregate_signatures(sigs))
    raise ValueError(mode)


def _sealing_header(chain: GeneratedChain):
    from ..types.block import Header
    return Header(chain_id=chain.chain_id,
                  height=chain.max_height() + 1,
                  validators_hash=chain.blocks[-1].header.next_validators_hash,
                  proposer_address=b"\x00" * 20)


def _corrupt_block(block: Block, mode: str) -> Block:
    import dataclasses
    if mode == "sig":
        lc = block.last_commit
        from ..types.agg_commit import AggregatedCommit
        if isinstance(lc, AggregatedCommit):
            # the aggregated seal's analog of a flipped lane signature
            # is a flipped aggregate byte (covered lanes carry none)
            return Block(header=block.header, data=block.data,
                         last_commit=_forge_seal(None, lc, "sig"))
        sigs = list(lc.signatures)
        s = sigs[0]
        sigs[0] = CommitSig(s.block_id_flag, s.validator_address,
                            s.timestamp,
                            bytes([s.signature[0] ^ 1]) + s.signature[1:])
        return Block(header=block.header, data=block.data,
                     last_commit=Commit(lc.height, lc.round, lc.block_id,
                                        sigs))
    if mode == "data":
        data = dataclasses.replace(block.data)
        data.txs = list(block.data.txs) + [b"injected=1"]
        return Block(header=block.header, data=data,
                     last_commit=block.last_commit)
    raise ValueError(mode)
