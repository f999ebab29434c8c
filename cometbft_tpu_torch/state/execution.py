"""Block executor: validate → finalize (ABCI) → update state
(reference state/execution.go:109-340, state/validation.go; port of
`cometbft_tpu/state/execution.py`).

The executor carries the device its commit checks batch-verify on
(`device=`, default cuda, resolved once at construction), where the JAX
package takes it from the process.
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Tuple

from ..abci.application import (
    Application, RequestFinalizeBlock, ResponseFinalizeBlock, ValidatorUpdate)
from ..crypto import merkle
from ..crypto.keys import Ed25519PubKey
from ..device import resolve_device
from ..types import validation
from ..types.block import Block, BlockID, Commit
from ..types.validator import Validator
from .state import State


class BlockValidationError(Exception):
    pass


def validate_block(state: State, block: Block,
                   check_commit: bool = True, device=None) -> None:
    """Full header/commit validation against state
    (reference state/validation.go:14-190).

    check_commit=False skips the last-commit signature verification for
    callers that already verified it out-of-band (blocksync's tiled
    verifier covers the identical commit bytes with full semantics; the
    last_commit_hash binding below still ties them to this block).
    `device` is where that verification batches (default cuda)."""
    h = block.header
    h.validate_basic()
    if h.chain_id != state.chain_id:
        raise BlockValidationError(
            f"wrong chain id: got {h.chain_id}, want {state.chain_id}")
    if h.height != state.last_block_height + 1 and \
            h.height != state.initial_height:
        raise BlockValidationError(
            f"wrong height {h.height}, expected {state.last_block_height + 1}")
    if h.last_block_id != state.last_block_id:
        raise BlockValidationError("wrong last_block_id")
    if h.last_commit_hash != block.last_commit.hash():
        raise BlockValidationError("wrong last_commit_hash")
    if h.data_hash != block.data.hash():
        raise BlockValidationError("wrong data_hash")
    if h.evidence_hash != block.evidence_hash():
        raise BlockValidationError("wrong evidence_hash")
    if h.validators_hash != state.validators.hash():
        raise BlockValidationError("wrong validators_hash")
    if h.next_validators_hash != state.next_validators.hash():
        raise BlockValidationError("wrong next_validators_hash")
    if h.consensus_hash != state.consensus_params.hash():
        raise BlockValidationError("wrong consensus_hash")
    if h.app_hash != state.app_hash:
        raise BlockValidationError("wrong app_hash")
    if h.last_results_hash != state.last_results_hash:
        raise BlockValidationError("wrong last_results_hash")

    # block time rules (reference state/validation.go:115-147): strictly
    # increasing after the first block; first block at/after genesis
    # time. The reference's pre-PBTS BFT-time equality check
    # (block.Time == LastCommit.MedianTime) is intentionally NOT
    # enforced: this chain's commit timestamps are advisory below the
    # PBTS activation height (make_block still STAMPS the median there
    # for parity), and under PBTS the prevote timeliness gate is the
    # normative check (consensus/state.py _do_prevote).
    t_ns = h.time.seconds * 1_000_000_000 + h.time.nanos
    last_ns = (state.last_block_time.seconds * 1_000_000_000
               + state.last_block_time.nanos)
    if h.height == state.initial_height:
        if t_ns < last_ns:
            raise BlockValidationError(
                "first block time precedes genesis time")
    elif t_ns <= last_ns:
        raise BlockValidationError(
            "block time not greater than last block time")

    if h.height == state.initial_height:
        if block.last_commit.signatures:
            raise BlockValidationError(
                "initial block must have empty last commit")
    elif check_commit:
        # verify the previous block's commit with the set that signed it
        validation.verify_commit(
            state.chain_id, state.last_validators, state.last_block_id,
            h.height - 1, block.last_commit, device=device)

    if not state.validators.has_address(h.proposer_address):
        raise BlockValidationError("proposer not in validator set")


def results_hash(tx_results) -> bytes:
    """reference types/results.go ABCIResults.Hash (merkle over
    deterministic result encodings)."""
    return merkle.hash_from_byte_slices([r.encode() for r in tx_results])


def validator_updates_to_validators(updates: List[ValidatorUpdate]
                                    ) -> List[Validator]:
    """App-issued set changes → Validators. A bls12_381 admission is
    gated on its proof of possession registering (idempotent, so
    replay/handshake re-application is free): letting an unproven BLS
    key into the set would poison every later aggregate over it with
    rogue-key unsoundness. Deterministic — a bad PoP fails on every
    node identically, so the block itself is rejected, not forked
    over."""
    out = []
    for u in updates:
        if u.pub_key_type == "ed25519":
            out.append(Validator(Ed25519PubKey(u.pub_key_bytes), u.power))
            continue
        if u.pub_key_type in ("bls12_381", "bls12381"):
            from ..aggsig.aggregate import register_pop
            from ..crypto.keys import pubkey_from_type_bytes
            if u.power > 0 and not register_pop(u.pub_key_bytes, u.pop):
                raise BlockValidationError(
                    "bls12_381 validator update with invalid proof "
                    "of possession")
            out.append(Validator(
                pubkey_from_type_bytes("bls12_381", u.pub_key_bytes),
                u.power))
            continue
        raise BlockValidationError(
            f"unsupported validator key type {u.pub_key_type}")
    return out


class BlockExecutor:
    """reference state/execution.go:71-120 (construction), :218 ApplyBlock,
    :109 CreateProposalBlock."""

    def __init__(self, app: Application, state_store=None, block_store=None,
                 mempool=None, evidence_pool=None, event_bus=None,
                 device=None):
        self.app = app
        self.device = resolve_device(device)
        self.state_store = state_store
        self.block_store = block_store
        self.mempool = mempool
        self.evidence_pool = evidence_pool
        self.event_bus = event_bus
        self.pruner = None  # background prune service (node-wired)

    # --- proposal path ------------------------------------------------------

    def create_proposal_block(self, height: int, state: State,
                              last_commit: Commit,
                              proposer_address: bytes) -> Block:
        """reference state/execution.go:109-166. When vote extensions
        were enabled for the previous height, the persisted extended
        commit's extensions ride to the app with PrepareProposal
        (reference buildExtendedCommitInfo, execution.go:136)."""
        max_bytes = state.consensus_params.max_block_bytes
        evidence = []
        if self.evidence_pool is not None:
            evidence = self.evidence_pool.pending_evidence(
                state.consensus_params.evidence_max_bytes)
        # evidence shares the block byte budget with txs (reference
        # types.MaxDataBytes, state/execution.go:126-133)
        ev_bytes = sum(len(ev.encode()) + 8 for ev in evidence)
        data_budget = max(0, max_bytes - 2048 - ev_bytes)
        txs: List[bytes] = []
        if self.mempool is not None:
            txs = self.mempool.reap_max_bytes_max_gas(
                data_budget, state.consensus_params.max_gas)
        local_last_commit = None
        if height > state.initial_height and \
                state.consensus_params.extensions_enabled(height - 1) \
                and self.block_store is not None:
            ec = self.block_store.load_extended_commit(height - 1)
            if ec is not None:
                local_last_commit = ec.extensions()
        txs = self.app.prepare_proposal(
            txs, data_budget, local_last_commit=local_last_commit)
        return state.make_block(height, txs, last_commit, proposer_address,
                                evidence=evidence)

    def process_proposal(self, block: Block, state: State) -> bool:
        """reference state/execution.go:169-196."""
        return self.app.process_proposal(block.data.txs, block.header.height)

    # --- apply path ---------------------------------------------------------

    def validate_block(self, state: State, block: Block,
                       check_commit: bool = True) -> None:
        validate_block(state, block, check_commit=check_commit,
                       device=self.device)
        if self.evidence_pool is not None and block.evidence:
            from ..types.evidence import EvidenceError
            try:
                self.evidence_pool.check_evidence(block.evidence, state)
            except EvidenceError as e:
                raise BlockValidationError(f"invalid evidence: {e}") from e

    def apply_block(self, state: State, block_id: BlockID, block: Block,
                    verified: bool = False) -> Tuple[State, ResponseFinalizeBlock]:
        """Validate (unless pre-verified), FinalizeBlock against the app,
        update state, commit (reference state/execution.go:218-340)."""
        if not verified:
            validate_block(state, block, device=self.device)

        from ..libs.fail import fail_point
        fail_point("apply_block:pre-finalize")       # execution.go:262
        resp = self.app.finalize_block(RequestFinalizeBlock(
            txs=block.data.txs,
            height=block.header.height,
            time=block.header.time,
            proposer_address=block.header.proposer_address,
            hash=block.hash(),
            next_validators_hash=block.header.next_validators_hash,
        ))
        if len(resp.tx_results) != len(block.data.txs):
            raise BlockValidationError(
                "app returned wrong number of tx results")

        new_state = self._update_state(state, block_id, block, resp)
        fail_point("apply_block:post-finalize")      # execution.go:269

        if self.state_store is not None:
            self.state_store.save_finalize_block_response(
                block.header.height, resp.encode())
        fail_point("apply_block:post-save-response")  # execution.go:304

        # app commit + mempool update (reference execution.go:296,390)
        if self.mempool is not None:
            self.mempool.lock()
        try:
            rc = self.app.commit()
            if self.mempool is not None:
                self.mempool.update(block.header.height, block.data.txs,
                                    resp.tx_results)
        finally:
            if self.mempool is not None:
                self.mempool.unlock()
        if self.pruner is not None and rc is not None and \
                getattr(rc, "retain_height", 0) > 0:
            # honor the app's retain height (reference execution.go:315
            # → pruner service); pruning runs in the background service,
            # never on the commit path
            self.pruner.set_retain_height(rc.retain_height)

        if self.evidence_pool is not None:
            self.evidence_pool.update(new_state, list(block.evidence))

        if self.state_store is not None:
            self.state_store.save(new_state)

        # fireEvents (reference state/execution.go:324-389): block, per-tx,
        # and valset-update events to the bus → indexers, RPC subscribers
        if self.event_bus is not None:
            self.event_bus.publish_new_block(block, resp)
            self.event_bus.publish_new_block_header(block.header)
            for i, tx in enumerate(block.data.txs):
                self.event_bus.publish_tx(block.header.height, i, tx,
                                          resp.tx_results[i])
            if resp.validator_updates:
                self.event_bus.publish_validator_set_updates(
                    resp.validator_updates)
        return new_state, resp

    def _update_state(self, state: State, block_id: BlockID, block: Block,
                      resp: ResponseFinalizeBlock) -> State:
        """reference state/execution.go:597-672."""
        n_valset = state.next_validators.copy()
        last_changed = state.last_height_validators_changed
        updates = validator_updates_to_validators(resp.validator_updates)
        if updates:
            n_valset.update_with_change_set(updates)
            last_changed = block.header.height + 2
        n_valset.increment_proposer_priority(1)

        return replace(
            state,
            last_block_height=block.header.height,
            last_block_id=block_id,
            last_block_time=block.header.time,
            next_validators=n_valset,
            validators=state.next_validators.copy(),
            last_validators=state.validators.copy(),
            last_height_validators_changed=last_changed,
            last_results_hash=results_hash(resp.tx_results),
            app_hash=resp.app_hash,
        )
