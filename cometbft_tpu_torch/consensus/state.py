"""The Tendermint consensus state machine — single-writer event loop
(reference internal/consensus/state.go: receiveRoutine :778, round steps
:1046-1914, vote accretion :2205-2470, own-vote signing :2471-2549).

Architecture: all mutations flow through `handle_msg`, called either from
the owning thread's `receive_routine` (live mode) or directly by a test
scheduler — the actor model the reference enforces with its
receiveRoutine goroutine (SURVEY §2.3). The TPU data plane is downstream:
votes verify through the crypto seam (crypto/batch + ops/ed25519), and
commits created here are what blocksync's tiled verifier checks in bulk.

WAL discipline (reference state.go:825,833,1890): every message is
WAL-logged BEFORE processing; own votes/proposals and #ENDHEIGHT markers
are fsynced. Crash replay re-feeds messages after the last #ENDHEIGHT
through the same handlers with side effects (broadcast, WAL append)
suppressed.

Port of `cometbft_tpu/consensus/state.py`. What differs: the state machine
takes the device its commit checks run on (`device=`, default cuda) and
hands it to its BlockExecutor, and `_finalize_commit` validates the
decided block (its last commit's signatures on that device) before
applying it, as the reference does and the JAX package does not;
`receive_routine` runs on its own thread
and makes that device the thread's current CUDA device for its whole
life, so no kernel of a commit it finalizes lands on another card. The
WAL is the port's byte-identical copy (`consensus/wal.py`), so either
package replays the other's.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Callable, List, Optional, Union

import torch

from ..device import resolve_device
from ..privval.file import DoubleSignError, PrivValidator
from ..state.execution import BlockExecutor, BlockValidationError
from ..state.state import State
from ..types.block import Block, BlockID, Commit, Part, PartSet
from ..types.proto import Timestamp
from ..types.vote import (Proposal, Vote, PREVOTE_TYPE, PRECOMMIT_TYPE)
from ..types.vote_set import ErrVoteConflictingVotes, VoteError, VoteSet
from .height_vote_set import HeightVoteSet
from .ticker import TimeoutInfo, TimeoutTicker
from .wal import (EndHeightMessage, NilWAL, WALBlockPart, WALProposal,
                  WALTimeout, WALVote)

# RoundStepType (reference internal/consensus/types/round_state.go:14-25)
STEP_NEW_HEIGHT = 1
STEP_NEW_ROUND = 2
STEP_PROPOSE = 3
STEP_PREVOTE = 4
STEP_PREVOTE_WAIT = 5
STEP_PRECOMMIT = 6
STEP_PRECOMMIT_WAIT = 7
STEP_COMMIT = 8


@dataclass
class ConsensusConfig:
    """Timeouts in ms (reference config/config.go consensus section).
    Defaults scaled down from the reference's 3000/1000/1000/1000 — tests
    override smaller still."""
    timeout_propose: int = 3000
    timeout_propose_delta: int = 500
    timeout_prevote: int = 1000
    timeout_prevote_delta: int = 500
    timeout_precommit: int = 1000
    timeout_precommit_delta: int = 500
    timeout_commit: int = 1000
    create_empty_blocks: bool = True
    # start the next height the instant 100% of power has precommitted
    # (reference config.go SkipTimeoutCommit / state.go:2405-2412):
    # with every precommit in hand there is nothing left to gather and
    # the commit timeout is a pure per-block latency floor
    skip_timeout_commit: bool = True

    def propose(self, round_: int) -> int:
        return self.timeout_propose + self.timeout_propose_delta * round_

    def prevote(self, round_: int) -> int:
        return self.timeout_prevote + self.timeout_prevote_delta * round_

    def precommit(self, round_: int) -> int:
        return self.timeout_precommit + self.timeout_precommit_delta * round_


@dataclass(frozen=True)
class ProposalMessage:
    proposal: Proposal


@dataclass(frozen=True)
class BlockPartMessage:
    height: int
    round: int
    part: Part


@dataclass(frozen=True)
class VoteMessage:
    vote: Vote


@dataclass(frozen=True)
class VoteSetMaj23Message:
    """A peer's claim that `block_id` has a 2/3 majority at
    (height, round, type) — reference consensus/types VoteSetMaj23.
    Unlocks VoteSet's conflicting-vote tracking (set_peer_maj23) so an
    equivocator's commit-backed vote can still be admitted after its
    conflicting twin arrived first; without the claim a laggard that
    recorded the wrong twin can NEVER assemble the decided commit and
    wedges at that height forever (found by simnet byzantine-proposer
    seed sweeps)."""
    height: int
    round: int
    type_: int
    block_id: BlockID


@dataclass(frozen=True)
class SealAdoptMessage:
    """An aggregate seal for the receiver's CURRENT height (sealsync's
    consensus-layer leg, docs/SEALSYNC.md): an AggregatedCommit folds
    per-lane signatures away, so a laggard can never reconstruct the
    decided precommits from it — it adopts the seal itself instead.
    The REACTOR verifies the pairing against this node's own validator
    set before injecting (the expensive check stays off the
    single-writer thread); the state machine then treats the height as
    decided and waits only for block parts. Not WAL-logged: like
    VoteSetMaj23Message it is re-derivable — any up-to-date peer
    re-serves it on the next round-state reconcile."""
    commit: Commit


@dataclass(frozen=True)
class _BroadcastMarker:
    """Internal-queue entry: gossip `msg` once the local deliveries
    queued ahead of it have been processed (see
    _broadcast_after_processing)."""
    msg: "Message"


Message = Union[ProposalMessage, BlockPartMessage, VoteMessage,
                VoteSetMaj23Message, SealAdoptMessage, TimeoutInfo]


# Thread-confinement checking (the Python analog of the reference's
# `go test -race` CI runs, SURVEY §5.2): the consensus design's core
# concurrency invariant is that ONLY the receive routine mutates round
# state — every other thread communicates through the inbox. With
# COMETBFT_TPU_THREAD_CHECK=1, RoundState verifies every attribute
# write against its claimed owner thread and raises on a violation, so
# a stray cross-thread mutation fails tests loudly instead of racing
# silently. Off by default the per-write cost is one module-global
# load and a false branch inside __setattr__ (the hook itself stays
# installed so tests can arm the check at runtime).
import os as _os

_THREAD_CHECK = _os.environ.get("COMETBFT_TPU_THREAD_CHECK") == "1"
# violations observed (tests assert 0 after a checked run: a violation
# raised inside the receive routine's generic exception guard would
# otherwise be logged-and-survived); lock-guarded — concurrent
# violators must not undercount
_thread_check_violations = 0
_violation_lock = threading.Lock()


@dataclass
class RoundState:
    """reference internal/consensus/types/round_state.go:65-100."""
    height: int = 0
    round: int = 0
    step: int = STEP_NEW_HEIGHT
    proposal: Optional[Proposal] = None
    proposal_block: Optional[Block] = None
    proposal_block_parts: Optional[PartSet] = None
    # local wall clock when rs.proposal was accepted — what PBTS judges
    # the proposal timestamp against (reference round_state.go:42
    # ProposalReceiveTime, state.go:2069)
    proposal_receive_time: Optional[Timestamp] = None
    locked_round: int = -1
    locked_block: Optional[Block] = None
    locked_block_parts: Optional[PartSet] = None
    valid_round: int = -1
    valid_block: Optional[Block] = None
    valid_block_parts: Optional[PartSet] = None
    votes: Optional[HeightVoteSet] = None
    commit_round: int = -1
    last_commit: Optional[VoteSet] = None
    triggered_timeout_precommit: bool = False
    # aggregate seal adopted for THIS height (sealsync): when set, the
    # commit/finalize paths take its block_id as the decided id instead
    # of a precommit 2/3 majority, and it becomes the seen commit
    adopted_commit: Optional[Commit] = None

    def claim(self, tid: int) -> None:
        """Record thread `tid` as this round state's owner. The claim
        is always recorded; ENFORCEMENT happens in __setattr__ only
        while _THREAD_CHECK is on (so tests can arm the check at
        runtime against claims made earlier)."""
        object.__setattr__(self, "_owner_tid", tid)

    def __setattr__(self, name, value):
        if _THREAD_CHECK:
            owner = getattr(self, "_owner_tid", None)
            if owner is not None and \
                    threading.get_ident() != owner:
                global _thread_check_violations
                with _violation_lock:
                    _thread_check_violations += 1
                raise RuntimeError(
                    f"single-writer violation: RoundState.{name} "
                    f"mutated from thread {threading.get_ident()} "
                    f"(writer is {owner}) — round state may only be "
                    f"touched by the consensus receive routine")
        object.__setattr__(self, name, value)


class ConsensusState:
    """reference internal/consensus/state.go State."""

    def __init__(self, config: ConsensusConfig, state: State,
                 executor: BlockExecutor, block_store,
                 priv_validator: Optional[PrivValidator] = None,
                 wal=None, ticker_cls=TimeoutTicker,
                 name: str = "", metrics=None, device=None):
        self.config = config
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            # pinned here, on the constructing thread: the receive
            # routine's thread must not pick its own current device
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        executor.device = dev
        self.executor = executor
        self.block_store = block_store
        self.priv_validator = priv_validator
        self.wal = wal if wal is not None else NilWAL()
        self.name = name
        self.chain_id = state.chain_id

        self.rs = RoundState()
        self._writer_tid: Optional[int] = None
        self.state = state  # committed state (height = last applied)

        self.inbox: "queue.Queue" = queue.Queue()
        self.ticker = ticker_cls(self._deliver_timeout)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._replaying = False

        # harness/reactor hooks
        self.broadcast: Callable[[Message], None] = lambda msg: None
        self.on_commit: Callable[[Block, Commit], None] = lambda b, c: None
        # double-sign material for the evidence pool (reference
        # state.go:2256 → evpool.AddEvidence)
        self.conflicting_votes: List[ErrVoteConflictingVotes] = []
        self.evidence_pool = None

        # future-(height,round) messages parked until we get there: the
        # reference relies on per-peer gossip routines retransmitting
        # (consensus/reactor.go:570,625); with queue-delivery transports
        # the state machine re-injects instead. Bounded to keep a flooding
        # peer from ballooning memory.
        self._pending: List[tuple] = []
        self._pending_cap = 10000
        # own-message re-entry queue (reference internalMsgQueue) — see
        # handle_msg
        from collections import deque
        self._internal_q: "deque[tuple]" = deque()
        self._in_handle = False

        self._priv_pubkey = (priv_validator.get_pub_key()
                             if priv_validator else None)
        # ConsensusMetrics (reference internal/consensus/metrics.go) —
        # optional: cluster tests and tools run metric-less
        self.metrics = metrics
        self._update_to_state(state)

    # --- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        """Replay the WAL, then run the receive loop in a thread
        (reference state.go OnStart: catchup replay then receiveRoutine)."""
        self.catchup_replay()
        self._thread = threading.Thread(
            target=self.receive_routine,
            name=f"consensus-{self.name}", daemon=True)
        self._thread.start()
        # kick off the first height (reference scheduleRound0)
        self.ticker.schedule(TimeoutInfo(
            0, self.rs.height, 0, STEP_NEW_HEIGHT))

    def stop(self) -> None:
        self._stop.set()
        self.ticker.stop()
        self.inbox.put(None)
        if self._thread is not None:
            self._thread.join(timeout=5)

    def receive_routine(self) -> None:
        """Single writer (reference state.go:778-866)."""
        # declare this thread the round-state owner (thread-confinement
        # checking, see RoundState.claim — the race-detector analog)
        self._writer_tid = threading.get_ident()
        self.rs.claim(self._writer_tid)
        with self.device_context():
            self._receive_loop()

    def device_context(self):
        """Makes the state's device the calling thread's current CUDA
        device for a `with` block (nothing on the CPU)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _receive_loop(self) -> None:
        while not self._stop.is_set():
            msg = self.inbox.get()
            if msg is None:
                break
            try:
                self.handle_msg(msg)
            except DoubleSignError:
                raise  # never continue past a refused signature
            except Exception:  # noqa: BLE001 — a bad peer msg must not
                # kill the loop (reference recovers/logs, state.go:784-800)
                import traceback
                traceback.print_exc()

    def send(self, msg: Message, peer_id: str = "") -> None:
        """Enqueue a message from a peer or self (thread-safe)."""
        self.inbox.put((msg, peer_id) if peer_id else msg)

    def _deliver_timeout(self, ti: TimeoutInfo) -> None:
        self.inbox.put(ti)

    # --- message dispatch ----------------------------------------------------

    def handle_msg(self, msg, peer_id: str = "") -> None:
        """reference state.go:869-926 handleMsg + :988 handleTimeout.

        Reentrant calls (the state machine delivering its OWN proposal,
        parts, and votes from inside a handler — the reference's
        internalMsgQueue) are queued and drained iteratively by the
        OUTERMOST call. Without this, a node that never waits (single
        validator + skip_timeout_commit) chains height N's commit into
        height N+1's proposal on the same Python stack, ~30 frames per
        height, and the consensus thread dies of RecursionError after
        ~35 uninterrupted heights."""
        self._internal_q.append((msg, peer_id))
        if self._in_handle:
            return
        self._in_handle = True
        try:
            # the drain must watch _stop: a solo validator with
            # timeout_commit=0 chains commit -> next proposal with no
            # waiting, so the queue NEVER empties — without this check
            # one outer handle_msg runs the chain forever and stop()
            # can neither join the thread nor reclaim the core
            while self._internal_q and not self._stop.is_set():
                m, pid = self._internal_q.popleft()
                self._handle_one(m, pid)
        finally:
            self._in_handle = False

    def _broadcast_after_processing(self, msg) -> None:
        """Gossip an own message AFTER the local delivery queued ahead
        of it has been processed — broadcasting first would let a vote
        leave the node before its WAL fsync (crash window: peers hold a
        precommit our replay doesn't know; re-signing with a fresh
        timestamp then trips the privval CheckHRS guard)."""
        if self._replaying:
            return
        if self._in_handle:
            self._internal_q.append((_BroadcastMarker(msg), ""))
        else:
            self.broadcast(msg)  # delivery already drained

    def _handle_one(self, msg, peer_id: str = "") -> None:
        if isinstance(msg, tuple):
            msg, peer_id = msg
        if isinstance(msg, _BroadcastMarker):
            self.broadcast(msg.msg)
            return
        if isinstance(msg, TimeoutInfo):
            self._handle_timeout(msg)
            return
        if isinstance(msg, VoteSetMaj23Message):
            # a hint, not a vote: not WAL-logged (a lost claim is
            # re-announced by whichever peer serves the catch-up again)
            self._on_maj23(msg, peer_id)
            return
        if isinstance(msg, SealAdoptMessage):
            # like Maj23, re-derivable: the serving peer re-sends the
            # seal on its next reconcile tick, so no WAL entry
            self._on_seal_adopt(msg)
            return
        if isinstance(msg, ProposalMessage):
            if not self._replaying:
                self.wal.write(WALProposal(msg.proposal, peer_id))
        elif isinstance(msg, BlockPartMessage):
            if not self._replaying:
                self.wal.write(WALBlockPart(
                    msg.height, msg.round, msg.part.index,
                    msg.part.encode(), peer_id))
        elif isinstance(msg, VoteMessage):
            if not self._replaying:
                if peer_id == "":  # own vote: fsync (state.go:825)
                    self.wal.write_sync(WALVote(msg.vote))
                else:
                    self.wal.write(WALVote(msg.vote, peer_id))
        else:
            raise TypeError(f"unknown consensus message {type(msg)}")
        self._dispatch(msg, peer_id)

    def _dispatch(self, msg, peer_id: str) -> None:
        """Route to a handler, parking future-(height,round) messages
        (WAL-logged already — re-injection skips the log)."""
        if self._park_if_future(msg, peer_id):
            return
        if isinstance(msg, ProposalMessage):
            self._set_proposal(msg.proposal)
        elif isinstance(msg, BlockPartMessage):
            self._add_proposal_block_part(msg)
        elif isinstance(msg, VoteMessage):
            self._try_add_vote(msg.vote, peer_id)

    def _park_if_future(self, msg, peer_id: str) -> bool:
        rs = self.rs
        if isinstance(msg, VoteMessage):
            future = msg.vote.height > rs.height
        elif isinstance(msg, ProposalMessage):
            future = (msg.proposal.height, msg.proposal.round) > \
                (rs.height, rs.round)
        elif isinstance(msg, BlockPartMessage):
            future = (msg.height, msg.round) > (rs.height, rs.round)
        else:
            return False
        if future and len(self._pending) < self._pending_cap:
            self._pending.append((msg, peer_id))
            return True
        return future

    def _replay_pending(self) -> None:
        """Re-inject parked messages now deliverable (called on every
        height/round entry; runs on the single-writer thread)."""
        if not self._pending:
            return
        parked, self._pending = self._pending, []
        for msg, peer_id in parked:
            self._dispatch(msg, peer_id)

    def _handle_timeout(self, ti: TimeoutInfo) -> None:
        """reference state.go:988-1040."""
        rs = self.rs
        if ti.height != rs.height or ti.round < rs.round or \
                (ti.round == rs.round and ti.step < rs.step):
            return  # stale
        if not self._replaying:
            self.wal.write(WALTimeout(ti.height, ti.round, ti.step,
                                      ti.duration_ms))
        if ti.step == STEP_NEW_HEIGHT:
            self._enter_new_round(ti.height, 0)
        elif ti.step == STEP_NEW_ROUND:
            self._enter_propose(ti.height, 0)
        elif ti.step == STEP_PROPOSE:
            self._enter_prevote(ti.height, ti.round)
        elif ti.step == STEP_PREVOTE_WAIT:
            self._enter_precommit(ti.height, ti.round)
        elif ti.step == STEP_PRECOMMIT_WAIT:
            self._enter_precommit(ti.height, ti.round)
            self._enter_new_round(ti.height, ti.round + 1)
        elif ti.step == STEP_COMMIT:
            self._commit_retry()

    # --- height/round transitions -------------------------------------------

    def _update_to_state(self, state: State) -> None:
        """Start a new height (reference state.go updateToState
        :1046-1135 analog)."""
        last_precommits = None
        if self.rs.commit_round > -1 and self.rs.votes is not None:
            vs = self.rs.votes.precommits(self.rs.commit_round)
            if vs.has_two_thirds_majority():
                last_precommits = vs
        # reference state.go updateToState: height 0 means pre-genesis
        height = (state.initial_height if state.last_block_height == 0
                  else state.last_block_height + 1)
        self.state = state
        self.rs = RoundState(
            height=height,
            round=0,
            step=STEP_NEW_HEIGHT,
            votes=HeightVoteSet(
                self.chain_id, height, state.validators,
                extensions_enabled=state.consensus_params
                .extensions_enabled(height)),
            last_commit=last_precommits,
        )
        if self._writer_tid is not None:
            self.rs.claim(self._writer_tid)
        if self.metrics is not None:
            self.metrics.height.set(state.last_block_height)
            self.metrics.validators.set(len(state.validators.validators))

    def _proposer_for(self, round_: int):
        vals = self.state.validators
        if round_ == 0:
            return vals.get_proposer()
        return vals.copy_increment_proposer_priority(round_).get_proposer()

    def _is_proposer(self, round_: int) -> bool:
        if self._priv_pubkey is None:
            return False
        prop = self._proposer_for(round_)
        return prop is not None and \
            prop.address == self._priv_pubkey.address()

    def _enter_new_round(self, height: int, round_: int) -> None:
        """reference state.go:1046-1133."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step != STEP_NEW_HEIGHT):
            return
        rs.round = round_
        rs.step = STEP_NEW_ROUND
        if round_ != 0:
            # a new round invalidates the old proposal (reference keeps
            # valid_block for re-proposal)
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
            rs.proposal_receive_time = None
        rs.triggered_timeout_precommit = False
        rs.votes.set_round(round_ + 1)
        if self.metrics is not None:
            self.metrics.rounds.inc(
                reason="new_height" if round_ == 0 else "round_skip")
        self._enter_propose(height, round_)
        self._replay_pending()

    def _enter_propose(self, height: int, round_: int) -> None:
        """reference state.go:1135-1207."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step >= STEP_PROPOSE):
            return
        rs.step = STEP_PROPOSE
        self.ticker.schedule(TimeoutInfo(
            self.config.propose(round_), height, round_, STEP_PROPOSE))
        if self._is_proposer(round_):
            self._decide_proposal(height, round_)
        if self._is_proposal_complete():
            self._enter_prevote(height, round_)

    def _decide_proposal(self, height: int, round_: int) -> None:
        """reference state.go:1209-1264 defaultDecideProposal."""
        rs = self.rs
        if rs.valid_block is not None:
            block, parts = rs.valid_block, rs.valid_block_parts
        else:
            last_commit = self._last_commit_for_proposal(height)
            if last_commit is None:
                return
            block = self.executor.create_proposal_block(
                height, self.state, last_commit,
                self._priv_pubkey.address())
            parts = block.make_part_set()
        block_id = BlockID(block.hash(), parts.header)
        # the proposal carries the BLOCK's timestamp (reference
        # state.go:1243): under PBTS validators check the two are equal
        # and judge the block time by the proposal's arrival
        proposal = Proposal(height=height, round=round_,
                            pol_round=rs.valid_round, block_id=block_id,
                            timestamp=block.header.time)
        try:
            self.priv_validator.sign_proposal(self.chain_id, proposal)
        except DoubleSignError:
            return
        from ..libs.fail import fail_point
        fail_point("propose:signed")  # privval persisted, WAL not yet —
        # the proposer-side crash window (simnet crash schedules target
        # this label; replay must re-release the identical signature)
        # deliver to self through the internal queue path; gossip is
        # queued BEHIND the local delivery (WAL-then-wire ordering)
        self.handle_msg(ProposalMessage(proposal))
        self._broadcast_after_processing(ProposalMessage(proposal))
        for part in parts.parts:
            self.handle_msg(BlockPartMessage(height, round_, part))
            self._broadcast_after_processing(
                BlockPartMessage(height, round_, part))

    def _last_commit_for_proposal(self, height: int) -> Optional[Commit]:
        if height == self.state.initial_height:
            return Commit(height=0, round=0)
        if self.rs.last_commit is not None and \
                self.rs.last_commit.has_two_thirds_majority():
            return self.rs.last_commit.make_commit()
        if self.block_store is not None:
            # restarted or statesynced proposer: the decided commit
            # lives in the store, not in-memory votes (reference
            # state.go:1227 LoadCommit fallback in decideProposal)
            return (self.block_store.load_seen_commit(height - 1)
                    or self.block_store.load_block_commit(height - 1))
        return None

    def _is_proposal_complete(self) -> bool:
        """reference state.go:1266-1283."""
        rs = self.rs
        if rs.proposal is None or rs.proposal_block is None:
            return False
        if rs.proposal.pol_round < 0:
            return True
        return rs.votes.prevotes(
            rs.proposal.pol_round).has_two_thirds_any()

    # --- proposal intake -----------------------------------------------------

    def _set_proposal(self, proposal: Proposal) -> None:
        """reference state.go:2084-2124 defaultSetProposal."""
        rs = self.rs
        if rs.proposal is not None:
            return
        if proposal.height != rs.height or proposal.round != rs.round:
            return
        try:
            proposal.validate_basic()
        except ValueError:
            return
        proposer = self._proposer_for(rs.round)
        if proposer is None:
            return
        sb = proposal.sign_bytes(self.chain_id)
        if not proposer.pub_key.verify_signature(sb, proposal.signature):
            return  # ErrInvalidProposalSignature
        rs.proposal = proposal
        # receive time is re-stamped on WAL replay; that cannot flip our
        # recorded prevote (privval CheckHRS refuses to re-sign), it
        # only affects metrics (reference records ReceiveTime in msgInfo
        # for byte-exact replay — state.go:883)
        rs.proposal_receive_time = Timestamp.now()
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet.new_from_header(
                proposal.block_id.parts)

    def _add_proposal_block_part(self, msg: BlockPartMessage) -> None:
        """reference state.go:2126-2203."""
        rs = self.rs
        if msg.height != rs.height:
            return
        if rs.proposal_block_parts is None:
            return  # no proposal yet; the reference buffers, we drop
        if not rs.proposal_block_parts.add_part(msg.part):
            return
        if not rs.proposal_block_parts.is_complete():
            return
        try:
            block = Block.decode(rs.proposal_block_parts.reassemble())
        except (ValueError, IndexError):
            return
        if rs.step == STEP_COMMIT:
            # catch-up: the part set was allocated from the
            # 2/3-precommitted block_id (enterCommit), possibly while a
            # stale same-height proposal from a later round is still in
            # rs.proposal — authenticate against the decided id, not it
            bid = rs.adopted_commit.block_id \
                if rs.adopted_commit is not None else \
                rs.votes.precommits(rs.commit_round).two_thirds_majority()
            if bid is not None and block.hash() != bid.hash:
                return
        elif rs.proposal is not None and \
                block.hash() != rs.proposal.block_id.hash:
            return  # parts complete but wrong block: proposer lied
        rs.proposal_block = block

        prevotes = rs.votes.prevotes(rs.round)
        bid = prevotes.two_thirds_majority()
        if bid is not None and not bid.is_nil() and rs.valid_round < rs.round:
            if block.hash() == bid.hash:
                rs.valid_round = rs.round
                rs.valid_block = block
                rs.valid_block_parts = rs.proposal_block_parts

        if rs.step <= STEP_PROPOSE and self._is_proposal_complete():
            self._enter_prevote(rs.height, rs.round)
        elif rs.step == STEP_COMMIT:
            self._try_finalize_commit(rs.height)

    # --- prevote -------------------------------------------------------------

    def _enter_prevote(self, height: int, round_: int) -> None:
        """reference state.go:1328-1352."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step >= STEP_PREVOTE):
            return
        rs.step = STEP_PREVOTE
        self._do_prevote(height, round_)

    def _do_prevote(self, height: int, round_: int) -> None:
        """reference state.go:1354-1422 defaultDoPrevote."""
        rs = self.rs
        if rs.locked_block is not None:
            self._sign_add_vote(PREVOTE_TYPE, rs.locked_block.hash(),
                                rs.locked_block_parts.header)
            return
        if rs.proposal_block is None:
            self._sign_add_vote(PREVOTE_TYPE, b"", None)
            return
        if self.state.consensus_params.pbts_enabled(height) and \
                rs.proposal is not None:
            # PBTS (reference state.go:1388-1416): the proposal and
            # block timestamps must agree, and a fresh (non-POL)
            # proposal must have arrived within the synchrony bounds of
            # its own timestamp — otherwise prevote nil
            if rs.proposal.timestamp != rs.proposal_block.header.time:
                self._sign_add_vote(PREVOTE_TYPE, b"", None)
                return
            if rs.proposal.pol_round == -1 and \
                    not self._proposal_is_timely():
                self._sign_add_vote(PREVOTE_TYPE, b"", None)
                return
        try:
            self.executor.validate_block(self.state, rs.proposal_block)
            app_ok = self.executor.process_proposal(
                rs.proposal_block, self.state)
        except (BlockValidationError, Exception):
            app_ok = False
        if app_ok:
            self._sign_add_vote(PREVOTE_TYPE, rs.proposal_block.hash(),
                                rs.proposal_block_parts.header)
        else:
            self._sign_add_vote(PREVOTE_TYPE, b"", None)

    def _proposal_is_timely(self) -> bool:
        """reference state.go:1361-1365 proposalIsTimely."""
        rs = self.rs
        if rs.proposal is None or rs.proposal_receive_time is None:
            return False
        prec, delay = self.state.consensus_params.synchrony_in_round(
            rs.proposal.round)
        return rs.proposal.is_timely(rs.proposal_receive_time, prec, delay)

    def _enter_prevote_wait(self, height: int, round_: int) -> None:
        """reference state.go:1424-1448."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step >= STEP_PREVOTE_WAIT):
            return
        rs.step = STEP_PREVOTE_WAIT
        self.ticker.schedule(TimeoutInfo(
            self.config.prevote(round_), height, round_, STEP_PREVOTE_WAIT))

    # --- precommit -----------------------------------------------------------

    def _enter_precommit(self, height: int, round_: int) -> None:
        """reference state.go:1450-1552."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step >= STEP_PRECOMMIT):
            return
        rs.step = STEP_PRECOMMIT
        bid = rs.votes.prevotes(round_).two_thirds_majority()
        if bid is None:
            # no POL for this round: precommit nil
            self._sign_add_vote(PRECOMMIT_TYPE, b"", None)
            return
        if bid.is_nil():
            # +2/3 prevoted nil: unlock and precommit nil
            rs.locked_round = -1
            rs.locked_block = None
            rs.locked_block_parts = None
            self._sign_add_vote(PRECOMMIT_TYPE, b"", None)
            return
        if rs.locked_block is not None and \
                rs.locked_block.hash() == bid.hash:
            rs.locked_round = round_
            self._sign_add_vote(PRECOMMIT_TYPE, bid.hash, bid.parts)
            return
        if rs.proposal_block is not None and \
                rs.proposal_block.hash() == bid.hash:
            try:
                self.executor.validate_block(self.state, rs.proposal_block)
            except BlockValidationError:
                # +2/3 prevoted an invalid block — cannot happen with <1/3
                # byzantine; do not lock, precommit nil
                self._sign_add_vote(PRECOMMIT_TYPE, b"", None)
                return
            rs.locked_round = round_
            rs.locked_block = rs.proposal_block
            rs.locked_block_parts = rs.proposal_block_parts
            self._sign_add_vote(PRECOMMIT_TYPE, bid.hash, bid.parts)
            return
        # +2/3 prevotes for a block we don't have: unlock, fetch it
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        if rs.proposal_block_parts is None or \
                rs.proposal_block_parts.header != bid.parts:
            rs.proposal_block = None
            rs.proposal_block_parts = PartSet.new_from_header(bid.parts)
        self._sign_add_vote(PRECOMMIT_TYPE, b"", None)

    def _enter_precommit_wait(self, height: int, round_: int) -> None:
        """reference state.go:1554-1580."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.triggered_timeout_precommit):
            return
        rs.triggered_timeout_precommit = True
        self.ticker.schedule(TimeoutInfo(
            self.config.precommit(round_), height, round_,
            STEP_PRECOMMIT_WAIT))

    # --- commit --------------------------------------------------------------

    def _enter_commit(self, height: int, commit_round: int) -> None:
        """reference state.go:1582-1643."""
        rs = self.rs
        if rs.height != height or rs.step >= STEP_COMMIT:
            return
        rs.step = STEP_COMMIT
        rs.commit_round = commit_round
        bid = rs.votes.precommits(commit_round).two_thirds_majority()
        if bid is None or bid.is_nil():
            raise AssertionError("enterCommit without +2/3 precommits")
        if rs.locked_block is not None and \
                rs.locked_block.hash() == bid.hash:
            rs.proposal_block = rs.locked_block
            rs.proposal_block_parts = rs.locked_block_parts
        if rs.proposal_block is None or \
                rs.proposal_block.hash() != bid.hash:
            if rs.proposal_block_parts is None or \
                    rs.proposal_block_parts.header != bid.parts:
                rs.proposal_block = None
                rs.proposal_block_parts = PartSet.new_from_header(bid.parts)
            # waiting for parts: a node parked here is SILENT (it votes
            # no more this height), so nothing would ever trigger the
            # reactor-side laggard catch-up and a lost part would stall
            # it forever — keep poking peers until the block completes
            self._schedule_commit_retry()
            return
        self._try_finalize_commit(height)

    def _schedule_commit_retry(self) -> None:
        self.ticker.schedule(TimeoutInfo(
            max(self.config.timeout_precommit, 500), self.rs.height,
            self.rs.round, STEP_COMMIT))

    def _on_seal_adopt(self, msg: SealAdoptMessage) -> None:
        """Adopt an aggregate seal for the CURRENT height (sealsync,
        docs/SEALSYNC.md). The reactor already settled the pairing
        against this node's own validator set before injecting
        (consensus/reactor.py _on_seal_adopt_wire) — here we take only
        the structural step: treat the height as decided, allocate the
        part set from the sealed block_id, and finalize once the body
        completes. Mirrors _enter_commit minus the 2/3-precommit
        assertion (per-lane votes are folded away in the seal and can
        never be reconstructed)."""
        rs = self.rs
        commit = msg.commit
        if commit.height != rs.height or rs.step >= STEP_COMMIT:
            return
        if self.state.consensus_params.extensions_enabled(rs.height):
            # an adopted seal carries no vote extensions and the next
            # proposer would need them — fall back to vote catch-up
            return
        try:
            commit.validate_basic()
        except ValueError:
            return
        bid = commit.block_id
        if bid.is_nil():
            return
        rs.adopted_commit = commit
        rs.step = STEP_COMMIT
        rs.commit_round = commit.round
        if rs.locked_block is not None and \
                rs.locked_block.hash() == bid.hash:
            rs.proposal_block = rs.locked_block
            rs.proposal_block_parts = rs.locked_block_parts
        if rs.proposal_block is None or \
                rs.proposal_block.hash() != bid.hash:
            if rs.proposal_block_parts is None or \
                    rs.proposal_block_parts.header != bid.parts:
                rs.proposal_block = None
                rs.proposal_block_parts = PartSet.new_from_header(bid.parts)
            self._schedule_commit_retry()
            return
        self._try_finalize_commit(rs.height)

    def _commit_retry(self) -> None:
        """Still in STEP_COMMIT with an incomplete decided block:
        re-broadcast a vote for this height (peers answer votes for
        below-tip heights with the full commit + parts — the catch-up
        path in consensus/reactor.py) and re-arm. A PREVOTE is
        preferred: peers ignore stale precommits for the height right
        below their tip (those are routine straggler votes), but a
        prevote there marks a genuinely stuck node."""
        rs = self.rs
        if rs.step != STEP_COMMIT or rs.proposal_block is not None:
            return
        vote = None
        own_idx = None
        if self._priv_pubkey is not None:
            own_idx, _ = self.state.validators.get_by_address(
                self._priv_pubkey.address())
        for vs in (rs.votes.prevotes(rs.commit_round),
                   rs.votes.precommits(rs.commit_round)):
            if own_idx is not None and own_idx >= 0:
                vote = vs.get_by_index(own_idx)
            if vote is None:
                votes = vs.list_votes()
                vote = votes[0] if votes else None
            if vote is not None:
                break
        if vote is not None and not self._replaying:
            self.broadcast(VoteMessage(vote))
        self._schedule_commit_retry()

    def _try_finalize_commit(self, height: int) -> None:
        """reference state.go:1645-1671."""
        rs = self.rs
        if rs.height != height or rs.step != STEP_COMMIT:
            return
        bid = rs.adopted_commit.block_id \
            if rs.adopted_commit is not None else \
            rs.votes.precommits(rs.commit_round).two_thirds_majority()
        if bid is None or bid.is_nil():
            return
        if rs.proposal_block is None or \
                rs.proposal_block.hash() != bid.hash:
            return
        self._finalize_commit(height)

    def _finalize_commit(self, height: int) -> None:
        """reference state.go:1673-1770 finalizeCommit."""
        rs = self.rs
        block = rs.proposal_block
        parts = rs.proposal_block_parts
        bid = BlockID(block.hash(), parts.header)
        precommits = rs.votes.precommits(rs.commit_round)
        if rs.adopted_commit is not None:
            # sealsync: the seal IS the seen commit — per-lane votes
            # were never reconstructible from it (adoption is refused
            # while vote extensions are enabled, so `extended` below
            # stays None on this path)
            seen_commit = rs.adopted_commit
        else:
            seen_commit = precommits.make_commit()
        extended = None
        if self.state.consensus_params.extensions_enabled(height):
            # persist extensions beside the block: a restarted proposer
            # must still feed them to PrepareProposal for height+1
            # (reference SaveBlockWithExtendedCommit, state.go:1863)
            extended = precommits.make_extended_commit()

        # +2/3 committed it, but the block is validated before anything
        # is stored or the app sees it, its last commit's signatures
        # included (reference state.go finalizeCommit: ValidateBlock
        # before saving, then ApplyVerifiedBlock); the JAX package
        # applies it unchecked. A failure raises out of the handler
        # before the block store, the WAL's EndHeight or the state
        # move, so the height stays uncommitted, as the reference's
        # panic leaves it, and a restart replays it through this check.
        self.executor.validate_block(self.state, block)

        from ..libs.fail import fail_point
        fail_point("finalize:pre-save")              # state.go:1857
        if self.block_store is not None and \
                self.block_store.height() < height:
            self.block_store.save_block(block, parts, seen_commit,
                                        extended_commit=extended)
        fail_point("finalize:post-save")             # state.go:1874

        # the WAL must know the height is decided before the app mutates
        # (reference state.go:1890 WriteSync EndHeightMessage)
        if not self._replaying:
            self.wal.write_sync(EndHeightMessage(height))
        fail_point("finalize:post-endheight")        # state.go:1897

        # deliberately wall clock: measures REAL apply_block compute
        # for the block_processing histogram — virtual time would
        # report 0 under simnet and hide regressions
        _t0 = time.monotonic()  # staticcheck: allow(wallclock)
        new_state, _resp = self.executor.apply_block(
            self.state, bid, block, verified=True)
        if self.metrics is not None:
            self.metrics.block_processing.observe(
                time.monotonic() - _t0)  # staticcheck: allow(wallclock)
        self.on_commit(block, seen_commit)
        self._update_to_state(new_state)
        # schedule the NewHeight timeout: gather more precommits before
        # starting the next round (reference timeout_commit)
        self.ticker.schedule(TimeoutInfo(
            self.config.timeout_commit, self.rs.height, 0,
            STEP_NEW_HEIGHT))

    # --- votes ---------------------------------------------------------------

    def _sign_add_vote(self, type_: int, hash_: bytes, psh) -> None:
        """reference state.go:2471-2549 signAddVote."""
        if self.priv_validator is None:
            return
        addr = self._priv_pubkey.address()
        idx, _val = self.state.validators.get_by_address(addr)
        if idx is None or idx < 0:
            return  # not a validator this height
        rs = self.rs
        bid = BlockID(hash_, psh) if hash_ else BlockID()
        vote = Vote(type_=type_, height=rs.height, round=rs.round,
                    block_id=bid, timestamp=Timestamp.now(),
                    validator_address=addr, validator_index=idx)
        extensions = self.state.consensus_params.extensions_enabled(
            rs.height)
        if extensions and type_ == PRECOMMIT_TYPE and not bid.is_nil():
            # ABCI ExtendVote (reference state.go:2471 signAddVote →
            # app.ExtendVote; the extension rides the precommit)
            try:
                vote.extension = self.executor.app.extend_vote(
                    rs.height, rs.round)
            except Exception:  # noqa: BLE001
                # abstain loudly: signing an empty extension instead
                # would produce a precommit every peer's
                # VerifyVoteExtension rejects — an invisible missed
                # vote (the reference panics here, state.go:2510)
                import traceback
                traceback.print_exc()
                return
        try:
            self.priv_validator.sign_vote(
                self.chain_id, vote, sign_extension=extensions)
        except DoubleSignError:
            return  # never sign conflicting votes; stay silent
        self.handle_msg(VoteMessage(vote))
        self._broadcast_after_processing(VoteMessage(vote))

    def _on_maj23(self, msg: VoteSetMaj23Message, peer_id: str) -> None:
        """reference state.go handleMsg VoteSetMaj23Message →
        HeightVoteSet.SetPeerMaj23.

        The message is unauthenticated and set_peer_maj23 allocates a
        VoteSet per (round, type), so HeightVoteSet bounds claims
        exactly like vote intake: real vote types only, and rounds past
        round+1 charge the peer's 2-catchup-round allowance. A claim
        for the decided commit's round must never be rejected outright
        — the laggard's own round can lag the decision round
        arbitrarily, and dropping the claim re-wedges the very case
        this message exists to unwedge."""
        rs = self.rs
        if msg.height != rs.height or rs.votes is None or msg.round < 0:
            return
        try:
            rs.votes.set_peer_maj23(msg.round, msg.type_,
                                    peer_id or "catchup", msg.block_id)
        except (VoteError, ValueError):
            pass  # bad type / conflicting claim / catchup budget spent

    def _try_add_vote(self, vote: Vote, peer_id: str) -> None:
        """reference state.go:2256-2339 tryAddVote: conflicting votes
        become evidence instead of crashing the loop."""
        try:
            self._add_vote(vote, peer_id)
        except ErrVoteConflictingVotes as err:
            self.conflicting_votes.append(err)
            if self.metrics is not None:
                self.metrics.byzantine_validators.inc()
            if self.evidence_pool is not None:
                self.evidence_pool.add_duplicate_vote(
                    err.vote_a, err.vote_b, self.state)
        except VoteError:
            pass  # bad vote from a peer: drop (the reactor would punish)

    def _add_vote(self, vote: Vote, peer_id: str) -> None:
        """reference state.go:2341-2469 addVote."""
        rs = self.rs
        # precommit for the previous height (late catch-up votes)
        if vote.height + 1 == rs.height and \
                vote.type_ == PRECOMMIT_TYPE:
            if rs.step != STEP_NEW_HEIGHT or rs.last_commit is None:
                return
            rs.last_commit.add_vote(vote)
            if self.config.skip_timeout_commit and \
                    rs.last_commit.has_all():
                # the straggler precommits all arrived: nothing more to
                # gather during timeout_commit (reference state.go:2371)
                self._enter_new_round(rs.height, 0)
            return
        if vote.height != rs.height:
            return

        # ABCI VerifyVoteExtension on peer precommits (reference
        # state.go addVote → blockExec.VerifyVoteExtension). Order
        # matters: authenticate the extension signature against the
        # validator's key FIRST (the main vote signature does not cover
        # the extension — unauthenticated bytes must never reach the
        # app or suppress a valid vote), and skip duplicates so gossip
        # re-deliveries don't cost an app round-trip each.
        if peer_id and vote.type_ == PRECOMMIT_TYPE and \
                not vote.block_id.is_nil() and \
                self.state.consensus_params.extensions_enabled(rs.height):
            existing = rs.votes.precommits(vote.round).get_by_index(
                vote.validator_index)
            if existing is None:
                _idx, val = self.state.validators.get_by_address(
                    vote.validator_address)
                if val is None or not vote.extension_signature or \
                        not val.pub_key.verify_signature(
                            vote.extension_sign_bytes(self.chain_id),
                            vote.extension_signature):
                    raise VoteError("bad vote extension signature")
                try:
                    ok = self.executor.app.verify_vote_extension(
                        vote.height, vote.validator_address,
                        vote.extension)
                except Exception:  # noqa: BLE001
                    ok = False
                if not ok:
                    raise VoteError("app rejected vote extension")

        try:
            rs.votes.add_vote(vote, peer_id)
        except ErrVoteConflictingVotes as err:
            if not err.added:
                raise
            # conflicting but ADDED (a peer claimed a 2/3 majority for
            # this block, so the set tracked it — vote_set.go:301): the
            # vote counts toward that block, so run the transition
            # hooks exactly as the reference does (state.go addVote
            # proceeds when added even with a conflict error), THEN
            # surface the equivocation for the evidence pool
            if vote.type_ == PREVOTE_TYPE:
                self._on_prevote_added(vote)
            else:
                self._on_precommit_added(vote)
            raise
        if vote.type_ == PREVOTE_TYPE:
            self._on_prevote_added(vote)
        else:
            self._on_precommit_added(vote)

    def _on_prevote_added(self, vote: Vote) -> None:
        rs = self.rs
        prevotes = rs.votes.prevotes(vote.round)
        bid = prevotes.two_thirds_majority()
        if bid is not None:
            # unlock if a newer POL exists for a different block
            # (reference state.go:2392-2403)
            if rs.locked_block is not None and \
                    rs.locked_round < vote.round <= rs.round and \
                    rs.locked_block.hash() != bid.hash:
                rs.locked_round = -1
                rs.locked_block = None
                rs.locked_block_parts = None
            # update valid block (reference state.go:2405-2425)
            if not bid.is_nil() and rs.valid_round < vote.round and \
                    vote.round == rs.round:
                if rs.proposal_block is not None and \
                        rs.proposal_block.hash() == bid.hash:
                    rs.valid_round = vote.round
                    rs.valid_block = rs.proposal_block
                    rs.valid_block_parts = rs.proposal_block_parts
                else:
                    rs.proposal_block = None
                    if rs.proposal_block_parts is None or \
                            rs.proposal_block_parts.header != bid.parts:
                        rs.proposal_block_parts = \
                            PartSet.new_from_header(bid.parts)

        if rs.round < vote.round and prevotes.has_two_thirds_any():
            self._enter_new_round(rs.height, vote.round)
        elif rs.round == vote.round and rs.step >= STEP_PREVOTE:
            if bid is not None and \
                    (self._is_proposal_complete() or bid.is_nil()):
                self._enter_precommit(rs.height, vote.round)
            elif prevotes.has_two_thirds_any() and \
                    rs.step == STEP_PREVOTE:
                self._enter_prevote_wait(rs.height, vote.round)
        elif rs.proposal is not None and \
                0 <= rs.proposal.pol_round == vote.round:
            if self._is_proposal_complete():
                self._enter_prevote(rs.height, rs.round)

    def _on_precommit_added(self, vote: Vote) -> None:
        rs = self.rs
        precommits = rs.votes.precommits(vote.round)
        bid = precommits.two_thirds_majority()
        if bid is not None:
            self._enter_new_round(rs.height, vote.round)
            self._enter_precommit(rs.height, vote.round)
            if not bid.is_nil():
                self._enter_commit(rs.height, vote.round)
                if self.config.skip_timeout_commit and \
                        precommits.has_all():
                    # everyone signed: skip the commit timeout — after
                    # _enter_commit finalized, rs is at the next height
                    # in STEP_NEW_HEIGHT, so this starts round 0 now
                    self._enter_new_round(self.rs.height, 0)
            else:
                self._enter_precommit_wait(rs.height, vote.round)
        elif rs.round <= vote.round and precommits.has_two_thirds_any():
            self._enter_new_round(rs.height, vote.round)
            self._enter_precommit_wait(rs.height, vote.round)

    # --- WAL replay ----------------------------------------------------------

    def catchup_replay(self) -> None:
        """Re-feed WAL messages recorded after the last #ENDHEIGHT
        (reference replay.go:95 catchupReplay). Handlers run with
        broadcast and WAL writes suppressed; the privval double-sign
        guard idempotently re-releases identical signatures."""
        msgs = self.wal.replay_messages(self.state.last_block_height)
        if not msgs:
            return
        self._replaying = True
        try:
            # the height must be entered before messages land
            self._enter_new_round(self.rs.height, 0)
            for m in msgs:
                if isinstance(m, EndHeightMessage):
                    continue
                if isinstance(m, WALVote):
                    self._try_add_vote(m.vote, m.peer_id)
                elif isinstance(m, WALProposal):
                    self._set_proposal(m.proposal)
                elif isinstance(m, WALBlockPart):
                    self._add_proposal_block_part(BlockPartMessage(
                        m.height, m.round, Part.decode(m.part)))
                elif isinstance(m, WALTimeout):
                    self._handle_timeout(TimeoutInfo(
                        m.duration_ms, m.height, m.round, m.step))
        finally:
            self._replaying = False
