"""Consensus p2p reactor: gossip proposals, block parts, and votes
between live validators (reference internal/consensus/reactor.go —
the DataChannel/VoteChannel split with per-channel priorities; the
reference's three per-peer gossip goroutines become re-broadcast off the
state machine's own outbound hook plus the state machine's parked-message
re-injection for late joiners).

Channels (reference reactor.go:31-38):
  0x21 DataChannel  — proposals + block parts (bulk, lower priority)
  0x22 VoteChannel  — votes (latency-critical, higher priority)
Wire: u8 kind || body. kinds: 1 proposal, 2 block part, 3 vote,
4 round state, 5 maj23 claim, 6 seal adopt (sealsync: an aggregate
seal for the receiver's current height — votes_from_commit cannot
reconstruct lanes from an AggregatedCommit, so the laggard catch-up
serve hands over the seal itself; the receiver pairing-verifies it on
the reactor thread before the state machine adopts).

Port of `cometbft_tpu/consensus/reactor.py` on the port's Switch and
MConnection; the wire bytes are the JAX package's. The seal's pairing
settles on the consensus state's device (`bls_miller_finalexp` on the
card), with that device made current on the connection's receive
thread for the call.
"""

from __future__ import annotations

import threading
from typing import List

from ..libs import timesource
from ..p2p.mconn import ChannelDescriptor
from ..types import proto
from ..types.block import BlockID, Commit, Part
from ..types.vote import Vote, PRECOMMIT_TYPE, PREVOTE_TYPE
from .state import (BlockPartMessage, ConsensusState, Message,
                    ProposalMessage, SealAdoptMessage, VoteMessage,
                    VoteSetMaj23Message)
from .wal import _decode_proposal, _encode_proposal

DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22

_PROPOSAL = 1
_BLOCK_PART = 2
_VOTE = 3
_ROUND_STATE = 4
_MAJ23 = 5
_SEAL_ADOPT = 6  # aggregate seal for the receiver's current height
#                  (sealsync; reactor-verified, never state-broadcast)


class RoundStateMessage:
    """Periodic peer-state summary (the reference's NewRoundStep +
    HasVote bitmaps compressed into one message,
    internal/consensus/reactor.go:570-686): height/round/step plus
    who-has-what bitmaps, so a peer can push exactly what this node is
    missing. Heals dropped broadcasts — without it, gossip here is
    broadcast-once and a lost vote/part has no retransmit path until
    some later event fires."""

    __slots__ = ("height", "round", "step", "has_proposal", "parts",
                 "prevotes", "precommits")

    def __init__(self, height, round_, step, has_proposal, parts,
                 prevotes, precommits):
        self.height = height
        self.round = round_
        self.step = step
        self.has_proposal = has_proposal
        self.parts = parts            # (total, mask int) or None
        self.prevotes = prevotes      # (bits, mask int) or None
        self.precommits = precommits  # (bits, mask int) or None

    @staticmethod
    def _f_bits(tag, pair):
        if pair is None:
            return b""
        bits, mask = pair
        return proto.f_varint(tag, bits) + proto.f_bytes(
            tag + 1, mask.to_bytes((bits + 7) // 8 or 1, "little"))

    def encode(self) -> bytes:
        return (proto.f_varint(1, self.height)
                + proto.f_varint(2, self.round)
                + proto.f_varint(3, self.step)
                + proto.f_varint(4, 1 if self.has_proposal else 0)
                + self._f_bits(5, self.parts)
                + self._f_bits(7, self.prevotes)
                + self._f_bits(9, self.precommits))

    @staticmethod
    def _p_bits(f, tag):
        bits = proto.field_int(f, tag, -1)
        if bits < 0:
            return None
        raw = proto.field_bytes(f, tag + 1, b"\x00")
        return bits, int.from_bytes(raw, "little")

    @classmethod
    def decode(cls, body: bytes) -> "RoundStateMessage":
        f = proto.parse_fields(body)
        return cls(proto.to_int64(proto.field_int(f, 1, 0)),
                   proto.to_int64(proto.field_int(f, 2, 0)),
                   proto.field_int(f, 3, 0),
                   bool(proto.field_int(f, 4, 0)),
                   cls._p_bits(f, 5), cls._p_bits(f, 7),
                   cls._p_bits(f, 9))


def encode_consensus_msg(msg: Message) -> tuple[int, bytes]:
    """-> (channel, wire bytes)."""
    if isinstance(msg, ProposalMessage):
        return DATA_CHANNEL, bytes([_PROPOSAL]) + _encode_proposal(
            msg.proposal)
    if isinstance(msg, BlockPartMessage):
        body = (proto.f_varint(1, msg.height)
                + proto.f_varint(2, msg.round)
                + proto.f_embed(3, msg.part.encode()))
        return DATA_CHANNEL, bytes([_BLOCK_PART]) + body
    if isinstance(msg, VoteMessage):
        return VOTE_CHANNEL, bytes([_VOTE]) + msg.vote.encode()
    if isinstance(msg, VoteSetMaj23Message):
        body = (proto.f_varint(1, msg.height)
                + proto.f_varint(2, msg.round)
                + proto.f_varint(3, msg.type_)
                + proto.f_embed(4, msg.block_id.encode()))
        return VOTE_CHANNEL, bytes([_MAJ23]) + body
    raise TypeError(f"cannot gossip {type(msg)}")


def decode_consensus_msg(raw: bytes) -> Message:
    kind, body = raw[0], raw[1:]
    if kind == _PROPOSAL:
        return ProposalMessage(_decode_proposal(body))
    if kind == _BLOCK_PART:
        f = proto.parse_fields(body)
        return BlockPartMessage(
            proto.to_int64(proto.field_int(f, 1, 0)),
            proto.to_int64(proto.field_int(f, 2, 0)),
            Part.decode(proto.field_bytes(f, 3, b"")))
    if kind == _VOTE:
        return VoteMessage(Vote.decode(body))
    if kind == _MAJ23:
        f = proto.parse_fields(body)
        bid = proto.field_bytes(f, 4, None)
        return VoteSetMaj23Message(
            proto.to_int64(proto.field_int(f, 1, 0)),
            proto.to_int64(proto.field_int(f, 2, 0)),
            proto.field_int(f, 3, 0),
            BlockID.decode(bid) if bid is not None else BlockID())
    raise ValueError(f"unknown consensus wire kind {kind}")


def votes_from_commit(commit: Commit) -> List[Vote]:
    """Reconstruct the signed precommits a Commit attests to (the
    reference's VoteSet-from-commit path, types/vote_set.go
    CommitToVoteSet) — what a lagging peer needs to cross its 2/3
    threshold for an already-decided height. An AggregatedCommit holds
    no per-lane signatures to reconstruct (callers serve Maj23 + block
    parts instead, the same posture as the extensions carve-out
    below)."""
    from ..types.agg_commit import AggregatedCommit
    if isinstance(commit, AggregatedCommit):
        return []
    votes = []
    for idx, cs in enumerate(commit.signatures):
        if cs.absent_():
            continue
        votes.append(Vote(
            type_=PRECOMMIT_TYPE, height=commit.height,
            round=commit.round, block_id=cs.block_id(commit.block_id),
            timestamp=cs.timestamp, validator_address=cs.validator_address,
            validator_index=idx, signature=cs.signature))
    return votes


class ConsensusReactor:
    """p2p.Reactor wrapping a ConsensusState."""

    # catch-up token bucket: burst covers a laggard finalizing a few
    # consecutive heights; the refill rate bounds a hostile sweep
    CATCHUP_BURST = 4
    CATCHUP_REFILL_SECS = 2.0
    # seal-adopt verification bucket: each accepted _SEAL_ADOPT costs a
    # pairing on the reactor thread and the sender is unauthenticated —
    # tighter than the catch-up bucket (one seal decides a height; a
    # laggard needs at most one per refill as it finalizes)
    SEAL_VERIFY_BURST = 2
    SEAL_VERIFY_REFILL_SECS = 2.0

    def __init__(self, cs: ConsensusState):
        self.cs = cs
        self._switch = None
        cs.broadcast = self._broadcast
        # peer.id -> (tokens, last_refill): catch-up token bucket;
        # keeps a stuck peer's once-per-round nil votes from triggering
        # a full commit+parts resend each time
        self._catchup_sent: dict = {}
        # peer.id -> last same-height reconciliation served (see
        # _on_round_state's budget)
        self._reconcile_served: dict = {}
        self._reconcile_thread = None
        self._reconcile_stop = threading.Event()
        # (peer_id, height) -> count of precommits seen at height-1
        self._precommit_strikes: dict = {}
        # peer.id -> (tokens, last_refill) for _SEAL_ADOPT verification
        self._seal_budget: dict = {}

    def attach(self, switch) -> None:
        self._switch = switch

    def get_channels(self) -> List[ChannelDescriptor]:
        # priorities per reference reactor.go:48-77: votes above data
        return [ChannelDescriptor(id=DATA_CHANNEL, priority=10,
                                  send_queue_capacity=1000),
                ChannelDescriptor(id=VOTE_CHANNEL, priority=15,
                                  send_queue_capacity=2000)]

    def add_peer(self, peer) -> None:
        # late joiners catch up via parked-message re-injection plus the
        # blocksync reactor; re-send our latest votes so a restarting
        # peer can finish its round (a slim stand-in for the reference's
        # gossipVotesRoutine)
        rs = self.cs.rs
        if rs.votes is None:
            return
        for vs in (rs.votes.prevotes(rs.round),
                   rs.votes.precommits(rs.round)):
            for vote in vs.list_votes():
                ch, raw = encode_consensus_msg(VoteMessage(vote))
                peer.try_send(ch, raw)

    def remove_peer(self, peer, reason: str) -> None:
        pass

    def receive(self, channel_id: int, peer, raw: bytes) -> None:
        if raw and raw[0] == _ROUND_STATE:
            self._on_round_state(RoundStateMessage.decode(raw[1:]), peer)
            return
        if raw and raw[0] == _SEAL_ADOPT:
            self._on_seal_adopt_wire(raw[1:], peer)
            return
        msg = decode_consensus_msg(raw)
        if isinstance(msg, VoteMessage):
            self._maybe_catchup_peer(msg.vote, peer)
        self.cs.send(msg, peer_id=peer.id)

    # --- periodic peer-state reconciliation ------------------------------

    RECONCILE_SECS = 0.5

    def start_reconciler(self) -> None:
        """Broadcast our round state every RECONCILE_SECS so peers can
        push exactly what we're missing (and vice versa) — the periodic
        analog of the reference's three per-peer gossip goroutines
        (reactor.go:209-211). Idempotent; reads consensus state without
        taking ownership (GIL-atomic snapshots of ints/refs, vote-set
        lookups with create=False so nothing mutates cross-thread)."""
        if self._reconcile_thread is not None:
            return
        self._reconcile_stop = threading.Event()
        self._reconcile_thread = threading.Thread(
            target=self._reconcile_loop, name="cs-reconcile", daemon=True)
        self._reconcile_thread.start()

    def stop(self) -> None:
        if self._reconcile_thread is not None:
            self._reconcile_stop.set()
            self._reconcile_thread.join(timeout=5)
            self._reconcile_thread = None

    def _reconcile_loop(self) -> None:
        while not self._reconcile_stop.wait(self.RECONCILE_SECS):
            if self._switch is None:
                continue
            try:
                msg = self._snapshot_round_state()
            except Exception:  # noqa: BLE001 — racing a height change
                continue
            self._switch.broadcast(
                VOTE_CHANNEL, bytes([_ROUND_STATE]) + msg.encode())

    @staticmethod
    def _sweep_stale(d: dict, now: float, stamp) -> None:
        """Bound a peer-keyed limiter dict: evict entries idle >60s once
        it grows past 4096 (shared by the catch-up token bucket and the
        reconciliation budget — one policy, one sweep)."""
        if len(d) > 4096:
            cutoff = now - 60.0
            for k in [k for k, v in d.items() if stamp(v) <= cutoff]:
                del d[k]

    @staticmethod
    def _peek_bits(votes, round_, type_):
        if votes is None:
            return None
        vs = votes._get(round_, type_, create=False)
        if vs is None:
            return None
        ba = vs.bit_array()
        mask = 0
        for i, w in enumerate(ba.to_words()):
            mask |= w << (64 * i)
        return ba.bits, mask

    def _snapshot_round_state(self) -> RoundStateMessage:
        rs = self.cs.rs
        h, r, step = rs.height, rs.round, rs.step
        parts = None
        psets = rs.proposal_block_parts
        if psets is not None:
            mask = 0
            for i, p in enumerate(psets.parts):
                if p is not None:
                    mask |= 1 << i
            parts = (psets.header.total, mask)
        from ..types.vote import PREVOTE_TYPE as PV, PRECOMMIT_TYPE as PC
        return RoundStateMessage(
            h, r, step, rs.proposal is not None, parts,
            self._peek_bits(rs.votes, r, PV),
            self._peek_bits(rs.votes, r, PC))

    def _on_round_state(self, st: RoundStateMessage, peer) -> None:
        """Push the peer exactly what its summary says it lacks."""
        cs = self.cs
        rs = cs.rs
        if st.height < rs.height:
            # lagging peer: serve the decided height (budgeted)
            self._serve_decided_height(peer, st.height)
            return
        if st.height != rs.height or rs.votes is None:
            return
        # same-height serving is ALSO unauthenticated and can total a
        # full proposal + parts + vote set per message — budget it to
        # the honest reconcile cadence, or a hostile peer looping
        # ~30-byte summaries becomes a bandwidth amplifier (the same
        # attacker model as _serve_decided_height's token bucket)
        now = timesource.monotonic()
        if now - self._reconcile_served.get(peer.id, 0.0) < \
                self.RECONCILE_SECS * 0.8:
            return
        self._sweep_stale(self._reconcile_served, now, lambda t: t)
        self._reconcile_served[peer.id] = now
        from ..types.vote import PREVOTE_TYPE as PV, PRECOMMIT_TYPE as PC
        for type_, theirs in ((PV, st.prevotes), (PC, st.precommits)):
            vs = rs.votes._get(st.round, type_, create=False)
            if vs is None:
                continue
            their_mask = theirs[1] if theirs else 0
            for vote in vs.list_votes():
                if not (their_mask >> vote.validator_index) & 1:
                    ch, raw = encode_consensus_msg(VoteMessage(vote))
                    peer.try_send(ch, raw)
        if rs.round > st.round:
            # help the peer catch up rounds (reference gossipVotes
            # serves higher-round votes): our current round's votes
            for type_ in (PV, PC):
                vs = rs.votes._get(rs.round, type_, create=False)
                if vs is None:
                    continue
                for vote in vs.list_votes():
                    ch, raw = encode_consensus_msg(VoteMessage(vote))
                    peer.try_send(ch, raw)
        if st.round == rs.round and rs.proposal is not None:
            if not st.has_proposal:
                ch, raw = encode_consensus_msg(
                    ProposalMessage(rs.proposal))
                peer.try_send(ch, raw)
            psets = rs.proposal_block_parts
            if psets is not None:
                their_mask = st.parts[1] if st.parts else 0
                for i, part in enumerate(psets.parts):
                    if part is not None and not (their_mask >> i) & 1:
                        ch, raw = encode_consensus_msg(
                            BlockPartMessage(rs.height, rs.round, part))
                        peer.try_send(ch, raw)

    def _maybe_catchup_peer(self, vote: Vote, peer) -> None:
        """A vote for a height below ours means the peer is lagging: feed
        it the decided commit's precommits, then the block parts, from
        the store. Liveness depends on this — gossip here is
        broadcast-once, so a peer that missed a vote or part at height H
        would otherwise cycle rounds at H forever while the rest of the
        cluster moves on (and with <=1/3 of power it can never commit H
        alone). The reference covers this with its per-peer
        gossipDataRoutine/gossipVotesRoutine, which stream old-height
        commits to behind peers (internal/consensus/reactor.go:570,625);
        without per-peer round-state tracking, the laggard's own
        once-per-round vote broadcasts are the trigger instead.

        Order matters: votes first (their 2/3 majority makes the laggard
        enter STEP_COMMIT and allocate the PartSet for the decided
        block_id), then parts (which complete it and finalize)."""
        h = vote.height
        cs = self.cs
        store = cs.block_store
        if h >= cs.rs.height or store is None:
            return
        # precommits for the height just below ours are ROUTINE: after we
        # finalize H and advance to H+1, the stragglers' precommits for H
        # arrive moments later — resending the whole block for each would
        # double steady-state bandwidth. A genuine laggard at H keeps
        # emitting votes for H: prevotes while cycling rounds (trigger
        # immediately), and a node parked in the commit step re-sends a
        # vote every ~500ms via its commit-retry timer — so REPEATED
        # precommits from one peer for the same old height (a straggler
        # sends each vote once) are the other trigger.
        if h == cs.rs.height - 1 and vote.type_ != PREVOTE_TYPE:
            if len(self._precommit_strikes) > 4096:
                self._precommit_strikes.clear()
            key = (peer.id, h)
            strikes = self._precommit_strikes.get(key, 0) + 1
            self._precommit_strikes[key] = strikes
            if strikes < 3:
                return
        self._serve_decided_height(peer, h)

    def _serve_decided_height(self, peer, h: int) -> None:
        """Stream commit votes + block parts for a decided height to a
        lagging peer, under the per-peer token-bucket budget."""
        cs = self.cs
        store = cs.block_store
        if store is None or h >= cs.rs.height:
            return
        if not (store.base() <= h <= store.height()):
            return
        now = timesource.monotonic()
        # the budget is a per-PEER token bucket, not per (peer, height):
        # the triggering vote is unauthenticated, and a per-height limit
        # would let one peer sweep base()..height()-2 with ~100-byte
        # fabricated prevotes and stream a different full block per
        # message — a bandwidth amplifier bounded only by send_rate. A
        # genuine laggard a few heights behind rides the burst (it needs
        # consecutive heights quickly as it finalizes each); a sweeper
        # drains the bucket and is held to one block per refill period.
        # Deep catch-up is blocksync's job, not this path's.
        tokens, last = self._catchup_sent.get(peer.id,
                                              (self.CATCHUP_BURST, now))
        tokens = min(self.CATCHUP_BURST,
                     tokens + (now - last) / self.CATCHUP_REFILL_SECS)
        if tokens < 1.0:
            return
        self._sweep_stale(self._catchup_sent, now, lambda v: v[1])
        self._catchup_sent[peer.id] = (tokens - 1.0, now)
        commit = store.load_seen_commit(h) or store.load_block_commit(h)
        if commit is None:
            return
        # announce the decided block's 2/3 majority FIRST: if the
        # laggard recorded an equivocator's conflicting precommit, the
        # commit's version is rejected as a conflict unless the vote set
        # was told to track this block (set_peer_maj23) — without the
        # claim the laggard can never reassemble the commit and wedges
        # at h forever (simnet byzantine-proposer finding)
        ch, raw = encode_consensus_msg(VoteSetMaj23Message(
            h, commit.round, PRECOMMIT_TYPE, commit.block_id))
        peer.try_send(ch, raw)
        if not cs.state.consensus_params.extensions_enabled(h):
            # reconstructed votes cannot carry extension signatures and
            # extension-checking vote sets reject votes without them, so
            # under extensions only the parts are served — enough for a
            # peer parked in STEP_COMMIT (it already holds 2/3
            # precommits); a rounds-cycling extension-era laggard
            # catches up via blocksync on restart instead
            votes = votes_from_commit(commit)
            for v in votes:
                ch, raw = encode_consensus_msg(VoteMessage(v))
                peer.try_send(ch, raw)
            if not votes:
                # AggregatedCommit: per-lane votes are folded away, so
                # the laggard can never cross a 2/3 threshold from this
                # serve — hand it the seal itself to adopt (sealsync;
                # the receiver pairing-verifies before acting)
                from ..types.agg_commit import AggregatedCommit
                if isinstance(commit, AggregatedCommit):
                    body = (proto.f_varint(1, h)
                            + proto.f_bytes(2, commit.encode()))
                    peer.try_send(VOTE_CHANNEL,
                                  bytes([_SEAL_ADOPT]) + body)
        block = store.load_block(h)
        if block is None:
            return
        # the store keeps raw part bytes; re-chunking the block rebuilds
        # the identical part set (deterministic split + merkle proofs)
        for part in block.make_part_set().parts:
            ch, raw = encode_consensus_msg(
                BlockPartMessage(h, commit.round, part))
            peer.try_send(ch, raw)

    def _on_seal_adopt_wire(self, body: bytes, peer) -> None:
        """Verify a peer-served aggregate seal for our CURRENT height
        and, only if the pairing settles TRUE against our own validator
        set, inject a SealAdoptMessage into the state machine. All
        checks (and the rate limit) run BEFORE any crypto: the sender
        is unauthenticated and each pairing is the priciest single
        check in the node — this runs on the reactor thread precisely
        so a garbage seal can never stall the consensus thread."""
        cs = self.cs
        rs = cs.rs
        f = proto.parse_fields(body)
        h = proto.to_int64(proto.field_int(f, 1, 0))
        if h != rs.height:
            return
        if cs.state.consensus_params.extensions_enabled(h):
            return  # the state machine would refuse; skip the pairing
        now = timesource.monotonic()
        tokens, last = self._seal_budget.get(
            peer.id, (self.SEAL_VERIFY_BURST, now))
        tokens = min(self.SEAL_VERIFY_BURST,
                     tokens + (now - last) / self.SEAL_VERIFY_REFILL_SECS)
        if tokens < 1.0:
            return
        self._sweep_stale(self._seal_budget, now, lambda v: v[1])
        self._seal_budget[peer.id] = (tokens - 1.0, now)
        from ..types.agg_commit import AggregatedCommit
        try:
            commit = Commit.decode(proto.field_bytes(f, 2, b""))
        except (ValueError, IndexError):
            return
        if not isinstance(commit, AggregatedCommit) or \
                commit.height != h:
            return
        from ..aggsig.verify import prepare_full_commit, settle_seals
        from ..pipeline.cache import shared_cache
        vals = cs.state.validators
        needed = vals.total_voting_power() * 2 // 3
        cache = shared_cache()
        try:
            seal = prepare_full_commit(cs.chain_id, vals, commit,
                                       needed, cache=cache)
            with cs.device_context():
                ok = settle_seals([seal], cache=cache, device=cs.device)[0]
        except (ValueError, KeyError):
            ok = False
        if not ok:
            # a structurally-valid seal that fails the pairing is a
            # deliberate forgery, never noise — drop the peer
            if self._switch is not None:
                self._switch.stop_peer(
                    peer, f"forged aggregate seal at height {h}",
                    ban=True)
            return
        cs.send(SealAdoptMessage(commit), peer_id=peer.id)

    def _broadcast(self, msg: Message) -> None:
        if self._switch is None:
            return
        ch, raw = encode_consensus_msg(msg)
        self._switch.broadcast(ch, raw)
