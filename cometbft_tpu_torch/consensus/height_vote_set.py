"""Per-height vote bookkeeping across rounds
(reference internal/consensus/types/height_vote_set.go).

Keeps one prevote + one precommit VoteSet per round, lazily created up to
a peer-catchup bound, and tracks which peers claimed 2/3 majorities so
conflicting votes stay bounded (the VoteSet DoS argument).

Copy of `cometbft_tpu/consensus/height_vote_set.py`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..types.vote import Vote, PREVOTE_TYPE, PRECOMMIT_TYPE
from ..types.vote_set import VoteSet
from ..types.block import BlockID


class HeightVoteSet:
    def __init__(self, chain_id: str, height: int, val_set,
                 extensions_enabled: bool = False):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.extensions_enabled = extensions_enabled
        self.round = 0
        self._sets: Dict[Tuple[int, int], VoteSet] = {}
        self._peer_catchup_rounds: Dict[str, list] = {}

    def set_round(self, round_: int) -> None:
        """Make vote sets available up to round_ + 1 (reference
        height_vote_set.go:104)."""
        self.round = max(self.round, round_)

    def _get(self, round_: int, type_: int, create: bool = True
             ) -> Optional[VoteSet]:
        key = (round_, type_)
        vs = self._sets.get(key)
        if vs is None and create:
            # extensions only apply to precommits (types/vote_set.go)
            ext = self.extensions_enabled and type_ == PRECOMMIT_TYPE
            vs = VoteSet(self.chain_id, self.height, round_, type_,
                         self.val_set, extensions_enabled=ext)
            self._sets[key] = vs
        return vs

    def prevotes(self, round_: int) -> VoteSet:
        return self._get(round_, PREVOTE_TYPE)

    def precommits(self, round_: int) -> VoteSet:
        return self._get(round_, PRECOMMIT_TYPE)

    def _check_catchup_round(self, round_: int, peer_id: str) -> None:
        """Peers may touch at most 2 rounds beyond round+1 (reference
        height_vote_set.go:126-151) — the DoS bound on per-round VoteSet
        allocation, shared by vote intake and maj23 claims."""
        if round_ > self.round + 1 and peer_id:
            rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
            if round_ not in rounds:
                if len(rounds) >= 2:
                    raise ValueError(
                        "peer has sent votes for too many catchup rounds")
                rounds.append(round_)

    def add_vote(self, vote: Vote, peer_id: str = "") -> bool:
        """reference height_vote_set.go:126-151: peers may push votes for
        up to 2 catchup rounds beyond the current round."""
        if vote.type_ not in (PREVOTE_TYPE, PRECOMMIT_TYPE):
            raise ValueError(f"bad vote type {vote.type_}")
        self._check_catchup_round(vote.round, peer_id)
        vs = self._get(vote.round, vote.type_)
        return vs.add_vote(vote)

    def pol_info(self) -> Tuple[Optional[BlockID], int]:
        """Highest round with a prevote 2/3 majority (reference
        height_vote_set.go POLInfo)."""
        for r in range(self.round, -1, -1):
            vs = self._get(r, PREVOTE_TYPE, create=False)
            if vs is not None:
                bid = vs.two_thirds_majority()
                if bid is not None:
                    return bid, r
        return None, -1

    def set_peer_maj23(self, round_: int, type_: int, peer_id: str,
                       block_id: BlockID) -> None:
        """A claim may target ANY round the decided commit used (the
        laggard's own round can lag the decision round arbitrarily), so
        it is bounded exactly like vote intake: rounds past round+1
        charge the peer's 2-catchup-round allowance rather than being
        rejected outright — the claim and the commit votes it precedes
        land on the same round and share one slot."""
        if type_ not in (PREVOTE_TYPE, PRECOMMIT_TYPE):
            raise ValueError(f"bad vote type {type_}")
        self._check_catchup_round(round_, peer_id)
        self._get(round_, type_).set_peer_maj23(peer_id, block_id)
