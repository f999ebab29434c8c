"""ABCI conformance grammar: validates that the sequence of ABCI calls
a node made against its application follows the protocol's legal order
(reference test/e2e/pkg/grammar/checker.go, whose gogll grammar encodes
the ABCI spec's connection-interleaving rules; this is a hand-rolled
recursive-descent over the same shape).

Grammar (clean-start and crash-recovery forms):

    start            := clean_start | recovery
    clean_start      := init_chain state_sync? consensus_exec
    state_sync       := attempt* success_sync
    attempt          := offer_snapshot apply_snapshot_chunk*
    success_sync     := offer_snapshot apply_snapshot_chunk+
    recovery         := consensus_exec
    consensus_exec   := consensus_height+
    consensus_height := round* finalize_block commit
    round            := proposer | non_proposer
    proposer         := prepare_proposal process_proposal?
    non_proposer     := process_proposal

Query/mempool-connection calls (info, query, check_tx, echo) run on
their own connections with no ordering contract against consensus
(reference proxy/multi_app_conn.go isolates them), so the recorder
drops them before checking.

Copy of `cometbft_tpu/abci/grammar.py` in the port: the same grammar,
the same verdicts and the same `GrammarError` positions.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

CONSENSUS_CALLS = frozenset({
    "init_chain", "offer_snapshot", "apply_snapshot_chunk",
    "prepare_proposal", "process_proposal", "finalize_block", "commit",
    "extend_vote", "verify_vote_extension",
})


class GrammarError(Exception):
    def __init__(self, pos: int, got: str, expected: str):
        self.pos, self.got, self.expected = pos, got, expected
        super().__init__(
            f"ABCI call #{pos} {got!r}: expected {expected}")


class _Parser:
    def __init__(self, calls: List[str]):
        # extend/verify vote ride inside a height's rounds at times the
        # vote schedule (not the ABCI contract) decides — strip like the
        # reference's checker filters non-grammar calls
        self.calls = [c for c in calls
                      if c not in ("extend_vote", "verify_vote_extension")]
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.calls[self.i] if self.i < len(self.calls) else None

    def eat(self, name: str, expected: str) -> None:
        got = self.peek()
        if got != name:
            raise GrammarError(self.i, got or "<end>", expected)
        self.i += 1

    # --- productions ---------------------------------------------------------

    def start(self, clean_start: bool) -> None:
        if clean_start:
            self.eat("init_chain", "init_chain (clean start)")
            if self.peek() == "offer_snapshot":
                self.state_sync()
        self.consensus_exec()
        if self.i != len(self.calls):
            raise GrammarError(self.i, self.calls[self.i],
                               "<end of execution>")

    def state_sync(self) -> None:
        # attempts may abort mid-chunks; only the LAST attempt must
        # complete with >=1 chunk (the success-sync). Greedy: consume
        # every offer+chunks group, remember whether the final group
        # applied anything.
        last_had_chunks = False
        while self.peek() == "offer_snapshot":
            self.i += 1
            last_had_chunks = False
            while self.peek() == "apply_snapshot_chunk":
                self.i += 1
                last_had_chunks = True
        if not last_had_chunks:
            raise GrammarError(self.i, self.peek() or "<end>",
                               "apply_snapshot_chunk completing the "
                               "final snapshot attempt")

    def consensus_exec(self) -> None:
        self.consensus_height()
        while self.peek() is not None:
            self.consensus_height()

    def consensus_height(self) -> None:
        while self.peek() in ("prepare_proposal", "process_proposal"):
            if self.peek() == "prepare_proposal":
                self.i += 1
                if self.peek() == "process_proposal":
                    self.i += 1
            else:
                self.i += 1
        self.eat("finalize_block", "finalize_block to decide the height")
        self.eat("commit", "commit after finalize_block")


def check_sequence(calls: List[str], clean_start: bool = True
                   ) -> Tuple[bool, Optional[GrammarError]]:
    """Validate a recorded consensus-connection call sequence."""
    try:
        _Parser(list(calls)).start(clean_start)
        return True, None
    except GrammarError as e:
        return False, e


class RecordingApp:
    """Application wrapper logging every consensus-connection call
    (reference test/e2e/app records requests the same way for the
    grammar checker)."""

    def __init__(self, app):
        self._app = app
        self.calls: List[str] = []
        self._lock = threading.Lock()

    def __getattr__(self, name):
        target = getattr(self._app, name)
        if not callable(target) or name not in CONSENSUS_CALLS:
            return target

        def wrapped(*args, **kwargs):
            with self._lock:
                self.calls.append(name)
            return target(*args, **kwargs)
        return wrapped

    def check(self, clean_start: bool = True
              ) -> Tuple[bool, Optional[GrammarError]]:
        with self._lock:
            calls = list(self.calls)
        return check_sequence(calls, clean_start)
