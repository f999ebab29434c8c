"""File-backed private validator with a double-sign guard
(reference privval/file.go:74-164, CheckHRS at :100-131).

The guard is the consensus-safety core: a validator must never sign two
different votes for the same (height, round, step). FilePV persists its
last-signed state BEFORE releasing a signature, so even a crash between
signing and broadcasting cannot lead to conflicting signatures later.

Step ordering (reference privval/file.go:40-47): propose=1 < prevote=2 <
precommit=3; signing is allowed only at a strictly advancing (H, R, S),
except re-signing the exact same sign-bytes (idempotent retry) or a
timestamp-only change, where the previous signature is returned.

Port of `cometbft_tpu/privval/file.py`: the state file is byte-compatible
both ways (the same JSON keys in the same order, `key_type` included), so
either package loads the other's. Signing is the port's native ed25519.
The remote signer is `privval/remote.py`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Protocol, Tuple

from ..crypto.keys import Ed25519PrivKey, Ed25519PubKey, PubKey
from ..libs import faultio
from ..types import proto
from ..types.vote import Vote, Proposal, PREVOTE_TYPE, PRECOMMIT_TYPE

STEP_NONE = 0
STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3


def vote_to_step(vote_type: int) -> int:
    if vote_type == PREVOTE_TYPE:
        return STEP_PREVOTE
    if vote_type == PRECOMMIT_TYPE:
        return STEP_PRECOMMIT
    raise ValueError(f"unknown vote type {vote_type}")


class DoubleSignError(Exception):
    """Refusing to sign: would conflict with a previous signature at the
    same or earlier (height, round, step)."""


class PrivValidator(Protocol):
    """reference types/priv_validator.go:14-23."""

    def get_pub_key(self) -> PubKey: ...
    def sign_vote(self, chain_id: str, vote: Vote,
                  sign_extension: bool = False) -> None: ...
    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None: ...


@dataclass
class _LastSignState:
    """reference privval/file.go:74-96 FilePVLastSignState."""
    height: int = 0
    round: int = 0
    step: int = STEP_NONE
    signature: bytes = b""
    sign_bytes: bytes = b""

    def check_hrs(self, height: int, round_: int, step: int
                  ) -> bool:
        """Monotonicity guard (reference privval/file.go:100-131).

        Returns True when (H,R,S) equals the last-signed triple AND a
        signature exists — the caller must then only re-release the same
        signature. Raises on any regression.
        """
        if self.height > height:
            raise DoubleSignError(f"height regression: {self.height} > {height}")
        if self.height == height:
            if self.round > round_:
                raise DoubleSignError(
                    f"round regression at height {height}: "
                    f"{self.round} > {round_}")
            if self.round == round_:
                if self.step > step:
                    raise DoubleSignError(
                        f"step regression at {height}/{round_}: "
                        f"{self.step} > {step}")
                if self.step == step:
                    if not self.sign_bytes:
                        raise DoubleSignError(
                            "no sign_bytes recorded for matching HRS")
                    if not self.signature:
                        raise AssertionError(
                            "sign_bytes recorded without signature")
                    return True
        return False


def _only_timestamp_differs(canonical_a: bytes, canonical_b: bytes,
                            strip) -> Tuple[bool, bool]:
    """(same_except_timestamp, identical). `strip` removes the timestamp
    field from a decoded canonical message (reference
    privval/file.go:415-447 checkVotesOnlyDifferByTimestamp)."""
    if canonical_a == canonical_b:
        return True, True
    try:
        return strip(canonical_a) == strip(canonical_b), False
    except Exception:
        return False, False


def _strip_field(sb: bytes, field_num: int) -> bytes:
    """Drop one top-level field from a length-delimited canonical message,
    keeping all other records' raw bytes (order preserved)."""
    ln, pos = proto.read_uvarint(sb, 0)
    body = sb[pos:pos + ln]
    out, i, n = [], 0, len(body)
    while i < n:
        start = i
        key, i = proto.read_uvarint(body, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            _, i = proto.read_uvarint(body, i)
        elif wire == 1:
            i += 8
        elif wire == 2:
            sz, i = proto.read_uvarint(body, i)
            i += sz
        elif wire == 5:
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        if i > n:
            raise ValueError("truncated canonical message")
        if num != field_num:
            out.append(body[start:i])
    return b"".join(out)


def _strip_vote_timestamp(sb: bytes) -> bytes:
    """Remove the timestamp (CanonicalVote field 5)."""
    return _strip_field(sb, 5)


def _strip_proposal_timestamp(sb: bytes) -> bytes:
    """Remove the timestamp (CanonicalProposal field 6)."""
    return _strip_field(sb, 6)


class FilePV:
    """reference privval/file.go:164-284 (key + state in one JSON file
    here; the reference splits them so the state file can live on faster
    storage — same durability contract: state is fsynced before the
    signature is released)."""

    def __init__(self, priv_key: Ed25519PrivKey, state_path: Optional[str],
                 last: Optional[_LastSignState] = None):
        self.priv_key = priv_key
        self.state_path = state_path
        self.last = last or _LastSignState()

    # --- construction / persistence -----------------------------------------

    @classmethod
    def generate(cls, state_path: Optional[str] = None,
                 rng=None) -> "FilePV":
        return cls(Ed25519PrivKey.generate(rng), state_path)

    @classmethod
    def load(cls, state_path: str) -> "FilePV":
        cls._clean_orphan_tmp(state_path)
        with faultio.open_file(state_path, "rb", label="pv:state") as f:
            d = json.loads(f.read())
        from ..crypto.keys import privkey_from_type_bytes
        return cls(
            privkey_from_type_bytes(d.get("key_type", "ed25519"),
                                    bytes.fromhex(d["priv_key"])),
            state_path,
            _LastSignState(
                height=d["height"], round=d["round"], step=d["step"],
                signature=bytes.fromhex(d["signature"]),
                sign_bytes=bytes.fromhex(d["sign_bytes"])))

    @classmethod
    def load_or_generate(cls, state_path: str) -> "FilePV":
        if os.path.exists(state_path):
            return cls.load(state_path)
        cls._clean_orphan_tmp(state_path)
        pv = cls.generate(state_path)
        pv._save()
        return pv

    @staticmethod
    def _clean_orphan_tmp(state_path: str) -> None:
        """A crash between _save's write and its os.replace orphans
        `state_path + ".tmp"`. Discarding it is always safe: _save
        completes (tmp replaced) BEFORE the signature it records is
        released, so an orphaned — possibly torn — tmp never holds a
        sign-state the network could have seen. The committed state
        file stays authoritative; last-sign state never regresses."""
        tmp = state_path + ".tmp"
        if os.path.exists(tmp):
            os.remove(tmp)
            from ..store import recovery  # lazy: cold repair path
            m = recovery.metrics()
            if m is not None:
                m.doctor_repairs.inc(kind="stale-pv-tmp")

    def _save(self) -> None:
        """Atomic write + fsync BEFORE the signature is released — the
        crash-safety half of the double-sign guard (reference
        privval/file.go:437-447 saveSigned → internal/tempfile). The
        temp is the fixed `state_path + ".tmp"` (not mkstemp) so a
        crash between write and replace leaves exactly one orphan the
        doctor / next load can identify and remove."""
        if self.state_path is None:
            return
        data = json.dumps({
            "priv_key": self.priv_key.bytes_().hex(),
            "key_type": self.priv_key.type_(),
            "address": self.priv_key.pub_key().address().hex(),
            "height": self.last.height,
            "round": self.last.round,
            "step": self.last.step,
            "signature": self.last.signature.hex(),
            "sign_bytes": self.last.sign_bytes.hex(),
        }).encode()
        tmp = self.state_path + ".tmp"
        f = faultio.open_file(tmp, "wb", label="pv:state")
        try:
            f.write(data)
            faultio.fsync(f)
        finally:
            f.close()
        os.replace(tmp, self.state_path)

    # --- PrivValidator interface ---------------------------------------------

    def get_pub_key(self) -> Ed25519PubKey:
        return self.priv_key.pub_key()

    def address(self) -> bytes:
        return self.get_pub_key().address()

    def sign_vote(self, chain_id: str, vote: Vote,
                  sign_extension: bool = False) -> None:
        """Sets vote.signature (reference privval/file.go:237 SignVote →
        :308-360 signVote). Raises DoubleSignError on a conflict.
        With sign_extension, non-nil precommits also get
        extension_signature (reference signs both in one SignVote; ed25519
        signing is deterministic so the retry path re-derives identical
        extension bytes)."""
        step = vote_to_step(vote.type_)
        sb = vote.sign_bytes(chain_id)
        same_hrs = self.last.check_hrs(vote.height, vote.round, step)
        if same_hrs:
            ts_only, identical = _only_timestamp_differs(
                self.last.sign_bytes, sb, _strip_vote_timestamp)
            if identical or ts_only:
                vote.signature = self.last.signature
                self._maybe_sign_extension(chain_id, vote, sign_extension)
                return
            raise DoubleSignError(
                f"conflicting vote at {vote.height}/{vote.round}/{step}")
        sig = self.priv_key.sign(sb)
        self._record(vote.height, vote.round, step, sb, sig)
        vote.signature = sig
        self._maybe_sign_extension(chain_id, vote, sign_extension)

    def _maybe_sign_extension(self, chain_id: str, vote: Vote,
                              sign_extension: bool) -> None:
        from ..types.vote import PRECOMMIT_TYPE
        if sign_extension and vote.type_ == PRECOMMIT_TYPE and \
                not vote.block_id.is_nil():
            vote.extension_signature = self.priv_key.sign(
                vote.extension_sign_bytes(chain_id))

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        """reference privval/file.go:262 SignProposal → :363-411."""
        sb = proposal.sign_bytes(chain_id)
        same_hrs = self.last.check_hrs(
            proposal.height, proposal.round, STEP_PROPOSE)
        if same_hrs:
            ts_only, identical = _only_timestamp_differs(
                self.last.sign_bytes, sb, _strip_proposal_timestamp)
            if identical or ts_only:
                proposal.signature = self.last.signature
                return
            raise DoubleSignError(
                f"conflicting proposal at {proposal.height}/{proposal.round}")
        sig = self.priv_key.sign(sb)
        self._record(proposal.height, proposal.round, STEP_PROPOSE, sb, sig)
        proposal.signature = sig

    def _record(self, height: int, round_: int, step: int,
                sign_bytes: bytes, sig: bytes) -> None:
        self.last = _LastSignState(height, round_, step, sig, sign_bytes)
        self._save()

    def __repr__(self) -> str:
        return (f"FilePV{{{self.address().hex()[:12]} "
                f"LH:{self.last.height} LR:{self.last.round} "
                f"LS:{self.last.step}}}")
