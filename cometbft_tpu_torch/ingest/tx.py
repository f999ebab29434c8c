"""Signed-tx envelope: the wire form that makes mempool admission a
batch-verifiable workload.

The reference treats txs as opaque bytes and leaves authentication to
the app — which forces CheckTx to the app round trip for every tx and
gives the device nothing to batch. This envelope carries the ed25519
authentication OUTSIDE the app payload, so the admission pipeline can
coalesce many concurrent txs' signature checks into one device batch
(the FPGA verification-engine shape of arXiv 2112.02229: an admission
front end feeding an offload-friendly signature stream) while the app
keeps seeing exactly the payload semantics it had before.

Wire layout (all fixed offsets — no parser state, no allocation):

    magic(4) | pubkey(32) | signature(64) | payload(...)

Sign bytes are domain-separated (`SIGN_DOMAIN || payload`) so a tx
signature can never be confused with a vote/proposal signature over
the same bytes. Bare txs (no magic) carry no signature work and flow
through admission untouched — the envelope is opt-in per tx.

Copy of `cometbft_tpu/ingest/tx.py` (the port keeps its own).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

MAGIC = b"\xf1TX1"
PUB_SIZE = 32
SIG_SIZE = 64
HEADER_SIZE = len(MAGIC) + PUB_SIZE + SIG_SIZE
SIGN_DOMAIN = b"cometbft-tpu/sigtx\n"


class MalformedTx(ValueError):
    """Envelope magic present but the frame is too short to hold the
    fixed pubkey+signature header — structurally invalid, rejected
    before any signature or app work."""


@dataclass(frozen=True)
class SignedTx:
    pub: bytes
    sig: bytes
    payload: bytes


def sign_bytes(payload: bytes) -> bytes:
    """The message a signed tx's signature covers."""
    return SIGN_DOMAIN + payload


def make_signed_tx(priv, payload: bytes) -> bytes:
    """Assemble an envelope tx signed by `priv` (crypto PrivKey)."""
    return (MAGIC + priv.pub_key().bytes_()
            + priv.sign(sign_bytes(payload)) + payload)


def parse_signed_tx(tx: bytes) -> Optional[SignedTx]:
    """SignedTx when the envelope magic is present, None for a bare tx.
    Raises MalformedTx on a magic-prefixed frame too short to hold the
    header."""
    if not tx.startswith(MAGIC):
        return None
    if len(tx) < HEADER_SIZE:
        raise MalformedTx(
            f"signed tx header is {HEADER_SIZE} bytes, got {len(tx)}")
    at = len(MAGIC)
    return SignedTx(pub=tx[at:at + PUB_SIZE],
                    sig=tx[at + PUB_SIZE:HEADER_SIZE],
                    payload=tx[HEADER_SIZE:])


def unwrap_payload(tx: bytes) -> bytes:
    """The app-visible payload: envelope txs shed their header, bare
    txs pass through. Raises MalformedTx on a truncated envelope."""
    parsed = parse_signed_tx(tx)
    return tx if parsed is None else parsed.payload
