"""Statesync syncer: discover snapshots, offer to the app, stream chunks,
verify against the light-client trust anchor, bootstrap state
(reference internal/statesync/syncer.go:324-366, snapshots.go, chunks.go).

Copy of `cometbft_tpu/statesync/syncer.py` in the port, with its three
catch-alls narrowed. The JAX package turns any exception of a source, a
candidate or the light client into "try the next one"; there a kernel
build or launch error, or a `KernelCanaryError` raised inside the light
client's verify, would vanish. Here only the peers' faults do:

- a source's listing or chunk transport error (`SOURCE_ERRORS`: an
  `OSError`, which `ConnectionError` and `TimeoutError` are) drops that
  source or candidate;
- the light client's and provider's errors (`light.PEER_ERRORS`) make a
  snapshot unanchorable;
- a chunk or snapshot the app refuses.

Each of these becomes `StateSyncError`. Anything else, an error of the
node's own app connection included, propagates out of `sync()`.
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Tuple

from ..abci.application import Snapshot
from ..light import PEER_ERRORS
from ..state.state import State

# a snapshot source's transport failing (the peer's fault)
SOURCE_ERRORS = (OSError,)


class StateSyncError(Exception):
    pass


class SnapshotSource(Protocol):
    """Where snapshots/chunks come from — an in-process app, or the p2p
    statesync channel (the reference's per-peer snapshot requests)."""

    def list_snapshots(self) -> List[Snapshot]: ...
    def fetch_chunk(self, height: int, format_: int,
                    chunk: int) -> bytes: ...


class AppSnapshotSource:
    """Serve snapshots straight from a peer's Application (the
    in-process stand-in for the statesync channel)."""

    def __init__(self, app):
        self.app = app

    def list_snapshots(self) -> List[Snapshot]:
        return self.app.list_snapshots()

    def fetch_chunk(self, height: int, format_: int, chunk: int) -> bytes:
        return self.app.load_snapshot_chunk(height, format_, chunk)


class Syncer:
    """reference internal/statesync/syncer.go syncer."""

    def __init__(self, app, state_provider, sources: List[SnapshotSource]):
        self.app = app
        self.state_provider = state_provider
        self.sources = list(sources)
        # (height, reason) of each candidate that failed, in order
        self.refused: List[Tuple[int, str]] = []

    def discover(self) -> List[Tuple[Snapshot, SnapshotSource]]:
        """Collect candidate snapshots, best (highest) first
        (snapshots.go snapshotPool.Best)."""
        found = []
        for src in self.sources:
            try:
                for snap in src.list_snapshots():
                    found.append((snap, src))
            except SOURCE_ERRORS:
                continue  # a bad peer must not abort discovery
        found.sort(key=lambda s: (-s[0].height, s[0].format))
        return found

    def sync(self) -> State:
        """Try candidates until one restores (syncer.go:324 SyncAny).
        Returns the bootstrapped State; the caller hands it to consensus
        or blocksync for the remaining heights."""
        candidates = self.discover()
        if not candidates:
            raise StateSyncError("no snapshots discovered")
        last_err: Optional[Exception] = None
        for snap, src in candidates:
            try:
                return self._try_one(snap, src)
            except StateSyncError as e:
                # a peer's fault: try the next candidate
                self.refused.append((snap.height, str(e)))
                last_err = e
        raise StateSyncError(f"all snapshots failed: {last_err}")

    def _try_one(self, snap: Snapshot, src: SnapshotSource) -> State:
        # trust anchor AND bootstrap state FIRST: both only read the
        # light client, so an unanchorable candidate (e.g. too close to
        # the tip for the height+2 header) fails BEFORE the app mutates
        # (syncer.go:366 verifies before applying chunks)
        try:
            app_hash = self.state_provider.app_hash(snap.height)
            boot_state = self.state_provider.state(snap.height)
        except PEER_ERRORS as e:
            raise StateSyncError(
                f"cannot anchor snapshot at {snap.height}: {e!r}") from e
        verdict = self.app.offer_snapshot(snap, app_hash)
        if verdict != "ACCEPT":
            raise StateSyncError(f"app rejected snapshot: {verdict}")
        for i in range(snap.chunks):
            try:
                chunk = src.fetch_chunk(snap.height, snap.format, i)
            except SOURCE_ERRORS as e:
                raise StateSyncError(f"chunk {i}: {e!r}") from e
            verdict = self.app.apply_snapshot_chunk(i, chunk, "")
            if verdict == "ACCEPT":
                continue
            if verdict == "COMPLETE":
                break
            raise StateSyncError(
                f"chunk {i} verdict {verdict} — snapshot abandoned")
        else:
            raise StateSyncError("chunks exhausted without COMPLETE")

        # app restored: double-check Info agrees with the anchor
        info = self.app.info()
        if info.last_block_height != snap.height or \
                info.last_block_app_hash != app_hash:
            raise StateSyncError(
                "restored app disagrees with light-verified app hash")
        return boot_state
