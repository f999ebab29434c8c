"""Blocksync: catch-up by fetching blocks and verifying commits in bulk —
the north-star hot loop (reference internal/blocksync/reactor.go:429-547,
pool.go:71-96).

TPU-native redesign: instead of one BatchVerifier per commit (≤ valset-size
signatures per device call, reference types/validation.go:218), the
`TiledCommitVerifier` accumulates signatures ACROSS a tile of consecutive
commits and flushes them as one large device batch — the cross-block
tiling of BASELINE.json. Safety order is preserved: a block is applied
only after (a) its commit's signatures verified against the validator set
speculated for its height AND (b) full header validation against executed
state confirms that speculation ((b) is `validate_block`'s
validators_hash check; on mismatch the commit is re-verified synchronously
against the true set — speculation can only waste work, never admit a bad
block).

The tile stages — fetch (`_fetch_range`), marshal (`marshal_commit`),
lane verify (`verify_lanes`), verdict settle (`settle_tile`), and
per-height apply (`_apply_one`) — are standalone so the asynchronous
pipeline of the JAX package (`pipeline/scheduler.py`) composes the SAME
stages with K tiles in flight; `pipeline_depth=1` is the synchronous
degenerate case and this module's `_sync_tile` loop.

Port of `cometbft_tpu/engine/blocksync.py`. What differs:
- the device is an argument (`device=`, default cuda, resolved once by
  `BlocksyncReactor` and `TiledCommitVerifier`) and is passed down to
  `verify_batch`, to the respeculation's `verify_commit` and to the
  pipeline's in-process verify backend; the JAX package takes it from
  the process;
- with `pipeline_depth > 1` and a backend that verifies in this
  process (none given, or one that does not declare the device link's
  `drain_on`), the reactor builds and warms the kernels of its batch
  bucket when it is constructed on cuda (`prewarm_verify_kernels`), so
  no first build or first launch lands inside a dispatch under the
  watchdog's deadline, where a miss raises;
- a commit over a non-ed25519 or mixed validator set is verified at
  marshal through `validation.verify_commit` (its `MixedBatchVerifier`
  sends the ed25519 lanes to `device`) and settles as an
  `aggsig.verify.AggSeal("ok"|"fail")`, as in the JAX package;
- an aggregated (BLS) commit is marshaled by `aggsig.verify.
  prepare_full_commit`, and `settle_tile` settles the tile's pending
  pairing equations in one `settle_seals` call on `device` (the fused
  `bls_miller_finalexp` kernel on the card);
- mesh routing (COMETBFT_TPU_MESH_VERIFY exactly "1" on a host with
  more than one card, the JAX package's `mesh_available`) raises
  NotImplementedError naming its ROADMAP.md item (mesh and multi-GPU).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from ..aggsig.verify import AggSeal, prepare_full_commit, settle_seals
from ..device import resolve_device
from ..ops.ed25519 import prewarm_verify_kernels, verify_batch
from ..state.execution import BlockExecutor, BlockValidationError
from ..state.state import State
from ..store.blockstore import BlockStore
from ..trace import shared_tracer
from ..types import validation
from ..types.agg_commit import AggregatedCommit
from ..types.block import Block, BlockID
from ..types.validator import ValidatorSet


class PeerSource(Protocol):
    """Block provider: the seam where the p2p pool plugs in
    (reference internal/blocksync/pool.go bpRequester)."""

    def max_height(self) -> int: ...
    def fetch(self, height: int) -> Optional[Tuple[Block, BlockID]]: ...
    def ban(self, height: int) -> None:
        """Report a bad block at `height` (peer sent garbage)."""


@dataclass
class TileEntry:
    height: int
    block: Block
    block_id: BlockID
    valset: ValidatorSet        # speculated set for this height
    commit: object = None       # the sealing Commit (block height+1's)
    commit_ok: Optional[bool] = None


def marshal_commit(chain_id: str, e: TileEntry, pubs: List[bytes],
                   msgs: List[bytes], sigs: List[bytes], cache=None,
                   device=None):
    """Marshal one commit's non-absent signatures into the lane lists;
    returns (entry, rows, needed) with rows=None on structural
    rejection. Each row is (lane, power, counted); lane=-1 marks a
    verified-signature-cache hit that occupies no device lane. An
    aggregated commit, or a commit over a non-ed25519 or mixed set, adds
    no lanes: rows is then an `AggSeal`, and `device` is where a mixed
    set's ed25519 lanes verify.

    Standalone (not a verifier method) because this IS the pipeline's
    host marshal stage: the scheduler runs it for tile N+1 while the
    device verifies tile N's lanes."""
    commit = e.commit
    vals = e.valset
    if len(vals) != len(commit.signatures):
        return e, None, 0
    if commit.height != e.height or commit.block_id != e.block_id:
        return e, None, 0
    needed = vals.total_voting_power() * 2 // 3
    if isinstance(commit, AggregatedCommit):
        # BLS aggregate seal: the whole-commit check is marshaled here
        # (structure, tally, PoP gate, pair grouping — all host work,
        # exactly this stage's job) and the pairing equation itself —
        # Miller loops AND final exponentiation — is left for
        # settle_tile, which batches it across the tile
        return e, prepare_full_commit(chain_id, vals, commit, needed,
                                      cache=cache), needed
    if any(v.pub_key.type_() != "ed25519" for v in vals.validators):
        # plain per-lane commit on a non-ed25519 (or mixed) valset:
        # the flat lanes below feed the ed25519 kernels, which reject
        # every foreign-curve signature. Verify it here with full
        # semantics through the generic dispatch seam instead (its
        # MixedBatchVerifier batches the ed25519 lanes on `device`);
        # the verdict is decided before settle time (AggSeal
        # "ok"/"fail", no pending work)
        try:
            validation.verify_commit(chain_id, vals, e.block_id,
                                     e.height, commit, device=device)
            return e, AggSeal("ok", None), needed
        except validation.CommitVerificationError:
            return e, AggSeal("fail", None), needed
    rows = []
    for idx, cs in enumerate(commit.signatures):
        if cs.absent_():
            continue
        try:
            cs.validate_basic()
        except ValueError:
            return e, None, 0
        val = vals.get_by_index(idx)
        msg = commit.vote_sign_bytes(chain_id, idx)
        pkb = val.pub_key.bytes_()
        if cache is not None and cache.seen(pkb, msg, cs.signature,
                                            path="blocksync"):
            rows.append((-1, val.voting_power, cs.for_block()))
            continue
        row = len(pubs)
        pubs.append(pkb)
        msgs.append(msg)
        sigs.append(cs.signature)
        rows.append((row, val.voting_power, cs.for_block()))
    return e, rows, needed


def verify_lanes(pubs: Sequence[bytes], msgs: Sequence[bytes],
                 sigs: Sequence[bytes], batch_size: int,
                 device=None) -> np.ndarray:
    """Per-lane verdicts for flat (pub, msg, sig) triples — the device
    path selection of the tile verifier. `device` is where the RLC
    batch runs (default cuda)."""
    if not pubs:
        return np.zeros((0,), dtype=bool)
    if batch_size <= 0 or len(pubs) < validation.BATCH_VERIFY_THRESHOLD:
        # batch_size<=0 = no device; small tiles take this path too,
        # where a device dispatch costs more than it saves
        from ..crypto.keys import Ed25519PubKey
        return np.array([
            len(p) == 32 and Ed25519PubKey(p).verify_signature(m, s)
            for p, m, s in zip(pubs, msgs, sigs)], dtype=bool)
    if mesh_available():
        # the JAX package routes lanes over every local chip
        # (parallel/verify.verify_batch_mesh) here
        raise NotImplementedError(
            "mesh verification is not ported yet (ROADMAP.md Queue 1: "
            "mesh and multi-GPU)")
    return verify_batch(pubs, msgs, sigs, batch_size=batch_size,
                        device=device)


def mesh_available() -> bool:
    """True when mesh routing is enabled (COMETBFT_TPU_MESH_VERIFY is
    exactly "1") AND more than one card is present: the rule of the JAX
    package's `parallel/verify.py:mesh_available`. Otherwise lanes
    verify on one device."""
    if os.environ.get("COMETBFT_TPU_MESH_VERIFY") != "1":
        return False
    return torch.cuda.device_count() > 1


def settle_tile(metas, out, pubs, msgs, sigs, cache=None,
                device=None) -> None:
    """Map per-lane verdicts back to per-commit results with FULL
    verify_commit semantics (every included signature valid AND for-block
    power > 2/3); newly verified-true lanes feed the cache. Commits
    marshaled as AggSeals settle in ONE batched pairing call (Miller
    loops + final exp) for the whole tile, on `device`."""
    agg = [(e, rows) for e, rows, _n in metas
           if isinstance(rows, AggSeal)]
    if agg:
        for (e, _s), ok in zip(agg, settle_seals([s for _e, s in agg],
                                                 cache=cache,
                                                 device=device)):
            e.commit_ok = ok
    for e, rows, needed in metas:
        if isinstance(rows, AggSeal):
            continue
        if rows is None:  # structural failure already decided
            e.commit_ok = False
            continue
        all_valid = all(r < 0 or out[r] for r, _p, _c in rows)
        tallied = sum(p for r, p, counted in rows if counted)
        e.commit_ok = all_valid and tallied > needed
        if cache is not None:
            for r, _p, _c in rows:
                if r >= 0 and out[r]:
                    cache.add(pubs[r], msgs[r], sigs[r])


class TiledCommitVerifier:
    """Flatten the non-absent signatures of many commits into one device
    batch; per-lane verdicts map back to per-commit results."""

    def __init__(self, chain_id: str, batch_size: int = 4096, cache=None,
                 device=None):
        self.chain_id = chain_id
        self.batch_size = batch_size
        self.cache = cache  # pipeline.cache.SigCache or None
        self.device = resolve_device(device)

    def verify_tile(self, entries: Sequence[TileEntry]) -> None:
        """Sets entry.commit_ok per entry with FULL verify_commit
        semantics (reference types/validation.go:26-53): absent sigs
        ignored, every included signature (block AND nil votes) must be
        valid, and the for-block voting power must exceed 2/3. Full
        semantics here is what lets the apply path skip per-commit
        re-verification entirely."""
        pubs: List[bytes] = []
        msgs: List[bytes] = []
        sigs: List[bytes] = []
        metas = [marshal_commit(self.chain_id, e, pubs, msgs, sigs,
                                self.cache, self.device) for e in entries]
        out = verify_lanes(pubs, msgs, sigs, self.batch_size, self.device)
        settle_tile(metas, out, pubs, msgs, sigs, self.cache, self.device)


@dataclass
class SyncStats:
    blocks_applied: int = 0
    sigs_verified: int = 0
    tiles_flushed: int = 0
    respeculations: int = 0


class SyncStalled(Exception):
    """The peer source cannot currently provide the next needed block."""


class TileApplyError(Exception):
    """A block failed commit/header verification during apply; carries
    the offending height so the caller can ban and decide whether the
    partial progress stands."""

    def __init__(self, height: int, msg: str):
        super().__init__(msg)
        self.height = height


class BlocksyncReactor:
    """Sequential-apply, tile-verified catch-up loop
    (reference internal/blocksync/reactor.go poolRoutine).

    With `pipeline_depth` > 1 the tile loop runs through
    `pipeline/scheduler.PipelinedBlocksync` — same stages, K tiles in
    flight, apply still strictly sequential. depth=1 keeps this module's
    synchronous loop (the degenerate case). `device` (default cuda) is
    where tiles batch-verify; the executor carries its own for the
    commits it re-verifies."""

    def __init__(self, executor: BlockExecutor, store: BlockStore,
                 source: PeerSource, chain_id: str, tile_size: int = 32,
                 batch_size: int = 4096, max_retries: int = 3,
                 pipeline_depth: int = 1, backend=None, watchdog=None,
                 cache=None, metrics=None, supervisor=None, device=None):
        self.executor = executor
        self.store = store
        self.source = source
        self.verifier = TiledCommitVerifier(chain_id, batch_size,
                                            cache=cache, device=device)
        self.tile_size = tile_size
        self.max_retries = max_retries
        self.pipeline_depth = pipeline_depth
        self.backend = backend      # pipeline verify backend (optional)
        self.watchdog = watchdog    # pipeline.watchdog.DeviceWatchdog
        self.cache = cache          # pipeline.cache.SigCache
        self.metrics = metrics      # libs/metrics_gen.PipelineMetrics
        self.supervisor = supervisor  # device/health.DeviceSupervisor
        self.stats = SyncStats()
        if (pipeline_depth > 1 and not getattr(backend, "drain_on", ())
                and batch_size > 0 and self.verifier.device.type == "cuda"):
            # an in-process backend verifies under the watchdog's
            # deadline, and a miss raises: build and warm its kernels
            # now, not there
            prewarm_verify_kernels(batch_size, device=self.verifier.device)
        # [height, commit, digest|None] of the last tile-verified seal,
        # keyed by the height of the block that CARRIES it as last_commit.
        # Applying a block skips last-commit signature re-verification only
        # when its last_commit bytes are the very bytes the tile verifier
        # checked — enforced, not assumed: blocks at tile boundaries are
        # re-fetched (possibly from another peer), so a mismatch falls
        # back to the reference behavior of a full VerifyCommit
        # (reference state/validation.go:94). "Same bytes" is decided by
        # object identity first (the common case: the seal we verified IS
        # the next block's last_commit from the same fetch) and by a
        # lazily computed sha256 over the encoding otherwise — commit
        # re-encoding per height dominated the sequential apply stage.
        self._verified_seal: Optional[list] = None

    def sync(self, state: State, target_height: Optional[int] = None
             ) -> State:
        """Catch up to target; bad blocks ban the peer and the tile is
        retried against (presumably re-routed) fetches, bounded by
        max_retries (reference reactor.go:498-513 bans + requeues)."""
        target = target_height or self.source.max_height()
        pipe = None
        step = self._sync_tile
        if self.pipeline_depth > 1:
            from ..pipeline.scheduler import PipelinedBlocksync
            pipe = PipelinedBlocksync(
                self, depth=self.pipeline_depth, backend=self.backend,
                watchdog=self.watchdog, metrics=self.metrics,
                supervisor=self.supervisor)
            step = pipe.run
        retries = 0
        try:
            while state.last_block_height < target:
                try:
                    state = step(state, target)
                    retries = 0
                except (BlockValidationError, SyncStalled):
                    retries += 1
                    if retries > self.max_retries:
                        raise
        finally:
            if pipe is not None:
                pipe.close()
        return state

    # --- stages shared with pipeline/scheduler ----------------------------

    def _stall_msg(self, height: int) -> str:
        msg = f"source cannot provide block {height}"
        pend = getattr(self.source, "pending_fetches", None)
        if pend is not None:
            msg += (f" (stalled at height {height}, "
                    f"{pend()} fetches pending)")
        return msg

    def _fetch_range(self, start: int, target: int
                     ) -> Tuple[Dict[int, Tuple[Block, object, BlockID]],
                                int]:
        """Fetch blocks start..end plus end+1 (its LastCommit seals block
        end; a peer at the tip serves its seen-commit as a synthetic
        successor). Part sets / block ids are computed ONCE here — the
        advertised peer block_id is never trusted. Raises SyncStalled
        when not even (start, start+1) can be served."""
        end = min(start + self.tile_size - 1, target)
        fetched: Dict[int, Tuple[Block, object, BlockID]] = {}
        for h in range(start, end + 2):
            got = self.source.fetch(h)
            if got is None:
                end = h - 2
                break
            block = got[0]
            if h <= end:
                parts = block.make_part_set()
                fetched[h] = (block, parts,
                              BlockID(block.hash(), parts.header))
            else:
                fetched[h] = (block, None, BlockID())
        if end < start:
            raise SyncStalled(self._stall_msg(start))
        return fetched, end

    def _apply_one(self, state: State, h: int, block: Block, parts,
                   block_id: BlockID, seal_commit,
                   e: Optional[TileEntry]) -> State:
        """Verify + apply ONE block at height h; raises TileApplyError
        on a bad commit/block (caller bans and decides about partial
        progress). Shared verbatim by the synchronous tile loop and the
        pipeline's sequential apply stage."""
        used_ok = None
        if e is not None and e.valset.hash() == state.validators.hash():
            used_ok = e.commit_ok
        if used_ok is None:
            # speculation miss (valset changed mid-tile or header
            # announced a change): verify synchronously, full
            # semantics, against the true set
            self.stats.respeculations += 1
            try:
                validation.verify_commit(
                    self.verifier.chain_id, state.validators, block_id,
                    h, seal_commit, device=self.verifier.device)
                used_ok = True
            except validation.CommitVerificationError:
                used_ok = False
        if not used_ok:
            raise TileApplyError(
                h, f"invalid commit for height {h} from peer")

        seal = self._verified_seal
        seal_checked = False
        if seal is not None and seal[0] == h:
            if seal[1] is block.last_commit:
                seal_checked = True  # identical object => identical bytes
            else:
                if seal[2] is None:
                    seal[2] = hashlib.sha256(seal[1].encode()).digest()
                lc_digest = hashlib.sha256(
                    block.last_commit.encode()).digest()
                seal_checked = seal[2] == lc_digest
        try:
            self.executor.validate_block(
                state, block, check_commit=not seal_checked)
        except (BlockValidationError,
                validation.CommitVerificationError) as exc:
            raise TileApplyError(
                h, f"invalid block at height {h}: {exc}") from exc

        self.store.save_block(block, parts, seal_commit)
        state, _resp = self.executor.apply_block(
            state, block_id, block, verified=True)
        self._verified_seal = [h + 1, seal_commit, None]
        self.stats.blocks_applied += 1
        return state

    # --- the synchronous (depth=1) tile loop ------------------------------

    def _sync_tile(self, state: State, target: int) -> State:
        start = state.last_block_height + 1
        tracer = shared_tracer()
        with tracer.start("blocksync.tile", start=start) as tspan:
            with tracer.start("blocksync.fetch", parent=tspan):
                fetched, end = self._fetch_range(start, target)
            tspan.set_attr("end", end)

            # speculate: per height, the valset is the tile-start set
            # until a header announces a different validators_hash
            cur_vals = state.validators
            cur_hash = cur_vals.hash()
            entries: List[TileEntry] = []
            for h in range(start, end + 1):
                block, _parts, bid = fetched[h]
                if block.header.validators_hash != cur_hash:
                    break  # valset changes: verify after applying
                entries.append(TileEntry(
                    height=h, block=block, block_id=bid, valset=cur_vals,
                    commit=fetched[h + 1][0].last_commit))

            if entries:
                with tracer.start("blocksync.verify", parent=tspan,
                                  entries=len(entries)):
                    self.verifier.verify_tile(entries)
                self.stats.tiles_flushed += 1
                self.stats.sigs_verified += sum(
                    1 for e in entries for cs in e.commit.signatures
                    if not cs.absent_())

            applied_any = False
            by_height = {e.height: e for e in entries}
            aspan = tracer.start("blocksync.apply", parent=tspan)
            try:
                h = start
                while h <= end:
                    block, parts, block_id = fetched[h]
                    seal_commit = fetched[h + 1][0].last_commit
                    try:
                        state = self._apply_one(
                            state, h, block, parts, block_id,
                            seal_commit, by_height.get(h))
                    except TileApplyError as f:
                        self.source.ban(h)
                        aspan.event("banned", height=h)
                        if applied_any:
                            return state  # retry remainder next tile
                        raise BlockValidationError(str(f)) from f
                    applied_any = True
                    h += 1
                return state
            finally:
                aspan.set_attr("applied",
                               state.last_block_height - start + 1)
                aspan.end()
