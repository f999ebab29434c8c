"""Seal adopter: settle a planned span's pivot seals in tiled,
canary-gated `PairingChecker` calls, then install adopted finality
into the blockstore so consensus/blocksync treat the heights as
decided while block bodies backfill lazily through the existing
blocksync pipeline.

Verdict discipline (the staticcheck verdict-taint sink contract): a
raw pairing verdict NEVER reaches `install_adopted` — every pivot
verdict comes out of `settle_seals`, whose only pairing authority is
`PairingChecker.check` (canary-spliced batches, permanent quarantine +
CPU re-verify on a wrong canary answer). Skipped heights carry no
verdict at all: they are proven by the host-side hash chain
(`chain.plan_adoption`), the same trust rule a light client applies.

Cache keying (the no-double-pairing contract): pivots that settle TRUE
get their whole-aggregate `b"aggsig|"` key added by `settle_seals`
itself; `install_adopted` adds the SAME key shape for every skipped
height. When blocksync later backfills the bodies, `marshal_commit`'s
`prepare_full_commit` finds each commit already cached and returns an
"ok" seal — an adopted height is never paired twice.

Mesh sharding: when the caller pins `shards=N`, tile settlement fans
out across shard-count workers, EACH with its own canary-gated checker
— canaries ride every batch on every worker, so parallelism never
widens the trust surface.

Port of `cometbft_tpu/sealsync/adopter.py`. Where the port differs:
- the adopter takes `device=` (default cuda, `device.resolve_device`):
  its default checker is `aggsig.verify.shared_pairing(device)`, a
  sharded settle builds `PairingChecker(device=...)` on it, and epoch
  PoPs are admitted on its route (`register_pops_batch(device=...)`);
- pivots settle through `settle_seals` -> `PairingChecker.check`, one
  `bls_miller_finalexp` launch a tile (a multi-group seal: the host
  Miller product, then one `bls_hard_pow` launch). A kernel error or a
  wrong canary (`KernelCanaryError`) propagates out of `adopt()`: it is
  never a ban and never a host re-verify;
- the mesh switch follows `engine/blocksync.mesh_available`: off (one
  card), settlement stays on the caller's thread; on, the adopter
  raises NotImplementedError (ROADMAP.md Queue 1 item 5: mesh).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Protocol

from ..aggsig.aggregate import register_pops_batch
from ..aggsig.verify import (PairingChecker, prepare_full_commit,
                             settle_seals, shared_pairing)
from ..device import resolve_device
from .chain import (DEFAULT_MAX_SKIP, AdoptionPlan, SealChainError,
                    SealTuple, plan_adoption)

DEFAULT_TILE = 32
DEFAULT_FETCH = 128


class AdoptionError(RuntimeError):
    """Adoption could not complete (retries exhausted / install
    refused)."""


class SealRejected(SealChainError):
    """A pivot seal failed its pairing: forged aggregate. Subclasses
    SealChainError so the retry/ban arc treats cryptographic and
    continuity rejections uniformly."""

    def __init__(self, height: int):
        super().__init__(height, "pivot seal failed pairing")


class SealSource(Protocol):
    """Seal provider seam — the p2p adapter (engine.reactor
    NetSealSource), the in-memory fixture (chain_gen ChainSealSource),
    a SealProvider behind another transport, or anything else that can
    serve contiguous SealTuple runs."""

    def max_height(self) -> int: ...
    def fetch_seals(self, start: int, count: int) -> List[SealTuple]: ...
    def ban(self, height: int) -> None:
        """Report a bad span at `height` (provider wrong or lying)."""


class SealAdopter:
    def __init__(self, chain_id: str, block_store, source: SealSource, *,
                 tile_size: int = DEFAULT_TILE,
                 max_skip: int = DEFAULT_MAX_SKIP,
                 fetch_window: int = DEFAULT_FETCH,
                 cache=None, checker=None, shards: Optional[int] = None,
                 metrics=None, log=None, max_attempts: int = 3,
                 device=None):
        self.device = resolve_device(device)
        self._chain_id = chain_id
        self._store = block_store
        self._source = source
        self.tile_size = max(1, tile_size)
        self.max_skip = max_skip
        self.fetch_window = max(1, fetch_window)
        self._cache = cache
        self._checker = checker
        self._shards = shards if shards is not None else _mesh_shards()
        self._metrics = metrics
        self._log = log
        self.max_attempts = max_attempts

    # --- adoption loop ------------------------------------------------------

    def adopt(self, state, target: Optional[int] = None) -> int:
        """Adopt decided heights above `state.last_block_height` up to
        `target` (default: the source's tip); returns the adopted tip.
        The anchor is always the applied state — resuming an
        interrupted adoption replans the whole span, and the SigCache
        turns every already-settled pivot into a pairing-free hit, so
        resume costs hashing, not pairings."""
        anchor = state.last_block_height
        goal = target if target is not None else self._source.max_height()
        if goal <= anchor:
            return anchor
        cur_h = anchor
        cur_vals = state.validators
        cur_vh = cur_vals.hash()
        attempts = 0
        while cur_h < goal:
            tuples = self._source.fetch_seals(
                cur_h + 1, min(goal - cur_h, self.fetch_window))
            if not tuples:
                # nothing sealable past cur_h (per-sig chain segment,
                # pruned provider...) — partial adoption is a result,
                # not a failure; blocksync proper takes it from here
                break
            try:
                plan = plan_adoption(self._chain_id, cur_h, cur_vals,
                                     tuples, self.max_skip,
                                     trusted_vh=cur_vh)
                self._admit_pops(plan)
                verdicts = self._settle(plan)
                bad = [h for h, ok in zip(plan.pivots, verdicts)
                       if not ok]
                if bad:
                    raise SealRejected(bad[0])
            except SealChainError as exc:
                attempts += 1
                if self._metrics is not None:
                    self._metrics.adoptions_rejected.inc()
                if self._log is not None:
                    self._log.info("seal span rejected",
                                   height=exc.height, reason=exc.reason,
                                   attempt=attempts)
                self._source.ban(exc.height)
                if attempts >= self.max_attempts:
                    raise AdoptionError(
                        f"seal adoption failed after {attempts} "
                        f"attempts: {exc}") from exc
                continue
            self.install_adopted(plan, verdicts)
            cur_h = plan.tip
            cur_vals = plan.vals_for[cur_h]
            cur_vh = plan.tuples[-1].header.next_validators_hash
        return cur_h

    def _admit_pops(self, plan: AdoptionPlan) -> None:
        """Epoch-boundary PoPs are self-certifying: verify + register
        before any pivot pairing is marshaled (prepare_full_commit's
        per-signer PoP gate would otherwise fail the whole epoch)."""
        if not plan.new_pops:
            return
        if not register_pops_batch(plan.new_pops, metrics=self._metrics,
                                   device=self.device):
            raise SealChainError(plan.start, "epoch PoP rejected")

    # --- settlement ---------------------------------------------------------

    def _settle(self, plan: AdoptionPlan) -> List[bool]:
        """One verdict per pivot, in pivot order. Tiles settle through
        canary-gated checkers; a cache-hit pivot ("ok" seal) costs
        nothing."""
        seals = []
        for h in plan.pivots:
            t = plan.tuples[h - plan.start]
            vals = plan.vals_for[h]
            needed = vals.total_voting_power() * 2 // 3
            seals.append(prepare_full_commit(
                self._chain_id, vals, t.commit, needed,
                cache=self._cache))
        tiles = [seals[i:i + self.tile_size]
                 for i in range(0, len(seals), self.tile_size)]
        if self._shards > 1 and len(tiles) > 1:
            verdicts = self._settle_sharded(tiles)
        else:
            verdicts = []
            for tile in tiles:
                verdicts.extend(settle_seals(tile, cache=self._cache,
                                             checker=self._pairing()))
        if self._metrics is not None:
            self._metrics.pivots_verified.inc(len(verdicts))
        return verdicts

    def _settle_sharded(self, tiles: List[list]) -> List[bool]:
        """Fan tiles across shard-count workers. Each worker owns a
        PRIVATE canary-gated checker on the adopter's device: concurrent
        calls through one checker would race its canary counters, and a
        canary must gate every batch on every worker. Verdict order is
        positional, so the result is deterministic regardless of
        completion order."""
        out: List[Optional[List[bool]]] = [None] * len(tiles)

        def run(i: int) -> None:
            out[i] = settle_seals(tiles[i], cache=self._cache,
                                  checker=PairingChecker(
                                      device=self.device))

        with ThreadPoolExecutor(
                max_workers=min(self._shards, len(tiles))) as pool:
            list(pool.map(run, range(len(tiles))))
        verdicts: List[bool] = []
        for tile_out in out:
            verdicts.extend(tile_out if tile_out is not None else [])
        return verdicts

    def _pairing(self) -> PairingChecker:
        return self._checker if self._checker is not None \
            else shared_pairing(self.device)

    # --- install ------------------------------------------------------------

    def install_adopted(self, plan: AdoptionPlan,
                        verdicts: List[bool]) -> int:
        """Persist adopted finality (verdict-taint SINK: `verdicts`
        must be settle_seals output — every entry canary-gated or CPU
        re-verified). Also adds the whole-aggregate cache key for
        every SKIPPED height: those commits are bound by the verified
        hash chain, so backfill must not pay a second pairing for
        them."""
        if len(verdicts) != len(plan.pivots) or not all(verdicts):
            raise AdoptionError("install refused: unsettled pivots")
        pivot_set = set(plan.pivots)
        for t in plan.tuples:
            self._store.save_adopted_seal(t.height, t.commit.block_id,
                                          t.header, t.commit)
            if self._cache is not None and t.height not in pivot_set:
                vh = plan.vals_for[t.height].hash()
                self._cache.add(
                    b"aggsig|" + vh,
                    t.commit.seal_digest(self._chain_id, vh),
                    t.commit.agg_sig)
        if self._metrics is not None:
            self._metrics.seals_adopted.inc(len(plan.tuples))
            self._metrics.pairings_skipped.inc(
                len(plan.tuples) - len(plan.pivots))
            self._metrics.adopted_tip.set(plan.tip)
        if self._log is not None:
            self._log.info("adopted seal span", start=plan.start,
                           tip=plan.tip, pivots=len(plan.pivots))
        return plan.tip


def _mesh_shards() -> int:
    """Shard count for settlement fan-out: 1 while the mesh is off
    (`engine/blocksync.mesh_available`, as on one card), so settlement
    stays on the caller's thread, deterministic. With the mesh on, the
    JAX package fans tiles out over its shared mesh executor, which the
    port does not have yet."""
    from ..engine.blocksync import mesh_available
    if mesh_available():
        raise NotImplementedError(
            "mesh settlement is not ported yet (ROADMAP.md Queue 1 item "
            "5: mesh and multi-GPU)")
    return 1
