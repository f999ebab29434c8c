"""Boot-time storage recovery doctor (the crash-consistency
reconciliation pass; docs/STORAGE.md has the repair table).

Runs at node boot AFTER the stores open (each store has already done
its own single-file repair: FileDB truncated any uncommitted batch
tail, the WAL truncated its torn head) and BEFORE consensus/reactors
start, cross-checking the artifacts no single store can see alone:
WAL ENDHEIGHT vs state store height vs blockstore base/height/
adopted_tip, plus the filesystem litter a crash can strand (stale
`.compact` temps, an orphaned privval `state.json.tmp`).

Every repair is logged and counted in metricsgen's StorageMetrics
(storage_doctor_repairs{kind=...}); anything the doctor cannot prove
safe to repair raises a typed `RecoveryError` and the node refuses to
boot — a wrong-but-running validator is the one outcome worse than a
down one.

Repairs (all idempotent — a crash mid-doctor re-runs clean):
  meta-without-parts    tip block meta present but body unreadable
                        (pre-v2 torn `save_block`) → delete-latest,
                        handshake re-fetches the height
  orphaned-adopted-seal AS: record for a height whose full body is
                        present (crash between backfill batches before
                        v2 atomicity) → drop the redundant record
  stale-compact         `*.compact` temp beside a db log → remove
  stale-pv-tmp          privval `state.json.tmp` orphaned between
                        write and rename → remove (always safe: _save
                        completes before a signature is released)

This module also hosts the StorageMetrics latch shared by the cold
corruption paths in db/kv.py and consensus/wal.py (both import it
lazily at call time — store/ imports db/ at module load, so the
reverse edge must never be import-time).

Copy of `cometbft_tpu/store/recovery.py` (the port keeps its own); the
privval litter sweep (`pv_state_path`) stays though privval is not
ported yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

_metrics = None  # libs/metrics_gen.StorageMetrics, wired by node boot


def set_metrics(m) -> None:
    global _metrics
    _metrics = m


def metrics():
    return _metrics


class RecoveryError(Exception):
    """Storage state the doctor cannot repair without guessing —
    booting would risk app-hash divergence, so we refuse."""


@dataclass
class RecoveryReport:
    """What one doctor pass saw and did."""
    repairs: List[Tuple[str, str]] = field(default_factory=list)
    wal_end_height: int = 0
    block_height: int = 0
    state_height: int = 0

    def count(self, kind: Optional[str] = None) -> int:
        if kind is None:
            return len(self.repairs)
        return sum(1 for k, _ in self.repairs if k == kind)


def scan_wal_end_height(wal) -> int:
    """Highest #ENDHEIGHT marker across the WAL group (0 if none).
    Takes any object with iter_messages (WAL or NilWAL)."""
    from ..consensus.wal import EndHeightMessage
    end = 0
    for msg in wal.iter_messages():
        if isinstance(msg, EndHeightMessage) and msg.height > end:
            end = msg.height
    return end


def _repair(report: RecoveryReport, log, kind: str, detail: str) -> None:
    report.repairs.append((kind, detail))
    m = metrics()
    if m is not None:
        m.doctor_repairs.inc(kind=kind)
    if log is not None:
        log(f"doctor repair [{kind}]: {detail}")


def run_doctor(block_store=None, state_store=None, wal=None,
               db_dir: Optional[str] = None,
               pv_state_path: Optional[str] = None,
               log=None) -> RecoveryReport:
    """One reconciliation pass. Any argument may be None (the caller
    wires what its node actually has); `log` is a callable taking one
    string (SimNode passes its deterministic sim logger, the real node
    stderr). Raises RecoveryError on unrepairable state."""
    report = RecoveryReport()

    # --- filesystem litter -------------------------------------------------
    if db_dir is not None and os.path.isdir(db_dir):
        for name in sorted(os.listdir(db_dir)):
            if name.endswith(".compact"):
                os.remove(os.path.join(db_dir, name))
                _repair(report, log, "stale-compact", name)
    if pv_state_path is not None:
        tmp = pv_state_path + ".tmp"
        if os.path.exists(tmp):
            os.remove(tmp)
            _repair(report, log, "stale-pv-tmp", os.path.basename(tmp))

    # --- blockstore self-consistency --------------------------------------
    if block_store is not None:
        # meta-without-parts at the tip: only a pre-v2 torn save_block
        # can produce it, and only delete-latest repairs it (the
        # handshake/blocksync re-fetches the height). Bounded loop:
        # each pass removes exactly the tip.
        while block_store.height() > block_store.base() \
                and block_store.height() > 0:
            h = block_store.height()
            if block_store.load_block_meta(h) is not None \
                    and block_store.load_block(h) is None:
                block_store.delete_block(h)
                _repair(report, log, "meta-without-parts", f"height {h}")
            else:
                break
        # orphaned adopted seal: the body backfilled but the crash hit
        # between batches, leaving the AS: record save_block should
        # have deleted. The canonical H:/P:/SC: keys own the height —
        # drop the redundant seal record.
        for h in block_store.adopted_seal_heights():
            if h <= block_store.height() \
                    and block_store.load_block_meta(h) is not None:
                block_store.drop_adopted_seal(h)
                _repair(report, log, "orphaned-adopted-seal",
                        f"height {h}")
        report.block_height = block_store.height()

    # --- cross-store height reconciliation --------------------------------
    state = state_store.load() if state_store is not None else None
    if state is not None:
        report.state_height = state.last_block_height
    if block_store is not None and state is not None:
        bh = block_store.height()
        sh = state.last_block_height
        tip = max(bh, block_store.adopted_tip())
        if sh > tip:
            raise RecoveryError(
                f"state store is ahead of block storage: state height "
                f"{sh} > block height {bh} (adopted tip "
                f"{block_store.adopted_tip()}) — block data was lost; "
                f"refusing to boot")
        if bh > sh + 1:
            raise RecoveryError(
                f"block store is more than one ahead of state: block "
                f"height {bh} vs state height {sh} — state writes were "
                f"lost mid-stream; refusing to boot (rollback cannot "
                f"span {bh - sh} heights)")
        # bh == sh + 1 is the NORMAL crash window: block saved, state
        # apply pending — the handshake replays it (state/rollback.py
        # handles the inverse repair when asked explicitly).
    if wal is not None:
        report.wal_end_height = scan_wal_end_height(wal)
        if block_store is not None:
            tip = max(block_store.height(), block_store.adopted_tip())
            if report.wal_end_height > tip:
                raise RecoveryError(
                    f"WAL closed height {report.wal_end_height} but "
                    f"block storage only reaches {tip} — the WAL "
                    f"proves a decided height whose block was lost; "
                    f"refusing to boot")

    m = metrics()
    if m is not None:
        m.doctor_runs.inc()
    return report
