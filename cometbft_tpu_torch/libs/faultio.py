"""Deterministic I/O fault injection for the durable-storage seam.

Crash injection used to stop at `fail_point()` boundaries BETWEEN
logical operations; nothing could tear a write mid-record, lie about an
fsync, run a disk out of space, or rot a byte on read. This module is
the missing half: a thin file-object wrapper adopted by the three
durable writers (consensus/wal.py, db/kv.py, privval/file.py) whose
faults are each a pure function of (seed, schedule) — the same
determinism contract as simnet's virtual clock and seeded PRNGs, so a
failing (scenario, seed, plan) triple replays byte-identically.

Fault taxonomy (docs/STORAGE.md):
  * torn write — the Nth write through a label persists only a prefix
    (explicit `keep` offset, or seeded) and then the process "loses
    power": `fail_point("faultio:torn-write")` is crossed (env modes
    os._exit, the simnet hook raises SimCrash) and, if that returns,
    `InjectedCrash` is raised for in-process tests.
  * ENOSPC — the Nth write raises OSError(ENOSPC) with nothing written.
  * fsync lie — fsync() reports success but durability does not
    advance; `FaultPlan.apply_crash()` is the power cut, truncating
    each lying file back to its last honestly-fsynced length.
  * bit flip — the Nth read through a label comes back with one seeded
    bit inverted (plausible-length bit-rot for CRC coverage).

When no plan is installed (the production case) `open_file` returns
the RAW builtin file object — zero wrapper overhead on the hot path.
Schedules ride labels, not call sites, so one plan addresses "the 3rd
blockstore batch" without knowing which file carries it; `path_substr`
narrows a rule to one simnet node's directory.

Env arming (malformed-tolerant, like libs/env): COMETBFT_TPU_FAULTIO=
"seed=7;torn@db:log@3;enospc@wal:head@2@;fsynclie@pv:state;
bitflip@wal:read@1" — '@'-separated because labels contain ':'.
Unparseable entries are skipped; zero valid rules installs nothing.

Copy of `cometbft_tpu/libs/faultio.py` (the port keeps its own).
"""

from __future__ import annotations

import errno
import os
import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import timesource
from .fail import fail_point

# The one crash-delivery fail point (registered in docs/SIMNET.md).
# A single literal label: simnet arms it with crash_at_label(...) and
# the env modes with COMETBFT_TPU_FAIL_LABEL — which write tears is the
# PLAN's schedule, so the label needs no per-site variants.
TORN_WRITE_LABEL = "faultio:torn-write"

_TORN = "torn"
_ENOSPC = "enospc"
_FSYNC_LIE = "fsynclie"
_BIT_FLIP = "bitflip"


class InjectedFault(OSError):
    """A scheduled I/O error surfaced to the caller (ENOSPC)."""


class InjectedCrash(RuntimeError):
    """Raised after a torn write when no fail_point mode consumed the
    crash — the in-process stand-in for the power cut. Callers that
    model reboot catch this, reopen, and run recovery."""


@dataclass
class _Rule:
    kind: str
    label: str
    nth: int = 1                 # 1-based count of matching operations
    keep: Optional[int] = None   # torn: explicit byte offset to keep
    path_substr: Optional[str] = None
    count: int = 0               # matching ops seen so far (monotonic)
    fired: bool = False

    def matches(self, label: str, path: str) -> bool:
        return (self.label == label
                and (self.path_substr is None
                     or self.path_substr in path))


@dataclass
class FaultPlan:
    """A deterministic fault schedule. Build rules with the chainable
    torn_write/enospc/fsync_lie/bit_flip methods, `install()` it, run
    the workload, and every fault lands at the same operation with the
    same seeded parameters on every run."""

    seed: int = 0
    rules: List[_Rule] = field(default_factory=list)
    # (time_ns, kind, label, path, detail) — observability + the
    # determinism tests' comparison artifact
    events: List[Tuple[int, str, str, str, str]] = field(
        default_factory=list)
    # path -> honestly-durable length, tracked only for fsync-lied files
    _watermarks: Dict[str, int] = field(default_factory=dict)

    # --- schedule construction -------------------------------------------

    def torn_write(self, label: str, nth: int = 1,
                   keep: Optional[int] = None,
                   path_substr: Optional[str] = None) -> "FaultPlan":
        self.rules.append(_Rule(_TORN, label, nth, keep, path_substr))
        return self

    def enospc(self, label: str, nth: int = 1,
               path_substr: Optional[str] = None) -> "FaultPlan":
        self.rules.append(_Rule(_ENOSPC, label, nth, None, path_substr))
        return self

    def fsync_lie(self, label: str,
                  path_substr: Optional[str] = None) -> "FaultPlan":
        self.rules.append(_Rule(_FSYNC_LIE, label, 0, None, path_substr))
        return self

    def bit_flip(self, label: str, nth: int = 1,
                 path_substr: Optional[str] = None) -> "FaultPlan":
        self.rules.append(_Rule(_BIT_FLIP, label, nth, None, path_substr))
        return self

    # --- deterministic parameter derivation ------------------------------

    def _derive(self, *parts: object) -> random.Random:
        """Seeded independently of call order: the same (seed, rule)
        always yields the same tear offset / flipped bit, no matter
        what other I/O happened first."""
        return random.Random("faultio:" + ":".join(
            str(p) for p in (self.seed,) + parts))

    def _note(self, kind: str, label: str, path: str, detail: str) -> None:
        now = timesource.time_ns() if timesource.installed() else 0
        self.events.append((now, kind, label, path, detail))

    def matches_label(self, label: str, path: str) -> bool:
        return any(r.matches(label, path) for r in self.rules)

    # --- fault application (called by FaultFile) -------------------------

    def on_write(self, ff: "FaultFile", data: bytes) -> bytes:
        """Returns the bytes actually written, raising for ENOSPC /
        torn-write faults. The caller has NOT written yet."""
        for r in self.rules:
            if r.fired or not r.matches(ff.label, ff.path):
                continue
            if r.kind == _ENOSPC:
                r.count += 1
                if r.count == r.nth:
                    r.fired = True
                    self._note(_ENOSPC, ff.label, ff.path, "")
                    raise InjectedFault(errno.ENOSPC,
                                        "injected: no space left on device",
                                        ff.path)
            elif r.kind == _TORN:
                r.count += 1
                if r.count == r.nth and len(data) > 0:
                    r.fired = True
                    keep = r.keep
                    if keep is None or not 0 <= keep < len(data):
                        keep = self._derive(
                            _TORN, ff.label, r.nth).randrange(len(data))
                    ff.raw.write(data[:keep])
                    ff.raw.flush()
                    self._note(_TORN, ff.label, ff.path,
                               f"keep={keep}/{len(data)}")
                    # literal (== TORN_WRITE_LABEL) so the failpoint
                    # registry lint can see it
                    fail_point("faultio:torn-write")
                    raise InjectedCrash(
                        f"torn write: {ff.label} {ff.path} "
                        f"kept {keep}/{len(data)}")
        return data

    def on_read(self, ff: "FaultFile", data: bytes) -> bytes:
        for r in self.rules:
            if (r.fired or r.kind != _BIT_FLIP
                    or not r.matches(ff.label, ff.path)):
                continue
            r.count += 1
            if r.count == r.nth and data:
                r.fired = True
                rng = self._derive(_BIT_FLIP, ff.label, r.nth)
                bit = rng.randrange(len(data) * 8)
                i, shift = divmod(bit, 8)
                data = (data[:i] + bytes([data[i] ^ (1 << shift)])
                        + data[i + 1:])
                self._note(_BIT_FLIP, ff.label, ff.path,
                           f"byte={i} bit={shift}")
        return data

    def on_fsync(self, ff: "FaultFile") -> bool:
        """True when the fsync should actually happen."""
        for r in self.rules:
            if r.kind == _FSYNC_LIE and r.matches(ff.label, ff.path):
                self._note(_FSYNC_LIE, ff.label, ff.path, "")
                return False
        return True

    def track_watermark(self, path: str, size: int) -> None:
        self._watermarks[path] = size

    def watermark_registered(self, path: str) -> bool:
        return path in self._watermarks

    def apply_crash(self) -> List[Tuple[str, int]]:
        """The power cut for fsync-lied files: truncate each back to
        its last honestly-durable length. Returns [(path, new_len)]."""
        out: List[Tuple[str, int]] = []
        for path, wm in sorted(self._watermarks.items()):
            if os.path.exists(path) and os.path.getsize(path) > wm:
                with open(path, "r+b") as f:
                    f.truncate(wm)
                out.append((path, wm))
        return out


class FaultFile:
    """File-object wrapper routing reads/writes/fsyncs through the
    installed plan. Only constructed when a rule matches (label, path);
    otherwise adopters hold the raw file object."""

    def __init__(self, plan: FaultPlan, raw, path: str, label: str):
        self.plan = plan
        self.raw = raw
        self.path = path
        self.label = label
        if plan.matches_label(label, path) and any(
                r.kind == _FSYNC_LIE and r.matches(label, path)
                for r in plan.rules):
            if not plan.watermark_registered(path):
                try:
                    plan.track_watermark(
                        path, os.fstat(raw.fileno()).st_size)
                except OSError:
                    plan.track_watermark(path, 0)

    # --- file protocol ----------------------------------------------------

    def write(self, data: bytes) -> int:
        self.plan.on_write(self, data)
        return self.raw.write(data)

    def read(self, n: int = -1) -> bytes:
        return self.plan.on_read(self, self.raw.read(n))

    def fsync(self) -> None:
        self.raw.flush()
        if self.plan.on_fsync(self):
            os.fsync(self.raw.fileno())
            if self.plan.watermark_registered(self.path):
                self.plan.track_watermark(
                    self.path, os.fstat(self.raw.fileno()).st_size)

    def flush(self) -> None:
        self.raw.flush()

    def close(self) -> None:
        self.raw.close()

    def truncate(self, size: Optional[int] = None) -> int:
        return self.raw.truncate(size)

    def seek(self, offset: int, whence: int = 0) -> int:
        return self.raw.seek(offset, whence)

    def tell(self) -> int:
        return self.raw.tell()

    def fileno(self) -> int:
        return self.raw.fileno()

    @property
    def closed(self) -> bool:
        return self.raw.closed

    def __enter__(self) -> "FaultFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# --- module seam -----------------------------------------------------------

_plan: Optional[FaultPlan] = None
_lock = threading.Lock()


def install(plan: FaultPlan) -> None:
    global _plan
    with _lock:
        _plan = plan


def reset() -> None:
    global _plan
    with _lock:
        _plan = None


def current() -> Optional[FaultPlan]:
    return _plan


def open_file(path: str, mode: str = "rb", label: str = ""):
    """The seam: every durable open in consensus/, db/, store/,
    privval/ goes through here (enforced by staticcheck raw-file-io).
    Returns the raw builtin file when no installed rule addresses
    (label, path) — the production path stays wrapper-free."""
    raw = open(path, mode)
    plan = _plan
    if plan is None or not plan.matches_label(label, path):
        return raw
    return FaultFile(plan, raw, path, label)


def fsync(f) -> None:
    """fsync through the seam: honors an fsync-lie rule when `f` is a
    FaultFile, plain os.fsync otherwise."""
    if isinstance(f, FaultFile):
        f.fsync()
    else:
        f.flush()
        os.fsync(f.fileno())


def fsync_path_dir(path: str) -> None:
    """Best-effort fsync of the directory containing `path` (rename
    durability); no-op where directories can't be opened."""
    d = os.path.dirname(path) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _parse_env_spec(raw: str) -> Optional[FaultPlan]:
    """Malformed-tolerant: each ';'-entry is kind@label[@nth[@keep]] or
    seed=N; bad entries are skipped, zero good rules -> None."""
    if not raw:
        return None
    plan = FaultPlan()
    good = 0
    for entry in raw.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if entry.startswith("seed="):
            try:
                plan.seed = int(entry[5:])
            except ValueError:
                pass
            continue
        parts = entry.split("@")
        kind = parts[0]
        if kind not in (_TORN, _ENOSPC, _FSYNC_LIE, _BIT_FLIP) \
                or len(parts) < 2 or not parts[1]:
            continue
        label = parts[1]
        try:
            nth = int(parts[2]) if len(parts) > 2 and parts[2] else 1
            keep = int(parts[3]) if len(parts) > 3 and parts[3] else None
        except ValueError:
            continue
        if kind == _TORN:
            plan.torn_write(label, nth, keep)
        elif kind == _ENOSPC:
            plan.enospc(label, nth)
        elif kind == _FSYNC_LIE:
            plan.fsync_lie(label)
        else:
            plan.bit_flip(label, nth)
        good += 1
    return plan if good else None


_env_plan = _parse_env_spec(os.environ.get("COMETBFT_TPU_FAULTIO", ""))
if _env_plan is not None:
    install(_env_plan)
