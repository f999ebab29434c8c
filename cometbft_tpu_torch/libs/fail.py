"""Crash-injection points (reference internal/fail/fail.go:47 — the
FAIL_TEST_INDEX mechanism sprinkled through the commit path,
state/execution.go:262-312, consensus state.go:1857-1897).

Set COMETBFT_TPU_FAIL_INDEX=N (or call set_fail_index) and the Nth
`fail_point()` crossed in the process exits hard — exercising every
crash-recovery class (WAL replay, handshake replay, torn files) without
hand-placed kill timing.

A third mode serves the in-process simulator (cometbft_tpu/simnet):
`set_fail_hook(fn)` registers a callable invoked at every fail point
crossing with the point's label. The hook may raise to unwind the
current node's stack at exactly the label's position — simnet raises
its `SimCrash` there and models the crash by discarding the node's
in-memory state while keeping its stores/WAL, the in-process analog of
the os._exit the env-var modes perform. The env modes take precedence:
in a process where either is configured, the hook never runs and the
crossing counters stay exact.

Copy of `cometbft_tpu/libs/fail.py` (the port keeps its own).
"""

from __future__ import annotations

import os
import threading

from .env import env_int

_lock = threading.Lock()
_counter = 0
# malformed index = disarmed (-1), not an import-time crash
_target = env_int("COMETBFT_TPU_FAIL_INDEX", -1)
# label-targeted variant: COMETBFT_TPU_FAIL_LABEL="wal:pre-rotate-rename:0"
# crashes at the k-th crossing of exactly that label (for points that are
# crossed data-dependently, e.g. WAL rotation, where a global index is
# not predictable)
_label_target: "tuple[str, int] | None" = None
_label_counter = 0
_env_label = os.environ.get("COMETBFT_TPU_FAIL_LABEL", "")
if _env_label:
    # labels contain colons ("wal:pre-rotate-rename"), so the :k
    # suffix is optional — a bare label means its first crossing
    _name, _, _k = _env_label.rpartition(":")
    if _name and _k.isdigit():
        _label_target = (_name, int(_k))
    else:
        _label_target = (_env_label, 0)


def set_fail_index(n: int) -> None:
    global _target, _counter
    with _lock:
        _target = n
        _counter = 0


def set_fail_label(label: str, k: int = 0) -> None:
    global _label_target, _label_counter
    with _lock:
        _label_target = (label, k)
        _label_counter = 0


# in-process hook (simnet crash schedules); None = disabled. Read
# without the lock — a single-slot reference swap, and the simulator
# that installs it is single-threaded by construction.
_hook = None


def set_fail_hook(fn) -> None:
    """Register fn(label) to run at every fail point crossing. The
    callable may raise to simulate a crash in-process (simnet)."""
    global _hook
    _hook = fn


def clear_fail_hook() -> None:
    global _hook
    _hook = None


def fail_point(label: str = "") -> None:
    """Crash (os._exit, no cleanup — like a power cut) when this is the
    configured failure index, or the k-th crossing of the configured
    failure label. The env-configured crash modes take precedence over
    a registered hook: while either is armed, crossings feed their
    counters (and crash at the target) exactly as if no hook existed;
    the hook receives crossings only in processes with no env mode
    configured — the simulator's case."""
    global _counter, _label_counter
    if _target < 0 and _label_target is None:
        if _hook is not None:
            _hook(label)
        return
    hit = False
    with _lock:
        if _target >= 0:
            hit = _counter == _target
            _counter += 1
        if not hit and _label_target is not None \
                and label == _label_target[0]:
            hit = _label_counter == _label_target[1]
            _label_counter += 1
    if hit:
        import sys
        print(f"FAIL_POINT hit: {label}", file=sys.stderr, flush=True)
        os._exit(99)
