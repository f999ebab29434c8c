"""Tolerant environment-knob parsing shared by every tunable subsystem.

A malformed env override must degrade to the compiled-in default, never
abort node boot or blocksync startup: operators fat-finger
`COMETBFT_TPU_*` knobs in systemd units and container manifests, and a
ValueError from deep inside the verify path would turn a typo into an
outage. Previously this guard was copy-pasted in pipeline/watchdog.py
and device/client.py (with subtly different blast radius — the client
variant reset BOTH knobs when either was malformed); it lives here once
and also serves the device-health backoff knobs, the p2p keepalive
windows, the Pallas tile size, and the signature-cache capacity.

`tools/staticcheck`'s raw-env rule enforces the seam: a bare
`int(os.environ.get(...))` outside this module is a lint error, so new
knobs inherit the malformed-tolerant behavior automatically.

Semantics shared by env_float/env_int:
  * unset → default
  * unparseable (empty, whitespace, wrong radix, "1.5" for an int) →
    default
  * NaN → default (a NaN knob poisons every comparison it feeds)
  * `minimum` given and value < minimum → default (negative deadlines,
    capacities, intervals are nonsensical; +inf stays allowed — it
    reads as "never")

Copy of `cometbft_tpu/libs/env.py` (the port keeps its own).
"""

from __future__ import annotations

import math
import os


def env_float(name: str, default: float,
              minimum: "float | None" = None) -> float:
    """float(os.environ[name]) with `default` for unset, malformed,
    NaN, or below `minimum`."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        val = float(raw)
    except ValueError:
        return default
    if math.isnan(val):
        return default
    if minimum is not None and val < minimum:
        return default
    return val


def env_int(name: str, default: int,
            minimum: "int | None" = None) -> int:
    """int(os.environ[name]) with `default` for unset, malformed
    (including float strings like "1.5"), or below `minimum`."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        val = int(raw.strip())
    except ValueError:
        return default
    if minimum is not None and val < minimum:
        return default
    return val


def env_bool(name: str, default: bool) -> bool:
    """Boolean knob: 1/true/yes/on (any case) is True, 0/false/no/off
    is False, unset or unrecognized is `default`."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    val = raw.strip().lower()
    if val in ("1", "true", "yes", "on"):
        return True
    if val in ("0", "false", "no", "off"):
        return False
    return default
