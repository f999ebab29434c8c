"""The one place an entry point turns its `device=` argument into a
`torch.device` (the port's counterpart of
`cometbft_tpu/libs/jax_cache.is_device_platform`).

The default is the card. Asking for cuda where there is none raises: the
port never carries on on the CPU behind a caller's back. The CPU is used
only when the caller names it, as the tests do.

The package also holds the port of `cometbft_tpu/device/`: the verify
device server (`server.py`), its wire (`protocol.py`), its client and
`RemoteBatchVerifier` (`client.py`), and the health supervisor with its
canary lanes (`health.py`). Import those modules explicitly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means cuda. Raises RuntimeError when cuda is asked for and
    no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cuda device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain torch path")
    return dev
