"""statesync/ in the port: the p2p reactor that serves the app's
snapshots and fetches a peer's (`reactor.py`, a copy of
`cometbft_tpu/statesync/reactor.py`). The consuming side, `syncer.py`
and `stateprovider.py`, is not ported yet (ROADMAP.md Queue 1 item
11.1): a port `Node` with `[statesync] enable = true` raises
NotImplementedError."""

from .reactor import (NetSnapshotSource, StatesyncNetReactor,
                      net_snapshot_sources)

__all__ = ["NetSnapshotSource", "StatesyncNetReactor",
           "net_snapshot_sources"]
