"""statesync/ in the port: the p2p reactor that serves the app's
snapshots and fetches a peer's (`reactor.py`), and the consuming side,
the syncer (`syncer.py`) and its light-client state provider
(`stateprovider.py`), copies of `cometbft_tpu/statesync/`. The syncer
narrows the JAX package's catch-alls to the peers' faults
(`syncer.py`)."""

from .reactor import (NetSnapshotSource, StatesyncNetReactor,
                      net_snapshot_sources)
from .stateprovider import LightStateProvider, light_provider_from_config
from .syncer import (AppSnapshotSource, SnapshotSource, StateSyncError,
                     Syncer)

__all__ = ["AppSnapshotSource", "LightStateProvider", "NetSnapshotSource",
           "SnapshotSource", "StateSyncError", "StatesyncNetReactor",
           "Syncer", "light_provider_from_config", "net_snapshot_sources"]
