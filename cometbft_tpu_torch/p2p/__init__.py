"""The p2p stack (reference p2p/): `SecretConnection` (conn.py),
`MConnection` (mconn.py), `Transport`/`NodeInfo` (transport.py) and
`Switch`/`Peer` (switch.py). Port of `cometbft_tpu/p2p/`; `pex.py`
comes with node boot."""

from .conn import SecretConnection
from .mconn import MConnection, ChannelDescriptor
from .switch import Switch, Peer, Reactor
from .transport import Transport, NodeInfo

__all__ = ["SecretConnection", "MConnection", "ChannelDescriptor",
           "Switch", "Peer", "Reactor", "Transport", "NodeInfo"]
