"""Light-client-backed state provider for statesync
(reference internal/statesync/stateprovider.go:38-139).

The restoring node has NO state — the light client supplies the trust
anchor: a verified header chain gives app_hash (to validate the restored
snapshot) and the validator sets needed to bootstrap consensus at the
snapshot height.

Copy of `cometbft_tpu/statesync/stateprovider.py` in the port:
`light_provider_from_config` takes `device=` and builds its
`LightClient(..., device=)`, so each commit the anchor checks at
`validation.BATCH_VERIFY_THRESHOLD` signatures or more batch-verifies on
that device (default cuda) through the RLC kernels.
"""

from __future__ import annotations

from ..light.client import LightClient
from ..state.state import GenesisDoc, State


def light_provider_from_config(ss_cfg, genesis: GenesisDoc, device=None
                               ) -> "LightStateProvider":
    """Build the light-client-backed provider from a [statesync] config
    section (shared by node boot and the offline bootstrap-state CLI):
    first rpc_server = primary, the rest = witnesses for the detector
    cross-check."""
    from ..db.kv import MemDB
    from ..light.client import TrustOptions
    from ..light.provider import HTTPProvider
    from ..light.store import LightStore
    from ..rpc.client import RPCClient
    providers = []
    for server in ss_cfg.rpc_servers.split(","):
        host, _, port = server.strip().rpartition(":")
        providers.append(HTTPProvider(genesis.chain_id,
                                      RPCClient(host, int(port))))
    lc = LightClient(
        genesis.chain_id,
        TrustOptions(period_seconds=ss_cfg.trust_period_seconds,
                     height=ss_cfg.trust_height,
                     hash=bytes.fromhex(ss_cfg.trust_hash)),
        providers[0], providers[1:], LightStore(MemDB()), device=device)
    return LightStateProvider(lc, genesis)


class LightStateProvider:
    def __init__(self, light_client: LightClient, genesis: GenesisDoc):
        self.lc = light_client
        self.genesis = genesis

    def app_hash(self, height: int) -> bytes:
        """The app hash AFTER block `height` executes is committed in
        header height+1 (reference stateprovider.go:98)."""
        lb = self.lc.verify_light_block_at_height(height + 1)
        return lb.header.app_hash

    def commit(self, height: int):
        lb = self.lc.verify_light_block_at_height(height)
        return lb.signed_header.commit

    def state(self, height: int) -> State:
        """Bootstrap state for consensus to resume AFTER `height`
        (reference stateprovider.go:108-139 buildStateFromHeaders)."""
        cur = self.lc.verify_light_block_at_height(height)
        nxt = self.lc.verify_light_block_at_height(height + 1)
        nxt2 = self.lc.verify_light_block_at_height(height + 2)
        return State(
            chain_id=self.genesis.chain_id,
            initial_height=self.genesis.initial_height,
            last_block_height=cur.height,
            last_block_id=nxt.header.last_block_id,
            last_block_time=cur.header.time,
            validators=nxt.validator_set.copy(),
            next_validators=nxt2.validator_set.copy(),
            last_validators=cur.validator_set.copy(),
            last_height_validators_changed=0,
            consensus_params=self.genesis.consensus_params,
            last_results_hash=nxt.header.last_results_hash,
            app_hash=nxt.header.app_hash,
        )
