"""Node assembly: the dependency-injection graph wiring every subsystem
(reference node/node.go:273-536 NewNode, :539-609 OnStart).

Boot order follows the reference: DBs → state (store or genesis) →
proxy app conns → ABCI handshake/replay → event bus + indexers →
mempool/evidence → consensus (+WAL) → reactors → switch → RPC.

Copy of `cometbft_tpu/node/node.py` in the port, which differs where the
JAX package reaches its device:

- `Node(..., device=None)` resolves one torch device (`resolve_device`:
  cuda unless the caller asks for "cpu") and hands it to every part that
  verifies: `ConsensusState`, `BlockExecutor`, `EvidencePool`, the boot
  `BlocksyncReactor`, `IngestPipeline`, `VerificationFarm`, `SealAdopter`
  and the genesis PoP admission (`register_pops_batch`).
- The boot sync's batch (`_device_batch_size`): on the CPU 0, the native
  per-signature path, as the JAX package does on a CPU platform. On
  cuda one flush holds a whole boot tile: `BOOT_TILE` (16) commits ×
  the validator count, rounded up to a power of two (`verify_batch`
  pads to one), so 3,200 lanes at 200 validators → 4,096. The JAX
  package takes its Pallas lane tile (512) because a smaller batch
  would leave its kernel; the CUDA kernels have no such rule, and a
  512-lane batch would split a 200-validator tile into 7 launch-bound
  flushes.
- The boot thread prewarms the kernels on the node's device, and a
  failed build or launch fails the boot. Only the peers' faults
  (`BlockValidationError`, `SyncStalled`) lead from a failed sync to
  consensus; any other error (a kernel build or launch,
  `KernelCanaryError`, `DispatchDeadlineExceeded`) stops the boot:
  consensus never starts, and the error is kept in `boot_error`
  (`cmd start` exits 1 on it).
- Depth > 1 without a device server runs the pipeline's in-process
  backend (`LocalAsyncBackend`, built by the scheduler) on the node's
  device under a `DeviceWatchdog`; it drains nothing. With a device
  server it is the `DeviceClientBackend` with the health supervisor, as
  in the JAX package.
- Statesync (`[statesync] enable`, `_run_statesync`) anchors through a
  light client on the node's device, and narrows the JAX package's
  catch-alls (`statesync/syncer.py`): only `StateSyncError` (a peer's
  fault: an unanchorable snapshot, a chunk the app refuses, a source's
  transport error) or finding nothing before `discovery_time_ms` leads
  to blocksync from genesis, where the JAX package falls back on any
  exception. Anything else (a kernel build or launch, `KernelCanaryError`
  inside the anchor's verify, the app's own connection failing) stops
  the boot and is kept in `boot_error`.
- A remote app over `proxy_app = tcp://` is the port's `abci/socket.py`
  client, and `[tx_index] indexer = "sqlite"` the port's
  `indexer/sqlite.py`, as in the JAX package.
- Not ported yet, each raising NotImplementedError at construction:
  `[device] mesh` (ROADMAP.md Queue 1 item 5), a `[grpc]` listener (item
  11.2) and a `grpc://` app (item 11.4): gRPC needs the grpcio package.
- `stop()` closes every listener and joins every thread it started.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

from ..abci.application import Application, RequestFinalizeBlock
from ..config import Config
from ..consensus.reactor import ConsensusReactor
from ..consensus.state import ConsensusConfig, ConsensusState
from ..consensus.wal import WAL
from ..crypto.keys import Ed25519PrivKey, pubkey_from_type_bytes
from ..db.kv import open_db
from ..device import resolve_device
from ..engine.reactor import BlocksyncNetReactor, NetSource
from ..evidence.pool import EvidencePool
from ..indexer.kv import BlockIndexer, IndexerService, TxIndexer
from ..mempool.mempool import CListMempool
from ..p2p.switch import Switch
from ..privval.file import FilePV
from ..proxy.multi_app_conn import AppConns, local_client_creator
from ..pubsub.events import EventBus
from ..rpc.server import RPCEnvironment, RPCServer
from ..state.execution import BlockExecutor
from ..state.state import GenesisDoc, State, StateStore
from ..store.blockstore import BlockStore
from ..types.proto import Timestamp
from ..types.validator import Validator

# commits a boot-sync tile holds (the JAX package's node uses 16 too)
BOOT_TILE = 16


def load_or_generate_node_key(path: str) -> Ed25519PrivKey:
    """Persistent p2p identity key (reference p2p/node_key.go) — the
    node id must survive restarts or peer allow/ban lists break."""
    if os.path.exists(path):
        with open(path) as f:
            return Ed25519PrivKey(bytes.fromhex(json.load(f)["priv_key"]))
    key = Ed25519PrivKey.generate()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"priv_key": key.seed.hex(),
                   "node_id": key.pub_key().address().hex()}, f)
    return key


def save_genesis(gen: GenesisDoc, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({
            "chain_id": gen.chain_id,
            "initial_height": gen.initial_height,
            "genesis_time": [gen.genesis_time.seconds,
                             gen.genesis_time.nanos],
            "validators": [{"pub_key": v.pub_key.bytes_().hex(),
                            "type": v.pub_key.type_(),
                            "power": v.voting_power}
                           for v in gen.validators],
            "app_state": gen.app_state.hex(),
            "app_hash": gen.app_hash.hex(),
            "bls_pops": {pub.hex(): pop.hex()
                         for pub, pop in gen.bls_pops.items()},
        }, f, indent=1)


def load_genesis(path: str) -> GenesisDoc:
    with open(path) as f:
        d = json.load(f)
    return GenesisDoc(
        chain_id=d["chain_id"],
        initial_height=d.get("initial_height", 1),
        genesis_time=Timestamp(*d.get("genesis_time", [0, 0])),
        validators=[Validator(
            pubkey_from_type_bytes(v.get("type", "ed25519"),
                                   bytes.fromhex(v["pub_key"])),
            v["power"]) for v in d["validators"]],
        app_state=bytes.fromhex(d.get("app_state", "")),
        app_hash=bytes.fromhex(d.get("app_hash", "")),
        bls_pops={bytes.fromhex(pub): bytes.fromhex(pop)
                  for pub, pop in d.get("bls_pops", {}).items()})


class Node:
    """reference node/node.go Node."""

    def __init__(self, config: Config, app: Optional[Application] = None,
                 genesis: Optional[GenesisDoc] = None,
                 priv_validator: Optional[FilePV] = None,
                 node_key: Optional[Ed25519PrivKey] = None,
                 client_creator=None, device=None):
        config.validate_basic()
        self._refuse_unported(config, grpc_app=(
            app is None and client_creator is None
            and config.base.proxy_app.startswith("grpc://")))
        self.config = config
        self.device = resolve_device(device)
        # the boot thread's fatal error (a kernel fault), else None
        self.boot_error: Optional[BaseException] = None
        self._boot_thread: Optional[threading.Thread] = None
        self._boot_source = None
        self.boot_engine = None      # the last boot sync's reactor
        self.statesync_syncer = None  # the last statesync attempt's Syncer
        self.statesync_state: Optional[State] = None  # what it bootstrapped
        self._stopping = threading.Event()
        self.genesis = genesis or load_genesis(
            config.path(config.base.genesis_file))

        # --- DBs (node.go:284 initDBs) ---------------------------------------
        be, ddir = config.base.db_backend, config.path(config.base.db_dir)
        self.block_store = BlockStore(open_db(be, "blockstore", ddir))
        self.state_store = StateStore(
            open_db(be, "state", ddir),
            retain_abci_responses=not config.storage.discard_abci_responses)
        self._indexer_db = open_db(be, "indexer", ddir)

        # --- boot-time recovery doctor (store/recovery.py) -------------------
        # Runs BEFORE the handshake and reactors: cross-checks WAL
        # ENDHEIGHT vs state vs blockstore, repairs crash litter, and
        # refuses to boot (RecoveryError) on anything unrepairable.
        # The metrics registry is created here (not with the consensus
        # metrics below) so doctor repairs — including the ones FileDB
        # already performed while opening above — are attributed in
        # StorageMetrics.
        from ..libs.metrics import Registry
        self.metrics_registry = Registry()
        from ..libs.metrics_gen import StorageMetrics
        from ..store import recovery as _recovery
        self.storage_metrics = StorageMetrics(self.metrics_registry)
        if _recovery._metrics is None:  # first node wins, like SigCache
            _recovery.set_metrics(self.storage_metrics)
        _wal_doctor = WAL(
            config.path(config.consensus.wal_file),
            head_size_limit=config.consensus.wal_head_size_limit,
            total_size_limit=config.consensus.wal_total_size_limit)
        try:
            import sys as _sys
            self.recovery_report = _recovery.run_doctor(
                block_store=self.block_store,
                state_store=self.state_store,
                wal=_wal_doctor, db_dir=ddir,
                pv_state_path=config.path(
                    config.base.priv_validator_file),
                log=lambda s: print(f"[{config.base.moniker}] {s}",
                                    file=_sys.stderr))
        finally:
            _wal_doctor.close()

        # --- state: stored or genesis (node.go:289) --------------------------
        state = self.state_store.load()
        if state is None:
            state = State.from_genesis(self.genesis)
            # bootstrap-save so the genesis validator set is indexed at
            # the initial height (reference state/store.go Bootstrap)
            self.state_store.save(state)
        elif self.genesis.bls_pops:
            # the PoP registry is process-local: a RESTARTED node loads
            # state from the store and skips from_genesis, so the
            # genesis proofs of possession must be re-admitted here or
            # every valid aggregated commit would be rejected for
            # missing PoPs (docs/AGGSIG.md "PoP policy")
            from ..aggsig.aggregate import register_pops_batch
            register_pops_batch(self.genesis.bls_pops, device=self.device)

        # --- proxy app (node.go:319): in-process app, explicit client
        # creator, or [base] proxy_app = tcp://host:port (the socket
        # flavor — reference proxy.DefaultClientCreator; a grpc:// app was
        # refused by _refuse_unported) ---------------------------------------
        if client_creator is None:
            if app is not None:
                client_creator = local_client_creator(app)
            elif config.base.proxy_app == "kvstore":
                from ..abci.kvstore import KVStoreApplication
                client_creator = local_client_creator(KVStoreApplication())
            else:
                from ..proxy.multi_app_conn import remote_client_creator
                host, port = self._split_addr(
                    config.base.proxy_app.removeprefix("tcp://"))
                client_creator = remote_client_creator(host, port)
        self.app_conns = AppConns(client_creator)
        self._handshake(state)

        # --- event bus + indexers (node.go:328-334) --------------------------
        self.event_bus = EventBus()
        if config.tx_index.indexer == "sqlite":
            # relational sink (reference psql sink's role,
            # state/indexer/sink/psql): same interface, sqlite file
            from ..indexer.sqlite import open_sqlite_indexers
            self.tx_indexer, self.block_indexer = open_sqlite_indexers(
                config.path(config.base.db_dir))
        else:
            self.tx_indexer = TxIndexer(self._indexer_db)
            self.block_indexer = BlockIndexer(self._indexer_db)
        self.indexer_service = IndexerService(
            self.tx_indexer, self.block_indexer, self.event_bus)

        # --- privval (node.go:343) -------------------------------------------
        if priv_validator is None:
            pv_path = config.path(config.base.priv_validator_file)
            priv_validator = FilePV.load_or_generate(pv_path)
        self.priv_validator = priv_validator

        # --- mempool + evidence (node.go:385-409) ----------------------------
        mc = config.mempool
        self.mempool = CListMempool(
            lambda tx: (self.app_conns.mempool.check_tx(tx).code, 0),
            max_tx_bytes=mc.max_tx_bytes, max_txs_bytes=mc.max_txs_bytes,
            size=mc.size, cache_size=mc.cache_size, recheck=mc.recheck)
        self.evidence_pool = EvidencePool(
            state_store=self.state_store, block_store=self.block_store,
            device=self.device)

        # --- executor + consensus (node.go:413-448) --------------------------
        self.executor = BlockExecutor(
            self.app_conns.consensus, state_store=self.state_store,
            block_store=self.block_store, mempool=self.mempool,
            evidence_pool=self.evidence_pool, event_bus=self.event_bus,
            device=self.device)
        from ..state.pruner import Pruner
        self.pruner = Pruner(
            self.block_store, self.state_store,
            interval_s=config.storage.pruning_interval_ms / 1000.0,
            tx_indexer=self.tx_indexer,
            block_indexer=self.block_indexer)
        self.executor.pruner = self.pruner
        from ..libs.metrics import ConsensusMetrics
        # (metrics_registry was created up in the doctor section so
        # storage repairs during DB open are attributed)
        # canary counters (ops/ed25519._run_canary), under the JAX
        # package's metric names so scrapers still find them: trips > 0
        # means the CUDA RLC kernels accepted a batch with a known-invalid
        # lane, which raises KernelCanaryError (nothing is disabled)
        from ..ops.ed25519 import canary_stats
        self.metrics_registry.callback_gauge(
            "crypto_pallas_canary_runs",
            "Tampered-lane canary executions against the CUDA RLC kernels",
            fn=lambda: canary_stats()["runs"])
        self.metrics_registry.callback_gauge(
            "crypto_pallas_canary_trips",
            "Silent accepts caught by the canary (KernelCanaryError raised)",
            fn=lambda: canary_stats()["trips"])
        # generated metrics structs (tools/metricsgen.py from
        # libs/metrics_defs.py — the reference's scripts/metricsgen
        # role): mempool occupancy now, p2p wiring after the switch
        # exists below
        from ..libs.metrics_gen import (AggsigMetrics, DeviceMetrics,
                                        MempoolMetrics, P2PMetrics,
                                        PipelineMetrics)
        self._p2p_metrics_cls = P2PMetrics
        self.mempool.metrics = MempoolMetrics(self.metrics_registry)
        self.pipeline_metrics = PipelineMetrics(self.metrics_registry)
        self.device_metrics = DeviceMetrics(self.metrics_registry)
        # aggregate-commit verification counters (aggsig/verify.py) —
        # module-shared like the SigCache: several in-process nodes
        # verify through one aggsig path, first node wins
        from ..aggsig import verify as _aggsig_verify
        self.aggsig_metrics = AggsigMetrics(self.metrics_registry)
        if _aggsig_verify._metrics is None:
            _aggsig_verify.set_metrics(self.aggsig_metrics)
        # the per-process device health supervisor (device/health.py):
        # wedge recovery probing, canary-verified batches, reconnect
        # backoff. Knobs from [device]; first node wins for metrics and
        # configuration (several in-process nodes share one device),
        # matching the shared-cache posture below.
        from ..device.health import shared_supervisor
        shared_supervisor().configure(config.device,
                                      metrics=self.device_metrics)
        # flight-recorder tracing ([instrumentation] trace —
        # docs/TRACE.md): same first-node-wins latch as the device
        # supervisor; COMETBFT_TPU_TRACE* env knobs override
        from .. import trace as _trace
        from ..libs.metrics_gen import TraceMetrics
        self.trace_metrics = TraceMetrics(self.metrics_registry)
        _trace.configure(config.instrumentation,
                         metrics=self.trace_metrics)
        # the process-wide verified-signature cache (vote intake, light
        # client, blocksync) reports hit/miss/eviction through the same
        # struct. First node wins: with several nodes in one process
        # (in-process tests) re-pointing the singleton would misfile
        # every earlier node's counts under the newest registry.
        from ..pipeline.cache import shared_cache
        if shared_cache().metrics is None:
            shared_cache().metrics = self.pipeline_metrics
        # batched CheckTx admission ([mempool] ingest_batch —
        # docs/INGEST.md): broadcast_tx_* and p2p-relayed txs coalesce
        # into shared signature batches over the same SigCache +
        # DeviceClient seam as vote intake and blocksync, with
        # explicit backpressure
        self.ingest = None
        if mc.ingest_batch:
            from ..ingest import IngestPipeline
            from ..libs.metrics_gen import IngestMetrics
            self.ingest = IngestPipeline(
                self.mempool, cache=shared_cache(),
                metrics=IngestMetrics(self.metrics_registry),
                device=self.device)
        cc = config.consensus
        self.consensus = ConsensusState(
            ConsensusConfig(
                timeout_propose=cc.timeout_propose,
                timeout_propose_delta=cc.timeout_propose_delta,
                timeout_prevote=cc.timeout_prevote,
                timeout_prevote_delta=cc.timeout_prevote_delta,
                timeout_precommit=cc.timeout_precommit,
                timeout_precommit_delta=cc.timeout_precommit_delta,
                timeout_commit=cc.timeout_commit,
                create_empty_blocks=cc.create_empty_blocks,
                skip_timeout_commit=cc.skip_timeout_commit),
            state, self.executor, self.block_store,
            priv_validator=self.priv_validator,
            wal=WAL(config.path(cc.wal_file),
                    head_size_limit=cc.wal_head_size_limit,
                    total_size_limit=cc.wal_total_size_limit),
            name=config.base.moniker,
            metrics=ConsensusMetrics(self.metrics_registry),
            device=self.device)
        self.consensus.evidence_pool = self.evidence_pool

        # --- reactors + switch (node.go:456-494) -----------------------------
        self.node_key = node_key or load_or_generate_node_key(
            config.path(config.base.node_key_file))
        self.switch = Switch(self.node_key, self.genesis.chain_id,
                             config.base.moniker,
                             send_rate=config.p2p.send_rate,
                             recv_rate=config.p2p.recv_rate)
        self.switch.metrics = self._p2p_metrics_cls(
            self.metrics_registry)
        self.consensus_reactor = ConsensusReactor(self.consensus)
        self.consensus_reactor.attach(self.switch)
        # every node SERVES seals (the provider reads straight out of
        # the stores, zero cost when nobody asks); CONSUMING them at
        # boot is gated by [blocksync] seal_sync below
        from ..libs.metrics_gen import SealsyncMetrics
        from ..sealsync import SealProvider
        self.sealsync_metrics = SealsyncMetrics(self.metrics_registry)
        self.seal_provider = SealProvider(
            self.block_store, state_store=self.state_store,
            metrics=self.sealsync_metrics)
        self.blocksync_reactor = BlocksyncNetReactor(
            self.block_store, seal_provider=self.seal_provider)
        from ..mempool.reactor import MempoolReactor
        self.mempool_reactor = MempoolReactor(self.mempool,
                                              ingest=self.ingest)
        self.mempool_reactor.attach(self.switch)
        from ..evidence.reactor import EvidenceReactor
        self.evidence_reactor = EvidenceReactor(
            self.evidence_pool, lambda: self.consensus.state)
        self.evidence_reactor.attach(self.switch)
        from ..statesync.reactor import StatesyncNetReactor
        # every node SERVES snapshots (reference node.go always mounts
        # the statesync reactor); consuming them at boot is gated by
        # [statesync] enable
        self.statesync_reactor = StatesyncNetReactor(
            self.app_conns.snapshot)
        self.switch.add_reactor(self.consensus_reactor)
        self.switch.add_reactor(self.blocksync_reactor)
        self.switch.add_reactor(self.mempool_reactor)
        self.switch.add_reactor(self.evidence_reactor)
        self.switch.add_reactor(self.statesync_reactor)

        # --- RPC (node.go:559 — started first on OnStart) --------------------
        # light-client verification farm ([rpc] light_farm): serves
        # many clients' skipping checks from this node's own stores,
        # coalesced into shared device batches (docs/FARM.md)
        self.farm = None
        if config.rpc.light_farm:
            from ..farm import VerificationFarm
            from ..libs.metrics_gen import FarmMetrics
            from ..light.provider import BlockStoreProvider
            self.farm = VerificationFarm(
                self.genesis.chain_id,
                BlockStoreProvider(self.genesis.chain_id,
                                   self.block_store, self.state_store),
                metrics=FarmMetrics(self.metrics_registry),
                device=self.device)
        self.rpc_env = RPCEnvironment(
            chain_id=self.genesis.chain_id,
            block_store=self.block_store,
            state_store=self.state_store, mempool=self.mempool,
            consensus=self.consensus, event_bus=self.event_bus,
            tx_indexer=self.tx_indexer,
            block_indexer=self.block_indexer,
            app_query=self.app_conns.query, genesis=self.genesis,
            switch=self.switch,
            evidence_pool=self.evidence_pool,
            unsafe=config.rpc.unsafe, farm=self.farm,
            ingest=self.ingest, sealsync=self.seal_provider)
        self.rpc_server: Optional[RPCServer] = None
        if config.rpc.enable:
            host, port = self._split_addr(config.rpc.laddr)
            rc = config.rpc
            self.rpc_server = RPCServer(
                self.rpc_env, host, port,
                max_body_bytes=rc.max_body_bytes,
                timeout_s=rc.timeout_ms / 1000.0,
                cors_origins=rc.cors_allowed_origins,
                cors_methods=rc.cors_allowed_methods,
                cors_headers=rc.cors_allowed_headers,
                tls_cert_file=config.path(rc.tls_cert_file)
                if rc.tls_cert_file else "",
                tls_key_file=config.path(rc.tls_key_file)
                if rc.tls_key_file else "")

    @staticmethod
    def _refuse_unported(config: Config, grpc_app: bool) -> None:
        """Branches whose modules are not ported raise here, before any
        store is opened, instead of falling back to something else."""
        if grpc_app:
            raise NotImplementedError(
                "a gRPC ABCI app (proxy_app grpc://) needs abci/grpc.py and "
                "the grpcio package, not ported yet (ROADMAP.md Queue 1 "
                "item 11.4)")
        if config.device.mesh:
            raise NotImplementedError(
                "[device] mesh needs the multi-card mesh, not ported yet "
                "(ROADMAP.md Queue 1 item 5)")
        if config.grpc.laddr or (config.grpc.privileged_laddr
                                 and config.grpc.pruning_service):
            raise NotImplementedError(
                "[grpc] listeners need rpc/grpc.py and the grpcio package, "
                "not ported yet (ROADMAP.md Queue 1 item 11.2)")

    @staticmethod
    def _split_addr(addr: str):
        host, _, port = addr.rpartition(":")
        return host or "127.0.0.1", int(port)

    def _handshake(self, state: State) -> None:
        """ABCI handshake: sync the app to the stored state by replaying
        blocks it hasn't seen (reference node/node.go:365 doHandshake →
        internal/consensus/replay.go:242-284)."""
        info = self.app_conns.consensus.info()
        app_height = info.last_block_height
        if app_height == 0:
            # fresh app: InitChain even when the store is ahead — the
            # replay below brings it to the stored height
            self.app_conns.consensus.init_chain(
                self.genesis.chain_id, self.genesis.initial_height,
                self.genesis.validators, self.genesis.app_state)
        # replay stored blocks the app is missing (crash between
        # SaveBlock and app commit, or a fresh app behind an old store)
        h = app_height + 1
        while h <= state.last_block_height:
            blk = self.block_store.load_block(h)
            if blk is None:
                break
            self.app_conns.consensus.finalize_block(RequestFinalizeBlock(
                txs=blk.data.txs, height=h, time=blk.header.time,
                proposer_address=blk.header.proposer_address,
                hash=blk.hash(),
                next_validators_hash=blk.header.next_validators_hash))
            self.app_conns.consensus.commit()
            h += 1

    # --- lifecycle (node.go:539-609) -----------------------------------------

    def start(self) -> None:
        if self.ingest is not None:
            # flusher first: relayed/async txs must settle even before
            # any RPC waiter performs a cooperative flush
            self.ingest.start()
        if self.rpc_server is not None:
            self.rpc_server.start()          # RPC first (node.go:559)
        if self.config.tx_index.indexer != "null":
            # "null" = no indexing (reference state/txindex null sink):
            # the service never subscribes, searches return empty
            self.indexer_service.start()
        self.pruner.start()
        self.consensus_reactor.start_reconciler()
        if self.config.instrumentation.prometheus:
            self._start_metrics_server()
        host, port = self._split_addr(self.config.p2p.laddr)
        self.p2p_addr = self.switch.listen(host, port)
        for peer in filter(None, self.config.p2p.persistent_peers.split(",")):
            ph, _, pp = peer.strip().rpartition(":")
            # registered (not one-shot dialed): the switch's
            # ensure-peers routine dials now and re-dials on any drop —
            # a node that loses all links otherwise stays isolated
            # forever and stalls consensus
            self.switch.add_persistent_peer(ph, int(pp))
        if self.config.base.block_sync:
            # blocksync to the peer tip BEFORE consensus (the reference's
            # blocksync mode → switchToConsensus,
            # internal/blocksync/reactor.go:388); consensus messages
            # arriving meanwhile queue in the inbox and replay on start
            self._boot_thread = threading.Thread(
                target=self._boot, name="blocksync-boot", daemon=True)
            self._boot_thread.start()
        else:
            self.consensus.start()

    def _device_batch_size(self, n_validators: int) -> int:
        """Lanes a boot-sync flush holds, or 0 for the native
        per-signature path (the node's device is the CPU). On cuda: a
        whole tile of `BOOT_TILE` commits × `n_validators`, rounded up
        to a power of two (module docstring)."""
        if self.device.type != "cuda":
            return 0
        return 1 << (BOOT_TILE * max(n_validators, 1) - 1).bit_length()

    def _prewarm_kernels(self, batch: int) -> None:
        """Build the kernels and run the boot batch's bucket once on the
        node's device; a failed build or launch raises (and fails the
        boot)."""
        if batch <= 0:
            return  # the CPU: blocksync runs native
        from ..ops.ed25519 import prewarm_verify_kernels
        prewarm_verify_kernels(batch_size=batch, device=self.device)

    def _boot(self) -> None:
        """The boot thread: any error but a peer's fault ends here, is
        kept in `boot_error`, and consensus does not start."""
        try:
            self._sync_then_consensus()
        except BaseException as e:  # noqa: BLE001 — surfaced, never lost
            import traceback
            traceback.print_exc()
            self.boot_error = e

    def _run_statesync(self) -> Optional[State]:
        """Snapshot-sync a fresh node (reference node.go:591-601
        startStateSync): discover snapshots on the p2p channel, restore
        the app from chunks, anchor against the light client built from
        [statesync] rpc_servers on the node's device, persist the
        bootstrapped state + seen commit, and return the State for
        blocksync to continue from. Returns None when nothing restored
        before `discovery_time_ms` (boot falls back to blocksync from
        genesis); raises StateSyncError when the rpc_servers cannot give
        the light client its trust root. Any other error propagates."""
        from ..libs import timesource
        from ..statesync import (StateSyncError, Syncer,
                                 light_provider_from_config,
                                 net_snapshot_sources)
        from ..light import PEER_ERRORS

        ss = self.config.statesync
        try:
            provider = light_provider_from_config(ss, self.genesis,
                                                  device=self.device)
        except PEER_ERRORS as e:
            raise StateSyncError(f"no trust root: {e!r}") from e

        # discovery waits read the timesource seam: wall clocks on a
        # live node, and under a virtual source the deadline math
        # follows the simulated clock
        deadline = timesource.monotonic() + ss.discovery_time_ms / 1000.0
        state = None
        while timesource.monotonic() < deadline and \
                not self._stopping.is_set():
            sources = net_snapshot_sources(self.statesync_reactor)
            if sources:
                self.statesync_syncer = Syncer(
                    self.app_conns.snapshot, provider, sources)
                try:
                    state = self.statesync_syncer.sync()
                    break
                except StateSyncError:
                    # snapshots may be too close to the tip for the
                    # height+2 anchor; the chain advances — retry
                    pass
            timesource.sleep(0.5)
        if state is None:
            return None
        # persist the bootstrap (reference node.go:152 BootstrapState)
        self.state_store.save(state)
        self.block_store.bootstrap_seen_commit(
            state.last_block_height,
            provider.commit(state.last_block_height))
        self.statesync_state = state
        return state

    def _sync_then_consensus(self) -> None:
        from ..engine.blocksync import (BlocksyncReactor, SyncStalled)
        from ..engine.pool import PooledSource
        from ..pipeline.cache import shared_cache
        from ..state.execution import BlockValidationError
        src = NetSource(self.blocksync_reactor, self.switch)
        state = self.consensus.state
        if self.config.statesync.enable and state.last_block_height == 0:
            from ..statesync import StateSyncError
            try:
                synced = self._run_statesync()
            except StateSyncError:
                # the peers' fault: blocksync from genesis remains the
                # safe fallback. Any other error leaves this method
                import traceback
                traceback.print_exc()
                synced = None
            if self._stopping.is_set():
                return
            if synced is not None:
                state = synced
        if self.config.blocksync.seal_sync:
            # sealsync (docs/SEALSYNC.md): adopt decided heights from
            # aggregate seals FIRST — O(pivots) pairings for the whole
            # gap instead of one per height — then let the blocksync
            # loop below backfill bodies (every adopted commit is a
            # SigCache hit, so backfill re-verifies nothing)
            from ..sealsync import AdoptionError, SealAdopter
            from ..engine.reactor import NetSealSource
            bs = self.config.blocksync
            try:
                SealAdopter(
                    self.genesis.chain_id, self.block_store,
                    NetSealSource(self.blocksync_reactor, self.switch),
                    tile_size=bs.seal_tile, max_skip=bs.seal_max_skip,
                    cache=shared_cache(),
                    metrics=self.sealsync_metrics,
                    device=self.device).adopt(state)
            except AdoptionError:
                # adoption is an accelerator, never a gate: a corrupt
                # or seal-less peer set just means plain blocksync
                import traceback
                traceback.print_exc()
        # catch up until no peer is ahead (each pass re-queries peer
        # status; a fresh net reports height 0 and falls through fast)
        batch = self._device_batch_size(len(state.validators))
        self._prewarm_kernels(batch)
        for _round in range(100):
            if self._stopping.is_set():
                return
            target = src.max_height()
            if target <= state.last_block_height:
                break
            pooled = PooledSource(src, state.last_block_height + 1,
                                  lookahead=32, n_workers=4)
            self._boot_source = pooled
            # device-backed nodes run the asynchronous verification
            # pipeline (device verify of tile N overlaps fetch/marshal/
            # apply of neighbors) under the wedge watchdog; CPU nodes
            # keep the synchronous loop — native verify has no device
            # latency to hide and threads would only add overhead
            depth = (self.config.blocksync.pipeline_depth
                     if batch > 0 else 1)
            watchdog = backend = supervisor = None
            if depth > 1:
                from ..pipeline.watchdog import DeviceWatchdog
                # with the host's card-owner server configured, dispatch
                # through the non-blocking DeviceClient.submit() seam;
                # otherwise (backend None) the scheduler's in-process
                # dispatch thread (LocalAsyncBackend) runs the kernels on
                # the reactor's device and drains nothing. The health
                # supervisor (and its canary lanes) only applies to the
                # remote link — in-process dispatch has no transport to
                # supervise, so it keeps the standalone sticky watchdog
                from ..device.client import shared_client
                client = shared_client()
                if client is not None:
                    from ..device.health import shared_supervisor
                    from ..pipeline.scheduler import DeviceClientBackend
                    supervisor = shared_supervisor()
                    backend = DeviceClientBackend(client)
                watchdog = DeviceWatchdog(
                    metrics=self.pipeline_metrics,
                    supervisor=supervisor)
            engine = BlocksyncReactor(
                self.executor, self.block_store, pooled,
                self.genesis.chain_id, tile_size=BOOT_TILE,
                batch_size=batch, pipeline_depth=depth,
                backend=backend, watchdog=watchdog,
                cache=shared_cache(), metrics=self.pipeline_metrics,
                supervisor=supervisor, device=self.device)
            self.boot_engine = engine
            try:
                state = engine.sync(state, target)
            except (BlockValidationError, SyncStalled):
                # peers can't serve clean blocks right now; consensus
                # gossip takes over from wherever sync actually got to.
                # Any other error (a kernel fault) leaves this method:
                # it is the node's fault, not the peers'
                state = self._recover_sync_state(state)
                break
            finally:
                pooled.stop()
        if self._stopping.is_set():
            return
        if state is not self.consensus.state:
            self.consensus.state = state
            self.consensus._update_to_state(state)
        self.consensus.start()

    def _recover_sync_state(self, fallback):
        """Blocksync applies tile-by-tile through the executor (which
        persists after each block), so on failure the authoritative
        partially-advanced state lives in the state store — reusing the
        pre-sync snapshot would re-execute blocks the app already saw."""
        stored = self.state_store.load()
        if stored is not None and \
                stored.last_block_height > fallback.last_block_height:
            return stored
        return fallback

    def _start_metrics_server(self) -> None:
        """Serve Registry.expose() at [instrumentation] prometheus_laddr
        (reference node.go Prometheus metrics server)."""
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)
        registry = self.metrics_registry

        class Handler(BaseHTTPRequestHandler):
            timeout = 10  # a stalled scraper must not wedge shutdown

            def log_message(self, *a):
                pass

            def do_GET(self):
                body = registry.expose().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        host, port = self._split_addr(
            self.config.instrumentation.prometheus_laddr or
            "127.0.0.1:0")
        self._metrics_server = ThreadingHTTPServer((host, port), Handler)
        self._metrics_server.daemon_threads = True
        self.metrics_addr = self._metrics_server.server_address
        self._metrics_thread = threading.Thread(
            target=self._metrics_server.serve_forever, name="metrics",
            daemon=True)
        self._metrics_thread.start()

    def stop(self) -> None:
        """Closes every listener and joins every thread `start` began
        (each join bounded: a wedged thread is a daemon and is left)."""
        self._stopping.set()
        if self._boot_source is not None:
            self._boot_source.stop()     # wakes the boot sync's fetch
        if self._boot_thread is not None:
            # it may be starting consensus: let it finish first
            self._boot_thread.join(timeout=10)
        self.consensus.stop()
        self.consensus_reactor.stop()
        if self.ingest is not None:
            self.ingest.stop()
        if getattr(self, "_metrics_server", None) is not None:
            self._metrics_server.shutdown()
            self._metrics_server.server_close()  # free the listen FD
            self._metrics_thread.join(timeout=5)
        self.switch.stop()
        self.pruner.stop()
        self.indexer_service.stop()
        if self.rpc_server is not None:
            self.rpc_server.stop()
        for sink in (self.tx_indexer, self.block_indexer):
            close = getattr(sink, "close", None)  # the sqlite connection
            if close is not None:
                close()
        self.app_conns.stop()
