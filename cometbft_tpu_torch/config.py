"""Node configuration (reference config/config.go:78-93 — the master
Config of sections — and config/toml.go's file round-trip).

Copy of `cometbft_tpu/config.py` in the port: the same sections, TOML
keys and defaults, so each package reads the other's `config.toml`.
`[device] mesh` is kept as a key but a port `Node` refuses it (mesh is
not ported: ROADMAP.md Queue 1 item 5).

TOML read uses the stdlib tomllib where it exists (Python >= 3.11);
on older interpreters `loads_flat_toml` falls back to parsing the
exact subset grammar `to_toml` emits (flat sections of scalars).
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass, field as dc_field
from typing import Optional


def loads_flat_toml(text: str) -> dict:
    """tomllib.loads when available; otherwise parse the flat subset
    `Config.to_toml` emits — `[section]` headers over `key = scalar`
    lines where scalar is true/false, an int, a float, or a
    JSON-escaped basic string. Python 3.10 images have no tomllib and
    no third-party toml wheel, and node boot must not depend on one."""
    try:
        import tomllib
        return tomllib.loads(text)
    except ModuleNotFoundError:
        pass
    import json
    out: dict = {}
    section = out
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[") and line.endswith("]"):
            section = out.setdefault(line[1:-1].strip(), {})
            continue
        key, sep, val = line.partition("=")
        if not sep:
            raise ValueError(f"toml line {ln}: expected key = value, "
                             f"got {raw!r}")
        key, val = key.strip(), val.strip()
        if val.startswith('"'):
            section[key] = json.loads(val)
        elif val in ("true", "false"):
            section[key] = val == "true"
        else:
            try:
                section[key] = int(val)
            except ValueError:
                section[key] = float(val)
    return out


@dataclass
class BaseConfig:
    """reference config/config.go BaseConfig."""
    chain_id: str = "tpu-chain"
    moniker: str = "tpu-node"
    db_backend: str = "filedb"          # memdb | filedb | native
    db_dir: str = "data"
    genesis_file: str = "config/genesis.json"
    priv_validator_file: str = "config/priv_validator.json"
    node_key_file: str = "config/node_key.json"
    block_sync: bool = True
    # "kvstore" = built-in in-process app; "tcp://host:port" or
    # "host:port" = external ABCI app over the socket protocol
    # (reference config.go BaseConfig.ProxyApp)
    proxy_app: str = "kvstore"


@dataclass
class P2PConfig:
    """reference config/config.go P2PConfig."""
    laddr: str = "127.0.0.1:0"
    persistent_peers: str = ""          # comma-separated host:port
    max_num_inbound_peers: int = 40
    max_num_outbound_peers: int = 10
    send_rate: int = 5_120_000          # bytes/s (config.go SendRate)
    recv_rate: int = 5_120_000          # bytes/s (config.go RecvRate)


@dataclass
class RPCConfig:
    laddr: str = "127.0.0.1:0"
    enable: bool = True
    # expose dial_seeds/dial_peers/unsafe_flush_mempool (reference
    # config.go RPCConfig.Unsafe — off by default: statesync requires
    # operators to expose RPC publicly, and these routes let any caller
    # flush the mempool or steer peering)
    unsafe: bool = False
    # server hardening (reference config.go RPCConfig +
    # rpc/jsonrpc/server/http_server.go:56 DefaultConfig):
    # CORS (empty = no CORS headers; "*" or csv of allowed origins)
    cors_allowed_origins: str = ""
    cors_allowed_methods: str = "HEAD,GET,POST"
    cors_allowed_headers: str = ("Origin,Accept,Content-Type,"
                                 "X-Requested-With,X-Server-Time")
    # request-body cap (reference MaxBodyBytes = 1MB) and per-connection
    # read/write timeout (reference ReadTimeout/WriteTimeout = 10s)
    max_body_bytes: int = 1_000_000
    timeout_ms: int = 10_000
    # TLS: both set -> serve https (reference TLSCertFile/TLSKeyFile)
    tls_cert_file: str = ""
    tls_key_file: str = ""
    # mount the light-client verification farm routes
    # (light_subscribe / light_verify / light_status — docs/FARM.md):
    # the node then serves verification as a product, coalescing many
    # clients' checks into shared device batches
    light_farm: bool = False

    def validate_basic(self) -> None:
        """reference config.go RPCConfig.ValidateBasic."""
        if self.max_body_bytes <= 0:
            raise ValueError("rpc.max_body_bytes must be positive")
        if self.timeout_ms <= 0:
            raise ValueError("rpc.timeout_ms must be positive")
        if bool(self.tls_cert_file) != bool(self.tls_key_file):
            raise ValueError(
                "rpc.tls_cert_file and rpc.tls_key_file must be set "
                "together")


@dataclass
class MempoolConfig:
    size: int = 5000
    cache_size: int = 10000
    max_tx_bytes: int = 1024 * 1024
    max_txs_bytes: int = 64 * 1024 * 1024
    recheck: bool = True
    # route broadcast_tx_* / p2p-relayed txs through the batched
    # admission pipeline (ingest/ — docs/INGEST.md): envelope
    # signatures coalesce into shared device batches with explicit
    # backpressure, instead of a synchronous per-tx check_tx
    ingest_batch: bool = False


@dataclass
class ConsensusTimeoutsConfig:
    timeout_propose: int = 3000
    timeout_propose_delta: int = 500
    timeout_prevote: int = 1000
    timeout_prevote_delta: int = 500
    timeout_precommit: int = 1000
    timeout_precommit_delta: int = 500
    timeout_commit: int = 1000
    create_empty_blocks: bool = True
    # advance the instant 100% of power precommitted (reference
    # config.go SkipTimeoutCommit)
    skip_timeout_commit: bool = True
    wal_file: str = "data/cs.wal"
    # autofile.Group rotation (reference internal/autofile/group.go
    # defaults: 10MB head / 1GB group): the head rotates to wal.NNN at
    # this size, and the oldest rotated files are pruned past the total
    wal_head_size_limit: int = 8 << 20
    wal_total_size_limit: int = 1 << 30


@dataclass
class StateSyncConfig:
    """reference config/config.go StateSyncConfig: bootstrap a fresh
    node from an app snapshot + light-client trust anchor instead of
    replaying history."""
    enable: bool = False
    rpc_servers: str = ""              # comma-separated host:port of
    #                                    light-provider RPC endpoints
    trust_height: int = 0
    trust_hash: str = ""               # hex header hash at trust_height
    trust_period_seconds: int = 168 * 3600   # reference default 168h
    discovery_time_ms: int = 15_000
    chunk_request_timeout_ms: int = 10_000

    def validate_basic(self) -> None:
        """reference config.go StateSyncConfig.ValidateBasic."""
        if not self.enable:
            return
        if not self.rpc_servers or len(self.rpc_servers.split(",")) < 2:
            # the reference requires >= 2 (config.go ValidateBasic):
            # the second server witnesses the light-client cross-check;
            # with only a primary a lying provider goes undetected
            raise ValueError("statesync requires at least two rpc_servers")
        if self.trust_height <= 0:
            raise ValueError("statesync requires trust_height > 0")
        if not self.trust_hash:
            raise ValueError("statesync requires trust_hash")
        bytes.fromhex(self.trust_hash)  # raises on malformed hex
        if self.trust_period_seconds <= 0:
            raise ValueError("statesync trust_period must be positive")
        if self.chunk_request_timeout_ms < 1000:
            raise ValueError("chunk_request_timeout must be >= 1s")


@dataclass
class BlockSyncConfig:
    """reference config/config.go BlockSyncConfig, plus the verification
    pipeline depth (tiles kept in flight through pipeline/scheduler on
    device-backed nodes; 1 = the synchronous loop)."""
    version: str = "v0"
    pipeline_depth: int = 4
    # sealsync (docs/SEALSYNC.md): adopt decided heights from aggregate
    # seals before body backfill. Opt-in — the seal-adopt path only
    # helps uniformly-BLS chains; mixed/ed25519 chains fall through to
    # plain blocksync immediately.
    seal_sync: bool = False
    seal_max_skip: int = 64   # pairing cadence: pivot every N heights
    seal_tile: int = 32       # seals settled per PairingChecker call

    def validate_basic(self) -> None:
        if self.version != "v0":
            raise ValueError(f"unknown blocksync version {self.version}")
        if not 1 <= self.pipeline_depth <= 64:
            raise ValueError(
                f"pipeline_depth must be in [1, 64], "
                f"got {self.pipeline_depth}")
        if not 1 <= self.seal_max_skip <= 4096:
            raise ValueError(
                f"seal_max_skip must be in [1, 4096], "
                f"got {self.seal_max_skip}")
        if not 1 <= self.seal_tile <= 1024:
            raise ValueError(
                f"seal_tile must be in [1, 1024], got {self.seal_tile}")


@dataclass
class DeviceConfig:
    """Verification-device health supervision (device/health.py): how
    aggressively a SUSPECT device is re-probed with known-answer
    batches, and whether canary lanes ride every device batch. The env
    knobs COMETBFT_TPU_DEVICE_BACKOFF_BASE/_CAP/_PROBE_DEADLINE/_CANARY
    serve the same role for processes booted without a config file."""
    canary: bool = True                 # known-good/bad lanes per batch
    probe_backoff_base_ms: int = 500    # first half-open window
    probe_backoff_cap_ms: int = 30_000  # exponential backoff ceiling
    probe_deadline_ms: int = 2_000      # per-probe answer deadline
    # multi-chip mesh serving (mesh/ — docs/MESH.md): own every local
    # device as one (commit, sig) verification mesh instead of a
    # single chip. Off by default: single-chip nodes and the CPU test
    # platform must never pay mesh compiles.
    mesh: bool = False
    mesh_devices: int = 0               # 0 = all local devices
    mesh_sig_parallel: int = 0          # 0 = auto (2 when even, else 1)
    mesh_tiles_per_shard: int = 4       # pipeline depth multiplier
    # per-shard quarantine re-probe backoff (shard_health.py); the
    # node-level probe_backoff_* above governs the whole-backend
    # supervisor, this one the per-shard regrow schedule
    mesh_backoff_base_ms: int = 1_000
    mesh_backoff_cap_ms: int = 60_000

    def validate_basic(self) -> None:
        if self.probe_backoff_base_ms <= 0:
            raise ValueError(
                "device.probe_backoff_base_ms must be positive")
        if self.probe_backoff_cap_ms < self.probe_backoff_base_ms:
            raise ValueError("device.probe_backoff_cap_ms must be >= "
                             "probe_backoff_base_ms")
        if self.probe_deadline_ms <= 0:
            raise ValueError("device.probe_deadline_ms must be positive")
        if not 0 <= self.mesh_devices < 255:
            # shard ids ride a u8 in the protocol attribution trailer
            # with 0xFF reserved for the CPU re-verify sentinel
            raise ValueError(
                "device.mesh_devices must be in [0, 254]")
        if self.mesh_sig_parallel < 0:
            raise ValueError("device.mesh_sig_parallel must be >= 0")
        if self.mesh_devices and self.mesh_sig_parallel \
                and self.mesh_devices % self.mesh_sig_parallel:
            # the typed factoring error surfaces at CONFIG time (the
            # parallel/mesh.MeshShapeError contract): a node booted
            # with an impossible mesh must fail validation, not crash
            # later inside topology discovery
            raise ValueError(
                f"device.mesh_devices={self.mesh_devices} does not "
                f"divide by mesh_sig_parallel={self.mesh_sig_parallel}")
        if not 1 <= self.mesh_tiles_per_shard <= 64:
            raise ValueError("device.mesh_tiles_per_shard must be in "
                             "[1, 64]")
        if self.mesh_backoff_base_ms <= 0:
            raise ValueError("device.mesh_backoff_base_ms must be "
                             "positive")
        if self.mesh_backoff_cap_ms < self.mesh_backoff_base_ms:
            raise ValueError("device.mesh_backoff_cap_ms must be >= "
                             "mesh_backoff_base_ms")


@dataclass
class StorageConfig:
    """reference config/config.go StorageConfig."""
    discard_abci_responses: bool = False   # drop FinalizeBlock responses
    #                                        (disables /block_results)
    pruning_interval_ms: int = 10_000      # background pruner cadence

    def validate_basic(self) -> None:
        if self.pruning_interval_ms <= 0:
            raise ValueError("pruning_interval must be positive")


@dataclass
class TxIndexConfig:
    """reference config/config.go TxIndexConfig."""
    indexer: str = "kv"                    # "kv" | "null" | "sqlite"

    def validate_basic(self) -> None:
        if self.indexer not in ("kv", "null", "sqlite"):
            raise ValueError(f"unknown indexer {self.indexer!r}")


@dataclass
class GRPCConfig:
    """reference config/config.go GRPCConfig: the companion gRPC
    surface. Empty laddr = disabled (the reference's default)."""
    laddr: str = ""
    version_service: bool = True
    block_service: bool = True
    block_results_service: bool = True
    # the privileged listener (reference GRPCPrivilegedConfig) is a
    # SEPARATE port: it exposes pruning control, which must not ride
    # the publicly-exposable laddr above
    privileged_laddr: str = ""
    pruning_service: bool = False

    def validate_basic(self) -> None:
        if self.pruning_service and not self.privileged_laddr:
            raise ValueError(
                "grpc pruning_service requires privileged_laddr")


@dataclass
class InstrumentationConfig:
    prometheus: bool = False
    prometheus_laddr: str = ""
    # flight-recorder tracing (docs/TRACE.md): spans land in a bounded
    # in-memory ring, dumped as JSONL on watchdog-trip / canary-failure
    # / shard-quarantine / shed-burst. Off by default — the disabled
    # path costs one attribute read per would-be span.
    trace: bool = False
    trace_ring: int = 4096             # ring capacity in spans
    trace_dump_dir: str = ""           # "" = in-memory dumps only

    def validate_basic(self) -> None:
        if self.trace_ring < 1:
            raise ValueError("instrumentation.trace_ring must be >= 1")


@dataclass
class Config:
    """reference config/config.go Config."""
    base: BaseConfig = dc_field(default_factory=BaseConfig)
    p2p: P2PConfig = dc_field(default_factory=P2PConfig)
    rpc: RPCConfig = dc_field(default_factory=RPCConfig)
    mempool: MempoolConfig = dc_field(default_factory=MempoolConfig)
    statesync: StateSyncConfig = dc_field(default_factory=StateSyncConfig)
    blocksync: BlockSyncConfig = dc_field(default_factory=BlockSyncConfig)
    device: DeviceConfig = dc_field(default_factory=DeviceConfig)
    consensus: ConsensusTimeoutsConfig = dc_field(
        default_factory=ConsensusTimeoutsConfig)
    storage: StorageConfig = dc_field(default_factory=StorageConfig)
    tx_index: TxIndexConfig = dc_field(default_factory=TxIndexConfig)
    grpc: GRPCConfig = dc_field(default_factory=GRPCConfig)
    instrumentation: InstrumentationConfig = dc_field(
        default_factory=InstrumentationConfig)
    root_dir: str = "."

    def validate_basic(self) -> None:
        if not self.base.chain_id:
            raise ValueError("chain_id must be set")
        if self.base.db_backend not in ("memdb", "filedb", "native"):
            raise ValueError(f"unknown db backend {self.base.db_backend}")
        pa = self.base.proxy_app
        if pa != "kvstore":
            # the built-in app, a tcp socket address, or a grpc address
            # (reference config.go ABCI = socket | grpc); no unix
            # sockets — fail at config time, not deep inside node boot
            addr = pa.removeprefix("tcp://").removeprefix("grpc://")
            _host, _, port = addr.rpartition(":")
            if pa.startswith("unix://") or not port.isdigit():
                raise ValueError(
                    f"proxy_app must be 'kvstore', tcp://host:port or "
                    f"grpc://host:port, got {pa!r}")
        for name in ("timeout_propose", "timeout_prevote",
                     "timeout_precommit", "timeout_commit"):
            if getattr(self.consensus, name) < 0:
                raise ValueError(f"negative {name}")
        self.rpc.validate_basic()
        self.statesync.validate_basic()
        self.blocksync.validate_basic()
        self.device.validate_basic()
        self.storage.validate_basic()
        self.tx_index.validate_basic()
        self.grpc.validate_basic()
        self.instrumentation.validate_basic()

    def path(self, rel: str) -> str:
        return os.path.join(self.root_dir, rel)

    # --- TOML round-trip ------------------------------------------------------

    def to_toml(self) -> str:
        import json as _json

        def emit(section: str, obj) -> str:
            lines = [f"[{section}]"]
            for k, v in asdict(obj).items():
                if isinstance(v, bool):
                    lines.append(f"{k} = {'true' if v else 'false'}")
                elif isinstance(v, int):
                    lines.append(f"{k} = {v}")
                else:
                    # JSON string escaping is valid TOML basic-string
                    # escaping (quotes, backslashes)
                    lines.append(f"{k} = {_json.dumps(str(v))}")
            return "\n".join(lines)
        return "\n\n".join([
            emit("base", self.base), emit("p2p", self.p2p),
            emit("rpc", self.rpc), emit("mempool", self.mempool),
            emit("statesync", self.statesync),
            emit("blocksync", self.blocksync),
            emit("device", self.device),
            emit("consensus", self.consensus),
            emit("storage", self.storage),
            emit("tx_index", self.tx_index),
            emit("grpc", self.grpc),
            emit("instrumentation", self.instrumentation)]) + "\n"

    @classmethod
    def from_toml(cls, text: str, root_dir: str = ".") -> "Config":
        d = loads_flat_toml(text)
        cfg = cls(root_dir=root_dir)
        for section, target in (("base", cfg.base), ("p2p", cfg.p2p),
                                ("rpc", cfg.rpc),
                                ("mempool", cfg.mempool),
                                ("statesync", cfg.statesync),
                                ("blocksync", cfg.blocksync),
                                ("device", cfg.device),
                                ("consensus", cfg.consensus),
                                ("storage", cfg.storage),
                                ("tx_index", cfg.tx_index),
                                ("grpc", cfg.grpc),
                                ("instrumentation", cfg.instrumentation)):
            for k, v in d.get(section, {}).items():
                if hasattr(target, k):
                    setattr(target, k, v)
        cfg.validate_basic()
        return cfg

    def write(self, path: Optional[str] = None) -> str:
        path = path or self.path("config/config.toml")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_toml())
        return path

    @classmethod
    def load(cls, root_dir: str) -> "Config":
        path = os.path.join(root_dir, "config/config.toml")
        with open(path) as f:
            return cls.from_toml(f.read(), root_dir)
