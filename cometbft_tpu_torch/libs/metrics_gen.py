"""The generated metrics structs the port uses: `PipelineMetrics`
(the pipelined blocksync scheduler, its watchdog and the signature
cache), `DeviceMetrics` (the device health supervisor), `AggsigMetrics`
(aggregated-commit verification), `FarmMetrics` (the light-client
verification farm), `IngestMetrics` (batched tx admission),
`SealsyncMetrics` (seal sync), `MempoolMetrics`, `StorageMetrics` (the
recovery doctor, FileDB replay, the WAL), `P2PMetrics` (the switch) and
`TraceMetrics` (the flight recorder, configured by node boot).

Copied from `cometbft_tpu/libs/metrics_gen.py` (:23, :43, :57, :79,
:103, :155, :193, :177, :9 and :141), which tools/metricsgen.py generates
from the JAX package's libs/metrics_defs.py. The port keeps only these; regenerate
there and copy again if their definitions change. Names and labels are
the JAX package's. Help texts say what the port does where it differs:
`aggsig_aggregates_verified` is labelled by the device the kernels ran
on, a wrong canary raises (`aggsig_canary_failures`), and the farm's
`kernel` backend is the batch kernels on the batcher's device, chosen
by width (`farm_lanes_verified`)."""

from __future__ import annotations

from .metrics import Registry


class PipelineMetrics:
    """Generated metrics struct (7 metrics)."""

    def __init__(self, reg: Registry):
        self.tiles_in_flight = reg.gauge(
            'pipeline_tiles_in_flight', 'Tiles dispatched to the verify backend but not yet applied')
        self.stage_occupancy = reg.gauge(
            'pipeline_stage_occupancy', 'Tiles resident per pipeline stage', label_names=['stage'])
        self.tiles_dispatched = reg.counter(
            'pipeline_tiles_dispatched', 'Tiles submitted to the verify backend')
        self.wedge_fallbacks = reg.counter(
            'pipeline_wedge_fallbacks', 'Tiles drained to the CPU fallback by the device-wedge watchdog')
        self.cache_hits = reg.counter(
            'pipeline_sigcache_hits', 'Verified-signature cache hits, by intake path', label_names=['path'])
        self.cache_misses = reg.counter(
            'pipeline_sigcache_misses', 'Verified-signature cache misses, by intake path', label_names=['path'])
        self.cache_evictions = reg.counter(
            'pipeline_sigcache_evictions', 'Verified-signature cache LRU evictions')


class DeviceMetrics:
    """Generated metrics struct (4 metrics)."""

    def __init__(self, reg: Registry):
        self.health_state = reg.gauge(
            'device_health_state', 'Verify-backend health state (0=healthy 1=suspect 2=probing 3=quarantined)')
        self.probes_total = reg.counter(
            'device_probes_total', 'Known-answer probe batches sent to a suspect verify backend')
        self.quarantines_total = reg.counter(
            'device_quarantines_total', 'Terminal verify-backend quarantines (corrupt verdicts)')
        self.canary_failures = reg.counter(
            'device_canary_failures', 'Device batches whose canary lanes answered wrong')


class AggsigMetrics:
    """Generated metrics struct (4 metrics)."""

    def __init__(self, reg: Registry):
        self.pairings_total = reg.counter(
            'aggsig_pairings_total', 'Miller-loop evaluations spent verifying aggregated commits (the O(1)-per-commit evidence vs 2n per-signature)')
        self.aggregates_verified = reg.counter(
            'aggsig_aggregates_verified', 'Aggregated-commit final-exponentiation verdicts settled by the BLS kernels, by device (cuda vs cpu, where the plain versions run)', label_names=['backend'])
        self.pop_rejections = reg.counter(
            'aggsig_pop_rejections', 'Proof-of-possession failures (bad PoP at admission, or an aggregate signer without a registered PoP)')
        self.canary_failures = reg.counter(
            'aggsig_canary_failures', 'Kernel batches whose known-answer canaries answered wrong (KernelCanaryError raised; nothing re-runs on the CPU)')


class FarmMetrics:
    """Generated metrics struct (8 metrics)."""

    def __init__(self, reg: Registry):
        self.sessions = reg.gauge(
            'farm_sessions', 'Active light-client sessions')
        self.headers_accepted = reg.counter(
            'farm_headers_accepted', 'Headers accepted into session trust stores')
        self.headers_rejected = reg.counter(
            'farm_headers_rejected', 'Verify/subscribe requests rejected by the acceptance rules')
        self.batches = reg.counter(
            'farm_batches', 'Coalesced verify batches flushed')
        self.batch_width = reg.gauge(
            'farm_batch_width', 'Unique-lane width of the most recent coalesced batch')
        self.lanes = reg.counter(
            'farm_lanes_verified', 'Signature lanes verified, by backend (device = server seam, kernel = the batch kernels in process on the batcher device, cpu = per-signature host verify)', label_names=['backend'])
        self.dedup_hits = reg.counter(
            'farm_dedup_hits', 'Lanes skipped by dedup (batch=intra-batch; SigCache hits show under pipeline_sigcache_hits path=farm)', label_names=['kind'])
        self.shed = reg.counter(
            'farm_shed_total', 'Requests shed by backpressure (session cap or lane queue)')


class IngestMetrics:
    """Generated metrics struct (9 metrics)."""

    def __init__(self, reg: Registry):
        self.queue_depth = reg.gauge(
            'ingest_queue_depth', 'Txs parked in the admission queue awaiting a batch flush')
        self.batch_width = reg.gauge(
            'ingest_batch_width', 'Unique signature lanes in the most recent admission batch')
        self.batches = reg.counter(
            'ingest_batches', 'Coalesced admission batches flushed')
        self.admitted = reg.counter(
            'ingest_admitted_txs', 'Txs admitted into the mempool through the ingest pipeline')
        self.rejected = reg.counter(
            'ingest_rejected_txs', 'Txs rejected at admission, by reason (sig=bad envelope signature, app=app CheckTx code, mempool=structural)', label_names=['reason'])
        self.shed = reg.counter(
            'ingest_shed_total', 'Txs shed by admission-queue backpressure')
        self.dedup_hits = reg.counter(
            'ingest_dedup_hits', 'Admission dedup hits (txhash=duplicate filter, batch=intra-batch lane collapse; SigCache hits show under pipeline_sigcache_hits path=ingest)', label_names=['kind'])
        self.lanes = reg.counter(
            'ingest_lanes_verified', 'Tx signature lanes verified, by backend (device = server seam, kernel = the batch kernels in process on the batcher device, cpu = per-signature host verify)', label_names=['backend'])
        self.admission_latency = reg.histogram(
            'ingest_admission_latency_seconds', 'Submit-to-verdict admission latency, seconds')


class SealsyncMetrics:
    """Generated metrics struct (8 metrics)."""

    def __init__(self, reg: Registry):
        self.seals_served = reg.counter(
            'sealsync_seals_served', 'Seal tuples served to catching-up peers')
        self.serve_sheds = reg.counter(
            'sealsync_serve_sheds', 'Seal-range requests shed by provider backpressure')
        self.seals_adopted = reg.counter(
            'sealsync_seals_adopted', 'Decided heights adopted from seals (pivot or skipped)')
        self.pivots_verified = reg.counter(
            'sealsync_pivots_verified', 'Pivot seals settled through the pairing checker')
        self.pairings_skipped = reg.counter(
            'sealsync_pairings_skipped', 'Adopted heights whose pairing was elided by hash-chain binding to a verified pivot')
        self.adoptions_rejected = reg.counter(
            'sealsync_adoptions_rejected', 'Seal spans rejected (chain-rule violation, bad epoch PoP, or forged pivot pairing)')
        self.pop_rejections = reg.counter(
            'sealsync_pop_rejections', 'Epoch validator-set PoPs that failed verification during adoption')
        self.adopted_tip = reg.gauge(
            'sealsync_adopted_tip', 'Highest height with adopted (seal-derived) finality')


class MempoolMetrics:
    """Generated metrics struct (5 metrics)."""

    def __init__(self, reg: Registry):
        self.size = reg.gauge(
            'mempool_size', 'Transactions in the mempool')
        self.size_bytes = reg.gauge(
            'mempool_size_bytes', 'Total byte size of mempool transactions')
        self.failed_txs = reg.counter(
            'mempool_failed_txs', 'Transactions rejected by CheckTx')
        self.evicted_txs = reg.counter(
            'mempool_evicted_txs', 'Txs removed as invalid on post-commit recheck')
        self.recheck_times = reg.counter(
            'mempool_recheck_times', 'Post-commit recheck passes over the pool')


class StorageMetrics:
    """Generated metrics struct (5 metrics)."""

    def __init__(self, reg: Registry):
        self.doctor_runs = reg.counter(
            'storage_doctor_runs', 'Boot-time recovery-doctor passes completed')
        self.doctor_repairs = reg.counter(
            'storage_doctor_repairs', 'Recovery-doctor repairs applied, by kind (meta-without-parts, orphaned-adopted-seal, stale-compact, stale-pv-tmp)', label_names=['kind'])
        self.wal_corruption = reg.counter(
            'storage_wal_corruption', 'Mid-group WAL CRC/length corruption events that truncated replay (disk damage, not crash-repair)')
        self.torn_batches = reg.counter(
            'storage_torn_batches', 'Uncommitted FileDB batch tails discarded at replay (crashed write_batch rolled back all-or-nothing)')
        self.crc_failures = reg.counter(
            'storage_crc_failures', 'FileDB v2 records failing CRC at replay (bit-rot detected instead of silently replayed)')


class P2PMetrics:
    """Generated metrics struct (4 metrics)."""

    def __init__(self, reg: Registry):
        self.peers = reg.gauge(
            'p2p_peers', 'Number of connected peers')
        self.message_send_bytes_total = reg.counter(
            'p2p_message_send_bytes_total', 'Bytes sent to peers, by channel', label_names=['ch_id'])
        self.message_receive_bytes_total = reg.counter(
            'p2p_message_receive_bytes_total', 'Bytes received from peers, by channel', label_names=['ch_id'])
        self.peer_dial_failures = reg.counter(
            'p2p_peer_dial_failures', 'Failed outbound dial attempts')


class TraceMetrics:
    """Generated metrics struct (4 metrics)."""

    def __init__(self, reg: Registry):
        self.spans = reg.counter(
            'trace_spans_recorded', 'Spans recorded into the flight-recorder ring')
        self.dropped = reg.counter(
            'trace_spans_dropped', 'Spans evicted from the full ring (drop-oldest)')
        self.dumps = reg.counter(
            'trace_dumps_total', 'Flight-recorder dumps, by trigger kind (watchdog-trip, canary-failure, shard-quarantine, shed-burst)', label_names=['kind'])
        self.ring_occupancy = reg.gauge(
            'trace_ring_occupancy', 'Spans currently resident in the flight-recorder ring')
