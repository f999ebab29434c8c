"""The three generated metrics structs the port uses: `PipelineMetrics`
(the pipelined blocksync scheduler, its watchdog and the signature
cache), `DeviceMetrics` (the device health supervisor) and
`AggsigMetrics` (aggregated-commit verification).

Copied from `cometbft_tpu/libs/metrics_gen.py` (:23, :43 and :103), which
tools/metricsgen.py generates from the JAX package's
libs/metrics_defs.py. The port keeps only these three; regenerate there
and copy again if their definitions change. Two help texts say what the
port does where it differs: `aggsig_aggregates_verified` is labelled by
the device the kernels ran on, and a wrong canary raises
(`aggsig_canary_failures`)."""

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
