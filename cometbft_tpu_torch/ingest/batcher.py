"""Shared signature batch for tx admission: many concurrent txs'
envelope signatures verified as ONE device dispatch.

The batcher is stateless between flushes — the admission pipeline
(admission.py) owns the bounded FIFO of tickets and hands a snapshot's
lanes here. `verify()` collapses identical (pub, msg, sig) lanes
across txs, dispatches the unique lanes through the same
`device_or_cpu_backend` the farm uses, records verified-TRUE lanes in
the SigCache so a recheck-evicted tx resubmitted later re-enters without
a lane, and returns a verdict per lane key.

Port of `cometbft_tpu/ingest/batcher.py`. The JAX package's batcher
never reaches its XLA kernel (a compile hazard); the port's takes the
farm backend's routes on `device=` (default cuda): in process, a batch
of at least `farm.batcher.FARM_KERNEL_MIN_LANES` unique lanes runs the
RLC kernels ("kernel") and a narrower one verifies per signature on the
host ("cpu"); a kernel error or a canary trip propagates out of the
flush. Only a device-server batch drains to the host (counted in
`fallbacks`, traced as `farm.cpu_drain`).
"""

from __future__ import annotations

import functools
import inspect
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..device import resolve_device
from ..farm.batcher import device_or_cpu_backend
from ..pipeline.cache import SigCache
from ..trace import shared_tracer


@dataclass(frozen=True)
class SigLane:
    """One pending envelope-signature verification (a device lane).
    `key` is the SigCache identity of the triple — the dedup handle."""
    pub: bytes
    msg: bytes
    sig: bytes
    key: bytes

    @property
    def pk(self):
        """crypto PubKey view (the CPU-fallback verify seam the farm's
        backend expects on a lane)."""
        from ..crypto.keys import Ed25519PubKey
        return Ed25519PubKey(self.pub)


def native_backend(lanes: Sequence[SigLane]) -> Tuple[List[bool], str]:
    """Per-signature host verify — the deterministic no-device backend
    (tests inject it explicitly)."""
    return [lane.pk.verify_signature(lane.msg, lane.sig)
            for lane in lanes], "cpu"


class IngestBatcher:
    """Dedup + dispatch for one admission batch's signature lanes."""

    def __init__(self, cache: SigCache,
                 verify_backend: Optional[Callable] = None,
                 metrics=None, device=None):
        self.device = resolve_device(device)
        self.cache = cache
        self.metrics = metrics  # libs/metrics_gen.IngestMetrics or None
        self._backend = verify_backend or functools.partial(
            device_or_cpu_backend, device=self.device,
            on_drain=self._drained)
        # ctx propagation is opt-in per backend: injected test/sim
        # backends keep their plain (lanes) signature, the real
        # device_or_cpu_backend takes ctx= — decided ONCE here, not
        # with a TypeError-masking try/except per flush
        self._backend_takes_ctx = (
            "ctx" in inspect.signature(self._backend).parameters)
        # monotonic stats (single-writer: the pipeline serializes
        # flushes)
        self.batches = 0
        self.last_batch_width = 0
        self.max_batch_width = 0
        self.dedup_batch_hits = 0
        self.lanes_by_backend: Dict[str, int] = {}
        # device-server batches re-verified on the host (farm.cpu_drain)
        self.fallbacks = 0

    def _drained(self) -> None:
        self.fallbacks += 1

    def verify(self, lanes: Sequence[SigLane],
               ctx=None) -> Dict[bytes, bool]:
        """Verdict per unique lane key for everything in `lanes`.
        Identical lanes are verified once; verified-TRUE triples land
        in the SigCache. An empty lane list costs nothing (a batch of
        bare/cache-hit txs dispatches no device work). `ctx` is the
        flush span's trace context, forwarded to a ctx-aware backend."""
        if not lanes:
            return {}
        unique: List[SigLane] = []
        index: Dict[bytes, int] = {}
        for lane in lanes:
            if lane.key not in index:
                index[lane.key] = len(unique)
                unique.append(lane)
            else:
                self.dedup_batch_hits += 1
                if self.metrics is not None:
                    self.metrics.dedup_hits.inc(kind="batch")
        with shared_tracer().start("ingest.verify", parent=ctx,
                                   lanes=len(unique)) as span:
            if self._backend_takes_ctx:
                oks, backend = self._backend(unique, ctx=span)
            else:
                oks, backend = self._backend(unique)
            span.set_attr("backend", backend)
        if len(oks) != len(unique):
            raise RuntimeError(
                f"verify backend answered {len(oks)} lanes "
                f"for {len(unique)}")
        self.batches += 1
        self.last_batch_width = len(unique)
        self.max_batch_width = max(self.max_batch_width, len(unique))
        self.lanes_by_backend[backend] = (
            self.lanes_by_backend.get(backend, 0) + len(unique))
        if self.metrics is not None:
            self.metrics.batches.inc()
            self.metrics.batch_width.set(len(unique))
            self.metrics.lanes.inc(len(unique), backend=backend)
        verdicts: Dict[bytes, bool] = {}
        for lane, ok in zip(unique, oks):
            ok = bool(ok)
            verdicts[lane.key] = ok
            if ok:
                self.cache.add(lane.pub, lane.msg, lane.sig)
        return verdicts
