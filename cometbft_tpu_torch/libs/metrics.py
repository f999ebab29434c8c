"""Prometheus-style metrics (reference scripts/metricsgen + the
per-package metrics.go structs, e.g. internal/consensus/metrics.go:34).

Counters, gauges, and histograms with label support, rendered in the
Prometheus text exposition format. `Registry.expose()` plugs into any
HTTP handler (config [instrumentation], reference config.go:1378-1384).
Metrics structs come in two flavors: hand-written (ConsensusMetrics
below, which consensus/state.py fills) and GENERATED in the JAX package
(tools/metricsgen.py from libs/metrics_defs.py into libs/metrics_gen.py);
the port keeps a copy of the generated structs it uses in its own
`libs/metrics_gen.py`.

Copy of `cometbft_tpu/libs/metrics.py` (the port keeps its own).
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Dict, List, Sequence, Tuple


class _Metric:
    def __init__(self, name: str, help_: str, label_names: Sequence[str]):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        return tuple(labels.get(n, "") for n in self.label_names)

    @staticmethod
    def _fmt_labels(names, values) -> str:
        if not names:
            return ""
        inner = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
        return "{" + inner + "}"


class Counter(_Metric):
    def __init__(self, name, help_="", label_names=()):
        super().__init__(name, help_, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            k = self._key(labels)
            self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} counter"]
        with self._lock:  # writers insert label keys concurrently
            items = sorted(self._values.items())
        for k, v in items:
            out.append(f"{self.name}"
                       f"{self._fmt_labels(self.label_names, k)} {v}")
        return out


class Gauge(_Metric):
    def __init__(self, name, help_="", label_names=()):
        super().__init__(name, help_, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def add(self, amount: float, **labels) -> None:
        with self._lock:
            k = self._key(labels)
            self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        with self._lock:  # writers insert label keys concurrently
            items = sorted(self._values.items())
        for k, v in items:
            out.append(f"{self.name}"
                       f"{self._fmt_labels(self.label_names, k)} {v}")
        return out


DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 2.5, 5, 10)


class Histogram(_Metric):
    """Step-duration histograms double as consensus timing metrics
    (reference RoundDurationSeconds, BlockProcessingTime)."""

    def __init__(self, name, help_="", label_names=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}

    def observe(self, value: float, **labels) -> None:
        with self._lock:
            k = self._key(labels)
            counts = self._counts.setdefault(
                k, [0] * (len(self.buckets) + 1))
            counts[bisect_right(self.buckets, value)] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:  # snapshot: observe() mutates concurrently
            items = [(k, list(c), self._sums[k])
                     for k, c in sorted(self._counts.items())]
        for k, counts, total_sum in items:
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += counts[i]
                names = self.label_names + ("le",)
                vals = k + (str(b),)
                out.append(f"{self.name}_bucket"
                           f"{self._fmt_labels(names, vals)} {cum}")
            total = sum(counts)
            names = self.label_names + ("le",)
            out.append(f"{self.name}_bucket"
                       f"{self._fmt_labels(names, k + ('+Inf',))} {total}")
            out.append(f"{self.name}_sum"
                       f"{self._fmt_labels(self.label_names, k)} "
                       f"{total_sum}")
            out.append(f"{self.name}_count"
                       f"{self._fmt_labels(self.label_names, k)} {total}")
        return out


class CallbackGauge(_Metric):
    """Gauge whose value is read from a callable at scrape time — for
    counters owned by modules that must not depend on a Registry (e.g.
    the ops-layer pallas canary, ops/ed25519.canary_stats)."""

    def __init__(self, name, help_="", fn=None):
        super().__init__(name, help_, ())
        self._fn = fn or (lambda: 0.0)

    def value(self) -> float:
        return float(self._fn())

    def expose(self) -> List[str]:
        try:
            v = float(self._fn())
        except Exception:  # noqa: BLE001 — scrape must never die
            v = float("nan")
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} gauge",
                f"{self.name} {v}"]


class Registry:
    def __init__(self, namespace: str = "cometbft_tpu"):
        self.namespace = namespace
        self._metrics: List[_Metric] = []
        self._lock = threading.Lock()

    def counter(self, name, help_="", label_names=()) -> Counter:
        return self._add(Counter(f"{self.namespace}_{name}", help_,
                                 label_names))

    def gauge(self, name, help_="", label_names=()) -> Gauge:
        return self._add(Gauge(f"{self.namespace}_{name}", help_,
                               label_names))

    def histogram(self, name, help_="", label_names=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._add(Histogram(f"{self.namespace}_{name}", help_,
                                   label_names, buckets))

    def callback_gauge(self, name, help_="", fn=None) -> CallbackGauge:
        return self._add(CallbackGauge(f"{self.namespace}_{name}",
                                       help_, fn))

    def _add(self, m):
        with self._lock:
            self._metrics.append(m)
        return m

    def expose(self) -> str:
        lines: List[str] = []
        for m in self._metrics:
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"


class ConsensusMetrics:
    """The reference's consensus metrics struct
    (internal/consensus/metrics.go), constructed over a Registry."""

    def __init__(self, reg: Registry):
        self.height = reg.gauge("consensus_height", "Committed height")
        self.rounds = reg.counter("consensus_rounds",
                                  "Rounds entered", ["reason"])
        self.round_duration = reg.histogram(
            "consensus_round_duration_seconds",
            "Time spent per consensus round")
        self.block_processing = reg.histogram(
            "consensus_block_processing_seconds",
            "ApplyBlock wall time")
        self.validators = reg.gauge("consensus_validators",
                                    "Validator-set size")
        self.byzantine_validators = reg.counter(
            "consensus_byzantine_validators",
            "Conflicting votes observed")
        self.sigs_verified = reg.counter(
            "crypto_sigs_verified", "Signatures verified", ["path"])
