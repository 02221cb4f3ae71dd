"""Thread-safe metrics registry: counters, gauges, histograms.

Stdlib only and strictly host-side: instruments are fed from masks
already computed, static metadata and host timestamps, never from inside a
kernel or a compiled graph, so the engine's keep masks are bit-identical
with observability on or off (see ``repro_torch.obs``).

The paper-grounded instrument catalog (names as they appear in the
process-wide ``REGISTRY``, prefixed by the entry point that recorded
them, e.g. ``engine_prune.entries_kept``):

==============================  =========  ==============================
instrument                      kind       meaning
==============================  =========  ==============================
entries_scanned                 counter    stream entries seen by pass 1
entries_kept                    counter    survivors in the final mask
prune_ratio                     gauge      1 - kept/scanned (per call)
state_bytes_shipped             counter    bytes crossing the wire per
                                           merge collective (§4.3/§9)
merge_collective_count          counter    merge collectives dispatched
dispatch_count                  counter    engine invocations
decode_skipped_ratio            gauge      encoded rows never decoded
snapshot_staleness_batches      histogram  folds since the live-mask
                                           snapshot was merged
window_occupancy                histogram  in-flight live masks after
                                           each streaming fold
tune_candidates                 counter    plans raced (``planner.tune``)
plan_cache_hit / _miss          counter    tuner lookups that replayed a
                                           cached plan / found none
hits / misses / evictions /     counter    plan-cache traffic
corruption_fallbacks                       (``plancache.*``)
==============================  =========  ==============================

The JAX package's ``planner.tune`` also counts ``compile_count``, once a
raced candidate, because each candidate compiles an XLA executable.
Nothing compiles in the port (its kernels are built once a process), so
the port does not count it.
"""
from __future__ import annotations

import threading


class Counter:
    """Monotonic sum. ``inc`` is atomic under the registry lock."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0

    def inc(self, n=1) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-written value (ratios, occupancies-at-a-point)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def set(self, v) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Summary stats + a bounded sample reservoir for percentiles."""

    __slots__ = ("_lock", "count", "total", "min", "max", "_samples")
    MAX_SAMPLES = 512

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._samples: list[float] = []

    def observe(self, v) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if len(self._samples) < self.MAX_SAMPLES:
                self._samples.append(v)
            else:
                # deterministic decimating reservoir: overwrite round-robin
                self._samples[self.count % self.MAX_SAMPLES] = v

    @property
    def mean(self) -> float:
        with self._lock:
            return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (q in [0, 100]) of the reservoir."""
        with self._lock:
            if not self._samples:
                return 0.0
            s = sorted(self._samples)
            i = min(len(s) - 1, max(0, round(q / 100 * (len(s) - 1))))
            return s[i]

    def summary(self) -> dict:
        with self._lock:
            return dict(count=self.count, total=self.total,
                        min=self.min, max=self.max,
                        mean=self.total / self.count if self.count else 0.0)


class Registry:
    """Name -> instrument, created on first use. Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def _get(self, table: dict, name: str, cls):
        with self._lock:
            inst = table.get(name)
            if inst is None:
                inst = table[name] = cls(self._lock)
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, name, Histogram)

    def record(self, name: str, value) -> None:
        """Route by name convention: ``*_ratio`` -> gauge, everything
        else -> counter (the Recorder's one-liner)."""
        if name.endswith("_ratio"):
            self.gauge(name).set(value)
        else:
            self.counter(name).inc(value)

    def snapshot(self) -> dict:
        """Flat name -> value/summary dict of everything recorded."""
        with self._lock:
            out: dict = {k: c.value for k, c in self._counters.items()}
            out.update({k: g.value for k, g in self._gauges.items()})
            hists = list(self._histograms.items())
        out.update({k: h.summary() for k, h in hists})
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


# the process-wide default registry (tests reset it per case)
REGISTRY = Registry()
