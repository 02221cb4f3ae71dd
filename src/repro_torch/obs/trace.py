"""Nestable wall-clock spans + Chrome trace-event export.

``Tracer.span("pass1")`` times a region with ``time.perf_counter`` and
records one complete ("X") Chrome trace event — the JSON format both
Perfetto (https://ui.perfetto.dev) and ``chrome://tracing`` load
directly. Spans nest through a thread-local stack, so the exported
trace shows the engine's phase hierarchy (engine_prune > pass1 /
gather_merge / pass2_apply) on one track per thread.

Timing is wall-clock around the host-side calls. CUDA kernels run
asynchronously, so a span that should hold its phase's device work
synchronises the card at its exit (``Recorder.sync`` in
``repro_torch.obs.report``): that adds sync points in ``obs="trace"`` mode
but never changes a computed value. Nothing here runs inside a kernel.
"""
from __future__ import annotations

import json
import os
import threading
import time


class _Span:
    """Context manager recording one complete event on exit."""

    __slots__ = ("_tracer", "name", "args", "_t0", "_depth", "_sink")

    def __init__(self, tracer: "Tracer", name: str, args: dict | None,
                 sink: list | None):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._sink = sink

    def __enter__(self):
        stack = self._tracer._stack()
        self._depth = len(stack)
        stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        stack = self._tracer._stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        ev = {
            "name": self.name,
            "ph": "X",
            "ts": (self._t0 - self._tracer.epoch) * 1e6,
            "dur": (t1 - self._t0) * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": dict(self.args or {}, depth=self._depth),
        }
        self._tracer._append(ev)
        if self._sink is not None:
            self._sink.append(ev)
        return False


class Tracer:
    """Process-wide span collector (one instance per export scope)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._local = threading.local()
        self.epoch = time.perf_counter()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _append(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    def span(self, name: str, args: dict | None = None,
             sink: list | None = None) -> _Span:
        """Open a nested span; ``sink`` additionally receives the event
        (per-call ``ExecReport`` collection)."""
        return _Span(self, name, args, sink)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object (load in Perfetto)."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def write(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
        self.epoch = time.perf_counter()


# the process-wide tracer every Recorder feeds (tests reset per case)
TRACER = Tracer()
