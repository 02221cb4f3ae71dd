"""Per-call ``ExecReport`` and the ``Recorder`` that entry points use.

Every instrumented entry point (``engine_prune``, ``run_query``) creates a
:func:`recorder` at the top, feeds it host-side facts while it runs, and
attaches ``rec.finish()``, an :class:`ExecReport`, to its result. The
recorder mirrors everything into the process-wide
``repro_torch.obs.metrics.REGISTRY`` under ``f"{entry}.{name}"`` keys and,
in ``"trace"`` mode, opens spans on ``repro_torch.obs.trace.TRACER``.

No instrument touches a kernel's input or output:

* counters read masks the kernels have already written (one sum and one
  host read of the count) and static metadata (``x.nbytes``);
* when the entry itself is being compiled (``torch.compiler.is_compiling()``)
  the factory gives the shared :data:`NULL` no-op recorder, so no host read
  lands in a graph;
* ``obs="off"`` gives :data:`NULL` too, a singleton whose methods are all
  constant-time no-ops.

Masks are therefore bit-identical with obs off, on, or tracing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import torch

from . import metrics, trace

# valid values for ExecOptions.obs / set_default_level
OBS_MODES = ("off", "counters", "trace")

_default_level = "counters"


def default_level() -> str:
    """Process-wide obs level used when ``ExecOptions.obs`` is unset."""
    return _default_level


def set_default_level(level: str) -> None:
    if level not in OBS_MODES:
        raise ValueError(
            f"obs level must be one of {OBS_MODES}, got {level!r}")
    global _default_level
    _default_level = level


@dataclasses.dataclass
class ExecReport:
    """What one engine call did: counters, spans, and identity.

    ``counters`` holds this call's local values (the registry holds the
    process-wide running totals); ``spans`` the Chrome trace events this
    call emitted (empty unless ``obs="trace"``).
    """

    entry: str
    meta: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    spans: list = dataclasses.field(default_factory=list)
    wall_us: float = 0.0

    def _c(self, name, default=0):
        return self.counters.get(name, default)

    @property
    def entries_scanned(self) -> int:
        return int(self._c("entries_scanned"))

    @property
    def entries_kept(self) -> int:
        return int(self._c("entries_kept"))

    @property
    def prune_ratio(self) -> float:
        return float(self._c("prune_ratio", 0.0))

    @property
    def state_bytes_shipped(self) -> int:
        return int(self._c("state_bytes_shipped"))

    @property
    def merge_collective_count(self) -> int:
        return int(self._c("merge_collective_count"))

    def summary(self) -> str:
        """Pretty-printed per-query summary (one string, many lines)."""
        lines = [f"ExecReport[{self.entry}]"]
        for k, v in sorted(self.meta.items()):
            lines.append(f"  {k:<26} {v}")
        for k in sorted(self.counters):
            v = self.counters[k]
            if isinstance(v, float):
                lines.append(f"  {k:<26} {v:.4f}")
            else:
                lines.append(f"  {k:<26} {v}")
        if self.wall_us:
            lines.append(f"  {'wall_us':<26} {self.wall_us:.1f}")
        for ev in self.spans:
            depth = int(ev.get("args", {}).get("depth", 0))
            lines.append(
                f"  span {'  ' * depth}{ev['name']:<{22 - 2 * depth}} "
                f"{ev['dur']:>10.1f} us")
        return "\n".join(lines)


class _NullRecorder:
    """The strict no-op fast path (``obs="off"``, or under compilation)."""

    __slots__ = ()
    active = False
    level = "off"

    def count(self, name, value=1):
        pass

    def observe(self, name, value):
        pass

    def annotate(self, **meta):
        pass

    def span(self, name, **args):
        return contextlib.nullcontext()

    def sync(self, x):
        return x

    def finish(self):
        return None


NULL = _NullRecorder()


class Recorder:
    """Accumulates one call's telemetry; ``finish()`` -> ExecReport."""

    active = True

    def __init__(self, entry: str, level: str,
                 registry: metrics.Registry | None = None,
                 tracer: trace.Tracer | None = None):
        self.entry = entry
        self.level = level
        self.registry = metrics.REGISTRY if registry is None else registry
        self.tracer = trace.TRACER if tracer is None else tracer
        self.counters: dict[str, Any] = {}
        self.meta: dict[str, Any] = {}
        self.spans: list[dict] = []
        self._t0 = time.perf_counter()
        self.registry.record(f"{entry}.dispatch_count", 1)

    def count(self, name: str, value=1) -> None:
        """Add to a local counter and the registry (``*_ratio`` names
        are last-value gauges in both)."""
        if name.endswith("_ratio"):
            self.counters[name] = float(value)
        else:
            self.counters[name] = self.counters.get(name, 0) + value
        self.registry.record(f"{self.entry}.{name}", value)

    def observe(self, name: str, value) -> None:
        """Feed a registry histogram; locally keep last/max."""
        self.registry.histogram(f"{self.entry}.{name}").observe(value)
        self.counters[f"{name}_max"] = max(
            self.counters.get(f"{name}_max", value), value)

    def annotate(self, **meta) -> None:
        self.meta.update(meta)

    def span(self, name: str, **args):
        """Trace-mode nested span; a no-op context otherwise."""
        if self.level != "trace":
            return contextlib.nullcontext()
        return self.tracer.span(f"{self.entry}.{name}", args=args or None,
                                sink=self.spans)

    def sync(self, x):
        """In trace mode, synchronise the card that holds ``x`` (any tensor
        among its leaves) so span walls measure the kernels, not their
        launches. Identity otherwise; never changes values."""
        if self.level == "trace" and x is not None:
            dev = _cuda_device(x)
            if dev is not None:
                torch.cuda.synchronize(dev)
        return x

    def finish(self) -> ExecReport:
        self.counters.setdefault("merge_collective_count", 0)
        if ("entries_scanned" in self.counters
                and "entries_kept" in self.counters
                and "prune_ratio" not in self.counters):
            scanned = self.counters["entries_scanned"]
            kept = self.counters["entries_kept"]
            ratio = 1.0 - kept / scanned if scanned else 0.0
            self.count("prune_ratio", ratio)
        wall = (time.perf_counter() - self._t0) * 1e6
        return ExecReport(entry=self.entry, meta=dict(self.meta),
                          counters=dict(self.counters),
                          spans=list(self.spans), wall_us=wall)


def _cuda_device(x):
    """The CUDA device of the first tensor among ``x``'s leaves (a tensor, a
    tuple or list, or a dataclass of tensors), or None."""
    if isinstance(x, torch.Tensor):
        return x.device if x.is_cuda else None
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        for v in x:
            dev = _cuda_device(v)
            if dev is not None:
                return dev
    return None


def _compiling() -> bool:
    compiler = getattr(torch, "compiler", None)
    return bool(compiler is not None and compiler.is_compiling())


def recorder(entry: str, level: str | None = None):
    """The factory every instrumented entry point calls.

    Returns :data:`NULL` when obs is off, or when the caller is being
    compiled (``torch.compiler.is_compiling()``: a host read there would
    bake one call's values into the graph)."""
    lvl = _default_level if level is None else level
    if lvl not in OBS_MODES:
        raise ValueError(f"obs level must be one of {OBS_MODES}, got {lvl!r}")
    if lvl == "off" or _compiling():
        return NULL
    return Recorder(entry, lvl)
