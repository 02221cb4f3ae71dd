"""Host-side observability for the pruning engine.

Three parts (stdlib only, strictly host-side):

* :mod:`repro_torch.obs.metrics`: thread-safe counters, gauges and
  histograms in a process-wide ``REGISTRY``;
* :mod:`repro_torch.obs.trace`: nestable wall-clock spans exported as
  Chrome trace-event JSON (load in Perfetto);
* :mod:`repro_torch.obs.report`: the per-call ``ExecReport`` that entry
  points attach to their results, and the ``Recorder`` / ``NULL`` behind
  ``ExecOptions.obs = "off" | "counters" | "trace"``.

Plus :mod:`repro_torch.obs.log`, the structured ``repro_torch.*`` logger.

No instrument touches a kernel's input or output: everything is fed from
masks already written, static metadata and host timestamps, so the
engine's masks are bit-identical whatever the obs level.
"""
from . import log, metrics, report, trace
from .log import get_logger
from .metrics import REGISTRY, Registry
from .report import (NULL, OBS_MODES, ExecReport, Recorder, default_level,
                     recorder, set_default_level)
from .trace import TRACER, Tracer

__all__ = [
    "log", "metrics", "report", "trace",
    "get_logger",
    "REGISTRY", "Registry",
    "NULL", "OBS_MODES", "ExecReport", "Recorder",
    "default_level", "recorder", "set_default_level",
    "TRACER", "Tracer",
]
