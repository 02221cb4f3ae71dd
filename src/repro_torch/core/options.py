"""ExecOptions: one frozen bundle for the engine's execution knobs.

Seven knobs (``mode`` / ``shards`` / ``pass2`` / ``apply_block`` /
``tune`` / ``plan_cache`` / ``decode``) and the telemetry level ``obs``,
which ``engine_prune`` and ``run_query`` also take as keyword arguments.
Build one, pass it as ``options=`` to either entry point. Fields default to
``None``, "the entry point's default", so one options object can be shared
across entry points whose defaults differ.

The keyword arguments keep working: each entry point merges them through
``ExecOptions.resolve``, which warns (``UserWarning``, and the
``repro_torch.core.options`` logger) when both name the same knob with
different values; ``options=`` wins.

``decode`` governs encoded streams: ``"auto"`` / ``"late"`` prune on codes
and decode survivors only; ``"eager"`` decodes every stream up front.
``obs`` selects the telemetry level (``repro_torch.obs``): ``"off"`` is a
strict no-op, ``"counters"`` (the process default) feeds the metrics
registry and attaches an ``ExecReport`` to results, ``"trace"`` also
records wall-clock spans for Chrome-trace export. No instrument touches a
kernel's input or output, so masks are bit-identical at every level.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from ..obs import log as _obslog
from ..obs.report import OBS_MODES

DECODE_MODES = ("auto", "late", "eager")


@dataclasses.dataclass(frozen=True)
class ExecOptions:
    """Execution knobs for the pruning engine entry points.

    Every field defaults to ``None``, "use the entry point's default".
    Entry points reject fields that do not apply to them with a
    ``ValueError`` (``require_unset``) rather than ignoring them.
    """

    mode: str | None = None          # scan | sharded | two_pass | mesh
    shards: Any = None               # int | "auto"
    pass2: str | None = None         # master | mesh | auto
    apply_block: int | None = None   # pass-2 chunk size
    tune: str | None = None          # off | cached | race
    plan_cache: Any = None           # PlanCache override for tune
    decode: str | None = None        # auto | late | eager
    obs: str | None = None           # off | counters | trace

    def __post_init__(self):
        if self.decode is not None and self.decode not in DECODE_MODES:
            raise ValueError(f"decode must be one of {DECODE_MODES}, "
                             f"got {self.decode!r}")
        if self.obs is not None and self.obs not in OBS_MODES:
            raise ValueError(f"obs must be one of {OBS_MODES}, "
                             f"got {self.obs!r}")

    @classmethod
    def resolve(cls, options: "ExecOptions | None", **kwargs,
                ) -> "ExecOptions":
        """Merge the keyword arguments into ``options``; ``options`` wins.

        ``kwargs`` are the entry point's keyword arguments, ``None`` for
        "not given". A knob set both ways with different values warns and
        takes the ``options`` value.
        """
        if options is None:
            return cls(**kwargs)
        if not isinstance(options, cls):
            raise TypeError(f"options must be ExecOptions, "
                            f"got {type(options).__name__}")
        merged = {}
        for field in dataclasses.fields(cls):
            opt_v = getattr(options, field.name)
            kw_v = kwargs.get(field.name)
            if opt_v is not None and kw_v is not None and opt_v != kw_v:
                _obslog.warn(
                    f"{field.name!r} specified both via options= "
                    f"({opt_v!r}) and as a keyword ({kw_v!r}); "
                    f"options= wins", logger="core.options", stacklevel=3)
            merged[field.name] = opt_v if opt_v is not None else kw_v
        return cls(**merged)

    def require_unset(self, entry: str, *names: str):
        """Raise if any of ``names`` is set (the knob does not apply)."""
        for name in names:
            if getattr(self, name) is not None:
                raise ValueError(
                    f"{entry} does not accept the {name!r} option")
