"""One structured logger for the port, namespaced ``repro_torch.*``.

Diagnostics leave the process through ``warnings.warn`` where tests (and
``pytest.warns`` users) assert on the warning, and every such event also
flows through one stdlib ``logging`` tree rooted at ``"repro_torch"``, so
operators get timestamps, severities and one switch, the environment
variable the JAX package reads too:

    REPRO_LOG_LEVEL=DEBUG python ...    # default WARNING

``get_logger("core.options")`` returns ``repro_torch.core.options``; the
handler and level are set once on the ``repro_torch`` root, and only when
the process has installed no handler there itself.
"""
from __future__ import annotations

import logging
import os
import warnings

ROOT = "repro_torch"
ENV_VAR = "REPRO_LOG_LEVEL"
_configured = False


def configure(force: bool = False) -> logging.Logger:
    """Set up the ``repro_torch`` root logger once.

    Level from ``REPRO_LOG_LEVEL`` (a name or a number, default WARNING). A
    stderr handler is attached only when the root has none, so applications
    that configured logging themselves win. ``force`` reads the variable
    again."""
    global _configured
    root = logging.getLogger(ROOT)
    if _configured and not force:
        return root
    level_name = os.environ.get(ENV_VAR, "WARNING").upper()
    level = getattr(logging, level_name, None)
    if not isinstance(level, int):
        try:
            level = int(level_name)
        except ValueError:
            level = logging.WARNING
    root.setLevel(level)
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        root.addHandler(h)
        root.propagate = False
    _configured = True
    return root


def get_logger(name: str = "") -> logging.Logger:
    """A logger under the ``repro_torch`` namespace (``""``: the root)."""
    configure()
    if not name or name == ROOT:
        return logging.getLogger(ROOT)
    if name.startswith(ROOT + "."):
        return logging.getLogger(name)
    return logging.getLogger(f"{ROOT}.{name}")


def warn(message: str, *, logger: logging.Logger | str | None = None,
         category: type[Warning] = UserWarning, stacklevel: int = 2
         ) -> None:
    """A structured log record and ``warnings.warn``, in one call: the
    ``warnings`` channel keeps the message verbatim, and the same message
    lands in the ``repro_torch.*`` log tree."""
    lg = (logger if isinstance(logger, logging.Logger)
          else get_logger(logger or "obs"))
    lg.warning(message)
    warnings.warn(message, category, stacklevel=stacklevel + 1)
