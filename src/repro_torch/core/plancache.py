"""Persisted plan cache for the self-tuning planner (``planner.tune``).

Winners of a tuning race are stored in one small JSON file keyed by

    (algo, query shape, m-bucket, distribution fingerprint, device)

so the next run of the *same workload shape* skips the race and replays
the recorded plan. The key buckets m by power of two and fingerprints the
value distribution from a prefix of each stream: a plan raced at m=2^20 on
zipf-skewed uint32 keys should not be replayed for a uniform float stream
a thousand times shorter.

Every field of the key is the JAX package's (dtypes by their numpy names)
except the device field, ``torch-<device type>x<count>`` (``torch-cudax1``
on one card). Both packages default to the same file and read the same
``REPRO_PLAN_CACHE``, so a shared file never replays one package's plan in
the other.

Durability rules:

* schema versioning: the file carries ``{"schema": N, "plans": ...}``; a
  version mismatch (or any unparsable or foreign content) degrades to an
  empty cache with a warning, never a crash. Callers fall back to the
  analytic plan.
* atomic writes: every ``put`` rewrites the file through a temp file in
  the same directory and ``os.replace``, so a reader never sees a torn
  write and concurrent writers lose at worst their own last update (each
  ``put`` is load-modify-write over the whole file).
* bounded size: at most ``MAX_ENTRIES`` plans are kept; the oldest (by
  ``saved_at``) are evicted first.

The default location is ``~/.cache/cheetah/plan_cache.json``; the
``REPRO_PLAN_CACHE`` environment variable overrides it (the test suite
points it at a temp file for each test).
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile
import threading
import time

import numpy as np
import torch

from ..obs import log as _obslog
from ..obs.metrics import REGISTRY

SCHEMA_VERSION = 1
ENV_VAR = "REPRO_PLAN_CACHE"
MAX_ENTRIES = 256

# entries of each stream consulted by the distribution fingerprint
FINGERPRINT_SAMPLE = 2048


def default_path() -> pathlib.Path:
    """The cache file's path (the environment variable wins; read on every
    call so tests can redirect it)."""
    env = os.environ.get(ENV_VAR)
    if env:
        return pathlib.Path(env).expanduser()
    return pathlib.Path("~/.cache/cheetah/plan_cache.json").expanduser()


def m_bucket(m: int) -> int:
    """floor(log2(m)): plans transfer within a power of two of stream
    length but not across orders of magnitude (S* scales with sqrt(m))."""
    return max(int(m).bit_length() - 1, 0)


def _dtype_name(t: torch.Tensor) -> str:
    """A tensor's dtype by its numpy name (``float32``, ``uint32``)."""
    return str(t.dtype).removeprefix("torch.")


def _host_prefix(s: torch.Tensor, n: int) -> np.ndarray:
    """The first ``n`` entries of ``s`` as a numpy array: the slice is cut
    on the device and only it is copied to the host."""
    a = s[:n].cpu()
    if a.dtype == torch.uint32:  # numpy takes uint32 through its bits
        return a.view(torch.int32).numpy().view(np.uint32)
    return a.numpy()


def distribution_fingerprint(streams, sample: int = FINGERPRINT_SAMPLE
                             ) -> str:
    """Coarse, deterministic signature of the streams' prefixes.

    Per stream: dtype kind and width, a quantized distinct-value ratio
    (drives DISTINCT / GROUP BY cache hit rates) and a log2 magnitude
    bucket (drives TOP-N ladder behaviour), in numpy on the host over at
    most ``sample`` leading entries.
    """
    parts = []
    for s in streams:
        n = min(sample, int(s.shape[0]))
        a = _host_prefix(s, n)
        col = a.reshape(n, -1)[:, 0]
        if a.dtype.kind == "b":
            uniq = 1.0
            mag = 0
        else:
            uniq = len(np.unique(col)) / max(n, 1)
            mean = float(np.mean(np.abs(col.astype(np.float64))))
            mag = int(np.log2(mean + 1.0))
        parts.append(f"{a.dtype.kind}{a.dtype.itemsize}"
                     f"u{int(round(uniq * 10))}g{mag}")
    return "-".join(parts)


def device_fingerprint(device) -> str:
    """``torch-<device type>x<count>``: the package, the device type and
    the device spread a plan may use, the positions of ``default_mesh`` for
    that device (the cards the process sees, 1 on the CPU, the process
    group's size when one is initialized): a plan raced on one card is not
    replayed on a host of four, nor in the JAX package."""
    from .mesh import default_positions

    dev = torch.device(device)
    return f"torch-{dev.type}x{default_positions(dev)}"


def cache_key(algo: str, streams, params: dict) -> str:
    """The full plan-cache key for one engine invocation."""
    streams = tuple(s for s in streams if s is not None)
    m = int(streams[0].shape[0])
    shape_sig = ",".join(
        _dtype_name(s) + "".join(f"x{d}" for d in s.shape[1:])
        for s in streams)
    param_sig = ",".join(
        f"{k}={v}" for k, v in sorted(params.items())
        if isinstance(v, (int, float, str, bool)))
    return "|".join([algo, shape_sig, f"m{m_bucket(m)}", param_sig,
                     distribution_fingerprint(streams),
                     device_fingerprint(streams[0].device)])


class PlanCache:
    """Load and store tuned plans in one schema-versioned JSON file.

    Every silent-degradation path is counted: ``stats()`` gives this
    instance's hits, misses, evictions and corruption fallbacks, and the
    same events feed the process-wide registry under ``plancache.*``, so a
    cache that never hits (or keeps falling back over a corrupt file)
    shows in telemetry instead of only as slow queries.
    """

    def __init__(self, path: os.PathLike | str | None = None):
        self.path = pathlib.Path(path) if path is not None \
            else default_path()
        self._stats_lock = threading.Lock()
        self._stats = dict(hits=0, misses=0, evictions=0,
                           corruption_fallbacks=0)

    def _count(self, name: str, n: int = 1) -> None:
        with self._stats_lock:
            self._stats[name] += n
        REGISTRY.record(f"plancache.{name}", n)

    def stats(self) -> dict:
        """This instance's counters: hits, misses, evictions,
        corruption_fallbacks (unreadable file or schema mismatch)."""
        with self._stats_lock:
            return dict(self._stats)

    # ------------------------------------------------------------- read
    def load(self) -> dict:
        """key -> entry dict. A missing file is empty; corrupt content or a
        schema mismatch is empty *with a warning* (analytic fallback)."""
        try:
            raw = json.loads(self.path.read_text())
        except FileNotFoundError:
            return {}
        except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
            self._count("corruption_fallbacks")
            _obslog.warn(
                f"plan cache {self.path} is unreadable ({e!r}); "
                f"falling back to analytic plans",
                logger="core.plancache", stacklevel=2)
            return {}
        if not isinstance(raw, dict) or raw.get("schema") != SCHEMA_VERSION:
            got = raw.get("schema") if isinstance(raw, dict) else None
            self._count("corruption_fallbacks")
            _obslog.warn(
                f"plan cache {self.path} has schema {got!r} (expected "
                f"{SCHEMA_VERSION}); ignoring it and falling back to "
                f"analytic plans", logger="core.plancache", stacklevel=2)
            return {}
        plans = raw.get("plans")
        return plans if isinstance(plans, dict) else {}

    def get(self, key: str) -> dict | None:
        """The cached entry for ``key``, or None. Entries are dicts with a
        ``"plan"`` sub-dict (see ``planner.Plan.from_dict``); malformed
        entries read as misses."""
        entry = self.load().get(key)
        if isinstance(entry, dict) and isinstance(entry.get("plan"), dict):
            self._count("hits")
            return entry
        self._count("misses")
        return None

    # ------------------------------------------------------------ write
    def put(self, key: str, plan: dict, **meta) -> None:
        """Persist one raced winner (load-modify-write, atomic rename)."""
        plans = self.load()
        plans[key] = {"plan": dict(plan), "saved_at": time.time(), **meta}
        if len(plans) > MAX_ENTRIES:
            # evict oldest first; unstamped entries count as oldest
            by_age = sorted(plans.items(),
                            key=lambda kv: kv[1].get("saved_at", 0.0)
                            if isinstance(kv[1], dict) else 0.0)
            evicted = len(plans) - MAX_ENTRIES
            plans = dict(by_age[evicted:])
            self._count("evictions", evicted)
        payload = {"schema": SCHEMA_VERSION, "plans": plans}
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                   prefix=self.path.name + ".", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def clear(self) -> None:
        try:
            self.path.unlink()
        except FileNotFoundError:
            pass
