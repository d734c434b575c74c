"""Persistent cross-process caching for DSE campaigns (DSE.md "Sharded
sweeps and the persistent cache").  Counterpart of ``repro.dse.cache``.

A fleet of short-lived sweep/search jobs (CI shards, search workers,
one-config-per-process campaigns) pays its warm-up once *per process*
unless the decisions a warm process made outlive it.  The reference
persists three layers; the port has one of them:

* **The XLA compilation cache and whole AOT executables** (the
  reference's ``jax_compilation_cache_dir`` wiring and
  ``get_executable`` / ``put_executable``) have no counterpart: the
  port's executable is a captured CUDA graph over static buffers, and a
  CUDA graph cannot be serialised.  A fresh process captures each rung
  it uses again (about 2 s a rung on an H100).
* **The runner's own artifacts** — :class:`DseCache` is a small JSON
  store (one file in the cache dir) keyed on ``(simulation structural
  signature, batch size, shard topology, torch version, cache
  version)`` that persists the three decisions a warm process made so a
  cold one can repeat them exactly:

  - the **autotuned chunk-ladder winner** (``tuned_top``) — otherwise
    the second process re-probes, and may pick a different rung;
  - the **warm-ladder rung set** (``rungs``) — which batch sizes a
    sweep of this shape can choose once tuned (the reference keeps the
    ones it used; which of them a run uses depends on round timings), so
    ``run_rounds`` captures them all before its first timed round
    instead of mid-sweep;
  - the **family max-shape union** (``family``) — ``memoize_build``
    grows a family's padded maximum across search rounds; persisting
    the union lets the next process build the family at the final
    maximum in one shot (one build, one set of rung captures).

Every lookup emits ``cache.hit`` / ``cache.miss`` (and writes emit
``cache.write``) on the telemetry bus with payload byte sizes, plus a
``dse.cache.hit_rate`` gauge the ``/campaign`` dashboard surfaces.

The directory is size-capped: :func:`gc` evicts least-recently-used
files down to ``REPRO_CACHE_MAX_BYTES`` / ``configure(max_bytes=...)``,
emitting ``cache.evict`` per file, and never evicts the artifact store.
The port writes nothing else there, so a directory it shares with the
reference's campaigns is capped as theirs is.

Nothing here is load-bearing for correctness: with no cache dir
configured every function is a cheap no-op, artifacts only shortcut
decisions that would otherwise be re-derived, and a corrupt or
concurrently-rewritten store file degrades to a miss.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import weakref

import torch

from repro_torch.core.engine import _structure, ref_leaves
from repro_torch.obs.bus import BUS

ENV_DIR = "REPRO_CACHE_DIR"
ENV_MAX_BYTES = "REPRO_CACHE_MAX_BYTES"

# Bump when the artifact semantics change (keys embed it, so old stores
# simply stop matching instead of poisoning new processes).
CACHE_VERSION = 1

STORE_NAME = "repro_dse_artifacts.json"

_lock = threading.Lock()
_cfg: dict = {"dir": None, "enabled": None, "max_bytes": None}
_store: "DseCache | None" = None
_counts = {"hits": 0, "misses": 0, "writes": 0, "evictions": 0}

_SIM_SIGS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
def configure(cache_dir: str | None,
              max_bytes: int | None = None) -> None:
    """Set (or clear, with ``None``) the campaign cache directory.

    Precedence: an explicit ``configure()`` beats the ``REPRO_CACHE_DIR``
    environment variable.  ``max_bytes`` caps the directory's total size
    for :func:`gc` (``None`` falls back to ``REPRO_CACHE_MAX_BYTES``;
    with neither set the cache grows unbounded).  Each ``configure()``
    call resets the cap, so a test that sets one cannot leak it into the
    next.
    """
    global _store
    with _lock:
        _cfg["dir"] = cache_dir
        _cfg["max_bytes"] = None if max_bytes is None else int(max_bytes)
        _store = None


def cache_dir() -> str | None:
    """The effective cache directory, or ``None`` when caching is off."""
    return _cfg["dir"] or os.environ.get(ENV_DIR) or None


def max_cache_bytes() -> int | None:
    """The effective size cap for :func:`gc`, or ``None`` (unbounded).
    ``configure(max_bytes=...)`` beats ``REPRO_CACHE_MAX_BYTES``."""
    if _cfg["max_bytes"] is not None:
        return int(_cfg["max_bytes"])
    env = os.environ.get(ENV_MAX_BYTES)
    try:
        return int(env) if env else None
    except ValueError:
        return None


def active() -> bool:
    """Whether a cache directory is configured (artifact lookups live)."""
    return cache_dir() is not None


def ensure_enabled() -> bool:
    """Idempotently open the configured directory (created if missing)
    and shrink it under its cap; returns whether caching is active.
    Called by ``run_sweep`` on entry; emits ``cache.enable`` once per
    directory."""
    d = cache_dir()
    if d is None:
        return False
    with _lock:
        if _cfg["enabled"] == d:
            return True
        os.makedirs(d, exist_ok=True)
        _cfg["enabled"] = d
    if BUS.active:
        BUS.emit("cache.enable", dir=d, torch=torch.__version__)
    gc()     # shrink a pre-existing over-cap dir at startup, not mid-sweep
    return True


def store() -> "DseCache | None":
    """The process-wide artifact store (``None`` when caching is off)."""
    global _store
    d = cache_dir()
    if d is None:
        return None
    with _lock:
        if _store is None or _store.path != os.path.join(d, STORE_NAME):
            _store = DseCache(os.path.join(d, STORE_NAME))
    return _store


def stats() -> dict:
    """Process-wide artifact hit/miss/write counts (tests + dashboards)."""
    return dict(_counts)


def _note(kind: str, key: str, hit: bool, nbytes: int = 0) -> None:
    _counts["hits" if hit else "misses"] += 1
    if BUS.active:
        BUS.emit("cache.hit" if hit else "cache.miss", what=kind, key=key,
                 bytes=nbytes)
        BUS.count("dse.cache.hits" if hit else "dse.cache.misses")
        seen = _counts["hits"] + _counts["misses"]
        BUS.gauge("dse.cache.hit_rate", _counts["hits"] / seen)


# ---------------------------------------------------------------------------
# size-capped LRU GC
# ---------------------------------------------------------------------------
def gc(limit: int | None = None) -> int:
    """Evict least-recently-used cache files until the directory fits
    the size cap; returns the number of files evicted.

    Candidates are every file under the cache dir *except* the artifact
    store (:data:`STORE_NAME`) and in-progress temp files; recency is
    file mtime.  ``limit`` overrides the configured cap
    (:func:`max_cache_bytes`); with no cap (or no cache dir) this is a
    no-op.  Every eviction emits a ``cache.evict`` event and bumps
    ``dse.cache.evictions``; the directory's size lands on the
    ``dse.cache.bytes`` gauge.
    """
    d = cache_dir()
    cap = max_cache_bytes() if limit is None else int(limit)
    if d is None or cap is None:
        return 0
    entries: list[tuple[int, int, str]] = []
    total = 0
    for root, _, files in os.walk(d):
        for name in files:
            if name == STORE_NAME or name.startswith(".dse_"):
                continue
            p = os.path.join(root, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            entries.append((st.st_mtime_ns, st.st_size, p))
            total += st.st_size
    if BUS.active:
        BUS.gauge("dse.cache.bytes", total)
    if total <= cap:
        return 0
    evicted = 0
    freed = 0
    for _, size, p in sorted(entries):        # oldest mtime first
        if total - freed <= cap:
            break
        try:
            os.unlink(p)
        except OSError:                       # raced another process
            continue
        freed += size
        evicted += 1
        _counts["evictions"] += 1
        if BUS.active:
            BUS.emit("cache.evict", path=os.path.relpath(p, d),
                     bytes=size)
            BUS.count("dse.cache.evictions")
    if BUS.active and evicted:
        BUS.gauge("dse.cache.bytes", total - freed)
    return evicted


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------
def _hash(obj) -> str:
    blob = json.dumps(obj, sort_keys=True, default=repr).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def sim_signature(sim) -> str:
    """A structural signature of a built
    :class:`~repro_torch.core.Simulation`, stable across processes: kind
    layout, capacities, connection count, block length, donation, device
    type and the (shape, dtype) tree of its default params.

    Two processes that build the same topology get the same signature;
    any structural difference (instance counts, port counts, padding,
    capacities, param schema) changes it — exactly the things that
    change the blocks an artifact points at.
    """
    sig = _SIM_SIGS.get(sim)
    if sig is None:
        params = sim.default_params()
        sig = _SIM_SIGS[sim] = _hash({
            "kinds": [(k.name, int(k.n_instances), int(k.n_ports))
                      for k in sim.kinds],
            "caps": [k.caps().tolist() for k in sim.kinds],
            "n_conn": int(sim.n_conn),
            "cap_phys": int(sim.cap_phys),
            "super_epoch": int(sim.super_epoch),
            "donate": bool(sim.donate),
            "device": sim.device.type,
            "params": [(list(x.shape), str(x.dtype))
                       for x in ref_leaves(params)],
            "structure": repr(_structure(params)),
        })
    return sig


def _key(kind: str, **parts) -> str:
    return f"{kind}:" + _hash(dict(parts, torch=torch.__version__,
                                   cache_version=CACHE_VERSION))


def family_build_key(build_fn, args: tuple, kwargs: dict) -> str:
    """Key for a memoized family build: the build function's identity
    plus its non-shape arguments (values via ``repr`` — build kwargs are
    plain scalars/strings in practice)."""
    fn = getattr(build_fn, "__wrapped__", build_fn)
    return _key("family",
                fn=f"{getattr(fn, '__module__', '?')}."
                   f"{getattr(fn, '__qualname__', repr(fn))}",
                args=[repr(a) for a in args],
                kwargs={k: repr(v) for k, v in sorted(kwargs.items())})


# ---------------------------------------------------------------------------
# the JSON artifact store
# ---------------------------------------------------------------------------
class DseCache:
    """A tiny persistent key→JSON-value store (one file, atomic writes).

    Reads reload the file only when its mtime/size changed (cheap stat
    per lookup); writes read-merge-replace under a process lock with
    ``os.replace`` so concurrent processes never see a torn file.  Two
    processes racing on the *same* key last-write-wins — every value
    here is a shortcut, not a source of truth, so that is safe.
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._data: dict = {}
        self._stamp: tuple | None = None

    # -- file I/O ----------------------------------------------------------
    def _refresh(self) -> None:
        try:
            st = os.stat(self.path)
            stamp = (st.st_mtime_ns, st.st_size)
        except OSError:
            self._data, self._stamp = {}, None
            return
        if stamp == self._stamp:
            return
        try:
            with open(self.path) as fh:
                raw = json.load(fh)
            self._data = raw.get("entries", {}) \
                if raw.get("version") == CACHE_VERSION else {}
        except (OSError, ValueError):     # torn/corrupt file -> miss
            self._data = {}
        self._stamp = stamp

    def _flush(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        body = {"version": CACHE_VERSION, "entries": self._data}
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path) or ".",
                                   prefix=".dse_cache_")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(body, fh, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:                    # read-only dir: stay in-memory
            try:
                os.unlink(tmp)
            except OSError:
                pass
        try:
            st = os.stat(self.path)
            self._stamp = (st.st_mtime_ns, st.st_size)
        except OSError:
            self._stamp = None

    # -- API ---------------------------------------------------------------
    def get(self, key: str, kind: str = "artifact"):
        with self._lock:
            self._refresh()
            v = self._data.get(key)
        hit = v is not None
        _note(kind, key, hit,
              len(json.dumps(v).encode()) if hit else 0)
        return v

    def put(self, key: str, value, kind: str = "artifact") -> None:
        blob = json.loads(json.dumps(value))   # force JSON-cleanliness now
        with self._lock:
            self._refresh()                    # merge concurrent writers
            self._data[key] = blob
            self._flush()
        _counts["writes"] += 1
        if BUS.active:
            BUS.emit("cache.write", what=kind, key=key,
                     bytes=len(json.dumps(blob).encode()))
            BUS.count("dse.cache.writes")


# ---------------------------------------------------------------------------
# artifact accessors (all no-ops without a configured cache dir)
# ---------------------------------------------------------------------------
def _maybe_enable_at_import() -> None:
    """With ``REPRO_CACHE_DIR`` in the environment, open the cache the
    moment ``repro_torch.dse`` is imported, as the reference does."""
    if os.environ.get(ENV_DIR):
        ensure_enabled()


_maybe_enable_at_import()


def get_tuned_top(sim, devices: int) -> int | None:
    """The persisted autotune winner for (this topology, this shard
    topology), or ``None``."""
    s = store()
    if s is None:
        return None
    v = s.get(_key("tuned_top", sim=sim_signature(sim), devices=devices),
              kind="tuned_top")
    return int(v) if v is not None else None


def put_tuned_top(sim, devices: int, top: int) -> None:
    s = store()
    if s is not None:
        s.put(_key("tuned_top", sim=sim_signature(sim), devices=devices),
              int(top), kind="tuned_top")


def get_rung_set(sim, b: int, devices: int) -> list[int] | None:
    """The rung batch sizes a previous process used for a B-point sweep
    of this topology at this shard topology."""
    s = store()
    if s is None:
        return None
    v = s.get(_key("rungs", sim=sim_signature(sim), b=b, devices=devices),
              kind="rungs")
    return sorted(int(r) for r in v) if v else None


def put_rung_set(sim, b: int, devices: int, rungs) -> None:
    s = store()
    if s is None:
        return
    key = _key("rungs", sim=sim_signature(sim), b=b, devices=devices)
    with s._lock:
        s._refresh()
        old = s._data.get(key) or []
    merged = sorted({int(r) for r in (*old, *rungs)})
    if merged != sorted(int(r) for r in old):
        s.put(key, merged, kind="rungs")


def get_family_shape(build_key: str) -> dict | None:
    """The persisted max-shape union of a memoized family build."""
    s = store()
    if s is None:
        return None
    v = s.get(build_key, kind="family")
    return {k: int(x) for k, x in v.items()} if v else None


def put_family_shape(build_key: str, shape_max: dict) -> None:
    s = store()
    if s is None:
        return
    with s._lock:
        s._refresh()
        old = s._data.get(build_key) or {}
    merged = dict(old)
    for k, v in shape_max.items():
        merged[k] = max(int(v), int(merged.get(k, 0)))
    if merged != old:
        s.put(build_key, merged, kind="family")
