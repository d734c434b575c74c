"""The port's campaign cache (``repro_torch.dse.cache``): the counterparts
of ``tests/dse/test_cache.py`` except the two about persisted executables
(a CUDA graph cannot be serialised, so the port has none): artifact store
semantics, key invalidation, telemetry, gc, configuration — and the
second-process contract: a fresh process with the same cache dir as a
campaign before it runs no autotune probe, makes every rung it uses
before its first timed round, and gives identical rows.  Also the
runner's hooks (the family shape union across processes) and the
``/campaign`` dashboard's cache and shard panels fed by a sharded sweep
with a cache.
"""
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from _torch_sim_parity import one_torch_thread  # noqa: F401

from repro_torch.core import pdes
from repro_torch.dse import (ChunkSchedule, SweepSpec, configure_cache,
                             memoize_build)
from repro_torch.dse import cache as dse_cache
from repro_torch.dse import run_sweep
from repro_torch.dse import schedule
from repro_torch.dse.cache import DseCache
from repro_torch.obs.bus import BUS, capture
from repro_torch.obs.dashboard import CampaignStats
from repro_torch.sims.memsys import build, build_family

ROOT = Path(__file__).resolve().parents[1]


def _build(n_cores=2):
    return build(n_cores=n_cores, n_reqs=6, donate=False, device="cpu")


@pytest.fixture()
def cache_dir(tmp_path):
    """A configured campaign cache dir, unconfigured again on exit (the
    module is process-global state)."""
    d = str(tmp_path / "campaign_cache")
    dse_cache.configure(d)
    try:
        yield d
    finally:
        dse_cache.configure(None)


# ---------------------------------------------------------------------------
# the JSON artifact store
# ---------------------------------------------------------------------------
def test_store_roundtrip_and_cross_instance_visibility(tmp_path):
    p = str(tmp_path / "store.json")
    a = DseCache(p)
    assert a.get("k") is None
    a.put("k", {"x": 1})
    assert a.get("k") == {"x": 1}
    # a second instance (= another process) sees the flushed value
    b = DseCache(p)
    assert b.get("k") == {"x": 1}
    # writes merge: b adds a key, a picks it up via the mtime check
    b.put("k2", [1, 2, 3])
    assert a.get("k2") == [1, 2, 3]
    assert a.get("k") == {"x": 1}


def test_store_survives_corrupt_file(tmp_path):
    p = str(tmp_path / "store.json")
    a = DseCache(p)
    a.put("k", 7)
    with open(p, "w") as fh:
        fh.write('{"version": 1, "entr')      # torn write
    b = DseCache(p)
    assert b.get("k") is None                  # corrupt -> miss, no raise
    b.put("k2", 8)                             # and it heals on next put
    assert DseCache(p).get("k2") == 8


def test_store_version_mismatch_is_a_miss(tmp_path):
    p = str(tmp_path / "store.json")
    with open(p, "w") as fh:
        json.dump({"version": 0, "entries": {"k": 1}}, fh)
    assert DseCache(p).get("k") is None


# ---------------------------------------------------------------------------
# keys + artifacts
# ---------------------------------------------------------------------------
def test_sim_signature_stable_and_structure_sensitive():
    sim1, _ = _build(2)
    sim1b, _ = _build(2)
    sim2, _ = _build(3)
    assert dse_cache.sim_signature(sim1) == dse_cache.sim_signature(sim1b)
    assert dse_cache.sim_signature(sim1) != dse_cache.sim_signature(sim2)
    # memoized per object: repeated calls are cheap and identical
    assert dse_cache.sim_signature(sim1) == dse_cache.sim_signature(sim1)


def test_artifacts_noop_without_cache_dir(monkeypatch):
    monkeypatch.delenv(dse_cache.ENV_DIR, raising=False)
    assert not dse_cache.active()
    sim, _ = _build()
    assert dse_cache.get_tuned_top(sim, 1) is None
    dse_cache.put_tuned_top(sim, 1, 32)        # silently dropped
    assert dse_cache.get_tuned_top(sim, 1) is None
    assert not dse_cache.ensure_enabled()


def test_tuned_top_keyed_on_sim_and_topology(cache_dir):
    sim1, _ = _build(2)
    sim2, _ = _build(3)
    dse_cache.put_tuned_top(sim1, 1, 32)
    dse_cache.put_tuned_top(sim1, 2, 64)
    assert dse_cache.get_tuned_top(sim1, 1) == 32
    assert dse_cache.get_tuned_top(sim1, 2) == 64   # per shard topology
    assert dse_cache.get_tuned_top(sim2, 1) is None  # per structure


def test_rung_set_union_merges(cache_dir):
    sim, _ = _build()
    dse_cache.put_rung_set(sim, 64, 1, {64, 32})
    dse_cache.put_rung_set(sim, 64, 1, {32, 8})
    assert dse_cache.get_rung_set(sim, 64, 1) == [8, 32, 64]
    assert dse_cache.get_rung_set(sim, 64, 2) is None    # topology-keyed
    assert dse_cache.get_rung_set(sim, 128, 1) is None   # B-keyed


def test_family_shape_elementwise_max_merge(cache_dir):
    def bf(**kw):
        pass
    k = dse_cache.family_build_key(bf, (), {"pattern": "mixed"})
    k2 = dse_cache.family_build_key(bf, (), {"pattern": "stream"})
    assert k != k2                             # kwargs are part of the key
    dse_cache.put_family_shape(k, {"core": 2, "l1": 4})
    dse_cache.put_family_shape(k, {"core": 8, "l1": 1})
    assert dse_cache.get_family_shape(k) == {"core": 8, "l1": 4}
    assert dse_cache.get_family_shape(k2) is None


def test_memoize_build_family_union_across_processes(cache_dir):
    """A fresh memoizer (another process) builds the family at the union
    the first one persisted, in one build."""
    shapes = []

    def fam(shape=None):
        shapes.append(dict(shape))
        return build_family(shape=shape, n_cores=1, n_reqs=4,
                            donate=False, device="cpu")
    first = memoize_build(fam)
    first(shape={"core": 2})
    first(shape={"core": 3})                   # grows: rebuilt at 3
    second = memoize_build(fam)                # "the next process"
    f = second(shape={"core": 1})
    assert shapes == [{"core": 2}, {"core": 3}, {"core": 3}]
    assert f.shape_max == {"core": 3}


def test_cache_events_and_hit_rate_gauge(cache_dir):
    sim, _ = _build()
    with capture() as sink:
        dse_cache.get_tuned_top(sim, 1)            # miss
        dse_cache.put_tuned_top(sim, 1, 16)        # write
        dse_cache.get_tuned_top(sim, 1)            # hit
    kinds = [e["kind"] for e in sink.events]
    assert kinds == ["cache.miss", "cache.write", "cache.hit"]
    hit = sink.events[-1]
    assert hit["what"] == "tuned_top" and hit["bytes"] > 0
    w = sink.events[1]
    assert w["bytes"] > 0
    g = BUS.metrics.gauge("dse.cache.hit_rate").value
    assert 0.0 < g <= 1.0


# ---------------------------------------------------------------------------
# the headline: process 2 repeats process 1's choices
# ---------------------------------------------------------------------------
WORKER = textwrap.dedent("""
    import json
    import torch
    torch.set_num_threads(1)
    import repro_torch.dse.schedule as schedule
    # short rounds, so that the autotuner's three probed rungs (two
    # rounds each) finish well inside a 64-point sweep of a small build
    schedule.DEFAULT_QUANTUM = 16
    from repro_torch.dse import SweepSpec, memoize_build, run_sweep
    from repro_torch.dse import cache as dse_cache
    from repro_torch.obs.bus import capture
    from repro_torch.sims.memsys import build
    assert dse_cache.active(), "REPRO_CACHE_DIR not picked up"
    spec = SweepSpec.grid({
        "conn_latency[-1]": [float(10 + 2 * i) for i in range(16)],
        "kind.core.think_scale": [1.0, 1.2, 1.4, 1.6]})
    bf = memoize_build(lambda: build(n_cores=2, n_reqs=8, donate=False,
                                     device="cpu"))
    with capture() as sink:
        rows = run_sweep(bf, spec, until=2000.0)
    ev = sink.events
    first = min(i for i, e in enumerate(ev) if e["kind"] == "round.end")
    made = lambda es: sorted(e["b"] for e in es if e["kind"] == "compile")
    print(json.dumps({
        "rows": rows,
        "persisted": dse_cache.get_rung_set(bf()[0], len(spec), 1),
        "tuned": dse_cache.get_tuned_top(bf()[0], 1),
        "probes": sum(e["kind"] == "autotune.probe" for e in ev),
        "made_before": made(ev[:first]), "made_after": made(ev[first:]),
        "used": sorted({e["rung"] for e in ev if e["kind"] == "round.end"}),
        "artifacts": dse_cache.stats()}))
""")


def test_second_process_no_probe_same_rungs_identical_rows(
        tmp_path, monkeypatch, capsys):
    """This process runs a campaign with a cache dir, then a fresh process
    runs it again: the second runs no autotune probe, makes the rung set
    the first persisted (every rung under the tuned top that a remaining
    count can pick, so every rung it uses) before its first round, and
    gives identical rows; it hits the store the first one wrote."""
    d = str(tmp_path / "shared_cache")
    monkeypatch.setenv(dse_cache.ENV_DIR, d)
    monkeypatch.setattr(schedule, "DEFAULT_QUANTUM", 16)   # restored after
    dse_cache.configure(None)
    exec(WORKER, {})
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", WORKER], capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    second = json.loads(r.stdout.strip().splitlines()[-1])
    assert second["rows"] == first["rows"]          # caching is invisible
    assert first["probes"] > 0 and first["made_after"]
    assert second["probes"] == 0, second
    assert second["made_after"] == [], second       # nothing mid-sweep
    assert second["made_before"] == first["persisted"], second
    assert set(second["used"]) <= set(second["made_before"])
    assert first["tuned"] == max(first["persisted"])
    assert {r for r in first["used"] if r <= first["tuned"]} <= \
        set(first["persisted"])
    assert first["artifacts"]["writes"] > 0
    assert second["artifacts"]["hits"] > 0


# ---------------------------------------------------------------------------
# size-capped LRU GC
# ---------------------------------------------------------------------------
def _fake_blob(d, name, nbytes, age_s):
    p = os.path.join(d, name)
    with open(p, "wb") as fh:
        fh.write(b"x" * nbytes)
    t = time.time() - age_s
    os.utime(p, (t, t))
    return p


def test_gc_evicts_lru_down_to_cap_and_spares_store(cache_dir):
    os.makedirs(cache_dir, exist_ok=True)
    for i in range(5):                    # oldest first: ages 50..10
        _fake_blob(cache_dir, f"exec_{i:04x}.bin", 1000, age_s=50 - 10 * i)
    store_p = os.path.join(cache_dir, dse_cache.STORE_NAME)
    with open(store_p, "w") as fh:        # big store: still never evicted
        fh.write("{}" + " " * 4000)
    before = dse_cache.stats()["evictions"]
    with capture() as sink:
        n = dse_cache.gc(limit=3000)
    assert n == 2                          # two oldest blobs freed 2000B
    left = sorted(os.listdir(cache_dir))
    assert dse_cache.STORE_NAME in left
    assert "exec_0000.bin" not in left and "exec_0001.bin" not in left
    assert "exec_0004.bin" in left
    assert dse_cache.stats()["evictions"] == before + 2
    ev = [e for e in sink.events if e["kind"] == "cache.evict"]
    assert len(ev) == 2 and all(e["bytes"] == 1000 for e in ev)


def test_gc_noop_under_cap_or_unconfigured(cache_dir, monkeypatch):
    monkeypatch.delenv(dse_cache.ENV_MAX_BYTES, raising=False)
    monkeypatch.delenv(dse_cache.ENV_DIR, raising=False)
    os.makedirs(cache_dir, exist_ok=True)
    _fake_blob(cache_dir, "exec_aaaa.bin", 100, age_s=10)
    assert dse_cache.gc(limit=10_000) == 0          # under cap
    assert dse_cache.gc() == 0                      # no cap configured
    dse_cache.configure(None)
    assert dse_cache.gc(limit=1) == 0               # no cache dir


def test_configure_max_bytes_and_env_fallback(tmp_path, monkeypatch):
    d = str(tmp_path / "c")
    dse_cache.configure(d, max_bytes=123)
    try:
        assert dse_cache.max_cache_bytes() == 123
        dse_cache.configure(d)                      # reset -> env fallback
        monkeypatch.setenv(dse_cache.ENV_MAX_BYTES, "456")
        assert dse_cache.max_cache_bytes() == 456
        monkeypatch.setenv(dse_cache.ENV_MAX_BYTES, "junk")
        assert dse_cache.max_cache_bytes() is None
        monkeypatch.delenv(dse_cache.ENV_MAX_BYTES)
        assert dse_cache.max_cache_bytes() is None
    finally:
        dse_cache.configure(None)


def test_configure_beats_env_dir_and_enable_shrinks(tmp_path, monkeypatch):
    """``REPRO_CACHE_DIR`` names the dir unless ``configure`` set one;
    ``ensure_enabled`` creates it, emits ``cache.enable`` and shrinks an
    over-cap dir at once."""
    env_d, cfg_d = str(tmp_path / "env"), str(tmp_path / "cfg")
    monkeypatch.setenv(dse_cache.ENV_DIR, env_d)
    assert dse_cache.cache_dir() == env_d and dse_cache.active()
    configure_cache(cfg_d, max_bytes=150)
    try:
        assert dse_cache.cache_dir() == cfg_d
        os.makedirs(cfg_d)
        for i in range(3):
            _fake_blob(cfg_d, f"old_{i}.bin", 100, age_s=30 - i)
        with capture() as sink:
            assert dse_cache.ensure_enabled()
        kinds = [e["kind"] for e in sink.events]
        assert kinds[0] == "cache.enable" and kinds.count("cache.evict") == 2
        assert sink.events[0]["dir"] == cfg_d
        assert sorted(os.listdir(cfg_d)) == ["old_2.bin"]
    finally:
        dse_cache.configure(None)


# ---------------------------------------------------------------------------
# the same sequence through the JAX package's cache
# ---------------------------------------------------------------------------
def _cache_trace(pkg, d, monkeypatch):
    """One put/get/gc sequence through package ``pkg``'s cache in dir
    ``d``: what each get returns, the files gc keeps, the artifact counts
    and the hit-rate gauge (from zeroed counts) and every ``cache.*``
    event.  A key is reduced to its kind: it hashes the package's own
    sim signature and version."""
    import importlib
    cache = importlib.import_module(f"{pkg}.dse.cache")
    memsys = importlib.import_module(f"{pkg}.sims.memsys")
    bus = importlib.import_module(f"{pkg}.obs.bus")
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    sim, _ = memsys.build(n_cores=2, n_reqs=6, donate=False, **kw)
    monkeypatch.setattr(cache, "_counts", dict.fromkeys(cache._counts, 0))
    cache.configure(d)
    try:
        fam = cache.family_build_key(memsys.build_family, (),
                                     {"n_cores": 2, "pattern": "mixed"})
        with bus.capture() as sink:
            got = [cache.get_tuned_top(sim, 1)]
            cache.put_tuned_top(sim, 1, 16)
            got += [cache.get_tuned_top(sim, 1), cache.get_tuned_top(sim, 2)]
            cache.put_rung_set(sim, 32, 2, [16, 8])
            cache.put_rung_set(sim, 32, 2, {4, 16})
            cache.put_rung_set(sim, 32, 2, [16])          # no new rung
            got += [cache.get_rung_set(sim, 32, 2),
                    cache.get_rung_set(sim, 32, 1)]
            cache.put_family_shape(fam, {"core": 2, "dram": 1})
            cache.put_family_shape(fam, {"core": 1, "dram": 3})
            cache.put_family_shape(fam, {"core": 2})      # no growth
            got.append(cache.get_family_shape(fam))
            os.makedirs(os.path.join(d, "sub"))
            for i, (name, n) in enumerate([("a.bin", 400), ("sub/b.bin", 300),
                                           ("c.bin", 200), ("d.bin", 100),
                                           (".dse_tmp", 900)]):
                _fake_blob(d, name, n, age_s=50 - 10 * i)
            got += [cache.gc(limit=10_000), cache.gc(limit=350),
                    cache.gc(limit=0)]
            kept = sorted(os.path.relpath(os.path.join(r, f), d)
                          for r, _, fs in os.walk(d) for f in fs)
        hit_rate = bus.BUS.metrics.gauge("dse.cache.hit_rate").value
    finally:
        cache.configure(None)
    events = [{k: (v.split(":")[0] if k == "key" else v)
               for k, v in e.items() if k not in ("ts", "seq")}
              for e in sink.events if e["kind"].startswith("cache.")]
    return dict(got=got, kept=kept, stats=cache.stats(),
                hit_rate=hit_rate, events=events)


def test_same_sequence_as_the_jax_cache(tmp_path, monkeypatch):
    """The JAX package's cache and the port's, driven through the same
    puts, gets and gc's: the same merged values (the rung-set union, the
    family shape's max), the same files kept, counts and hit rate, and
    the same ``cache.*`` events with the same payloads."""
    ref = _cache_trace("repro", str(tmp_path / "ref"), monkeypatch)
    got = _cache_trace("repro_torch", str(tmp_path / "port"), monkeypatch)
    assert got == ref
    assert ref["got"] == [None, 16, None, [4, 8, 16], None,
                          {"core": 2, "dram": 3}, 0, 2, 2]
    assert ref["kept"] == [".dse_tmp", dse_cache.STORE_NAME]


# ---------------------------------------------------------------------------
# the /campaign dashboard
# ---------------------------------------------------------------------------
def test_dashboard_reads_cache_and_shard_panels(cache_dir, monkeypatch):
    """A sharded sweep (2 placements of the CPU) with a campaign cache,
    fed to the dashboard's state: both panels fill.  Rounds are small
    enough that survivors move between the 2 slots."""
    monkeypatch.setenv(pdes.FORCE_DEVICES_ENV, "2")
    state = CampaignStats()
    spec = SweepSpec.grid({"conn_latency[-1]": [10.0, 20.0, 30.0],
                           "kind.core.think_scale": [1.0, 1.5]})
    bf = memoize_build(lambda: _build())
    with capture() as sink:
        for _ in range(2):
            run_sweep(bf, spec, until=[60.0, 240.0] * 3, shard=True,
                      schedule=ChunkSchedule(ladder=(4, 2), quantum=16,
                                             min_round_s=0.0))
    for e in sink.events:
        state.on_event(e)
    snap = state.snapshot()
    cache, shards = snap["cache"], snap["shards"]
    assert cache["dir"] == cache_dir
    assert cache["writes"] >= 1 and cache["hits"] >= 1
    assert cache["misses"] >= 1 and cache["bytes_written"] > 0
    assert shards["devices"] == 2 and shards["rebalances"] >= 2
    assert shards["lanes_moved"] == sum(
        e["moved"] for e in sink.events if e["kind"] == "shard.rebalance")

