"""Shared pieces of the engine parity tests: the same small component
kinds written once for each package, an exact comparison of two states,
leaf by leaf, f32 compared by its bits and dtypes included,
``chip_smoke.py``'s reference constants, and the small memsys search
context of both packages (``search_ctx``)."""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T


def _leaves(tree, path=()):
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], path + (k,)))
        return out
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(_leaves(getattr(tree, f.name), path + (f.name,)))
        return out
    return {".".join(map(str, path)): tree}


@functools.cache
def chip_smoke():
    """The repo's ``chip_smoke.py`` as a module, for its reference
    constants (importing it needs no card)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same_state(port, ref):
    """Every leaf of ``port`` (a torch tree) equals the same leaf of
    ``ref`` (a JAX tree) in dtype, shape and bits."""
    a, b = _leaves(port), _leaves(ref)
    assert a.keys() == b.keys(), (sorted(a), sorted(b))
    for k in a:
        x, y = as_np(a[k]), as_np(b[k])
        assert x.dtype == y.dtype, (k, x.dtype, y.dtype)
        assert x.shape == y.shape, (k, x.shape, y.shape)
        if x.dtype.kind == "f":
            x = x.view(np.uint32 if x.dtype.itemsize == 4 else np.uint64)
            y = y.view(x.dtype)
        assert np.array_equal(x, y), (k, as_np(a[k]), as_np(b[k]))


# ---------------------------------------------------------------------------
# the kinds of tests/core/test_engine.py, in each package
# ---------------------------------------------------------------------------
def _j_producer(state, ports, t):
    want = state["remaining"] > 0
    ports, ok = ports.send(
        0, J.msg_new(1, dst=state["dst"], p0=state["sent"]), when=want)
    oki = ok.astype(jnp.int32)
    return ({"remaining": state["remaining"] - oki,
             "sent": state["sent"] + oki, "dst": state["dst"]},
            ports, J.TickResult.make(ok))


def _j_forwarder(state, ports, t):
    can = ports.can_send(1)
    msg, ok, ports = ports.recv(0, when=can)
    ports, sent = ports.send(1, J.msg_new(1, p0=J.payload(msg, 0)), when=ok)
    return ({"seen": state["seen"] + ok.astype(jnp.int32)},
            ports, J.TickResult.make(ok))


def _j_consumer(state, ports, t):
    msg, ok, ports = ports.recv(0)
    oki = ok.astype(jnp.int32)
    return ({"received": state["received"] + oki,
             "sum": state["sum"] + oki * J.payload(msg, 0),
             "last_t": jnp.where(ok, t, state["last_t"])},
            ports, J.TickResult.make(ok))


def _j_timer(state, ports, t):
    fire = t + 1e-3 >= state["next_fire"]
    st = {"count": state["count"] + fire.astype(jnp.int32),
          "next_fire": jnp.where(fire, state["next_fire"] + 100.0,
                                 state["next_fire"])}
    return st, ports, J.TickResult.make(fire, next_time=st["next_fire"])


def _t_producer(state, ports, t):
    want = state["remaining"] > 0
    ports, ok = ports.send(
        0, T.msg_new(1, dst=state["dst"], p0=state["sent"]), when=want)
    oki = ok.to(torch.int32)
    return ({"remaining": state["remaining"] - oki,
             "sent": state["sent"] + oki, "dst": state["dst"]},
            ports, T.TickResult.make(ok))


def _t_forwarder(state, ports, t):
    can = ports.can_send(1)
    msg, ok, ports = ports.recv(0, when=can)
    ports, sent = ports.send(1, T.msg_new(1, p0=T.payload(msg, 0)), when=ok)
    return ({"seen": state["seen"] + ok.to(torch.int32)},
            ports, T.TickResult.make(ok))


def _t_consumer(state, ports, t):
    msg, ok, ports = ports.recv(0)
    oki = ok.to(torch.int32)
    return ({"received": state["received"] + oki,
             "sum": state["sum"] + oki * T.payload(msg, 0),
             "last_t": torch.where(ok, t, state["last_t"])},
            ports, T.TickResult.make(ok))


def _t_timer(state, ports, t):
    fire = t + 1e-3 >= state["next_fire"]
    st = {"count": state["count"] + fire.to(torch.int32),
          "next_fire": torch.where(fire, state["next_fire"] + 100.0,
                                   state["next_fire"])}
    return st, ports, T.TickResult.make(fire, next_time=st["next_fire"])


JAX = types.SimpleNamespace(
    name="jax", core=J, producer=_j_producer, forwarder=_j_forwarder,
    consumer=_j_consumer, timer=_j_timer,
    i32=lambda x: jnp.asarray(x, jnp.int32),
    f32=lambda x: jnp.asarray(x, jnp.float32),
    build_kw={})
TORCH = types.SimpleNamespace(
    name="torch", core=T, producer=_t_producer, forwarder=_t_forwarder,
    consumer=_t_consumer, timer=_t_timer,
    i32=lambda x: torch.as_tensor(np.asarray(x, np.int32)),
    f32=lambda x: torch.as_tensor(np.asarray(x, np.float32)),
    build_kw={"device": "cpu"})
KITS = (JAX, TORCH)


def make_producer(kit, n, remaining, dst=None):
    dst = kit.i32(np.full((n,), -1)) if dst is None else kit.i32(dst)
    return kit.core.ComponentKind(
        "producer", kit.producer, n, 1,
        {"remaining": kit.i32(remaining), "sent": kit.i32(np.zeros(n)),
         "dst": dst})


def make_consumer(kit, n, period=1.0, cap=4):
    return kit.core.ComponentKind(
        "consumer", kit.consumer, n, 1,
        {"received": kit.i32(np.zeros(n)), "sum": kit.i32(np.zeros(n)),
         "last_t": kit.f32(np.full(n, -1.0))}, period=period, cap=cap)


def make_forwarder(kit, name, n, cap):
    return kit.core.ComponentKind(
        name, kit.forwarder, n, 2, {"seen": kit.i32(np.zeros(n))}, cap=cap)


# ---------------------------------------------------------------------------
# the search tests' context (tests/dse/test_search.py's ``ctx``)
# ---------------------------------------------------------------------------
@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's lanes run eagerly on the CPU, a few hundred tiny ops an
    epoch; torch's intra-op threads only add wake-up latency to each (a
    vmapped ``torch.min`` takes milliseconds with 8 threads, 0.06 ms with
    one).  Import this fixture into a test module to run it on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def search_ctx(pkg: str, n_cores=3, pattern="mixed", n_reqs=6):
    """One package's memoized small memsys build (``pkg`` "jax" or
    "torch"), the reference tests' ``est_finish`` extractor, their
    12-point grid and the list of builds made."""
    if pkg == "jax":
        import repro.dse as dse
        from repro.sims import memsys
        kw = {}
    else:
        import repro_torch.dse as dse
        from repro_torch.sims import memsys
        kw = {"device": "cpu"}
    built = []

    def build_fn():
        built.append(1)
        return memsys.build(n_cores=n_cores, pattern=pattern, n_reqs=n_reqs,
                            donate=True, **kw)

    bf = dse.memoize_build(build_fn)
    sim, st = bf()
    total = int(np.sum(as_np(st.comp_state["core"]["remaining"])))

    def extract(sim, s):
        rem = int(np.sum(as_np(s.comp_state["core"]["remaining"])))
        vt = float(s.time)
        done = total - rem
        return {"virtual_time": vt, "remaining": rem,
                "est_finish": vt * total / max(done, 1)}

    pool = dse.SweepSpec.grid({"conn_latency[-1]": [10., 20., 30., 40.],
                               "kind.l1.extra_hit_rate": [0.0, 0.4, 0.8]})
    return types.SimpleNamespace(dse=dse, memsys=memsys, kw=kw, bf=bf,
                                 sim=sim, st=st, extract=extract, pool=pool,
                                 built=built)


def assert_same_search(port, ref):
    """Two ``SearchResult`` objects trial for trial: rows, best, front, budget,
    rounds, and the ``SearchState`` JSON as text."""
    assert port.rows == ref.rows
    assert port.best == ref.best
    assert port.front == ref.front
    assert port.budget == ref.budget
    assert port.rounds == ref.rounds
    assert port.state.to_json() == ref.state.to_json()
