"""The port's sharded conservative PDES (``repro_torch.core.pdes``,
``repro_torch.sims.memsys.build_sharded_memsys``) against the JAX
package's ``ShardedSim``: every case of ``chip_smoke.py``'s phase 11 (a)
against PDES_REF (the JAX package's runs with one forced host device a
shard, ``tests/_pdes_refs.py``), window count and every leaf by its bits,
and one live JAX run at 2 shards in a child process with 2 forced host
devices.  The port runs its shards as placements of the CPU
(``REPRO_TORCH_FORCE_DEVICES``); a placement changes no result.  Also the
reference tests' properties (``tests/launch/test_dryrun_small.py``), and
the two reference faults the port does not copy (ROADMAP queue 3).
"""
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _pdes_refs import child_env
from _torch_sim_parity import (_leaves, as_np, chip_smoke,  # noqa: F401
                               one_torch_thread)

from repro_torch.core import pdes
from repro_torch.launch.mesh import make_sim_mesh
from repro_torch.sims.memsys import build_sharded_memsys

CS = chip_smoke()
CPU = torch.device("cpu")
CASES_A = ("s1", "s2", "s4", "s8", "s4_default", "s4_skew")
# the live case: 2 shards whose writers differ (chip_smoke.pdes_skew)
LIVE = dict(n_shards=2, tiles_per_shard=2, n_reqs=8, until=3000.0,
            skew=True)


def _run(case, mesh):
    """The port's run of a case (a PDES_CASES entry) on ``mesh``: the
    final stacked state and the window count."""
    c = dict(case)
    until, skew = c.pop("until"), c.pop("skew", False)
    ss = build_sharded_memsys(mesh=mesh, **c)
    st = ss.init_state()
    if skew:
        for k, v in CS.pdes_skew(c["n_shards"], c["n_reqs"]).items():
            st.comp_state["writer"][k] = torch.from_numpy(v)
    return ss.run(ss.shard_state(st), until=until, return_windows=True)


def _cpu_mesh(n):
    """A mesh of ``n`` placements of the CPU, made as the reference's tests
    make theirs: with the forced count set while the mesh is made."""
    mp = pytest.MonkeyPatch()
    mp.setenv(pdes.FORCE_DEVICES_ENV, str(n))
    try:
        return make_sim_mesh(n, device="cpu")
    finally:
        mp.undo()


@functools.cache
def _port(name):
    case = CS.PDES_CASES[name] if isinstance(name, str) else dict(name)
    return _run(case, _cpu_mesh(case["n_shards"]))


def _summary(out, w):
    return CS.pdes_summary({k: as_np(v) for k, v in _leaves(out).items()},
                           w)


@pytest.fixture(scope="module")
def jax_live():
    """The JAX package's run of LIVE, started when the module's first test
    starts so that it overlaps the port's runs; read by the last test."""
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).with_name("_pdes_refs.py")),
         "--leaves", json.dumps(LIVE)], env=child_env(LIVE["n_shards"]),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.mark.parametrize("name", CASES_A)
def test_port_equals_pdes_ref(name, jax_live):
    out, w = _port(name)
    assert _summary(out, w) == CS.PDES_REF[name]


def test_one_shard_conserves_messages():
    """1-shard PDES == plain engine on the same local topology (gateway
    traffic aside): every core's requests issued and answered."""
    out, _ = _port("s1")
    core = out.comp_state["core"]
    assert int(core["remaining"].sum()) == 0
    assert int(core["outstanding"].sum()) == 0


def test_every_writer_drained_on_8_shards():
    """On 8 shards every remote write is issued, and every DRAM served at
    least its neighbour's 8 writes' worth."""
    out, _ = _port("s8")
    assert int(out.comp_state["writer"]["remaining"].sum()) == 0
    served = out.comp_state["dram"]["served"].reshape(8, -1).sum(dim=1)
    assert bool((served >= 8).all()), served


def test_run_returns_windows_on_a_mesh():
    """Reference fault 5: the reference's ``run(return_windows=True)``
    raises on a mesh of more than one device; the port returns the count
    on any mesh."""
    for name in ("s2", "s8"):
        _, w = _port(name)
        assert isinstance(w, int) and w == CS.PDES_REF[name]["windows"]


def test_more_shards_than_placements():
    """Reference fault 6: the reference needs one device a shard (2 shards
    on its default one-device mesh raise in ``ppermute``); the port runs
    several shards on one placement to the same bits."""
    out, w = _run(CS.PDES_CASES["s2"], make_sim_mesh(1, device="cpu"))
    assert _summary(out, w) == CS.PDES_REF["s2"]


def test_an_event_at_the_horizon_spins_to_max_windows():
    """Reference limit 3, copied: a shard's event at the horizon itself is
    never processed (a window runs to ``t_end - 2*EPS``), yet the loop
    goes on while the next event is within ``until + EPS``, so the run
    spins to ``max_windows``.  The reference, on the s1 case to 150 with
    max_windows=300: 300 windows, time 150.0."""
    case = dict(CS.PDES_CASES["s1"], until=150.0)
    c = dict(case)
    until = c.pop("until")
    ss = build_sharded_memsys(mesh=make_sim_mesh(1, device="cpu"), **c)
    out, w = ss.run(ss.init_state(), until=until, max_windows=30,
                    return_windows=True)
    assert w == 30 and float(out.time[0]) == 150.0


def test_blocks_on_two_devices_exchange_mailboxes():
    """A mesh of two distinct devices (the CPU named two ways) puts each
    half of the shards on its own twin of the simulation and moves the
    mailboxes between them: the same bits as one device."""
    mesh = (CPU, torch.device("cpu", 0))
    assert [g[1:] for g in pdes.device_groups(mesh, 4)] == [(0, 2), (2, 4)]
    out, w = _run(CS.PDES_CASES["s2"], mesh)
    assert _summary(out, w) == CS.PDES_REF["s2"]


def test_meshes_and_placements(monkeypatch):
    monkeypatch.delenv(pdes.FORCE_DEVICES_ENV, raising=False)
    assert pdes.placements("cpu") == (CPU,)
    assert pdes.lane_mesh(4, device="cpu") == (CPU,)       # clamped
    monkeypatch.setenv(pdes.FORCE_DEVICES_ENV, "3")
    assert pdes.device_count("cpu") == 3
    m = pdes.lane_mesh(device="cpu")
    assert m == (CPU,) * 3 and pdes.lane_mesh(3, device="cpu") is m
    assert make_sim_mesh(device="cpu") == (CPU,) * 3
    with pytest.raises(ValueError, match="REPRO_TORCH_FORCE_DEVICES"):
        make_sim_mesh(4, device="cpu")
    # consecutive placements of one device share one group
    assert pdes.device_groups((CPU,) * 3, 6) == [(CPU, 0, 6)]
    with pytest.raises(ValueError, match="split evenly"):
        build_sharded_memsys(mesh=(CPU,) * 3, n_shards=4,
                             tiles_per_shard=2, n_reqs=8)
    # a mesh made with no device names the cards: no silent CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pdes.lane_mesh(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_sharded_memsys(n_shards=1, tiles_per_shard=2, n_reqs=8)


def test_sharded_sim_matches_jax_live(jax_live):
    """The JAX ShardedSim at 2 shards (2 forced host devices, writers
    skewed) and the port at 2 placements of the CPU: the window count and
    every leaf, f32 by its bits."""
    out, w = _port(tuple(sorted(LIVE.items())))
    stdout, stderr = jax_live.communicate(timeout=600)
    assert jax_live.returncode == 0, stderr[-3000:]
    ref = json.loads(stdout.strip().splitlines()[-1])
    assert w == ref["windows"]
    got = {k: as_np(v) for k, v in _leaves(out).items()}
    assert got.keys() == ref["leaves"].keys()
    for k, (dt, shape, hexb) in ref["leaves"].items():
        want = np.frombuffer(bytes.fromhex(hexb), np.dtype(dt)).reshape(
            shape)
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        assert got[k].tobytes() == want.tobytes(), (k, got[k], want)
