"""The JAX package's results behind ``chip_smoke.py``'s phase 11 (a) and
(b): PDES_REF.  Each case runs ``repro.sims.memsys.build_sharded_memsys``
in a child process with as many forced host devices as shards
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``, as the
reference's own tests run it), on the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_pdes_refs.py [case ...]

With no case it runs every case of ``chip_smoke.PDES_CASES``.  It prints
the constant to paste into chip_smoke.py and each case's wall time.

``jax_pdes`` is also the live reference of ``tests/test_torch_pdes.py``
(``--leaves <case as JSON>`` prints every leaf of the final state, f32 as
its bits, and the window count).  The window count comes from a copy of
``ShardedSim.run`` that reads the sharded counter with ``np.asarray``:
the reference's ``run(return_windows=True)`` raises on a mesh of more
than one device (ROADMAP queue 3, reference fault 5).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))


def _run_windows(ss, st, until, max_windows=10_000):
    """``ShardedSim.run(..., return_windows=True)`` of the reference, with
    the window count read by ``np.asarray``."""
    import jax
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.core.pdes import _SM_KW, shard_map_compat
    from repro.core.ports import EPS

    spec = lambda a: P(*([ss.axis] + [None] * (a.ndim - 1)))
    in_specs = jax.tree.map(spec, st)

    @partial(shard_map_compat, mesh=ss.mesh, in_specs=(in_specs,),
             out_specs=(in_specs, P(ss.axis)), **_SM_KW)
    def _run(s_st):
        s = jax.tree.map(lambda a: a[0], s_st)

        def cond(carry):
            s, w = carry
            t = jax.lax.pmin(ss._local_next(s), ss.axis)
            return (t <= until + EPS) & (w < max_windows)

        def body(carry):
            s, w = carry
            return ss._step_window(s, jax.numpy.float32(until)), w + 1

        s, w = jax.lax.while_loop(cond, body, (s, jax.numpy.int32(0)))
        return jax.tree.map(lambda a: a[None], s), w[None]

    out, w = _run(st)
    return out, int(np.asarray(w)[0])


def jax_pdes(n_shards, tiles_per_shard, n_reqs, until, skew=False):
    """The reference's run of one case in this process (which must have
    ``n_shards`` devices): ``(leaves, windows)``, the leaves as numpy
    arrays keyed by path."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.launch.mesh import make_sim_mesh
    from repro.sims.memsys import build_sharded_memsys
    from _torch_sim_parity import _leaves, as_np, chip_smoke
    assert len(jax.devices()) >= n_shards, jax.devices()
    ss = build_sharded_memsys(mesh=make_sim_mesh(n_shards),
                              n_shards=n_shards,
                              tiles_per_shard=tiles_per_shard,
                              n_reqs=n_reqs)
    st = ss.init_state()
    if skew:
        cs = dict(st.comp_state)
        cs["writer"] = {k: jnp.asarray(v) for k, v in
                        chip_smoke().pdes_skew(n_shards, n_reqs).items()}
        st = dataclasses.replace(st, comp_state=cs)
    out, w = _run_windows(ss, ss.shard_state(st), until)
    return {k: as_np(v) for k, v in _leaves(out).items()}, w


def child_env(n_devices):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={n_devices}"
    return env


def _one(name):
    """Child: one case's PDES_REF entry as JSON on the last line."""
    from _torch_sim_parity import chip_smoke
    cs = chip_smoke()
    case = cs.PDES_CASES[name]
    t = time.perf_counter()
    leaves, w = jax_pdes(**case)
    print(json.dumps({"ref": cs.pdes_summary(leaves, w),
                      "wall_s": time.perf_counter() - t}))


def _leaves_json(case):
    """Child: every leaf of one case's final state and the window count
    as JSON on the last line (each leaf as dtype, shape and hex bytes)."""
    leaves, w = jax_pdes(**case)
    print(json.dumps({"windows": w, "leaves": {
        k: [v.dtype.str, list(v.shape), v.tobytes().hex()]
        for k, v in leaves.items()}}))


def main(names):
    from _torch_sim_parity import chip_smoke
    cs = chip_smoke()
    names = names or list(cs.PDES_CASES)
    refs = {}
    for name in names:
        n = cs.PDES_CASES[name]["n_shards"]
        r = subprocess.run([sys.executable, __file__, "--one", name],
                           env=child_env(n), capture_output=True,
                           text=True, check=True)
        got = json.loads(r.stdout.strip().splitlines()[-1])
        refs[name] = got["ref"]
        print(f"# {name}: {got['wall_s']:.1f} s", flush=True)
    print("PDES_REF = " + json.dumps(refs, indent=1))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        _one(sys.argv[2])
    elif sys.argv[1:2] == ["--leaves"]:
        _leaves_json(json.loads(sys.argv[2]))
    else:
        main(sys.argv[1:])
