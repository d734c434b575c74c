"""The JAX package's dry-run numbers that the port's dry run is held to.

JAX fixes its device count at first use, so each run is a process of its
own with forced host devices.  Run from the repo root:

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_dryrun_refs.py sim 8
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_dryrun_refs.py tests
    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_dryrun_refs.py fault7

``sim N``: the sharded-PDES memsys (4 tiles a shard) lowered to 4096 on
N host devices, as ``repro.launch.dryrun.run_sim_cell`` lowers it (the
port's ``chip_smoke.py`` keeps N=8 as ``DRYRUN_SIM_REF``).  ``tests``:
the sim at 2 shards and the reference test's tiny deepseek-67b decode on
the 2x2 test mesh (``tests/launch/test_dryrun_small.py``), each compiled
on 8 host devices.  ``fault7``: whether a tiny train, prefill and decode
cell lower under ``activation_sharding`` as ``run_cell`` lowers them.
Each prints one JSON line.
"""
import dataclasses
import json
import os
import sys


def sim_ref(n: int) -> dict:
    import jax

    from repro.launch.roofline import parse_collectives
    from repro.sims.memsys import build_sharded_memsys

    mesh = jax.make_mesh((n,), ("sim",))
    ss = build_sharded_memsys(mesh=mesh, n_shards=n, tiles_per_shard=4)
    compiled = ss.lower(until=4096.0).compile()
    mem = compiled.memory_analysis()
    coll = parse_collectives(compiled.as_text(), n)
    return {"argument_bytes": mem.argument_size_in_bytes,
            "temp_bytes": mem.temp_size_in_bytes,
            "collective_by_op": coll.bytes_by_op,
            "collective_op_count": coll.count}


def tiny_cells():
    """The reference tests' tiny configs and shapes."""
    from repro.configs import SHAPES, get_smoke_config
    dec = dataclasses.replace(get_smoke_config("deepseek-67b"), d_model=64,
                              n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128)
    dec_shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=128,
                                    global_batch=8)
    tr = dataclasses.replace(get_smoke_config("stablelm-1.6b"), d_model=64,
                             n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128)
    tr_shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                   global_batch=8)
    pre_shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=64,
                                    global_batch=8)
    return dec, dec_shape, tr, tr_shape, pre_shape


def decode_ref() -> dict:
    from repro.launch.mesh import make_test_mesh
    from repro.launch.roofline import parse_collectives
    from repro.serve.step import assemble_decode

    cfg, shape = tiny_cells()[:2]
    mesh = make_test_mesh()
    jitted, args = assemble_decode(cfg, mesh, shape)
    with mesh:
        compiled = jitted.lower(*args).compile()
    mem = compiled.memory_analysis()
    coll = parse_collectives(compiled.as_text(), mesh.devices.size)
    return {"argument_bytes": mem.argument_size_in_bytes,
            "collective_by_op": coll.bytes_by_op,
            "collective_bytes": coll.total_bytes,
            "collective_op_count": coll.count}


def fault7() -> dict:
    """Lower each tiny cell under ``activation_sharding``, as ``run_cell``
    does: "ok", or the first line of what it raised."""
    from repro.launch.mesh import make_test_mesh
    from repro.parallel.sharding import (activation_sharding,
                                         make_rules_for_mesh)
    from repro.serve.step import assemble_decode, assemble_prefill
    from repro.train.step import TrainHParams, assemble_train

    dec, dec_shape, tr, tr_shape, pre_shape = tiny_cells()
    mesh = make_test_mesh()
    out = {}
    for name, make in (
            ("train", lambda: assemble_train(tr, mesh, tr_shape,
                                             TrainHParams())),
            ("prefill", lambda: assemble_prefill(tr, mesh, pre_shape)),
            ("decode", lambda: assemble_decode(dec, mesh, dec_shape))):
        cfg = dec if name == "decode" else tr
        jitted, args = make()
        try:
            with mesh, activation_sharding(mesh,
                                           make_rules_for_mesh(cfg, mesh)):
                jitted.lower(*args).compile()
            out[name] = "ok"
        except Exception as e:      # the outcome is the record
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return out


def main():
    what = sys.argv[1]
    n = int(sys.argv[2]) if what == "sim" else 8
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    if what == "sim":
        out = sim_ref(n)
    elif what == "tests":
        out = {"sim2": sim_ref(2), "decode": decode_ref()}
    elif what == "fault7":
        out = fault7()
    else:
        raise SystemExit(f"unknown {what!r}: sim N | tests | fault7")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
