"""Multi-pod dry run.  Counterpart of ``repro.launch.dryrun``.

Plans every (architecture x input shape) cell on the production meshes --
16x16 single-pod and 2x16x16 multi-pod -- and records per-device memory,
FLOPs, bytes and collectives for the roofline (``launch.roofline``).  The
reference lowers and compiles each cell on ShapeDtypeStruct stand-ins;
PyTorch has no such compiler, so here each step runs on the ``meta``
device, which is the dry run's nature and not a fallback: every tensor
has a shape and a dtype and no storage, nothing is allocated, and no
kernel launches (``meta`` goes to the kernels' plain versions, as the
reference lowers ``attn_impl="xla"``).  One trace per (arch, shape) serves
every mesh:

* argument and output bytes a device are exact: each leaf's shard under
  the same PartitionSpecs the reference builds (parameters, optimizer
  state, batch, cache), summed;
* matmul FLOPs and result bytes are counted during the trace and split
  evenly over the devices;
* temp bytes are an estimate: the peak of the live bytes the trace
  creates, batch-led tensors over the batch's shard factor and the rest
  over all devices (``roofline.TraceCounter``);
* collectives follow ``roofline``'s model with the reference's ring
  formulas.

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-67b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--out runs/dryrun]
  python -m repro_torch.launch.dryrun --sim     # the engine as a workload
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, applicable, get_config
from repro_torch.core.pdes import device_count
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh, make_sim_mesh
from repro_torch.models import transformer as tfm
from repro_torch.parallel.sharding import (P, activation_sharding,
                                           batch_pspec, constraint_spec,
                                           make_rules_for_mesh, shard_factor)
from repro_torch.serve.step import assemble_decode, assemble_prefill
from repro_torch.train.step import TrainHParams, assemble_train


def _pairs(tree, specs):
    """``[(tensor, spec), ...]`` of a tree and its spec tree (a ``P`` is a
    spec leaf; a model stands for its ``param_tree``)."""
    if isinstance(tree, tfm.Model):
        tree = tfm.param_tree(tree)
    if isinstance(specs, P):
        return [(tree, specs)]
    if isinstance(specs, dict):
        return [x for k in specs for x in _pairs(tree[k], specs[k])]
    return [x for t, s in zip(tree, specs, strict=True)
            for x in _pairs(t, s)]


def spec_bytes(tree, specs, mesh) -> int:
    """Bytes a device holds of ``tree`` laid out by ``specs`` on ``mesh``."""
    return sum(roofline.shard_bytes(t, s, mesh) for t, s in
               _pairs(tree, specs))


def assemble(cfg, mesh, shape, hp: TrainHParams | None = None):
    if shape.kind == "train":
        return assemble_train(cfg, mesh, shape, hp)
    if shape.kind == "prefill":
        return assemble_prefill(cfg, mesh, shape)
    return assemble_decode(cfg, mesh, shape)


def _batch_ways(mesh, shape) -> int:
    return shard_factor(batch_pspec(mesh, shape.global_batch)[0], mesh)


def trace_step(asm, cfg, shape, meshes):
    """Run ``asm``'s step once on ``meta`` under a ``TraceCounter`` whose
    live bytes are weighed for each of ``meshes`` (the activation specs
    are resolved on the first).  -> (counter, outputs, activation
    constraints, seconds)."""
    B = shape.global_batch
    s_tok = 1 if shape.kind == "decode" else shape.seq_len
    counter = roofline.TraceCounter(
        divisors=[(_batch_ways(m, shape), m.size) for m in meshes],
        batch_dims=(B, B * s_tok))
    grad = contextlib.nullcontext() if shape.kind == "train" else \
        torch.no_grad()
    t0 = time.time()
    mesh = meshes[0]
    with activation_sharding(mesh, make_rules_for_mesh(cfg, mesh)) as rec, \
            grad, counter:
        out = asm.step(*asm.args)
    return counter, out, rec, time.time() - t0


def plan_cells(cfg, shape, meshes, hp: TrainHParams | None = None):
    """Trace one step of ``cfg`` at ``shape`` and plan it on each mesh.
    -> ([Plan per mesh], trace seconds, activation constraints)."""
    asms = [assemble(cfg, m, shape, hp) for m in meshes]
    counter, out, rec, secs = trace_step(asms[0], cfg, shape, meshes)
    plans = []
    for i, (mesh, asm) in enumerate(zip(meshes, asms)):
        coll = roofline.TraceCounter()
        roofline.record_step_collectives(
            coll, cfg, mesh, shape, _pairs(asm.args[0], asm.in_specs[0]),
            train=shape.kind == "train")
        plans.append(roofline.Plan(
            flops=counter.dot_flops / mesh.size,
            result_bytes=counter.result_bytes / mesh.size
            + coll.result_bytes,
            collectives=coll.collectives,
            argument_bytes=spec_bytes(asm.args, asm.in_specs, mesh),
            output_bytes=spec_bytes(out, asm.out_specs, mesh),
            temp_bytes=int(counter.peaks[i])))
    return plans, secs, rec


def run_cells(arch: str, shape_name: str, multi_pods=(False,),
              hillclimb: dict | None = None) -> list[dict]:
    """One record per mesh of one (arch, shape) cell, from one trace."""
    cfg = get_config(arch, **(hillclimb.get("cfg", {}) if hillclimb else {}))
    shape = SHAPES[shape_name]
    recs = [{"arch": arch, "shape": shape_name,
             "mesh": "2x16x16" if mp else "16x16",
             "params_total": cfg.param_count(),
             "params_active": cfg.active_param_count(),
             "override": hillclimb} for mp in multi_pods]
    ok, why = applicable(cfg, shape_name)
    if not ok:
        for r in recs:
            r.update(status="skipped", reason=why)
        return recs
    meshes = [make_production_mesh(multi_pod=mp) for mp in multi_pods]
    hp = TrainHParams(**(hillclimb.get("hp", {}) if hillclimb else {}))
    plans, secs, rec = plan_cells(cfg, shape, meshes, hp)
    for r, mesh, plan in zip(recs, meshes, plans):
        rules = make_rules_for_mesh(cfg, mesh)
        specs = sorted({(s, str(tuple(constraint_spec(s, a, mesh, rules))))
                        for s, a, _ in rec})
        r["trace_s"] = round(secs, 1)
        print(f"[{arch} x {shape_name} x {r['mesh']}] planned per device:")
        print(f"  args={plan.argument_bytes/2**30:.2f}GiB "
              f"temp~{plan.temp_bytes/2**30:.2f}GiB "
              f"out={plan.output_bytes/2**30:.2f}GiB  flops={plan.flops:.3e} "
              f"bytes={2 * plan.result_bytes:.3e}")
        r.update(status="ok", activation_specs=[list(x) for x in specs],
                 **roofline.analyze(plan, cfg, shape, mesh.size))
    return recs


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             hillclimb: dict | None = None) -> dict:
    return run_cells(arch, shape_name, (multi_pod,), hillclimb)[0]


def run_sim_cell(multi_pod: bool, device=None) -> dict:
    """The paper's engine itself as a workload: the sharded-PDES memsys,
    one shard a placement of ``device`` (the card by default; its count
    is ``core.pdes.device_count``, ``REPRO_TORCH_FORCE_DEVICES`` adds
    placements), planned by ``ShardedSim.lower``: per-shard argument
    bytes and the exchange's collectives a window."""
    from repro_torch.sims.memsys import build_sharded_memsys

    n = device_count(device if device is not None else "cuda")
    t0 = time.time()
    ss = build_sharded_memsys(mesh=make_sim_mesh(n, device), n_shards=n,
                              tiles_per_shard=4)
    low = ss.lower(until=4096.0)
    coll = roofline.TraceCounter()
    for op, nbytes, group, times in low["collectives"]:
        coll.record_collective(op, nbytes, group, times)
    st = coll.collectives
    rec = {"arch": "akita-memsys-pdes", "shape": f"{n}shards",
           "mesh": f"{n}", "status": "ok",
           "plan_s": round(time.time() - t0, 1),
           "argument_bytes_per_shard": low["argument_bytes"],
           "collective_bytes_per_chip": st.total_bytes,
           "collective_by_op": st.bytes_by_op,
           "collective_op_count": st.count}
    print(f"[akita-memsys-pdes x {n} shards] "
          f"args={low['argument_bytes']/2**20:.1f}MiB a shard, "
          f"collectives {st.bytes_by_op} a window")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--sim", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--device", default=None,
                    help="the sim cell's device (default: the card)")
    ap.add_argument("--override", default=None,
                    help='hillclimb JSON, e.g. \'{"hp":{"micro_batches":8},'
                         '"cfg":{"remat":"none"},"tag":"mb8"}\'')
    args = ap.parse_args(argv)
    override = json.loads(args.override) if args.override else None

    os.makedirs(args.out, exist_ok=True)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = []
    if args.sim:
        cells.append(("__sim__", ""))
    elif args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all, or --sim")
        cells.append((args.arch, args.shape))

    def path_of(a, s, mp):
        tag = f"{a}_{s}_{'mp' if mp else 'sp'}".replace("__sim___", "sim_")
        if override and override.get("tag"):
            tag += "_" + override["tag"]
        return tag, os.path.join(args.out, tag + ".json")

    results = []
    t_all = time.time()
    for a, s in cells:
        todo = []
        for mp in (meshes if a != "__sim__" else meshes[:1]):
            tag, path = path_of(a, s, mp)
            if os.path.exists(path):
                print(f"== {tag}: cached, skipping")
                with open(path) as fh:
                    results.append(json.load(fh))
            else:
                todo.append((mp, tag, path))
        if not todo:
            continue
        print("== " + ", ".join(t for _, t, _ in todo))
        try:
            recs = [run_sim_cell(todo[0][0], args.device)] \
                if a == "__sim__" else \
                run_cells(a, s, [mp for mp, _, _ in todo], override)
        except Exception as e:      # a cell's failure is its record
            traceback.print_exc()
            recs = [{"arch": a, "shape": s, "mesh": "mp" if mp else "sp",
                     "status": "error", "error": repr(e)}
                    for mp, _, _ in todo]
        for (_, _, path), rec in zip(todo, recs):
            with open(path, "w") as fh:
                json.dump(rec, fh, indent=1, default=str)
            results.append(rec)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\nDONE: {n_ok} ok, {n_skip} skipped (documented), {n_err} "
          f"errors in {time.time() - t_all:.1f} s")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
