"""The port's sharding rules and PartitionSpecs against the JAX package's,
spec for spec: parameter axes, rules, batch/seq specs, parameter,
optimizer (f32 and int8), batch and cache specs on both production meshes
and both test meshes, the activation specs that ``constrain`` records,
and the per-device argument bytes of every applicable (arch x shape x
production mesh) cell against the reference's shard shapes on an
``AbstractMesh`` (no devices, nothing compiled)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import applicable as j_applicable
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_smoke
from repro.models import transformer as jtfm
from repro.models.layers import PSpec as JPSpec
from repro.models.layers import make_pspecs as j_make_pspecs
from repro.parallel import sharding as jsh
from repro.serve import step as jserve
from repro.train import step as jtrain
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import PSpec, abstract_params, make_pspecs
from repro_torch.parallel import sharding as sh
from repro_torch.serve import step as serve
from repro_torch.train import step as train

MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True),
          "2x2": make_test_mesh(),
          "2x2x2": make_test_mesh(multi_pod=True)}


def jmesh(mesh):
    return AbstractMesh(mesh.axis_sizes, mesh.axis_names)


def tup(spec):
    """A spec (either package's) as a plain tuple of entries."""
    return tuple(spec)


def port_vs_ref(port, ref):
    """Walk the port's tree beside the reference's: the port's
    ``"layers"`` holds one tree per layer where the reference stacks them.
    Yields (path, port leaf, reference leaf, whether it is stacked)."""
    def walk(p, r, stacked, path):
        if isinstance(r, dict):
            assert set(p) == set(r), path
            for k in r:
                yield from walk(p[k], r[k], stacked, path + (k,))
        else:
            yield path, p, r, stacked
    assert set(port) == set(ref)
    for k in ref:
        if k == "layers":
            for i, lay in port[k].items():
                yield from walk(lay, ref[k], True, (k, i))
        else:
            yield from walk(port[k], ref[k], False, (k,))


def unstacked(spec, stacked):
    """A reference spec as a tuple, without the scan axis of a stacked
    leaf (which is always unsharded)."""
    t = tup(spec)
    if stacked:
        assert t[0] is None
        return t[1:]
    return t


def test_p_equals_jax_partitionspec():
    for entries in [(), (None,), (("data",), "model", None),
                    (("pod", "data"),), ("data",), (None, "data"),
                    (["pod", "data"], None)]:
        assert tup(sh.P(*entries)) == tup(JP(*entries))


def test_logical_meshes_have_the_reference_axes():
    for mp in (False, True):
        m = make_production_mesh(multi_pod=mp)
        assert m.size == (512 if mp else 256)
        assert m.shape == ({"pod": 2} if mp else {}) | {"data": 16,
                                                         "model": 16}
        assert m.axis_names == (("pod",) if mp else ()) + ("data", "model")
        t = make_test_mesh(multi_pod=mp)
        assert t.shape == ({"pod": 2} if mp else {}) | {"data": 2,
                                                         "model": 2}
        assert jmesh(m).shape == m.shape


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_parameter_axes_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    n = 0
    for path, p, r, stacked in port_vs_ref(tfm.model_specs(cfg),
                                           jtfm.model_specs(jcfg)):
        assert isinstance(p, PSpec) and isinstance(r, JPSpec), path
        if stacked:
            assert r.shape[0] == tfm.n_scanned(cfg) and r.axes[0] is None
            r = dataclasses.replace(r, shape=r.shape[1:], axes=r.axes[1:])
        assert (p.shape, p.axes, p.init, p.scale) == \
            (r.shape, r.axes, r.init, r.scale), path
        n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_parameter_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for name, mesh in MESHES.items():
        rules = sh.make_rules_for_mesh(cfg, mesh)
        jrules = jsh.make_rules_for_mesh(jcfg, jmesh(mesh))
        assert rules == jrules, name
        assert sh.data_axes(mesh) == jsh.data_axes(jmesh(mesh))
        p_specs = make_pspecs(tfm.model_specs(cfg), rules)
        j_specs = j_make_pspecs(jtfm.model_specs(jcfg), jrules)
        for path, p, r, stacked in port_vs_ref(p_specs, j_specs):
            assert tup(p) == unstacked(r, stacked), (name, path)
        for dt in ("float32", "int8"):
            o = train.opt_pspecs(p_specs, dt)
            jo = jtrain.opt_pspecs(j_specs, dt)
            assert tup(o["count"]) == tup(jo["count"]) == ()
            for k in ("m", "v"):
                for path, p, r, stacked in port_vs_ref(o[k], jo[k]):
                    if dt == "int8":     # blocks of the flattened leaf
                        assert path[-1] in ("q", "s"), path
                        assert tup(p) == tup(r), (name, path)
                    else:
                        assert tup(p) == unstacked(r, stacked), (name, path)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_seq_specs_equal_the_reference(mesh_name):
    mesh = MESHES[mesh_name]
    jm = jmesh(mesh)
    for B in (1, 2, 3, 4, 8, 16, 32, 128, 256, 512):
        assert tup(sh.batch_pspec(mesh, B)) == tup(jsh.batch_pspec(jm, B))
        for S in (1, 7, 64, 4096, 524288):
            for bs in (False, True):
                p = sh.seq_pspec(mesh, None, S, bs)
                r = jsh.seq_pspec(jm, None, S, bs)
                assert (p is None and r is None) or tup(p) == tup(r)
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), j_get_config(arch)
        for s in SHAPES:
            b = train.batch_pspecs(cfg, mesh, SHAPES[s])
            jb = jtrain.batch_pspecs(jcfg, jm, J_SHAPES[s])
            assert {k: tup(v) for k, v in b.items()} == \
                {k: tup(v) for k, v in jb.items()}, (arch, s)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cache_specs_equal_the_reference(mesh_name):
    mesh = MESHES[mesh_name]
    jm = jmesh(mesh)
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), j_get_config(arch)
        for s in SHAPES:
            B, S = SHAPES[s].global_batch, SHAPES[s].seq_len
            for unrolled in (False, True):
                got = serve.cache_pspecs(cfg, mesh, B, S, unrolled)
                ref = jserve.cache_pspecs(jcfg, jm, B, S, unrolled)
                assert jax.tree.map(tup, got, is_leaf=lambda x:
                                    isinstance(x, sh.P)) == \
                    jax.tree.map(tup, ref, is_leaf=lambda x:
                                 isinstance(x, JP)), (arch, s, unrolled)


def _ref_constraints(jcfg, mesh, batch):
    """The specs the reference's ``constrain`` hands
    ``with_sharding_constraint`` in one prefill forward, traced by
    ``jax.eval_shape`` on an AbstractMesh."""
    from repro.models.layers import abstract_params
    seen = []

    def record(x, sharding):
        seen.append((tuple(x.shape), tup(sharding.spec)))
        return x
    jm = jmesh(mesh)
    params = abstract_params(jtfm.model_specs(jcfg))
    orig = jax.lax.with_sharding_constraint
    jax.lax.with_sharding_constraint = record
    try:
        with jsh.activation_sharding(jm, jsh.make_rules_for_mesh(jcfg, jm)):
            jax.eval_shape(lambda p, b: jtfm.forward(p, jcfg, b,
                                                     mode="prefill"),
                           params, batch)
    finally:
        jax.lax.with_sharding_constraint = orig
    return set(seen)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "deepseek-v2-236b",
                                  "grok-1-314b"])
def test_constrain_records_the_reference_activation_specs(arch):
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    mesh = make_test_mesh()
    B, S = 4, 16
    with sh.activation_sharding(mesh, sh.make_rules_for_mesh(cfg, mesh)) \
            as rec, torch.no_grad():
        model = tfm.Model(cfg, abstract_params(tfm.model_specs(cfg)))
        tfm.forward(model, cfg, {"tokens": torch.empty(
            (B, S), dtype=torch.int32, device="meta")}, mode="prefill")
    got = {(s, tup(p)) for s, _, p in rec}
    want = _ref_constraints(jcfg, mesh, {"tokens": jax.ShapeDtypeStruct(
        (B, S), np.int32)})
    assert got == want
    # outside the context nothing is recorded and nothing changes
    x = torch.zeros(2, 3)
    assert sh.constrain(x, "fsdp", None) is x


def ref_argument_bytes(arch, shape_name, mesh):
    """The reference's per-device argument bytes: its abstract arguments'
    shard shapes under its own PartitionSpecs on an AbstractMesh."""
    jcfg, shape, jm = j_get_config(arch), J_SHAPES[shape_name], jmesh(mesh)
    rules = jsh.make_rules_for_mesh(jcfg, jm)
    p_specs = j_make_pspecs(jtfm.model_specs(jcfg), rules)
    if shape.kind == "train":
        _, args = jtrain.assemble_train(jcfg, jm, shape)
        specs = (p_specs, jtrain.opt_pspecs(p_specs),
                 jtrain.batch_pspecs(jcfg, jm, shape))
    elif shape.kind == "prefill":
        _, args = jserve.assemble_prefill(jcfg, jm, shape)
        specs = (p_specs, jtrain.batch_pspecs(jcfg, jm, shape))
    else:
        _, args = jserve.assemble_decode(jcfg, jm, shape)
        B, S = shape.global_batch, shape.seq_len
        bp = jsh.batch_pspec(jm, B)
        tp = JP(bp[0] if len(bp) else None, None)
        specs = (p_specs, jserve.cache_pspecs(
            jcfg, jm, B, S, jtfm.needs_unrolled_decode(jcfg, S)), tp, tp)
    total = 0
    for spec_tree, arg in zip(specs, args, strict=True):
        pairs = jax.tree.leaves(jax.tree.map(
            lambda s, a: (s, a), spec_tree, arg,
            is_leaf=lambda x: isinstance(x, JP)),
            is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], JP))
        for s, a in pairs:
            n = int(np.prod(NamedSharding(jm, s).shard_shape(a.shape)))
            total += n * a.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_equal_the_reference_on_production_meshes(arch):
    cfg = get_config(arch)
    n = 0
    for s in SHAPES:
        if not j_applicable(j_get_config(arch), s)[0]:
            continue
        for name in ("16x16", "2x16x16"):
            mesh = MESHES[name]
            asm = dryrun.assemble(cfg, mesh, SHAPES[s])
            got = dryrun.spec_bytes(asm.args, asm.in_specs, mesh)
            assert got == ref_argument_bytes(arch, s, mesh), (s, name)
            n += 1
    assert n >= 4


def test_argument_bytes_of_the_reference_test_decode_on_2x2():
    """The reference test's tiny deepseek-67b decode on the 2x2 test mesh:
    287,648 B a device, as its compiled module's ``memory_analysis``
    gives (held in tests/test_torch_dryrun.py)."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-67b"), d_model=64,
                              n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128)
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=128,
                                global_batch=8)
    mesh = make_test_mesh()
    asm = serve.assemble_decode(cfg, mesh, shape)
    assert dryrun.spec_bytes(asm.args, asm.in_specs, mesh) == 287_648


def test_every_jax_arch_and_shape_is_covered():
    assert list(J_ARCHS) == list(ARCH_IDS)
    assert list(J_SHAPES) == list(SHAPES)
