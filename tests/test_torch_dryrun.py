"""The port's dry run against the JAX package's: traced FLOPs against the
reference's HLO dot count, the trace counter against the reference's HLO
parser test, the collective model against a hand count, the report
tables, the serving steps against the reference's jitted steps, the sim
cell and the 2x2 test mesh's decode against the reference's compiled
modules (in a child process with 8 forced host devices), the planned
train step on both test meshes (the counterpart of the reference's red
``test_train_step_lowers_on_test_meshes``), and the ``meta`` routing that
lets a model trace without allocating or launching anything."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import SHAPES as J_SHAPES
from repro.configs import applicable as j_applicable
from repro.configs import cell_list as j_cell_list
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_smoke
from repro.launch import report as jreport
from repro.launch import roofline as jroof
from repro.models import transformer as jtfm
from repro.models.layers import abstract_params as j_abstract
from repro.models.layers import init_params
from repro.serve import step as jserve
from repro_torch.configs import (ARCH_IDS, SHAPES, applicable, cell_list,
                                 get_config, get_smoke_config)
from repro_torch.convert import from_jax_params
from repro_torch.kernels.flash_attention import autograd as fa_autograd
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.ssd import autograd as ssd_autograd
from repro_torch.kernels.ssd import kernel as ssd_kernel
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import abstract_params
from repro_torch.serve import step as serve
from repro_torch.train.step import TrainHParams

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 512


def _batches(cfg, B, S):
    """The same batch shapes for both packages (meta on the port's side)."""
    if cfg.frontend == "audio":
        shp = {"features": ((B, S, cfg.frontend_dim), np.float32)}
    elif cfg.frontend == "vision":
        nv = cfg.n_vision_tokens
        shp = {"tokens": ((B, S - nv), np.int32),
               "vision": ((B, nv, cfg.d_model), np.float32)}
    else:
        shp = {"tokens": ((B, S), np.int32)}
    jb = {k: jax.ShapeDtypeStruct(s, d) for k, (s, d) in shp.items()}
    tb = {k: torch.empty(s, dtype=torch.int32 if d == np.int32 else
                         torch.float32, device="meta")
          for k, (s, d) in shp.items()}
    return jb, tb


def _stash_flops(cfg, T):
    """The prefill's recomputed cache projections (``_layer``'s "stash
    this layer's K/V", MLA's ``_project_latent``): the port computes them
    again, XLA's common-subexpression elimination merges them with the
    attention block's own, so the reference's HLO counts them once."""
    if not cfg.has_attn:
        return 0
    width = (cfg.kv_lora + cfg.qk_rope_dim) if cfg.use_mla else \
        2 * cfg.n_kv_heads * cfg.head_dim
    return cfg.n_layers * 2 * T * cfg.d_model * width


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_traced_flops_equal_the_reference_hlo_dot_count(arch):
    """Prefill of each smoke config at B=2, S=512.  Both plain attentions
    compute every key block (one block of 1024 here): the only difference
    is the recomputed projections XLA merges, exactly; mamba2 has none."""
    jcfg = j_smoke(arch)
    jb, tb = _batches(jcfg, B, S)
    compiled = jax.jit(lambda p, b: jtfm.forward(p, jcfg, b, mode="prefill")
                       ).lower(j_abstract(jtfm.model_specs(jcfg)), jb
                               ).compile()
    ref = jroof.parse_hlo(compiled.as_text(), 1).dot_flops
    cfg = get_smoke_config(arch)
    model = tfm.Model(cfg, abstract_params(tfm.model_specs(cfg)))
    with roofline.TraceCounter() as tc, torch.no_grad():
        tfm.forward(model, cfg, tb, mode="prefill")
    assert tc.dot_flops == ref + _stash_flops(cfg, B * S)
    if arch == "mamba2-130m":
        assert tc.dot_flops == ref == 166_199_296


def test_counter_reads_the_reference_parser_test_program():
    """tests/launch/test_roofline_parser.py's HLO written in torch: a
    10-trip loop of an 8x16 @ 16x16 dot whose result is all-reduced over
    groups of 4, an s32 counter, and an all-gather of a 32x16 f32
    result; the same three expected numbers."""
    x = torch.empty(8, 16, device="meta")
    w = torch.empty(16, 16, device="meta")
    i = torch.zeros((), dtype=torch.int32, device="meta")
    one = torch.ones((), dtype=torch.int32, device="meta")
    with roofline.TraceCounter() as tc:
        for _ in range(10):
            y = x @ w
            tc.record_collective("all-reduce", y.nbytes, 4)
            x = y
            i = i + one
        tc.record_collective("all-gather", 32 * 16 * 4, 4)
    st = tc.collectives
    assert abs(st.bytes_by_op["all-reduce"] - 2 * 8 * 16 * 4 * 0.75 * 10) \
        < 1e-6
    assert abs(st.bytes_by_op["all-gather"] - 32 * 16 * 4 * 0.75) < 1e-6
    assert abs(tc.dot_flops - 2 * 8 * 16 * 16 * 10) < 1e-6
    expect = (8 * 16 * 4) * 2 * 10 + 32 * 16 * 4 + 4 * 10
    assert abs(tc.result_bytes - expect) < 1e-6


def _tiny_train():
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"), d_model=64,
                              n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                global_batch=8)
    return cfg, shape


def test_collectives_equal_a_hand_count_on_the_2x2_mesh():
    """Tiny stablelm (2 layers, d 64, 4 heads of 16, d_ff 128, vocab
    padded to 256) training at B=8 x S=64 on data 2 x model 2, bf16."""
    cfg, shape = _tiny_train()
    (plan,), _, _ = dryrun.plan_cells(cfg, shape, [make_test_mesh()])
    bf = 2
    # every leaf but the norms is fsdp-sharded over data (2 ways) and
    # tensor-sharded over model (2 ways): one device holds a quarter
    embed = 2 * (256 * 64 * bf)                 # tok, unembed
    layer = (4 * (64 * 4 * 16) + 3 * (64 * 128)) * bf
    gathered = (embed + 2 * layer) / 2          # per device after gather
    shards = gathered / 2
    leaves = 2 + 2 * 7
    ag = gathered * (1 / 2) * 2                 # ring 1/2, fwd and bwd
    rs = shards * 1                             # (g - 1) = 1
    act = (8 // 2) * 64 * 64 * bf               # [B/dp, S, d]
    ar = 2 * act * (1 / 2) * (2 * 2) * 2        # 2 blocks x 2 layers, x2
    st = plan.collectives
    assert st.bytes_by_op == {"all-gather": ag, "reduce-scatter": rs,
                              "all-reduce": ar}
    assert st.count == 2 * leaves + leaves + 2 * 2 * 2
    assert st.total_bytes == ag + rs + ar


def test_model_flops_applicable_and_cell_list_equal_the_reference():
    for a in ARCH_IDS:
        for s in SHAPES:
            assert roofline.model_flops(get_config(a), SHAPES[s]) == \
                jroof.model_flops(j_get_config(a), J_SHAPES[s])
            assert applicable(get_config(a), s) == \
                j_applicable(j_get_config(a), s)
    assert cell_list(ARCH_IDS, get_config) == \
        j_cell_list(ARCH_IDS, j_get_config)


def _rows(rng):
    rows = []
    for i, (a, s) in enumerate([(a, s) for a in ARCH_IDS[:5]
                                for s in SHAPES]):
        mesh = "16x16" if i % 3 else "2x16x16"
        if i % 7 == 3:
            rows.append({"arch": a, "shape": s, "mesh": mesh,
                         "status": "skipped", "reason": "encoder-only arch "
                         "has no autoregressive decode" * 3})
            continue
        if i % 11 == 5:
            rows.append({"arch": a, "shape": s, "mesh": mesh,
                         "status": "error", "error": "boom"})
            continue
        terms = rng.random(3) * 10.0 ** rng.integers(-4, 1, 3)
        gib = [1.0, 12.0, 40.0, 95.0][i % 4]    # fits both, then 80 only
        rows.append({
            "arch": a, "shape": s, "mesh": mesh, "status": "ok",
            "lower_compile_s": float(i), "trace_s": float(i),
            "compute_s": terms[0], "memory_s": terms[1],
            "collective_s": terms[2],
            "dominant": ["compute", "memory", "collective"][
                int(np.argmax(terms))],
            "useful_flops_ratio": rng.random(),
            "roofline_fraction": rng.random(),
            "step_lower_bound_s": float(terms.max()),
            "memory_per_device": {"argument_bytes": int(gib * 2**30 / 2),
                                  "temp_bytes": int(gib * 2**30 / 2)}})
    return rows


# the reference's one-line fixes (repro/launch/report.py roofline_table),
# which name TPU levers; the port's name the H100's (report.FIXES)
REF_FIXES = {
    "memory": "fuse attention temporaries (Pallas FA) / cast "
              "collectives+softmax to bf16",
    "collective": "sequence-parallel RS+AG instead of AR; overlap "
                  "via async collectives",
    "compute": "already MXU-bound; raise per-chip batch or reduce remat",
}


def test_report_tables_equal_the_reference_fed_the_same_rows():
    rows = _rows(np.random.default_rng(0))
    for mesh in ("16x16", "2x16x16"):
        ref = jreport.dryrun_table(rows, mesh)
        got = report.dryrun_table(rows, mesh)
        ref = ref.replace("compile s", "trace s").replace("fits 16GB",
                                                          "fits 80GB")
        for r, g in zip(ref.splitlines(), got.splitlines(), strict=True):
            if "NO (40 GiB)" in r:       # fits 80 GB, not 16
                assert g == r.replace("NO (40 GiB)", "YES")
            else:
                assert g == r
        ref = jreport.roofline_table(rows, mesh)
        for dom, fix in REF_FIXES.items():
            ref = ref.replace(fix, report.FIXES[dom])
        assert report.roofline_table(rows, mesh) == ref
    assert report.pick_hillclimb(rows) == jreport.pick_hillclimb(rows)
    # the port's own arch x shape table: a line an arch, a cell a shape
    lines = report.cell_table(rows, "16x16").splitlines()
    assert len(lines) == 2 + len(ARCH_IDS)
    for r in rows:
        if r["mesh"] != "16x16":
            continue
        row = lines[2 + ARCH_IDS.index(r["arch"])].split(" | ")
        cell = row[1 + list(SHAPES).index(r["shape"])]
        want = (f"{r['step_lower_bound_s']:.4f} s {r['dominant'][0]}"
                if r["status"] == "ok" else
                {"skipped": "SKIP", "error": "ERROR"}[r["status"]])
        assert want in cell, (r["arch"], r["shape"], cell)


def _models(cfg, seed=0):
    jp = init_params(jtfm.model_specs(cfg), jax.random.PRNGKey(seed),
                     dtype=jnp.float32)
    return jp, from_jax_params(cfg, jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gemma2-27b"])
def test_serving_steps_equal_the_reference_jitted_steps(arch):
    """Prefill, then decode (uniform cache; gemma2's alternating windows
    also through the unrolled ring step), greedy tokens equal."""
    cfg = j_smoke(arch)
    jp, tp = _models(cfg)
    rng = np.random.default_rng(1)
    Bs, P, L = 2, 12, 24
    toks = rng.integers(0, cfg.vocab, (Bs, P)).astype(np.int32)
    jn, jc = jax.jit(jserve.make_prefill_step(cfg))(
        jp, {"tokens": jnp.asarray(toks)})
    with torch.inference_mode():
        tn, tc = serve.make_prefill_step(cfg)(
            tp, {"tokens": torch.as_tensor(toks)})
    assert tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for unrolled in ((False, True) if arch == "gemma2-27b" else (False,)):
        if unrolled:
            jcache = jtfm.init_cache_unrolled(cfg, Bs, L)
            tcache = tfm.init_cache_unrolled(cfg, Bs, L, device="cpu")
        else:
            jcache = jtfm.init_cache(cfg, Bs, L)
            tcache = tfm.init_cache(cfg, Bs, L, device="cpu")
        jstep = jax.jit(jserve.make_decode_step(cfg, unrolled))
        tstep = serve.make_decode_step(cfg, unrolled)
        jt, tt = jnp.asarray(toks[:, :1]), torch.as_tensor(toks[:, :1])
        for pos in range(6):
            p = np.full((Bs, 1), pos, np.int32)
            jt, jcache = jstep(jp, jcache, jt, jnp.asarray(p))
            with torch.inference_mode():
                tt, tcache = tstep(tp, tcache, tt, torch.as_tensor(p))
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
            jt, tt = jt[:, None], tt[:, None]


@pytest.fixture(scope="module")
def jax_refs():
    """The reference's compiled sim cell (2 shards) and the 2x2 decode,
    from tests/_dryrun_refs.py in a child with 8 forced host devices."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, str(ROOT / "tests" /
                                              "_dryrun_refs.py"), "tests"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_sim_cell_equals_the_reference_at_2_shards(jax_refs, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_FORCE_DEVICES", "2")
    rec = dryrun.run_sim_cell(False, device="cpu")
    ref = jax_refs["sim2"]
    assert rec["argument_bytes_per_shard"] == ref["argument_bytes"] == 10_416
    assert rec["collective_by_op"] == ref["collective_by_op"] == \
        {"all-reduce": 8.0, "collective-permute": 256.0}
    assert rec["collective_op_count"] == ref["collective_op_count"] == 3
    assert rec["shape"] == "2shards" and rec["mesh"] == "2"


def test_2x2_decode_argument_bytes_equal_the_compiled_reference(jax_refs):
    cfg = dataclasses.replace(get_smoke_config("deepseek-67b"), d_model=64,
                              n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128)
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=128,
                                global_batch=8)
    (plan,), _, _ = dryrun.plan_cells(cfg, shape, [make_test_mesh()])
    ref = jax_refs["decode"]
    assert plan.argument_bytes == ref["argument_bytes"] == 287_648
    # no bar: the reference's partitioner against the port's model
    print("collectives a device, reference", ref["collective_by_op"],
          ref["collective_bytes"], "port", plan.collectives.bytes_by_op,
          plan.collectives.total_bytes, "ratio",
          plan.collectives.total_bytes / ref["collective_bytes"])


def test_train_step_plans_on_both_test_meshes():
    """The counterpart of the reference's red
    ``test_train_step_lowers_on_test_meshes``."""
    cfg, shape = _tiny_train()
    meshes = [make_test_mesh(), make_test_mesh(multi_pod=True)]
    plans, secs, rec = dryrun.plan_cells(cfg, shape, meshes, TrainHParams())
    for plan, mesh in zip(plans, meshes):
        assert plan.temp_bytes > 0 and plan.flops > 0
        assert plan.argument_bytes > 0 and plan.output_bytes > 0
    assert plans[1].argument_bytes < plans[0].argument_bytes  # 8 vs 4 ways
    assert {(s, a) for s, a, _ in rec} == {((8, 64, 64), ("fsdp", None,
                                                          None)),
                                           ((8, 64, 256), ("fsdp", None,
                                                           "tensor"))}


class _Devices(TorchDispatchMode):
    """Every device an op's result lands on."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.seen.add(t.device.type)
        return out


def test_meta_prefill_and_train_step_launch_and_allocate_nothing(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel launched")
    monkeypatch.setattr(fa_kernel, "flash_attention", refuse)
    monkeypatch.setattr(ssd_kernel, "ssd", refuse)
    cfg = get_smoke_config("hymba-1.5b")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=64,
                                global_batch=2)
    mesh = make_test_mesh()
    asm = dryrun.assemble(cfg, mesh, shape)
    with _Devices() as d:
        loss, gnorm, model, state = asm.step(*asm.args)
        pre = dryrun.assemble(cfg, mesh, dataclasses.replace(
            shape, kind="prefill"))
        with torch.no_grad():
            nxt, cache = pre.step(*pre.args)
    assert d.seen == {"meta"}
    assert loss.device.type == nxt.device.type == "meta"
    assert all(t.device.type == "meta" for t in cache.values())
    assert tuple(nxt.shape) == (2,) and nxt.dtype == torch.int32


def test_kernel_routing_by_device():
    class On:
        def __init__(self, dev):
            self.device = torch.device(dev)
    for mod in (fa_autograd, ssd_autograd):
        assert mod.on_card(On("cuda")) and mod.on_card(On("cuda:0"))
        assert not mod.on_card(torch.zeros(1))
        assert not mod.on_card(torch.empty(1, device="meta"))
        with pytest.raises(ValueError, match="no route"):
            mod.on_card(On("xpu"))


def test_init_model_on_meta_names_abstract_params():
    with pytest.raises(ValueError, match="abstract_params"):
        tfm.init_model(get_smoke_config("stablelm-1.6b"), device="meta")


# the reference's record keys (repro/launch/dryrun.py run_cell and
# repro/launch/roofline.py analyze); the port says trace_s for
# lower_compile_s and adds the activation specs its trace recorded
REF_KEYS = {"arch", "shape", "mesh", "params_total", "params_active",
            "override", "status", "lower_compile_s", "hlo_flops_per_chip",
            "hlo_bytes_per_chip", "collective_bytes_per_chip",
            "collective_by_op", "collective_op_count", "compute_s",
            "memory_s", "collective_s", "dominant", "model_flops_total",
            "model_flops_per_chip", "useful_flops_ratio",
            "step_lower_bound_s", "ideal_step_s", "roofline_fraction",
            "memory_per_device"}


def test_cli_plans_and_skips_with_the_reference_records(tmp_path, capsys):
    out = str(tmp_path)
    assert dryrun.main(["--arch", "mamba2-130m", "--shape", "decode_32k",
                        "--both-meshes", "--out", out]) == 0
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                        "--out", out]) == 0
    recs = {p.name: json.loads(p.read_text())
            for p in tmp_path.glob("*.json")}
    assert set(recs) == {"mamba2-130m_decode_32k_sp.json",
                         "mamba2-130m_decode_32k_mp.json",
                         "hubert-xlarge_decode_32k_sp.json"}
    for name in ("mamba2-130m_decode_32k_sp.json",
                 "mamba2-130m_decode_32k_mp.json"):
        r = recs[name]
        assert set(r) == REF_KEYS - {"lower_compile_s"} | {
            "trace_s", "activation_specs"}
        assert r["status"] == "ok" and r["dominant"] in (
            "compute", "memory", "collective")
        assert set(r["memory_per_device"]) == {
            "argument_bytes", "output_bytes", "temp_bytes", "total_bytes"}
    # the layer input's activation spec, resolved on each mesh
    fsdp = {"mamba2-130m_decode_32k_sp.json": "('data', None, None)",
            "mamba2-130m_decode_32k_mp.json": "(('pod', 'data'), None, None)"}
    for name, spec in fsdp.items():
        assert [[128, 1, 768], spec] in recs[name]["activation_specs"]
    sk = recs["hubert-xlarge_decode_32k_sp.json"]
    assert sk["status"] == "skipped"
    assert sk["reason"] == j_applicable(j_get_config("hubert-xlarge"),
                                        "decode_32k")[1]
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                        "--out", out]) == 0
    assert "cached, skipping" in capsys.readouterr().out


def test_roofline_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.HBM_BYTES,
            roofline.LINK_BW) == (989e12, 3.35e12, 80e9, 450e9)
    tpu = {jroof.PEAK_FLOPS, jroof.HBM_BW, jroof.ICI_BW}
    assert not tpu & {v for v in vars(roofline).values()
                      if isinstance(v, float)}
    assert report.FIT_GIB == 80
