"""The port's optimizer and gradient compression against the JAX package.

``repro_torch.optim`` is held leaf by leaf against ``repro.optim`` on the
same seeded numpy trees: 20 AdamW steps with f32 and with int8 moments
(parameters and moments within 1e-6 of each leaf's largest magnitude:
both sides compute the same f32 operations, but ``b ** count`` is a pow
whose last bit may differ between XLA and PyTorch, and int8 blocks then
round alike except at a half-way tie), ``_q8``/``_dq8`` and
``quant_int8`` bit for bit (ties round half to even in both),
``clip_by_global_norm`` (within 1e-6; squares summed in the same leaf
order), and ``int8_allreduce_grads`` at world 1 (no process group) equal
to the reference's one-device ``shard_map``.  Then the substrate tests of
``tests/test_substrate.py`` (AdamW on a quadratic, int8 moments close to
f32, the int8 error bound, error feedback converging) run on the port,
and two gloo processes show the int8 all-reduce's integer wire sum.
"""
import os
import socket
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch.core.engine import ref_map
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               dequant_int8, int8_allreduce_grads,
                               quant_int8)
from repro_torch.optim import adamw as tadamw

from _torch_sim_parity import one_torch_thread  # noqa: F401

SHAPES = {"a": (3, 5), "b": {"c": (300,), "d": (2, 256)}, "e": (1,)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return (rng.standard_normal(t) * scale).astype(np.float32)
    return walk(SHAPES)


def _jax(t):
    return jax.tree.map(jnp.asarray, t)


def _torch(t):
    return ref_map(torch.from_numpy, t)


def _np(t):
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    return np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


def _assert_close_tree(got, ref, rel):
    got, ref = _np(got), jax.tree.map(np.asarray, ref)
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree.leaves(got)):
        if r.dtype == np.int8:       # quantized moments: within one step
            assert np.abs(g.astype(np.int32) - r).max() <= 1, path
            continue
        scale = max(float(np.abs(r).max()), 1e-30)
        assert np.abs(g - r).max() <= rel * scale, path


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_adamw_20_steps_against_jax(moments):
    p0 = _tree(0)
    jp, jo = _jax(p0), jadamw.adamw_init(_jax(p0), moments_dtype=moments)
    tp = _torch(p0)
    to = adamw_init(tp, moments_dtype=moments)
    for step in range(20):
        g = _tree(100 + step, scale=0.1 + step)
        kw = dict(lr=3e-2, weight_decay=0.1, moments_dtype=moments)
        jp, jo = jadamw.adamw_update(_jax(g), jo, jp, **kw)
        tp, to = adamw_update(_torch(g), to, tp, **kw)
    _assert_close_tree(tp, jp, 1e-6)
    _assert_close_tree(to["m"], jo["m"], 1e-6)
    _assert_close_tree(to["v"], jo["v"], 1e-6)
    assert int(to["count"]) == int(jo["count"]) == 20
    assert to["count"].dtype == torch.int32


def test_q8_dq8_bit_for_bit_ties_included():
    rng = np.random.default_rng(7)
    x = rng.standard_normal(1000).astype(np.float32) * 3
    # one block whose scale is exactly 1: its halves are ties
    x[256:512] = np.concatenate([[127.0], np.arange(255) * 0.5 - 63.5]) \
        .astype(np.float32)
    for shape in ((1000,), (10, 100), (8, 125)):
        jq, js = jadamw._q8(jnp.asarray(x.reshape(shape)))
        tq, ts = tadamw._q8(torch.from_numpy(x.reshape(shape)))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tadamw._dq8(tq, ts, shape).numpy(),
            np.asarray(jadamw._dq8(jq, js, shape)))
    half = tq.numpy().reshape(-1)[256:512]
    # -63.5, -63, -62.5, -62, -61.5 round half to even
    assert list(half[1:6]) == [-64, -63, -62, -62, -62]


def test_quant_int8_bit_for_bit():
    g = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    jq, js = jcompress.quant_int8(jnp.asarray(g))
    tq, ts = quant_int8(torch.from_numpy(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(dequant_int8(tq, ts).numpy(),
                                  np.asarray(jcompress.dequant_int8(jq, js)))


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_against_jax(max_norm):
    g = _tree(3)
    jg, jn = jadamw.clip_by_global_norm(_jax(g), max_norm)
    tg, tn = clip_by_global_norm(_torch(g), max_norm)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    _assert_close_tree(tg, jg, 1e-6)


def test_int8_allreduce_world_1_equals_the_one_device_mesh():
    from jax.sharding import PartitionSpec as P
    from repro.core.pdes import shard_map_compat
    mesh = jax.make_mesh((1,), ("data",))
    g, e = _tree(4), _tree(5, scale=0.01)

    @partial(shard_map_compat, mesh=mesh, in_specs=(P(), P()),
             out_specs=(P(), P()))
    def reduced(g, e):
        return jcompress.int8_allreduce_grads(g, e, mesh, axes=("data",))

    jr, je = reduced(_jax(g), _jax(e))   # eager: XLA fuses under jit
    tr, te = int8_allreduce_grads(_torch(g), _torch(e))
    _assert_close_tree(tr, jr, 0.0)
    _assert_close_tree(te, je, 0.0)


# --- tests/test_substrate.py's optimizer tests, on the port ---------------
def test_adamw_converges_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"x": torch.zeros(3)}
    opt = adamw_init(params)
    for _ in range(300):
        g = {"x": 2 * (params["x"] - target)}
        params, opt = adamw_update(g, opt, params, lr=3e-2, weight_decay=0.0)
    np.testing.assert_allclose(params["x"].numpy(), target.numpy(),
                               atol=0.05)


def test_adamw_int8_moments_close_to_fp32():
    target = torch.tensor([0.5, -1.5, 2.5, -3.5])
    outs = {}
    for md in ("float32", "int8"):
        params = {"x": torch.zeros(4)}
        opt = adamw_init(params, moments_dtype=md)
        for _ in range(200):
            g = {"x": 2 * (params["x"] - target)}
            params, opt = adamw_update(g, opt, params, lr=3e-2,
                                       weight_decay=0.0, moments_dtype=md)
        outs[md] = params["x"].numpy()
    np.testing.assert_allclose(outs["int8"], outs["float32"], atol=0.2)


def test_int8_quant_error_bounded():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    q, s = quant_int8(g)
    err = (dequant_int8(q, s) - g).abs().numpy()
    assert err.max() <= float(s) * 0.5 + 1e-6


def test_int8_allreduce_error_feedback_converges():
    target = torch.tensor([1.0, -1.0])
    params = torch.zeros(2)
    err = {"x": torch.zeros(2)}
    for _ in range(150):
        g = {"x": 2 * (params - target)}
        red, err = int8_allreduce_grads(g, err)
        params = params - 3e-2 * red["x"]
    np.testing.assert_allclose(params.numpy(), target.numpy(), atol=0.05)


# --- two processes over gloo ----------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, port, out_dir):
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
        rank=rank)
    try:
        g = {"x": torch.from_numpy(_tree(10 + rank)["b"]["c"])}
        red, err = int8_allreduce_grads(g, {"x": torch.zeros(300)})
        torch.save({"red": red["x"], "err": err["x"]},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def test_int8_allreduce_two_gloo_ranks(tmp_path):
    mp.start_processes(_rank_main, args=(_free_port(), str(tmp_path)),
                       nprocs=2, start_method="spawn")
    outs = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    qs = [quant_int8(torch.from_numpy(_tree(10 + r)["b"]["c"]))
          for r in range(2)]
    s_max = max(s for _, s in qs)
    total = sum(torch.round(q.float() * (s / s_max)).to(torch.int32)
                for q, s in qs)
    want = total.float() * s_max / 2
    for r, o in enumerate(outs):
        torch.testing.assert_close(o["red"], want, rtol=0, atol=0)
        g = torch.from_numpy(_tree(10 + r)["b"]["c"])
        torch.testing.assert_close(o["err"], g - dequant_int8(*qs[r]),
                                   rtol=0, atol=0)
