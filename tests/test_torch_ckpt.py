"""The port's checkpoints (``repro_torch.ckpt``): the cases of
tests/test_ckpt_fidelity.py on torch trees, ``CheckpointManager``, and
checkpoints that cross between the two packages.

* every dtype of the reference's grid, and bf16, round-trips exactly,
  shapes and dtypes included; so do randomly nested trees, 64-bit
  counters, an evolved memsys ``SimState`` (which then runs on exactly as
  the original) and non-finite floats;
* the manager saves in the background from a host copy made before the
  thread starts, keeps the last k steps and reports the latest;
* a checkpoint written by ``repro.ckpt`` restores in the port to the same
  values, and the reverse, bf16 and int64 leaves included;
* a restore lands on the template leaf's device, or on ``device=``; a
  template leaf that is not a tensor means the card, never a silent
  CPU."""
import json
import math
import os
import shutil

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.ckpt as jckpt
import repro_torch.ckpt as tckpt
from _torch_sim_parity import as_np, assert_same_state
from repro_torch.convert import to_tensor
from repro_torch.dse.search import ref_leaves, ref_unflatten
from repro_torch.sims import memsys as tm
from test_ckpt_fidelity import DTYPES, SHAPES, _rand


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _assert_exact(got, want):
    """Tensors equal in dtype, shape and bits (NaN positions included)."""
    assert isinstance(got, torch.Tensor)
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got, want
    if g.dtype == torch.bfloat16:
        g, w = g.view(torch.int16), w.view(torch.int16)
    assert np.array_equal(np.ascontiguousarray(g.numpy()).view(np.uint8),
                          np.ascontiguousarray(w.numpy()).view(np.uint8))


@pytest.mark.parametrize("dt", DTYPES + ["bfloat16"],
                         ids=lambda d: str(d) if isinstance(d, str)
                         else np.dtype(d).name)
def test_roundtrip_exact_per_dtype(tmp_path, dt):
    name = dt if isinstance(dt, str) else np.dtype(dt).name
    rng = np.random.default_rng(abs(hash(name)) % 2**32)
    if dt == "bfloat16":
        tree = {f"s{i}": _t(_rand(rng, np.float32, s)).to(torch.bfloat16)
                for i, s in enumerate(SHAPES)}
    else:
        tree = {f"s{i}": _t(_rand(rng, dt, s)) for i, s in enumerate(SHAPES)}
    tckpt.save_checkpoint(str(tmp_path), tree, 0)
    back, manifest = tckpt.restore_checkpoint(str(tmp_path), tree)
    for k, want in tree.items():
        _assert_exact(back[k], want)
        assert manifest["leaves"][k]["dtype"] == name


@pytest.mark.parametrize("seed", range(5))
def test_roundtrip_exact_random_nested_trees(tmp_path, seed):
    rng = np.random.default_rng(seed)

    def gen(depth):
        if depth == 0 or rng.random() < 0.4:
            dt = DTYPES[int(rng.integers(len(DTYPES)))]
            shape = SHAPES[int(rng.integers(len(SHAPES)))]
            return _t(_rand(rng, dt, shape))
        kind = rng.random()
        n = int(rng.integers(1, 4))
        if kind < 0.5:
            return {f"k{i}": gen(depth - 1) for i in range(n)}
        if kind < 0.75:
            return [gen(depth - 1) for _ in range(n)]
        return tuple(gen(depth - 1) for _ in range(n))

    tree = {"root": gen(3)}
    tckpt.save_checkpoint(str(tmp_path), tree, 0)
    back, _ = tckpt.restore_checkpoint(str(tmp_path), tree)
    la, lb = ref_leaves(tree), ref_leaves(back)
    assert len(la) == len(lb)
    for want, got in zip(la, lb):
        _assert_exact(got, want)
    assert ref_unflatten(tree, lb).keys() == tree.keys()


def test_int64_counters_and_float64_survive(tmp_path):
    tree = {"clock": _t(np.asarray([2**40 + 7, -(2**35)], np.int64)),
            "t": _t(np.asarray([1.0 + 2**-40], np.float64)),
            "u": _t(np.asarray([2**63 - 1], np.uint64))}
    tckpt.save_checkpoint(str(tmp_path), tree, 0)
    back, _ = tckpt.restore_checkpoint(str(tmp_path), tree)
    for k, want in tree.items():
        _assert_exact(back[k], want)


def test_simstate_leaves_roundtrip_bit_exact(tmp_path):
    """An evolved memsys SimState through the rung checkpoints' tree shape
    ({key: [leaves...]}); the restored state runs on exactly as the
    original does."""
    sim, st = tm.build(n_cores=3, pattern="mixed", n_reqs=6, donate=False,
                       device="cpu")
    out = sim.run(sim.copy_state(st), 400.0)
    leaves = ref_leaves(out)
    assert {as_np(x).dtype.kind for x in leaves} >= {"f", "i"}
    tree = {"handles": {"0|{}": list(leaves)}}
    tckpt.save_checkpoint(str(tmp_path), tree, 3)
    back, manifest = tckpt.restore_checkpoint(str(tmp_path), tree)
    assert manifest["step"] == 3
    got = back["handles"]["0|{}"]
    assert len(got) == len(leaves)
    for want, g in zip(leaves, got):
        _assert_exact(g, want)
    rebuilt = ref_unflatten(out, got)
    assert_same_state(sim.run(rebuilt, 800.0),
                      sim.run(sim.copy_state(out), 800.0))


def test_nonfinite_and_extreme_floats_roundtrip(tmp_path):
    """Engine states carry +inf wake times; NaN (with its payload, as a
    CUDA cast leaves it), denormals and -0.0 survive too."""
    x = _t(np.asarray([np.inf, -np.inf, np.nan, 0.0, -0.0,
                       np.finfo(np.float32).tiny, math.pi], np.float32))
    nan_bits = torch.tensor([0x7FFF, -63, 0x7F81, -32768], dtype=torch.int16)
    tree = {"x": x, "b": x.to(torch.bfloat16),
            "payload": nan_bits.view(torch.bfloat16)}
    tckpt.save_checkpoint(str(tmp_path), tree, 0)
    back, _ = tckpt.restore_checkpoint(str(tmp_path), tree)
    for k in tree:
        _assert_exact(back[k], tree[k])
    assert torch.signbit(back["x"][4]) and torch.signbit(back["b"][4])


# ---------------------------------------------------------------------------
def test_manager_async_keep_latest_and_host_copy(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    assert mgr.latest_step() is None
    x = torch.arange(6, dtype=torch.int64) * (2**40)
    tree = {"x": x, "nested": [x.to(torch.bfloat16), {"n": torch.tensor(
        [float("nan"), float("inf")])}]}
    want = []
    for step in range(3):
        mgr.save(tree, step, extra={"step": step})
        want.append(x.clone())
        x.add_(1)                  # the save holds its own host copy
    mgr.wait()
    assert tckpt.list_steps(str(tmp_path)) == [1, 2]
    assert mgr.latest_step() == 2
    for step in (1, 2):
        back, manifest = mgr.restore(tree, step)
        _assert_exact(back["x"], want[step])
        _assert_exact(back["nested"][1]["n"], tree["nested"][1]["n"])
        assert manifest["extra"] == {"step": step}
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    sync = tckpt.CheckpointManager(str(tmp_path / "sync"), keep=1,
                                   async_save=False)
    sync.save(tree, 5)
    sync.save(tree, 6)
    assert tckpt.list_steps(str(tmp_path / "sync")) == [6]


def test_manager_surfaces_a_failed_background_save(tmp_path):
    root = tmp_path / "ckpt"
    mgr = tckpt.CheckpointManager(str(root))
    mgr.save({"x": torch.zeros(2)}, 0)
    mgr.wait()
    shutil.rmtree(root)
    root.write_text("not a directory")      # the next save cannot write
    mgr.save({"x": torch.zeros(2)}, 1)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                               # raised once, then clear


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------
def _mixed_tree():
    rng = np.random.default_rng(7)
    f = rng.standard_normal((3, 4)).astype(np.float32)
    return {"w": f, "bf": f.astype(ml_dtypes.bfloat16),
            "clock": np.asarray([2**40 + 3, -(2**33)], np.int64),
            "mask": np.asarray([True, False, True]),
            "nested": [np.asarray(2, np.int32),
                       {"z": np.asarray([np.nan, -np.inf, -0.0],
                                        np.float32)}]}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    return to_tensor(tree)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    src = _mixed_tree()
    jckpt.save_checkpoint(str(tmp_path), src, 4, extra={"by": "jax"})
    template = _as_torch(src)
    back, manifest = tckpt.restore_checkpoint(str(tmp_path), template)
    assert manifest["extra"] == {"by": "jax"}
    for got, want in zip(ref_leaves(back), ref_leaves(template)):
        _assert_exact(got, want)


def test_port_checkpoint_restores_in_jax(tmp_path):
    src = _mixed_tree()
    tckpt.save_checkpoint(str(tmp_path), _as_torch(src), 4)
    with open(tmp_path / "step_00000004" / "manifest.json") as fh:
        leaves = json.load(fh)["leaves"]
    assert leaves["bf"]["dtype"] == "bfloat16"
    assert leaves["clock"]["dtype"] == "int64"
    assert leaves["mask"]["dtype"] == "bool"
    back, _ = jckpt.restore_checkpoint(str(tmp_path), src)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(src)):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(np.ascontiguousarray(got).view(np.uint8),
                              np.ascontiguousarray(want).view(np.uint8))


def test_restore_device_follows_the_template_or_device(tmp_path,
                                                       monkeypatch):
    tree = {"x": torch.arange(3), "y": np.arange(2.0)}
    tckpt.save_checkpoint(str(tmp_path), tree, 0)
    back, _ = tckpt.restore_checkpoint(str(tmp_path), tree, device="cpu")
    assert back["x"].device.type == back["y"].device.type == "cpu"
    assert back["y"].dtype == torch.float64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tckpt.restore_checkpoint(str(tmp_path), tree)
    back, _ = tckpt.restore_checkpoint(str(tmp_path), {"x": tree["x"]})
    assert back["x"].device.type == "cpu"        # the template's device
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"), tree)
