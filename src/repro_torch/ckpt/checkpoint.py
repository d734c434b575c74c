"""Fault-tolerant checkpointing.  Counterpart of ``repro.ckpt.checkpoint``,
with its on-disk format byte for byte, so a checkpoint written by either
package restores in the other.

* flat path-keyed .npz shards + JSON manifest, written atomically
  (tmp-dir + rename) so a killed save never corrupts the latest checkpoint;
  dict keys are sorted into the ``/``-joined paths;
* the manifest spells each leaf's logical dtype as numpy / ml_dtypes do
  (``"bfloat16"``, ``"float32"``, ``"int64"``); bf16 is stored as f32,
  exactly;
* async save (background thread) so a training loop never blocks on I/O:
  device tensors are copied to the host on the caller's stream *before*
  the thread starts, and the thread never reads a CUDA tensor;
* keep-last-k garbage collection;
* restore into a template: each leaf is cast to the template leaf's dtype
  while still on the host (torch has 64-bit types throughout, so the
  reference's x64 workaround becomes this plain cast), then lands on the
  template leaf's device, or on ``device=`` when given.  One card has no
  mesh, so the reference's ``shardings=`` becomes ``device=``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch import resolve_device

_SEP = "/"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{_SEP}{k}" if prefix
                                else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{_SEP}{i}"))
    else:
        out[prefix] = tree
    return out


def _unflatten_into(flat, template):
    def rec(t, prefix):
        if isinstance(t, dict):
            return {k: rec(t[k], f"{prefix}{_SEP}{k}" if prefix else str(k))
                    for k in t}
        if isinstance(t, (list, tuple)):
            vals = [rec(v, f"{prefix}{_SEP}{i}") for i, v in enumerate(t)]
            return type(t)(vals)
        return flat[prefix]
    return rec(template, "")


def _dtype_name(dt) -> str:
    """numpy's / ml_dtypes' spelling of a torch or numpy dtype."""
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return str(np.dtype(dt))


def _to_numpy(v):
    """npz-safe array: bf16 (or other dtypes numpy lacks) stored as f32
    exactly; the manifest records the logical dtype."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        try:
            a = v.numpy()
        except TypeError:            # bfloat16 & friends
            return v.float().numpy(), _dtype_name(v.dtype)
        return a, _dtype_name(a.dtype)
    a = np.asarray(v)
    if a.dtype.kind not in "biufc":       # ml_dtypes' bfloat16 & friends
        return a.astype(np.float32), str(a.dtype)
    return a, str(a.dtype)


def _to_host(tree):
    """``tree`` with every tensor copied to the host (on the caller's
    stream, so the copy sees every queued write)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.asarray(tree)


def save_checkpoint(path: str, tree, step: int, extra: dict | None = None):
    """Atomic checkpoint write: <path>/step_<n>/{manifest.json, arrays.npz}"""
    pairs = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    flat = {k: p[0] for k, p in pairs.items()}
    logical = {k: p[1] for k, p in pairs.items()}
    final = os.path.join(path, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=path, prefix=".tmp_save_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: v for k, v in flat.items()})
        manifest = {
            "step": step, "time": time.time(),
            "leaves": {k: {"shape": list(v.shape), "dtype": logical[k]}
                       for k, v in flat.items()},
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as fh:
            json.dump(manifest, fh)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _f32_to_bf16_bits(v: torch.Tensor) -> torch.Tensor:
    """bf16 stored as f32, back to bf16 by its upper 16 bits.  The f32 is
    an exact widening (its lower 16 bits are zero), so this is exact for
    every value, NaN payloads included, where a rounding cast would make
    each NaN the canonical one."""
    return (v.view(torch.int32) >> 16).to(torch.int16).view(torch.bfloat16)


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"checkpoint dtype {name!r} has no torch dtype")
    return dt


def restore_checkpoint(path: str, template, step: int | None = None,
                       device=None):
    """Restore into ``template``'s structure.  Each leaf becomes a tensor of
    the template leaf's dtype, on ``device`` when given, else on the
    template leaf's device (a template leaf that is not a tensor: the card,
    as every entry point's ``device=None``)."""
    steps = list_steps(path)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {path}")
    step = steps[-1] if step is None else step
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as fh:
        manifest = json.load(fh)
    tmpl_flat = _flatten(template)
    want_dev = None if device is None else resolve_device(device)
    flat = {}
    with np.load(os.path.join(d, "arrays.npz")) as z:
        for k in z.files:
            if k not in tmpl_flat:        # no place in the template
                continue
            v = torch.from_numpy(np.array(z[k], copy=True))
            logical = manifest["leaves"][k]["dtype"]
            if logical == "bfloat16" and v.dtype == torch.float32:
                v = _f32_to_bf16_bits(v)
            elif _dtype_name(v.dtype) != logical:   # stored widened
                v = v.to(_torch_dtype(logical))
            # align to the template dtype while still on the host
            t = tmpl_flat[k]
            want = (t.dtype if isinstance(t, torch.Tensor) else
                    _torch_dtype(_dtype_name(np.asarray(t).dtype)))
            if v.dtype != want:
                v = v.to(want)
            dev = want_dev or (t.device if isinstance(t, torch.Tensor)
                               else resolve_device(None))
            flat[k] = v.to(dev)
    return _unflatten_into(flat, template), manifest


def list_steps(path: str):
    if not os.path.isdir(path):
        return []
    out = []
    for d in os.listdir(path):
        if d.startswith("step_"):
            out.append(int(d.split("_")[1]))
    return sorted(out)


class CheckpointManager:
    """Async save + keep-k GC + latest-step tracking."""

    def __init__(self, path: str, keep: int = 3, async_save: bool = True):
        self.path = path
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(path, exist_ok=True)

    def save(self, tree, step: int, extra: dict | None = None):
        self.wait()
        # on the host BEFORE backgrounding: the thread never reads a
        # device tensor, and later writes to the tree cannot reach it
        flat_host = _to_host(tree)

        def work():
            try:
                save_checkpoint(self.path, flat_host, step, extra)
                self._gc()
            except BaseException as e:   # surfaced on next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self.check()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.check()

    def check(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def restore(self, template, step=None, device=None):
        self.wait()
        return restore_checkpoint(self.path, template, step, device)

    def latest_step(self):
        s = list_steps(self.path)
        return s[-1] if s else None

    def _gc(self):
        steps = list_steps(self.path)
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)
