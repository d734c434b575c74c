"""Rung checkpoints: persist a warm search — trajectory *and* rung-end
states — through :mod:`repro_torch.ckpt`.  Counterpart of
``repro.dse.search.warm``, with its checkpoint layout, so a search saved
by either package resumes in the other.

:class:`~repro_torch.dse.search.driver.SearchState` alone is JSON and
resumes the *decisions* of a search exactly, but a warm
:class:`~repro_torch.dse.search.halving.SuccessiveHalving` also carries
live :class:`~repro_torch.dse.runner.ResumeHandle`\\ s — the frozen
``SimState`` of every promoted config.  Dropping them on resume is correct
but wasteful: the first post-resume round replays its rungs from cycle 0.
This module writes both through the checkpoint layer (atomic npz +
manifest, exact dtype round-trip):

* :func:`save_search` — one checkpoint step per search round: each
  handle's state leaves in the npz shard (``handles/<key>/<i>``), handle
  metadata (frozen time / horizon / epochs) and the ``SearchState`` JSON
  in the manifest.
* :func:`load_search` — the reverse: ``(SearchState, handles)``;
  rebuild the driver with ``state=`` and hand it the handles via
  :meth:`~repro_torch.dse.search.halving.SuccessiveHalving.adopt_handles`.

A state's leaves are numbered in the reference's pytree order
(:func:`ref_leaves`: dataclass fields in declaration order, dict keys
sorted, ``None`` no leaf), not in the engine's ``tree_leaves`` order
(dicts in insertion order), so leaf ``i`` is the same leaf in both
packages whatever order a build inserted its kinds in.

A search resumed this way is **bit-identical** to the uninterrupted one
— same rows, same promotions, same cumulative budget — because the
handles make the post-resume rounds charge the same increments
(tests/test_torch_warm_resume.py).
"""
from __future__ import annotations

import json
import os
import time

from repro_torch.ckpt import list_steps, restore_checkpoint, save_checkpoint
from repro_torch.core.engine import ref_leaves, ref_unflatten  # noqa: F401
from repro_torch.obs.bus import BUS

from ..runner import ResumeHandle
from .driver import SearchState


def save_search(path: str, driver, step: int | None = None) -> str:
    """Checkpoint ``driver`` under ``path``: rung-end handle states plus
    the serialized :class:`SearchState`.  ``step`` defaults to the
    driver's round counter (one checkpoint per completed round — a
    valid snapshot point).  Returns the written step directory."""
    store: dict = getattr(driver, "_handle_store", {}) or {}
    tree = {k: ref_leaves(h.state) for k, h in store.items()}
    meta = {k: {"time": float(h.time), "until": float(h.until),
                "epochs": int(h.epochs)} for k, h in store.items()}
    step = int(driver.state.round) if step is None else int(step)
    os.makedirs(path, exist_ok=True)
    t0 = time.perf_counter()
    out = save_checkpoint(path, {"handles": tree}, step,
                          extra={"search_state": driver.state.to_json(),
                                 "handles": meta})
    if BUS.active:
        BUS.emit("ckpt.save", path=str(out), step=step,
                 handles=len(store), dur=time.perf_counter() - t0)
    return out


def load_search(path: str, template_state, step: int | None = None
                ) -> tuple[SearchState, dict[str, ResumeHandle]]:
    """Restore ``(SearchState, handles)`` from :func:`save_search`.

    ``template_state`` is any :class:`~repro_torch.core.SimState` of the
    searched simulation (e.g. the build function's fresh state) — it
    supplies the tree structure, the exact leaf dtypes and the device the
    stored handle states are restored into.  Handle keys are unknown
    before the manifest is read, so the restore template is assembled
    from it.
    """
    steps = list_steps(path)
    if not steps:
        raise FileNotFoundError(f"no search checkpoints under {path}")
    step = steps[-1] if step is None else step
    t0 = time.perf_counter()
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as fh:
        manifest = json.load(fh)
    meta = manifest["extra"]["handles"]
    leaves_t = ref_leaves(template_state)
    template = {"handles": {k: list(leaves_t) for k in meta}}
    tree, manifest = restore_checkpoint(path, template, step)
    handles = {}
    for k, m in meta.items():
        st = ref_unflatten(template_state, tree["handles"][k])
        handles[k] = ResumeHandle(state=st, time=float(m["time"]),
                                  until=float(m["until"]),
                                  epochs=int(m["epochs"]))
    state = SearchState.from_json(manifest["extra"]["search_state"])
    if BUS.active:
        BUS.emit("ckpt.load", path=str(d), step=int(step),
                 handles=len(handles), round=state.round,
                 dur=time.perf_counter() - t0)
    return state, handles
