"""Continuous-batching serving engine.  Counterpart of
``repro.serve.engine``.

Fixed decode slots share one stacked cache (K/V, or MLA's latent
``ckv``/``kr``, along the sequence; conv and SSM states); requests are
admitted into free slots (prefill writes the slot's cache region in
place), and one batched decode step advances every active slot.  The loop follows
Smart-Ticking semantics: when no slot is active it returns without any
device work, and request arrival wakes it; idle slots ride along.

Every request is a traced task, from ``submit`` to its last token.  It
and its ``queue`` task (``submit`` until admission) are asynchronous:
they take their parents explicitly and stay off the thread's task stack.
Each ``step()`` is a ``step`` task over its ``prefill`` tasks (a
request's, as its parent says) and its ``decode`` task; the domain
mirrors them as ``torch.profiler`` ranges while a profiler records.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from repro_torch.core.tracers import profiler_ranges
from repro_torch.core.tracing import TracingDomain, current_task
from repro_torch.models import transformer as tfm


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    slot: int = -1
    task: object = None
    queued: object = None      # its ``queue`` task until admitted
    done: bool = False


class ServeEngine:
    """Serves a :class:`~repro_torch.models.transformer.Model` on the
    device its parameters live on."""

    def __init__(self, cfg, params, max_batch: int = 4, max_len: int = 256,
                 eos_id: int | None = None,
                 domain: TracingDomain | None = None):
        if tfm.needs_unrolled_decode(cfg, max_len):
            raise ValueError("slot engine uses the uniform decode path: "
                             f"max_len {max_len} mixes ring and full caches")
        self.cfg, self.params = cfg, params
        self.device = params.device
        self.B, self.S = max_batch, max_len
        self.eos = eos_id
        self.dom = domain or TracingDomain("serve")
        profiler_ranges(self.dom)
        self.cache = tfm.init_cache(cfg, max_batch, max_len,
                                    device=self.device)
        self.pos = np.zeros(max_batch, np.int32)      # next write position
        self.active: list[Request | None] = [None] * max_batch
        self.queue: list[Request] = []
        self.last_tok = np.zeros(max_batch, np.int32)
        self._rid = itertools.count()

    # ------------------------------------------------------------------
    def submit(self, prompt_tokens, max_new: int = 32) -> int:
        r = Request(next(self._rid), np.asarray(prompt_tokens, np.int32),
                    max_new)
        if not 0 < len(r.prompt) < self.S:
            raise ValueError(f"prompt length {len(r.prompt)} not in "
                             f"[1, {self.S - 1}]")
        r.task = self.dom.start_task("request", "serve", "engine",
                                     parent=current_task(), rid=r.rid,
                                     prompt_len=len(r.prompt))
        r.queued = self.dom.start_task("queue", "wait", "engine",
                                       parent=r.task)
        self.queue.append(r)
        return r.rid

    @torch.inference_mode()
    def _admit(self):
        for slot in range(self.B):
            if self.active[slot] is not None or not self.queue:
                continue
            r = self.queue.pop(0)
            r.slot = slot
            self.dom.end_task(r.queued)
            with self.dom.task("prefill", f"len{len(r.prompt)}",
                               f"slot{slot}", parent=r.task):
                toks = torch.as_tensor(r.prompt, device=self.device)[None, :]
                logits, pcache, _ = tfm.forward(self.params, self.cfg,
                                                {"tokens": toks},
                                                mode="prefill")
                S0 = len(r.prompt)
                for k, v in pcache.items():
                    dst = self.cache[k]
                    if k in tfm.IN_PLACE:     # along the sequence
                        dst[:, slot, :S0] = v[:, 0].to(dst.dtype)
                    else:
                        dst[:, slot] = v[:, 0].to(dst.dtype)
                nxt = int(torch.argmax(logits[0, -1]))
            self.active[slot] = r
            self.pos[slot] = S0
            self.last_tok[slot] = nxt
            r.out.append(nxt)

    # ------------------------------------------------------------------
    def _decode(self, tokens, positions):
        logits, self.cache, _ = tfm.forward(
            self.params, self.cfg, {"tokens": tokens}, mode="decode",
            cache=self.cache, positions=positions, cache_len=positions + 1)
        return torch.argmax(logits[:, -1], dim=-1)

    @torch.inference_mode()
    def step(self) -> list[Request]:
        """Admit + one batched decode step.  Smart-Ticking: returns without
        touching the device when every slot is idle."""
        with self.dom.task("step", "step", "engine"):
            return self._step()

    def _step(self) -> list[Request]:
        self._admit()
        if all(r is None for r in self.active):
            return []
        with self.dom.task("decode", "step", "engine",
                           active=sum(r is not None for r in self.active)):
            toks = torch.as_tensor(self.last_tok, device=self.device)[:, None]
            pos = torch.as_tensor(self.pos, device=self.device)[:, None]
            nxt = self._decode(toks, pos).cpu().numpy()
        finished = []
        for slot, r in enumerate(self.active):
            if r is None:
                continue
            self.pos[slot] += 1
            tok = int(nxt[slot])
            r.out.append(tok)
            self.last_tok[slot] = tok
            hit_eos = self.eos is not None and tok == self.eos
            if len(r.out) >= r.max_new or hit_eos or \
                    self.pos[slot] >= self.S - 1:
                r.done = True
                self.dom.tag_task("eos" if hit_eos else "length",
                                  t=r.task)
                self.dom.end_task(r.task)
                finished.append(r)
                self.active[slot] = None
        return finished

    def run_until_idle(self, max_steps: int = 10_000):
        done = []
        for _ in range(max_steps):
            if not self.queue and all(r is None for r in self.active):
                break
            done += self.step()
        return done
