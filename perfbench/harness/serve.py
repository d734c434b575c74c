"""The serving driver: ``repro_torch.serve.engine.ServeEngine`` on the
seeded bf16 model, driven through ``submit`` and ``step`` by a closed loop
of clients: each sends its next request as soon as the last one finishes.

Set-up makes the weights and the engine, submits one request a client
and steps until every one of them has finished: one full turnover of the
slots, which leaves the loop in its steady state.  The window then runs
whole ``step()`` calls until ``seconds`` have passed; its rate counts
every token those steps processed: each prompt they prefilled and each
token they produced.  A request's first
token counts from its ``submit`` to the end of the ``step()`` whose
return first shows it; requests submitted in the window are waited for
(the clients go on sending) until each has its first token.  Once the
window has closed, a sample of the requests it finished, drawn from the
seed with the longest among them, is compared with the plain reference's
full forward pass.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import time

import numpy as np
import torch

from . import check, counting, spec, traffic, weights


@dataclasses.dataclass
class Rec:
    req: object            # the engine's Request
    t_submit: float
    t_first: float | None = None
    t_done: float | None = None
    seen: int = 0          # output tokens already accounted


class _Spans:
    """A tracer on the engine's TracingDomain: (category, start, end) of
    every finished task."""

    def __init__(self):
        self.done = []

    def on_start(self, t):
        pass

    def on_tag(self, t, tag):
        pass

    def on_end(self, t):
        self.done.append((t.category, t.start, t.end))


class Loop:
    def __init__(self, eng, reqs, cfg):
        self.eng, self.reqs, self.cfg = eng, reqs, cfg
        self.live: list[Rec] = []
        self.recs: list[Rec] = []

    def submit(self):
        ids, new = self.reqs.next()
        t = time.perf_counter()
        self.eng.submit(ids, max_new=new)
        r = Rec(self.eng.queue[-1], t)
        self.live.append(r)
        self.recs.append(r)

    def step(self):
        """One engine step -> (its end, its FLOPs: the work the algorithm
        needs for the tokens it produced, the prompt lengths it
        prefilled, its tokens: those prompts' and every output token,
        the context each token it decoded attended over)."""
        done = self.eng.step()
        now = time.perf_counter()
        flops, prefills, tokens, decodes = 0, [], 0, []
        for r in self.live:
            n = len(r.req.out)
            S0 = len(r.req.prompt)
            if n and r.t_first is None:
                r.t_first = now
            tokens += n - r.seen
            k = r.seen
            if k == 0 and n:
                flops += counting.prefill_flops(self.cfg, S0)
                prefills.append(S0)
                tokens += S0
                k = 1
            for j in range(k, n):        # output j came from a decode
                flops += counting.decode_flops(self.cfg, S0 + j)
                decodes.append(S0 + j)
            r.seen = n
        finished = {id(q) for q in done}
        for r in [r for r in self.live if id(r.req) in finished]:
            r.t_done = now
            self.live.remove(r)
            self.submit()                # the client's next request
        return now, flops, prefills, tokens, decodes


def run(cell, seed, seconds, trace, device, log):
    from repro_torch.core.tracing import TracingDomain
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine

    cfg, mix = cell.config, cell.mix
    mcfg = spec.model_config(cfg)
    W = weights.make(cfg, seed, device)
    check.same_layout(W, tfm.model_specs(mcfg))
    model = tfm.Model(mcfg, W)
    del W
    dom = TracingDomain("serve")
    spans = dom.attach(_Spans())
    eng = ServeEngine(mcfg, model, max_batch=mix["max_batch"],
                      max_len=mix["max_len"], domain=dom)
    loop = Loop(eng, traffic.Requests(mix, seed, cfg["vocab"]), cfg)
    for _ in range(mix["clients"]):
        loop.submit()
    first = list(loop.recs)
    while any(r.t_done is None for r in first):      # one turnover
        loop.step()
    log(f"set-up turnover: {len(loop.recs)} requests submitted")

    # -- the window -------------------------------------------------------
    t0 = time.perf_counter()
    n_spans, n_recs = len(spans.done), len(loop.recs)
    flops = tokens = 0
    while True:      # whole steps, and in a short window one request
        t1, f, _, n, _ = loop.step()
        flops += f
        tokens += n
        if t1 - t0 >= seconds and \
                any(r.t_submit < t1 for r in loop.recs[n_recs:]) and \
                any(r.t_done is not None and r.t_done > t0
                    for r in loop.recs):
            break
    in_window = [r for r in loop.recs if t0 <= r.t_submit < t1]
    window_spans = [s for s in spans.done[n_spans:] if s[1] >= t0]
    while any(r.t_first is None for r in in_window):
        loop.step()
    finished = [r for r in loop.recs
                if r.t_done is not None and t0 < r.t_done <= t1]
    win = t1 - t0
    ttft = [(r.t_first - r.t_submit) * 1e3 for r in in_window]
    out = dict(
        t_window=t0, attempted=len(in_window), failed=0,
        window=dict(seconds=win, flops=flops, requests=len(finished),
                    tokens=tokens, spans=window_spans),
        e2e={"serve_tokens_per_s": tokens / win,
             "ttft_p95_ms": float(np.percentile(ttft, 95))})
    log(f"window: {len(finished)} requests finished, {tokens} tokens in "
        f"{win:.3f} s; {len(in_window)} submitted, first token median "
        f"{np.median(ttft):.1f} ms")

    if trace:
        from . import trace as tr_mod
        out["trace"], traced = tr_mod.capture(
            lambda: [loop.step() for _ in range(mix["trace_steps"])], device)
        out["trace_info"] = dict(
            steps=mix["trace_steps"],
            prefill_lens=[n for _, _, lens, _, _ in traced for n in lens],
            decode_ctx=[dec for *_, dec in traced])
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)

    # -- the comparison, with the program's state freed ---------------------
    sample = _sample(finished, seed, cell.cell["check"]["served_tokens"])
    jobs = [(np.asarray(r.req.prompt), list(r.req.out)) for r in sample]
    del eng, model, loop, first, in_window, finished, sample
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    gaps = served_gaps(cfg, weights.make(cfg, seed, device), jobs, device)
    out["reference_s"] = time.perf_counter() - t
    out["checks"] = check.serve_numbers(gaps, cell.cell["limits"])
    out["checked_tokens"] = len(gaps)
    out["jobs"] = jobs
    return out


def _sample(finished, seed, target):
    """Requests drawn from the seed until ``target`` served tokens, the
    one with the most served tokens first."""
    if not finished:
        raise SystemExit("no request finished in the window")
    longest = max(finished, key=lambda r: (len(r.req.out),
                                           len(r.req.prompt)))
    rng = np.random.default_rng(int(seed) ^ 0x5EED)
    rest = [finished[i] for i in rng.permutation(len(finished))
            if finished[i] is not longest]
    picked, n = [longest], len(longest.req.out)
    for r in rest:
        if n >= target:
            break
        picked.append(r)
        n += len(r.req.out)
    return picked


def served_gaps(cfg, W, jobs, device, fp8=False):
    """Each served token's gap below the reference's best logit at its
    position: the prompt and the served tokens run once through the
    reference (all but the last token, whose logits nothing needs).  With
    ``fp8`` the gap is of the token the fp8 control puts first."""
    ref = importlib.import_module(f"perfbench.reference.{cfg['reference']}")
    gaps = []
    for prompt, served in jobs:
        seq = torch.as_tensor(np.concatenate([prompt, served[:-1]]),
                              device=device).long()
        at = torch.arange(len(prompt) - 1, len(seq), device=device)
        lg = ref.logits(cfg, W, seq, at)
        toks = torch.as_tensor(served, device=device).long()
        if fp8:
            toks = ref.logits(cfg, W, seq, at, fp8=True).argmax(dim=-1)
        gaps += check.logit_gaps(lg, toks).tolist()
    return gaps
