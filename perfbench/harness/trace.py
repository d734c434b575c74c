"""The traced sub-window: ``torch.profiler`` over whole steps, reduced to
what the per-layer readers and the result's ``device`` and ``breakdown``
need.  Device events are the profiler's kernels, copies and sets; host
events its CPU ops, on every thread (the backward runs on autograd's
device thread)."""
from __future__ import annotations

import bisect
import time

import torch
from torch.autograd import DeviceType


def _dev_us(e):
    for k in ("device_time_total", "cuda_time_total"):
        if hasattr(e, k):
            return getattr(e, k)
    return 0.0


class Trace:
    def __init__(self, events, window_s):
        self.window_s = window_s
        self.device = []              # (start us, end us, name)
        self.host = []                # top-level CPU ops
        for e in events:
            if e.device_type == DeviceType.CPU:
                if e.cpu_parent is None:
                    self.host.append(e)
            elif not getattr(e, "is_user_annotation", False):
                self.device.append((e.time_range.start, e.time_range.end,
                                    e.name))
        self.device.sort()
        self.host.sort(key=lambda e: e.time_range.start)
        self._threads = {}            # thread -> (starts, top-level ops)
        for e in self.host:
            st, ops = self._threads.setdefault(e.thread, ([], []))
            st.append(e.time_range.start)
            ops.append(e)
        self.busy_us, self.gaps = 0.0, []
        end = None
        for lo, hi, _ in self.device:
            if end is not None and lo > end:
                self.gaps.append((end, lo))
            self.busy_us += max(0.0, hi - max(lo, end if end is not None
                                              else lo))
            end = hi if end is None else max(end, hi)

    # -- device ------------------------------------------------------------
    @property
    def busy_s(self):
        return self.busy_us / 1e6

    def kernel_us(self, *patterns):
        """Durations of the device events whose name holds a pattern."""
        return [hi - lo for lo, hi, n in self.device
                if any(p in n for p in patterns)]

    def device_ops(self, top=10):
        by = {}
        for lo, hi, n in self.device:
            by[n] = by.get(n, 0.0) + (hi - lo)
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], us / 1e6] for n, us in rows]

    # -- host --------------------------------------------------------------
    def under(self, *names):
        """Device us of the kernels launched under the outermost host ops
        whose name holds one of ``names`` (the profiler links each kernel
        to the op that launched it)."""
        total = 0.0

        def walk(e):
            nonlocal total
            if any(n in e.name for n in names):
                total += _dev_us(e)
                return
            for c in e.cpu_children:
                walk(c)
        for e in self.host:
            walk(e)
        return total

    def _host_at(self, t):
        """The innermost host op running at ``t`` us and its parent's name,
        across threads: the one that started last."""
        best = None
        for starts, ops in self._threads.values():
            i = bisect.bisect_right(starts, t) - 1
            if i < 0 or ops[i].time_range.end < t:
                continue
            e = ops[i]
            chain = [e]
            while True:
                kids = [c for c in chain[-1].cpu_children
                        if c.time_range.start <= t <= c.time_range.end]
                if not kids:
                    break
                chain.append(kids[-1])
            if best is None or chain[-1].time_range.start > \
                    best[-1].time_range.start:
                best = chain
        if best is None:
            return "(no host op)"
        names = [c.name for c in best[-2:]]
        return " > ".join(n[:80] for n in names)

    def idle_gaps(self, top=10):
        by = {}
        for lo, hi in self.gaps:
            k = self._host_at((lo + hi) / 2)
            by[k] = by.get(k, 0.0) + (hi - lo)
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, us / 1e6] for n, us in rows]


def capture(fn, device):
    """Run ``fn`` under the profiler, CPU ops and device activity; the
    window is the host's time from the first launch to the last sync."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_end = time.perf_counter()
    tr = Trace(prof.events(), t_end - t)
    tr.reduce_s = time.perf_counter() - t_end    # the profiler's parse too
    return tr, out
