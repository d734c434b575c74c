"""Operator-level trace generation for TrioSim (paper §5.2).
A copy of ``repro.sims.opgraph`` (numpy only); ``cfg`` is a
``repro_torch.models.config.ModelConfig``.

Converts any assigned (arch config × shape) plus a parallelism plan
(DP/TP/PP) into per-device operator lists: COMPUTE (estimated from the
roofline cost model, standing in for the paper's single-GPU trace
measurements), COLL (ring collectives) and P2P (pipeline stage handoffs).

Op encoding (int32 rows): [kind, size_kb_or_us, tag, peer]
  kind: 0=DONE 1=COMPUTE(size=duration µs) 2=COLL(size=KB, tag)
        3=P2P_SEND(size=KB, tag, peer) 4=P2P_RECV(tag)
"""
from __future__ import annotations

import dataclasses

import numpy as np

DONE, COMPUTE, COLL, P2P_SEND, P2P_RECV = 0, 1, 2, 3, 4


@dataclasses.dataclass
class HW:
    flops: float = 70e12          # per device (A40-class bf16 dense)
    hbm: float = 696e9
    link_bw: float = 25e9         # per-direction interconnect
    coll_alpha_us: float = 10.0   # per-step latency


def _us(flops, bytes_, hw: HW) -> float:
    return max(flops / hw.flops, bytes_ / hw.hbm) * 1e6


def build_train_trace(cfg, batch: int, seq: int, dp: int, tp: int, pp: int,
                      micro: int = 4, hw: HW = HW()):
    """Returns (ops [n_dev, MAX, 4] int32, n_tags). Device grid: dp×pp×tp
    (tp innermost)."""
    n_dev = dp * tp * pp
    P = cfg.param_count()
    L = cfg.n_layers
    stages = [L // pp + (1 if s < L % pp else 0) for s in range(pp)]
    tokens = batch * seq // dp // max(micro, 1)      # per microbatch per dp
    p_layer = (P - 2 * cfg.vocab * cfg.d_model) / L
    act_kb = tokens * cfg.d_model * 2 / 1024

    tag = [0]

    def next_tag():
        tag[0] += 1
        return tag[0] - 1

    devs = [[] for _ in range(n_dev)]

    def dev(d, s, t):
        return (d * pp + s) * tp + t

    # microbatch pipeline: fwd then bwd (GPipe flush schedule)
    for d in range(dp):
        fwd_tags: dict = {}
        bwd_tags: dict = {}
        for m in range(micro):
            for s in range(pp):
                coll_tag = next_tag() if tp > 1 else -1  # shared across tp
                for t in range(tp):
                    ops = devs[dev(d, s, t)]
                    if s > 0:
                        tg = fwd_tags.setdefault((m, s, t), next_tag())
                        ops.append([P2P_RECV, 0, tg, dev(d, s - 1, t)])
                    fl = 2 * p_layer * stages[s] * tokens / tp
                    by = p_layer * stages[s] * 2 / tp
                    ops.append([COMPUTE, int(_us(fl, by, hw)) + 1, 0, 0])
                    if tp > 1:   # TP activation allreduce per stage
                        ops.append([COLL, int(act_kb) + 1, coll_tag, tp])
                    if s < pp - 1:
                        tg = fwd_tags.setdefault((m, s + 1, t), next_tag())
                        ops.append([P2P_SEND, int(act_kb) + 1, tg,
                                    dev(d, s + 1, t)])
        for m in range(micro):
            for s in reversed(range(pp)):
                coll_tag = next_tag() if tp > 1 else -1
                for t in range(tp):
                    ops = devs[dev(d, s, t)]
                    if s < pp - 1:
                        tg = bwd_tags.setdefault((m, s, t), next_tag())
                        ops.append([P2P_RECV, 0, tg, dev(d, s + 1, t)])
                    fl = 4 * p_layer * stages[s] * tokens / tp
                    by = 2 * p_layer * stages[s] * 2 / tp
                    ops.append([COMPUTE, int(_us(fl, by, hw)) + 1, 0, 0])
                    if tp > 1:
                        ops.append([COLL, int(act_kb) + 1, coll_tag, tp])
                    if s > 0:
                        tg = bwd_tags.setdefault((m, s - 1, t), next_tag())
                        ops.append([P2P_SEND, int(act_kb) + 1, tg,
                                    dev(d, s - 1, t)])
    # DP gradient allreduce (per stage×tp slice, across dp)
    if dp > 1:
        for s in range(pp):
            for t in range(tp):
                tg = next_tag()
                grad_kb = p_layer * stages[s] * 2 / tp / 1024
                for d in range(dp):
                    devs[dev(d, s, t)].append([COLL, int(grad_kb) + 1, tg,
                                               dp])
    for ops in devs:
        ops.append([DONE, 0, 0, 0])
    mx = max(len(o) for o in devs)
    arr = np.zeros((n_dev, mx, 4), np.int32)
    for i, o in enumerate(devs):
        arr[i, :len(o)] = np.asarray(o, np.int32)
    return arr, tag[0]


def analytic_step_us(cfg, batch, seq, dp, tp, pp, micro, hw: HW = HW()):
    """Closed-form lower bound (no overlap): compute + TP coll + DP coll +
    pipeline bubble factor."""
    P = cfg.param_count()
    p_layer = (P - 2 * cfg.vocab * cfg.d_model) / cfg.n_layers
    L = cfg.n_layers
    tokens = batch * seq // dp
    comp = 6 * p_layer * L * tokens / tp / pp / hw.flops * 1e6
    bubble = (pp - 1) / max(micro, 1)      # GPipe flush bubble
    comp *= (1 + bubble)
    act_b = tokens // max(micro, 1) * cfg.d_model * 2
    tp_coll = 0.0
    if tp > 1:
        # trace aggregates one collective per (microbatch, direction, stage)
        n_coll = 2 * max(micro, 1)
        tp_coll = n_coll * (2 * (tp - 1) / tp * act_b / hw.link_bw * 1e6
                            + hw.coll_alpha_us)
    dp_coll = 0.0
    if dp > 1:
        grad_b = p_layer * L / pp * 2 / tp
        dp_coll = (2 * (dp - 1) / dp * grad_b / hw.link_bw * 1e6
                   + hw.coll_alpha_us)
    return comp + tp_coll + dp_coll
