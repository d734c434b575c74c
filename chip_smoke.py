#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

  python3 chip_smoke.py              # needs one CUDA card

Phases (each raises on failure, and the run then exits non-zero):
  1. setup: card name and power limit, build every CUDA kernel from the
     sources in the checkout (one nvcc per source, all at once, with each
     kernel's registers and spills from ptxas), TF32 off;
  2. kernels: each kernel against its plain PyTorch version on the card,
     in bf16 (the tensor-core kernels) and f32 (the CUDA-core kernels), at
     hymba-1.5b's prefill shapes (ragged S, S > window, and S=2048 for
     SSD), at mamba2-130m's SSD widths (where the f32 kernel is also held
     against an f64 recurrence), at the JAX package's kernel-test cases
     and at the edges of what the kernels accept, with the tolerances of
     those tests, and one SSD call's output fed straight into the next;
     kernel, plain and library times;
  3. serve: a small f32 hybrid model on the card against the same model on
     the CPU (plain versions), which is the f32 kernels' path, then
     hymba-1.5b at full width and depth with seeded random bf16 weights
     served by ``ServeEngine`` (5 requests, 32 new tokens each), the bf16
     kernels' path; each path must launch both kernels once per layer of
     every prefill;
  4. profile: device busy share (the union of kernel intervals: the SSD
     kernels overlap) and kernel time by group for one prefill and for
     decode steps with every slot active (torch.profiler);
  5. engine: the Akita engine and the memsys simulator, each block of
     epochs a captured CUDA graph.  All five workload patterns at 16 cores
     and 96 requests a core, by benchmarks/smart_ticking.py's procedure,
     Smart Ticking and naive: the stats must equal MEMSYS_REF (from the
     JAX package), stat_err must be 0, and idle_half's whole final state
     must equal the port's CPU run and an eager K=1 run on the card, bit
     for bit; then 64 cores x 256 requests (mixed) to completion, with
     wall time, epochs/s, simulated cycles/s, kernels per epoch and the
     device-busy share of one block.  This path has no hand-written
     kernel: the reference's epoch is plain jnp code.
  6. dse: the batched lanes (``repro_torch.dse``), each round's block of
     epochs for every lane one captured CUDA graph.  (a) 256 design points
     at memsys 16 cores x 96 requests with per-lane horizons, through
     ``run_sweep`` (autotuner and depth-2 pipeline), through
     ``run_sweep(pipeline=False)`` and as one ``run_batch``: the three
     give identical rows, equal to SWEEP_REF (from the JAX package), and
     lanes 0, 85, 170 and 255 equal single runs on the card, whole final
     state, f32 by bits; (b) the ``shape.core`` topology family, 15 rows
     against SWEEP_REF; (c) 32 lanes at 64 cores x 256 requests, whose
     lane 0 (the build's defaults) ends at MEMSYS64.  Wall time,
     configs/s, rounds, chunk, quantum, overlap share and captures of each
     sweep, a block's time and kernels an epoch at 1 lane and at the top
     rung, and the batching ratio against 4 single runs.  No hand-written
     kernel either: the reference's batched loop is ``jax.vmap`` of the
     same jnp code.
Then the engine's and the DSE path's JSON records, the kernels' JSON
record (the line before the last), and ``{"ok": true, "device": {...}}``
as the last line.  ``python3 chip_smoke.py --engine`` runs phase 5 alone,
``python3 chip_smoke.py --dse`` phase 6.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12,     # dense tensor-core rate
                  "float32": 67e12}       # CUDA cores, no TF32
TOL = {"flash_attention": {"float32": 2e-5, "bfloat16": 2e-2},
       "ssd": {"float32": 1e-4, "bfloat16": 5e-2}}
# kernel-test cases of the JAX package (tests/kernels/*.py)
FA_CASES = [  # B, S, H, KV, hd, causal, window, cap
    (1, 128, 2, 2, 32, True, 0, 0.0),
    (2, 256, 4, 2, 16, True, 0, 0.0),
    (1, 256, 4, 1, 32, True, 64, 0.0),
    (2, 128, 2, 2, 64, True, 0, 50.0),
    (1, 128, 4, 4, 32, False, 0, 0.0),
    (1, 512, 8, 2, 64, True, 128, 30.0),
]
SSD_CASES = [  # B, S, H, P, N, chunk
    (1, 64, 2, 16, 8, 16),
    (2, 128, 3, 32, 16, 32),
    (1, 256, 2, 64, 64, 64),
]
# edges of what the kernels accept: hd=128 with one and with two key
# groups, a ragged S, P and N that are not multiples of 16 or of 8 (rows
# that are not 16-byte aligned), and the longest chunk with a ragged tail
FA_EDGE = [
    (1, 200, 4, 2, 128, False, 0, 0.0),
    (2, 1100, 8, 2, 128, True, 300, 30.0),
]
SSD_EDGE = [
    (1, 250, 3, 40, 24, 100),
    (1, 70, 2, 5, 7, 32),
    (2, 1030, 2, 64, 128, 1024),
]
# (B, S, H, P, N, chunk) at mamba2-130m's widths
MAMBA2_SSD = (1, 512, 24, 64, 128, 256)
PROMPT_LENS = (256, 200, 384, 130, 64)
MAX_NEW = 32

# phase 5: memsys at 16 cores and 96 requests a core, by the procedure of
# benchmarks/smart_ticking.py (Smart Ticking to completion, horizon =
# ceil(virtual time) + 2, then Smart Ticking and naive to the horizon).
# finish_stats, progress_ticks and the per-component busy vector of the
# JAX package on the CPU; CHANGES.md (PR 13) has the command that made it.
MEMSYS_PATTERNS = ("compute", "stream", "pointer", "idle_half", "mixed")
MEMSYS_REF = {
    "compute": dict(
        horizon=15270.0,
        smart=dict(virtual_time=15268.0, epochs=3937, ticks=11185,
                   delivered=6144, reads_done=1536, hits=0, misses=1536,
                   remaining=0, outstanding=0, progress_ticks=6160,
                   busy=[97] * 16 + [192] * 16 + [1536]),
        naive=dict(virtual_time=15271.0, epochs=15271, ticks=503943,
                   delivered=6144, reads_done=1536, hits=0, misses=1536,
                   remaining=0, outstanding=0, progress_ticks=6160,
                   busy=[97] * 16 + [192] * 16 + [1536]),
    ),
    "stream": dict(
        horizon=15270.0,
        smart=dict(virtual_time=15268.0, epochs=3937, ticks=11185,
                   delivered=6144, reads_done=1536, hits=0, misses=1536,
                   remaining=0, outstanding=0, progress_ticks=6160,
                   busy=[97] * 16 + [192] * 16 + [1536]),
        naive=dict(virtual_time=15271.0, epochs=15271, ticks=503943,
                   delivered=6144, reads_done=1536, hits=0, misses=1536,
                   remaining=0, outstanding=0, progress_ticks=6160,
                   busy=[97] * 16 + [192] * 16 + [1536]),
    ),
    "pointer": dict(
        horizon=15270.0,
        smart=dict(virtual_time=15268.0, epochs=3937, ticks=11185,
                   delivered=6144, reads_done=1536, hits=0, misses=1536,
                   remaining=0, outstanding=0, progress_ticks=6160,
                   busy=[97] * 16 + [192] * 16 + [1536]),
        naive=dict(virtual_time=15271.0, epochs=15271, ticks=503943,
                   delivered=6144, reads_done=1536, hits=0, misses=1536,
                   remaining=0, outstanding=0, progress_ticks=6160,
                   busy=[97] * 16 + [192] * 16 + [1536]),
    ),
    "idle_half": dict(
        horizon=6373.0,
        smart=dict(virtual_time=6371.0, epochs=1737, ticks=5609,
                   delivered=3072, reads_done=768, hits=0, misses=768,
                   remaining=0, outstanding=0, progress_ticks=3080,
                   busy=[97] * 8 + [0] * 8 + [192] * 8 + [0] * 8 + [768]),
        naive=dict(virtual_time=6374.0, epochs=6374, ticks=210342,
                   delivered=3072, reads_done=768, hits=0, misses=768,
                   remaining=0, outstanding=0, progress_ticks=3080,
                   busy=[97] * 8 + [0] * 8 + [192] * 8 + [0] * 8 + [768]),
    ),
    "mixed": dict(
        horizon=15270.0,
        smart=dict(virtual_time=15268.0, epochs=3937, ticks=11185,
                   delivered=6144, reads_done=1536, hits=0, misses=1536,
                   remaining=0, outstanding=0, progress_ticks=6160,
                   busy=[97] * 16 + [192] * 16 + [1536]),
        naive=dict(virtual_time=15271.0, epochs=15271, ticks=503943,
                   delivered=6144, reads_done=1536, hits=0, misses=1536,
                   remaining=0, outstanding=0, progress_ticks=6160,
                   busy=[97] * 16 + [192] * 16 + [1536]),
    ),
}
# full width: 64 cores (the R9 Nano's compute units, MGPUSim's default GPU)
# and 256 requests a core (examples/simulate_gpu.py), pattern mixed, Smart
# Ticking to completion (JAX package on the CPU)
# horizon of the eager K=1 run held against the graph (idle_half)
MEMSYS_EAGER_UNTIL = 1000.0
MEMSYS64 = dict(n_cores=64, n_reqs=256, pattern="mixed", epochs=38121,
                virtual_time=135940.0)

# phase 6: the batched lanes.  (a) 256 points of
# benchmarks/dse_throughput.py's _points at memsys 16 cores x 96 requests
# (mixed), each with its own horizon, spread 8x below mixed's MEMSYS_REF
# horizon; (b) the shape.core family of examples/sweep_topology.py widened
# to 16 cores; (c) 32 lanes at 64 cores x 256 requests.  SWEEP_REF: the JAX
# package's rows on the CPU for (a) and (b) (default_extract's fields; the
# sha256 of the canonical JSON of all rows, each column's sum and 8 sampled
# rows, as axes + DSE_ROW); CHANGES.md has the command that made it.
DSE_ROW = ("virtual_time", "epochs", "ticks", "progress_ticks", "delivered")
DSE_SAMPLED = (0, 85, 170, 255)       # lanes held against single runs
SWEEP_REF = {
    "sweep256": dict(
        n=256,
        sha256="ed2be16f3f3191062ad6dce5c885712a"
               "7cdbd4387febf467bd4bf920c7c74df2",
        sums=dict(virtual_time=1596848.0, epochs=884320, ticks=2166460,
                  progress_ticks=1185726, delivered=1093607),
        axes=("conn_latency[-1]", "kind.l1.extra_hit_rate"),
        sample={
            0: (10.0, 0.0, 1908.0, 1557, 5059, 2782, 2774),
            1: (10.117647058823529, 0.02196078431372549, 2482.0, 1888, 6129,
                 3370, 3352),
            37: (14.352941176470587, 0.009411764705882354, 7999.0, 4878, 11359,
                 6136, 6110),
            85: (20.0, 0.26039215686274514, 8148.0, 4654, 10321, 5611, 5348),
            128: (25.058823529411764, 0.40156862745098043, 8581.0, 4627, 9666,
                 5291, 4890),
            170: (30.0, 0.5207843137254903, 5995.0, 3760, 8396, 4626, 4170),
            201: (33.64705882352941, 0.39843137254901967, 10428.0, 4917, 9572,
                 5230, 4839),
            255: (40.0, 0.7811764705882354, 5093.0, 3723, 8151, 4502, 3736),
        }),
    "family": dict(
        n=15,
        sha256="49cbd114541cabf82fc7fbcd3da5c150"
               "7bcc0157c16a5c472f7bc97bf2b324fb",
        sums=dict(virtual_time=80041.0, epochs=27841, ticks=56684,
                  progress_ticks=30798, delivered=28530),
        axes=("shape.core", "kind.l1.extra_hit_rate"),
        sample={
            0: (1, 0.0, 6337.0, 770, 772, 385, 384),
            2: (1, 0.8, 2353.0, 544, 546, 309, 234),
            4: (2, 0.4, 4261.0, 1189, 1307, 690, 612),
            6: (4, 0.0, 6340.0, 1349, 2797, 1540, 1536),
            8: (4, 0.8, 2247.0, 1418, 2065, 1147, 914),
            10: (8, 0.4, 4424.0, 2949, 5003, 2577, 2458),
            12: (16, 0.0, 15268.0, 3937, 11185, 6160, 6144),
            14: (16, 0.8, 3336.0, 2827, 8076, 4467, 3686),
        }),
}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=20, warmup=3):
    """Mean device time of one call: ``reps`` calls captured in one CUDA
    graph after ``warmup`` eager calls, the graph replayed between two CUDA
    events.  The graph takes the host's launch work out of the time; for a
    kernel of a few microseconds that work is longer than the kernel."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def eager_ms(fn, reps=20):
    """Mean time of one call issued eagerly, back to back, between two
    CUDA events: the device time, or the host's launch work where that is
    longer, as on the serving path."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def compare(name, out, ref, dtype_name):
    import torch
    tol = TOL[name][dtype_name]
    out, ref = out.float(), ref.float()
    err = float((out - ref).abs().max())
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if not torch.allclose(out, ref, atol=tol, rtol=tol):
        raise AssertionError(f"{name}: max abs err {err} beyond tol {tol}")
    return err


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------
def setup():
    import torch
    from repro_torch.kernels import _build
    log(_card())
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    logs = _build.build_all()
    log(f"built kernels {sorted(logs) or 'none (cached)'} in "
        f"{time.perf_counter() - t:.2f} s")
    entry = re.compile(r"\d(fa_tc_fwd|fa_fwd|ssd_tc_(?:state|pass|scan)"
                       r"|ssd_fwd)(\w*)")
    for name, text in logs.items():
        kernel = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                m = entry.search(line)
                hd = re.search(r"Li(\d+)E", m.group(2)) if m else None
                kernel = (m.group(1) if m else "?") + \
                    (f"<{hd.group(1)}>" if hd else "")
            if "registers" in line or "spill" in line:
                log(f"  {name} {kernel}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN (f32 plain versions run in full f32)")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------
def _attn_pairs(S, causal, window):
    """(q, k) pairs the masks keep at self-attention positions."""
    if not causal:
        return S * (S if window <= 0 else min(S, window))
    if window <= 0:
        return S * (S + 1) // 2
    return sum(min(q + 1, window) for q in range(S))


def check_flash(dev, gen):
    """Both kernels against the plain version at every case; times at
    hymba's shapes.  Returns the JSON record of each dtype's kernel, from
    the S=256, window 1024 case."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    def mk(B, S, H, KV, hd, dtype):
        q = torch.randn((B, S, H, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(dtype)
        return q, k, v

    # hymba-1.5b prefill: 25 query heads, 5 KV heads of 64
    hymba = [(1, S, 25, 5, 64, True, w, 0.0)
             for S in (256, 200) for w in (0, 1024)]
    hymba.append((1, 1536, 25, 5, 64, True, 1024, 0.0))
    err, rec = {}, {}
    for tag, cases in (("hymba", hymba), ("jax-case", FA_CASES),
                       ("edge", FA_EDGE)):
        for case in cases:
            B, S, H, KV, hd, causal, window, cap = case
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[1]
                q, k, v = mk(B, S, H, KV, hd, dtype)
                kw = dict(causal=causal, window=window, cap=cap)
                out = fak.flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                ref = flash_attention_ref(q, k, v, **kw)
                e = compare("flash_attention", out, ref, dn)
                line = (f"flash_attention {fak.entry(dtype)[1]} {tag} B={B} "
                        f"S={S} H={H} KV={KV} hd={hd} causal={causal} "
                        f"window={window} cap={cap} {dn}: max_abs_err "
                        f"{e:.3g}")
                if tag == "hymba":
                    err[dn] = max(err.get(dn, 0.0), e)
                    ms = time_ms(lambda: fak.flash_attention(q, k, v, **kw))
                    plain = time_ms(lambda: flash_attention_ref(q, k, v, **kw),
                                    reps=5)
                    G = H // KV
                    qh = q.transpose(1, 2)
                    kh = k.repeat_interleave(G, dim=2).transpose(1, 2)
                    vh = v.repeat_interleave(G, dim=2).transpose(1, 2)
                    if window > 0 and window < S:
                        i = torch.arange(S, device=dev)
                        mask = (i[None, :] <= i[:, None]) & \
                            (i[:, None] - i[None, :] < window)
                        sdpa = lambda: F.scaled_dot_product_attention(  # noqa
                            qh, kh, vh, attn_mask=mask)
                    else:
                        sdpa = lambda: F.scaled_dot_product_attention(  # noqa
                            qh, kh, vh, is_causal=True)
                    lib = time_ms(sdpa)
                    eager = eager_ms(lambda: fak.flash_attention(q, k, v,
                                                                 **kw))
                    ops = 4 * B * H * hd * _attn_pairs(S, causal, window)
                    b_ms, b_by = bound(nbytes(q, k, v, out), ops, dn)
                    line += (f", kernel {ms:.4f} ms (eager {eager:.4f}), "
                             f"plain {plain:.4f} ms, "
                             f"sdpa {lib:.4f} ms, bound {b_ms:.4f} ms "
                             f"({b_by}), share of bound {b_ms / ms:.3f}")
                    if S == 256 and window == 1024:
                        rec[dn] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                       bound_ms=b_ms, bound_by=b_by)
                log(line)
    for dn in rec:
        rec[dn]["max_abs_err"] = err[dn]
    return rec


def _ssd_ops(B, S, H, P, N, chunk):
    """Operations of the chunked form at these shapes (per step pair inside
    a chunk: C.B, decay, dt and the P-wide product; per step: the
    inter-chunk read and the state update)."""
    ops = 0
    for c0 in range(0, S, chunk):
        ln = min(chunk, S - c0)
        pairs = ln * (ln + 1) // 2
        ops += pairs * (2 * N + 3 + 2 * P) + ln * (2 * N * P + 2 * P) \
            + ln * (2 * P * N + 2) + 2 * P * N
    return B * H * ops


def _ssd_recurrence_f64(xs, dt, A, B_, C_):
    """The sequential recurrence in f64: an oracle free of the chunked
    form's f32 rounding."""
    import torch
    xs, dt, A, B_, C_ = (t.double() for t in (xs, dt, A, B_, C_))
    B, S, H, P = xs.shape
    h = torch.zeros((B, H, P, B_.shape[-1]), dtype=torch.float64,
                    device=xs.device)
    ys = []
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[:, :, None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, t], B_[:, t], xs[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", C_[:, t], h))
    return torch.stack(ys, dim=1), h


def _ssd_witness(args, y, hT, chunk):
    """The f32 kernel, the chunked plain version on the card and the same
    on the CPU, each against the f64 recurrence, and the kernel against the
    CPU's chunked version: shows which side a miss of the f32 tolerance
    comes from.  Each pair gives the max abs error of y and the state, and
    max |a - b| / (tol + tol |b|), which is at most 1 within tolerance."""
    from repro_torch.kernels.ssd.ref import ssd_chunked
    tol = TOL["ssd"]["float32"]
    truth = _ssd_recurrence_f64(*args)
    card = ssd_chunked(*args, chunk)
    cpu = ssd_chunked(*(t.cpu() for t in args), chunk)

    def err(a, b):
        e = r = 0.0
        for u, v in zip(a, b):
            u, v = u.double().cpu(), v.double().cpu()
            d = (u - v).abs()
            e = max(e, float(d.max()))
            r = max(r, float((d / (tol + tol * v.abs())).max()))
        return f"{e:.3g} (ratio {r:.3g})"
    kern = (y, hT)
    return (f"; witness, max abs err of y and state: kernel vs CPU chunked "
            f"{err(kern, cpu)}, vs f64 recurrence {err(kern, truth)}; card "
            f"chunked vs f64 recurrence {err(card, truth)}; CPU chunked vs "
            f"f64 recurrence {err(cpu, truth)}")


def check_ssd(dev, gen):
    """Both kernels against the chunked plain version (and, at the JAX
    cases, the recurrence) at every case; bf16 times at hymba's and
    mamba2-130m's shapes; one call's output fed straight into the next.
    Returns the JSON record of each dtype's kernel, from hymba's S=256
    case."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd import kernel as ssdk
    from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_ref

    def mk(B, S, H, P, N, dtype):
        xs = torch.randn((B, S, H, P), generator=gen, device=dev).to(dtype)
        dt = F.softplus(torch.randn((B, S, H), generator=gen, device=dev)
                        - 1.0)
        A = -torch.exp(torch.randn((H,), generator=gen, device=dev) * 0.3)
        B_ = torch.randn((B, S, N), generator=gen, device=dev).to(dtype)
        C_ = torch.randn((B, S, N), generator=gen, device=dev).to(dtype)
        return xs, dt, A, B_, C_

    # hymba-1.5b prefill: 50 heads, P=64, N=16, chunk 128
    hymba = [(1, S, 50, 64, 16, 128) for S in (256, 200, 2048)]
    err, rec = {}, {}
    for tag, cases in (("hymba", hymba), ("mamba2-130m", [MAMBA2_SSD]),
                       ("jax-case", SSD_CASES), ("edge", SSD_EDGE)):
        for case in cases:
            B, S, H, P, N, chunk = case
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[1]
                args = mk(B, S, H, P, N, dtype)
                y, hT = ssdk.ssd(*args, chunk=chunk)
                torch.cuda.synchronize()
                y_ref, h_ref = ssd_chunked(*args, chunk)
                e = max(compare("ssd", y, y_ref, dn),
                        compare("ssd", hT, h_ref, dn))
                line = (f"ssd {ssdk.entry(dtype)[1]} {tag} B={B} S={S} H={H} "
                        f"P={P} N={N} chunk={chunk} {dn}: max_abs_err "
                        f"{e:.3g}")
                if tag == "jax-case":   # also the sequential oracle
                    y_seq, h_seq = ssd_ref(*args)
                    e2 = max(compare("ssd", y, y_seq, dn),
                             compare("ssd", hT, h_seq, dn))
                    line += f", vs recurrence {e2:.3g}"
                elif tag != "edge":
                    err[dn] = max(err.get(dn, 0.0), e)
                if tag == "mamba2-130m" and dtype == torch.float32:
                    line += _ssd_witness(args, y, hT, chunk)
                if tag in ("hymba", "mamba2-130m") and (dtype == torch.bfloat16
                                          or (S == 256 and tag == "hymba")):
                    ms = time_ms(lambda: ssdk.ssd(*args, chunk=chunk))
                    plain = time_ms(lambda: ssd_chunked(*args, chunk),
                                    reps=5)
                    eager = eager_ms(lambda: ssdk.ssd(*args, chunk=chunk))
                    b_ms, b_by = bound(nbytes(*args, y, hT),
                                       _ssd_ops(B, S, H, P, N, chunk), dn)
                    line += (f", kernel {ms:.4f} ms (eager {eager:.4f}), "
                             f"plain {plain:.4f} ms, "
                             f"bound {b_ms:.4f} ms ({b_by}), share of bound "
                             f"{b_ms / ms:.3f}")
                    if tag == "hymba" and S == 256:
                        rec[dn] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                       bound_ms=b_ms, bound_by=b_by)
                log(line)

    # one call's output straight into the next, with nothing between: the
    # second call's kernels start early and must still see the first's y
    B, S, H, P, N, chunk = hymba[-1]
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        xs, dt, A, B_, C_ = mk(B, S, H, P, N, dtype)
        torch.cuda.synchronize()
        y1, _ = ssdk.ssd(xs, dt, A, B_, C_, chunk=chunk)
        y2, h2 = ssdk.ssd(y1, dt, A, B_, C_, chunk=chunk)
        torch.cuda.synchronize()
        y1_ref, _ = ssd_chunked(xs, dt, A, B_, C_, chunk)
        y2_ref, h2_ref = ssd_chunked(y1, dt, A, B_, C_, chunk)
        e = max(compare("ssd", y1, y1_ref, dn), compare("ssd", y2, y2_ref, dn),
                compare("ssd", h2, h2_ref, dn))
        log(f"ssd {ssdk.entry(dtype)[1]} chained ssd(ssd(x).y) B={B} S={S} "
            f"H={H} P={P} N={N} chunk={chunk} {dn}: max_abs_err {e:.3g}")
    for dn in rec:
        rec[dn]["max_abs_err"] = err[dn]
    return rec


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------
class _Timer:
    """Tracer that collects host durations of the engine's tasks."""

    def __init__(self):
        self.spans: dict[str, list[float]] = {}
        self._t0: dict[str, float] = {}

    def on_start(self, t):
        self._t0[t.id] = time.perf_counter()

    def on_end(self, t):
        self.spans.setdefault(t.category, []).append(
            (time.perf_counter() - self._t0.pop(t.id)) * 1e3)

    def on_tag(self, t, tag):
        pass


def _finite_forward(tfm, counter):
    """Wrap ``tfm.forward`` to count calls whose real logits are not
    finite (the padded vocab columns hold -1e30 by design)."""
    import torch
    orig = tfm.forward

    def checked(params, cfg, *a, **kw):
        logits, cache, aux = orig(params, cfg, *a, **kw)
        counter["calls"] += 1
        if not bool(torch.isfinite(logits[..., :cfg.vocab]).all()):
            counter["nonfinite"] += 1
        return logits, cache, aux

    return orig, checked


def check_small_model(dev):
    """f32 hybrid model (hymba smoke shapes, window 32, chunk 8): card
    (kernels) against CPU (plain versions).  This is the f32 kernels'
    path: returns their launches in it, one per layer of every prefill."""
    import copy
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.ssd import kernel as ssdk
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine

    cfg = dataclasses.replace(get_smoke_config("hymba-1.5b"), window=32)
    cpu = tfm.init_model(cfg, seed=1, device="cpu", dtype=torch.float32)
    gpu = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(1)
    tol = 1e-4
    fak.launches = 0
    ssdk.launches = 0
    for S in (40, 12):   # S > window, and S ragged against chunk 8
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, S)))
        with torch.inference_mode():
            lc, cc, _ = tfm.forward(cpu, cfg, {"tokens": toks},
                                    mode="prefill")
            lg, cg, _ = tfm.forward(gpu, cfg, {"tokens": toks.to(dev)},
                                    mode="prefill")
        lg = lg.cpu()
        err = float((lg - lc)[..., :cfg.vocab].abs().max())
        if not torch.allclose(lg[..., :cfg.vocab], lc[..., :cfg.vocab],
                              atol=tol, rtol=tol):
            raise AssertionError(f"small model prefill S={S}: logits "
                                 f"differ by {err} (tol {tol})")
        for k in cc:
            if not torch.allclose(cg[k].cpu().float(), cc[k].float(),
                                  atol=tol, rtol=tol):
                raise AssertionError(f"small model prefill S={S}: cache "
                                     f"{k!r} differs")
        log(f"small model f32 prefill S={S}: card vs CPU logits max abs "
            f"err {err:.3g} (tol {tol})")
    outs = []
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (5, 12, 17)]
    for model in (cpu, gpu):
        eng = ServeEngine(cfg, model, max_batch=2, max_len=32)
        timer = eng.dom.attach(_Timer())
        for p in prompts:
            eng.submit(p, max_new=8)
        outs.append({r.rid: r.out for r in eng.run_until_idle()})
    torch.cuda.synchronize()
    launches = {"flash_attention": fak.launches, "ssd": ssdk.launches}
    if outs[0] != outs[1]:
        raise AssertionError(f"small model greedy tokens differ: CPU "
                             f"{outs[0]} vs card {outs[1]}")
    log(f"small model greedy serving: card tokens == CPU tokens "
        f"({sum(len(o) for o in outs[0].values())} tokens)")
    n_prefill = 2 + len(timer.spans["prefill"])   # 2 forward calls above
    for name, n in launches.items():
        if n != cfg.n_layers * n_prefill:
            raise AssertionError(f"{name}: {n} f32 launches on the small "
                                 f"model, want {cfg.n_layers} x {n_prefill}")
    log(f"launches on the small f32 model: {launches} "
        f"(= {cfg.n_layers} layers x {n_prefill} prefills)")
    return launches


def serve_hymba(dev):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.ssd import kernel as ssdk
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("hymba-1.5b")
    t = time.perf_counter()
    model = tfm.init_model(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"hymba-1.5b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params} params (bf16, seeded random) on the card in "
        f"{time.perf_counter() - t:.2f} s")

    eng = ServeEngine(cfg, model, max_batch=4, max_len=512)
    timer = eng.dom.attach(_Timer())
    rng = np.random.default_rng(0)
    counter = {"calls": 0, "nonfinite": 0}
    orig, checked = _finite_forward(tfm, counter)
    tfm.forward = checked
    try:
        for n in PROMPT_LENS:
            eng.submit(rng.integers(0, cfg.vocab, n), max_new=MAX_NEW)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fak.launches = 0
        ssdk.launches = 0
        t = time.perf_counter()
        done = eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {"flash_attention": fak.launches, "ssd": ssdk.launches}
    finally:
        tfm.forward = orig

    if len(done) != len(PROMPT_LENS) or \
            any(len(r.out) != MAX_NEW for r in done):
        raise AssertionError(f"requests did not all finish with {MAX_NEW} "
                             f"tokens: {[len(r.out) for r in done]}")
    if counter["nonfinite"]:
        raise AssertionError(f"{counter['nonfinite']} of {counter['calls']}"
                             f" forward calls gave non-finite logits")
    n_prefill = len(timer.spans["prefill"])
    want = cfg.n_layers * n_prefill
    for name, n in launches.items():
        if n != want:
            raise AssertionError(f"{name}: {n} launches in the serve run, "
                                 f"want {cfg.n_layers} x {n_prefill}")
    pre, dec = timer.spans["prefill"], timer.spans["decode"]
    toks = sum(len(r.out) for r in done)
    log(f"served {len(done)} requests x {MAX_NEW} tokens in {wall:.3f} s: "
        f"{toks / wall:.2f} tokens/s; {counter['calls']} forward calls, "
        f"all logits finite; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("prefill ms per request (prompt lens "
        f"{list(PROMPT_LENS)}): {[round(x, 3) for x in pre]}")
    log(f"decode ms per step: mean {sum(dec) / len(dec):.3f}, "
        f"min {min(dec):.3f}, max {max(dec):.3f} over {len(dec)} steps")
    log(f"launches in the serve run: {launches} "
        f"(= {cfg.n_layers} layers x {n_prefill} prefills), through "
        f"{fak.entry(torch.bfloat16)[1]} and {ssdk.entry(torch.bfloat16)[1]}")
    return launches, model


OWN_KERNELS = ("fa_tc_fwd", "fa_fwd", "ssd_tc_state", "ssd_tc_pass",
               "ssd_tc_scan", "ssd_fwd")


def _kernel_group(name):
    if "fa_fwd" in name or "fa_tc_" in name:
        return "flash_attention"
    if "ssd_fwd" in name or "ssd_tc_" in name:
        return "ssd"
    if any(s in name for s in ("gemm", "nvjet", "cutlass", "sm90_", "cublas")):
        return "matmul"
    return "other"


def _profile(model):
    """Device busy share and kernel time by group, for one prefill and for
    decode steps with every slot active.  Wall times come from an
    unprofiled run of the same work; device times from torch.profiler's
    kernel events (one stream, so their sum is the busy time)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine

    cfg, rng = model.cfg, np.random.default_rng(1)

    def run(label, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e6
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        # busy time is the union of the kernels' intervals: the SSD
        # kernels overlap (programmatic dependent launch)
        busy, end = 0.0, float("-inf")
        for e in sorted(kern, key=lambda e: e.time_range.start):
            lo, hi = max(e.time_range.start, end), e.time_range.end
            busy += max(0.0, hi - lo)
            end = max(end, hi)
        groups: dict[str, float] = {}
        for e in kern:
            g = _kernel_group(e.name)
            groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us()
        own: dict[str, list[float]] = {}   # the port's kernels, by name
        for e in kern:
            name = next((n for n in OWN_KERNELS if n in e.name), None)
            if name:
                own.setdefault(name, []).append(e.time_range.elapsed_us())
        log(f"profile {label}: wall {wall:.0f} us unprofiled, device busy "
            f"{busy:.0f} us ({100 * busy / wall:.1f}%), {len(kern)} kernels;"
            " device us by group: "
            + ", ".join(f"{g} {u:.0f}" for g, u in
                        sorted(groups.items(), key=lambda kv: -kv[1]))
            + "; own kernels, us per launch: "
            + ", ".join(f"{n} {sum(u) / len(u):.2f} x {len(u)}"
                        for n, u in own.items()))
        ev = prof.key_averages()
        key = ("self_device_time_total"
               if hasattr(ev[0], "self_device_time_total")
               else "self_cuda_time_total")
        log(ev.table(sort_by=key, row_limit=12))

    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 256)),
                           device=model.device)
    with torch.inference_mode():
        run("prefill S=256", lambda: tfm.forward(model, cfg,
                                                 {"tokens": toks},
                                                 mode="prefill"))
    eng = ServeEngine(cfg, model, max_batch=4, max_len=512)
    for n in (256, 200, 130, 64):
        eng.submit(rng.integers(0, cfg.vocab, n), max_new=24)
    eng.step()                       # admit all four, one decode step
    run("4 decode steps, 4 active slots",
        lambda: [eng.step() for _ in range(4)])


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------
def _leaves(tree, path=()):
    import dataclasses

    import torch
    if isinstance(tree, torch.Tensor):
        return {".".join(path): tree}
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = sorted(tree.items())
    else:
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    out = {}
    for k, v in items:
        out.update(_leaves(v, path + (k,)))
    return out


def _state_diff(a, b):
    """Leaves of two engine states that differ in dtype, shape or bits."""
    import torch
    la, lb = _leaves(a), _leaves(b)
    bad = sorted(set(la) ^ set(lb))
    for k in sorted(set(la) & set(lb)):
        x, y = la[k].cpu(), lb[k].cpu()
        if x.dtype != y.dtype or x.shape != y.shape:
            bad.append(k)
            continue
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            bad.append(k)
    return bad


def _memsys_stats(tm, sim, st):
    return {**tm.finish_stats(sim, st),
            "progress_ticks": int(st.stats.progress_ticks),
            "busy": st.stats.busy.cpu().tolist()}


def _timed_run(sim, st, until):
    """Wall time of one run on the card, with the block graph captured
    beforehand (a run to a horizon before the first event captures it and
    replays one block of no-op epochs)."""
    import torch
    sim.run(sim.copy_state(st), until=-1.0)
    st = sim.copy_state(st)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = sim.run(st, until=until)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _profile_block(sim, st0, mid):
    """What one live block costs: run to ``mid``, lift the horizon, then
    replay the block once and synchronise (as ``run`` does; the host's
    replay call timed apart), five times back to back (wall clock and
    CUDA events), and once under torch.profiler for the kernel count and
    the busy share: the union of the kernels' intervals over the span from
    the first kernel's start to the last one's end, both from that trace
    (the profiler stretches tiny kernels, so its busy time is not held
    against the unprofiled wall clock)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sim.run(sim.copy_state(st0), until=mid)
    g = sim.last_graph
    g.until.fill_(1e6)
    torch.cuda.synchronize()
    t = time.perf_counter()
    g.graph.replay()
    launch = (time.perf_counter() - t) * 1e6
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e6
    # back to back, with no read of ``live`` between them: the host's
    # launch of one replay overlaps the device's run of the one before
    reps = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    for _ in range(reps):
        g.graph.replay()
    end.record()
    end.synchronize()
    b2b = (time.perf_counter() - t) * 1e6 / reps
    b2b_dev = start.elapsed_time(end) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        g.graph.replay()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        raise AssertionError("torch.profiler saw no kernel in a block "
                             "graph replay")
    busy, end_t = 0.0, float("-inf")
    for e in sorted(kern, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, end_t), e.time_range.end
        busy += max(0.0, hi - lo)
        end_t = max(end_t, hi)
    span = end_t - min(e.time_range.start for e in kern)
    return dict(kernels=len(kern), busy_us=busy, span_us=span,
                wall_us=wall, launch_us=launch, b2b_wall_us=b2b,
                b2b_device_us=b2b_dev)


def check_engine():
    """Phase 5: the Akita engine and memsys on the card.  (a) the five
    patterns at 16 cores and 96 requests, Smart Ticking and naive, against
    MEMSYS_REF, with stat_err 0; idle_half's whole final state on the card
    against the port's CPU run and against an eager K=1 run on the card;
    (b) 64 cores and 256 requests a core, mixed, to completion."""
    import numpy as np
    import torch
    from repro_torch.sims import memsys as tm

    t_phase = time.perf_counter()
    rec = {"patterns": {}}
    keep = {}
    for pattern in MEMSYS_PATTERNS:
        ref = MEMSYS_REF[pattern]
        kw = dict(n_cores=16, pattern=pattern, n_reqs=96)
        sim, st0 = tm.build(**kw)
        first = sim.run(sim.copy_state(st0), until=100000.0)
        horizon = float(np.ceil(tm.finish_stats(sim, first)["virtual_time"])) \
            + 2
        if horizon != ref["horizon"]:
            raise AssertionError(f"memsys {pattern}: horizon {horizon}, "
                                 f"want {ref['horizon']}")
        smart, dt_s = _timed_run(sim, st0, horizon)
        simn, stn = tm.build(naive=True, **kw)
        naive, dt_n = _timed_run(simn, stn, horizon)
        got = {"smart": _memsys_stats(tm, sim, smart),
               "naive": _memsys_stats(tm, simn, naive)}
        for mode in ("smart", "naive"):
            if got[mode] != ref[mode]:
                raise AssertionError(f"memsys {pattern} {mode}: "
                                     f"{got[mode]} != MEMSYS_REF "
                                     f"{ref[mode]}")
        err = 0.0
        for k in ("reads_done", "hits", "misses", "delivered"):
            if got["naive"][k]:
                err = max(err, abs(got["smart"][k] - got["naive"][k])
                          / got["naive"][k])
        if err != 0.0:
            raise AssertionError(f"memsys {pattern}: stat_err {err}")
        rec["patterns"][pattern] = dict(
            smart_s=dt_s, naive_s=dt_n, speedup=dt_n / dt_s,
            epochs=[got["smart"]["epochs"], got["naive"]["epochs"]],
            stat_err=err)
        log(f"memsys {pattern} 16 cores x 96 requests: smart "
            f"{got['smart']['epochs']} epochs in {dt_s:.3f} s, naive "
            f"{got['naive']['epochs']} epochs in {dt_n:.3f} s, speedup "
            f"{dt_n / dt_s:.2f}x, stat_err {err}; MEMSYS_REF matched")
        if pattern == "idle_half":
            keep = dict(sim=sim, st0=st0, smart=smart, horizon=horizon)

    # idle_half, Smart Ticking: the card's state against the port's CPU
    # run and against an eager K=1 run of the same block on the card
    kw = dict(n_cores=16, pattern="idle_half", n_reqs=96)
    sim_c, st_c = tm.build(device="cpu", **kw)
    t = time.perf_counter()
    cpu = sim_c.run(st_c, until=keep["horizon"])
    dt_cpu = time.perf_counter() - t
    bad = _state_diff(keep["smart"], cpu)
    if bad:
        raise AssertionError(f"idle_half: card and CPU states differ at "
                             f"{bad}")
    # the eager K=1 run launches every op from Python, so it stops at a
    # mid-run horizon, where the graph's run ends inside a block
    mid = MEMSYS_EAGER_UNTIL
    graph_mid = keep["sim"].run(keep["sim"].copy_state(keep["st0"]),
                                until=mid)
    sim_e, st_e = tm.build(super_epoch=1, cuda_graph=False, **kw)
    torch.cuda.synchronize()
    t = time.perf_counter()
    eager = sim_e.run(st_e, until=mid)
    torch.cuda.synchronize()
    dt_eager = time.perf_counter() - t
    bad = _state_diff(graph_mid, eager)
    if bad:
        raise AssertionError(f"idle_half: graph (K={keep['sim'].super_epoch})"
                             f" and eager K=1 states differ at {bad}")
    n_leaves = len(_leaves(cpu))
    log(f"idle_half smart: the card's final state (graph, K="
        f"{keep['sim'].super_epoch}) equals the port's CPU run "
        f"({dt_cpu:.3f} s), all {n_leaves} leaves, f32 by bits; at "
        f"until={mid} ({int(eager.stats.epochs)} epochs) the graph's state "
        f"equals an eager K=1 run on the card ({dt_eager:.3f} s)")
    rec.update(idle_half_cpu_s=dt_cpu, idle_half_eager_k1_s=dt_eager,
               eager_until=mid, card_equals_cpu=True,
               graph_equals_eager=True)

    # (b) full width
    ref64 = MEMSYS64
    sim, st0 = tm.build(n_cores=ref64["n_cores"], pattern=ref64["pattern"],
                        n_reqs=ref64["n_reqs"])
    t = time.perf_counter()
    sim.run(sim.copy_state(st0), until=-1.0)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    out, wall = _timed_run(sim, st0, 1e6)
    s64 = tm.finish_stats(sim, out)
    if (s64["epochs"], s64["virtual_time"], s64["remaining"],
            s64["outstanding"]) != (ref64["epochs"], ref64["virtual_time"],
                                    0, 0):
        raise AssertionError(f"memsys 64 cores: {s64}, want epochs "
                             f"{ref64['epochs']} and virtual time "
                             f"{ref64['virtual_time']}, all drained")
    blk = _profile_block(sim, st0, 5000.0)
    K, n_kern = sim.super_epoch, blk["kernels"]
    rec["full_width"] = dict(
        n_cores=ref64["n_cores"], n_reqs=ref64["n_reqs"], K=K,
        epochs=s64["epochs"], virtual_time=s64["virtual_time"],
        wall_s=wall, capture_s=capture_s,
        epochs_per_s=s64["epochs"] / wall,
        cycles_per_s=s64["virtual_time"] / wall,
        kernels_per_block=n_kern, kernels_per_epoch=n_kern / K,
        busy_share=blk["busy_us"] / blk["span_us"],
        **{f"block_{k}": v for k, v in blk.items() if k != "kernels"})
    log(f"memsys 64 cores x 256 requests, mixed, Smart Ticking: "
        f"{s64['epochs']} epochs, virtual time {s64['virtual_time']} in "
        f"{wall:.3f} s ({s64['epochs'] / wall:.1f} epochs/s, "
        f"{s64['virtual_time'] / wall:.1f} simulated cycles/s; capture "
        f"{capture_s:.3f} s)")
    log(f"one block of K={K}: {n_kern} kernels ({n_kern / K:.2f} per "
        f"epoch); replay then sync {blk['wall_us']:.1f} us, of which the "
        f"host's replay call {blk['launch_us']:.1f} us; back to back "
        f"{blk['b2b_wall_us']:.1f} us a block (CUDA events "
        f"{blk['b2b_device_us']:.1f} us); profiled, device busy "
        f"{blk['busy_us']:.1f} us of a {blk['span_us']:.1f} us span "
        f"({100 * blk['busy_us'] / blk['span_us']:.1f}%)")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 5 (engine) took {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------
def _card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _dse_points(b):
    """benchmarks/dse_throughput.py's ``_points``: b design points spreading
    crossbar latency and L1 boost."""
    return [{"conn_latency[-1]": 10.0 + (30.0 * i) / max(b - 1, 1),
             "kind.l1.extra_hit_rate": 0.8 * ((i * 7) % b) / max(b - 1, 1)}
            for i in range(b)]


def _dse_untils(b, top):
    """benchmarks/dse_throughput.py's ``_mixed_untils`` with its top
    horizon set to ``top``: per-lane horizons spread 8x."""
    import numpy as np
    lo = top / 8
    mix = (np.arange(b) * 11) % b
    return (lo + (top - lo) * mix / max(b - 1, 1)).astype(np.float32)


def _check_rows(name, rows, ref):
    """Rows against a SWEEP_REF entry; on a mismatch, print the sampled
    rows' differences and fail."""
    import hashlib
    digest = hashlib.sha256(json.dumps(rows, sort_keys=True, separators=(
        ",", ":")).encode()).hexdigest()
    sums = {c: sum(r[c] for r in rows) for c in DSE_ROW}
    if (len(rows), digest, sums) == (ref["n"], ref["sha256"], ref["sums"]):
        return
    cols = ref["axes"] + DSE_ROW
    for i, want in ref["sample"].items():
        got = tuple(rows[i].get(c) for c in cols) if i < len(rows) else None
        if got != want:
            log(f"{name} row {i}: " + ", ".join(
                f"{c} {g!r} != {w!r}" for c, g, w in
                zip(cols, got or (None,) * len(cols), want) if g != w))
    raise AssertionError(f"{name}: {len(rows)} rows, sha256 {digest}, sums "
                         f"{sums}; SWEEP_REF has {ref['n']}, "
                         f"{ref['sha256']}, {ref['sums']}")


def _timed_sweep(name, card, runner, warm, sweep):
    """Warm the ladder (its captures timed apart), then time one sweep
    on the host's clock, ending in a device sync."""
    import torch
    tc0 = runner.trace_count
    t = time.perf_counter()
    warm()
    torch.cuda.synchronize()
    cap_s, caps = time.perf_counter() - t, runner.trace_count - tc0
    tc0 = runner.trace_count
    runner.last_rounds = None
    t = time.perf_counter()
    out = sweep()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    rows = out[0] if isinstance(out, tuple) else out
    lr = runner.last_rounds or {}
    rec = dict(points=len(rows), wall_s=wall,
               configs_per_s=len(rows) / wall,
               rounds=lr.get("rounds"), chunk=lr.get("chunk"),
               quantum=lr.get("quantum"), pipeline=lr.get("pipeline"),
               overlap_frac=lr.get("overlap_frac"),
               captures=caps, capture_s=cap_s,
               captures_in_sweep=runner.trace_count - tc0,
               epochs=sum(r["epochs"] for r in rows),
               slowest_lane_epochs=max(r["epochs"] for r in rows))
    if rec["captures_in_sweep"]:
        raise AssertionError(f"{name}: {rec['captures_in_sweep']} captures "
                             "inside the timed sweep after warm_ladder")
    log(f"[{card}] {name}: {len(rows)} points in {wall:.3f} s "
        f"({rec['configs_per_s']:.2f} configs/s), {rec['rounds']} rounds, "
        f"chunk {rec['chunk']}, final quantum {rec['quantum']}, pipeline "
        f"{rec['pipeline']}, overlap_frac {rec['overlap_frac']}, "
        f"{rec['epochs']} lane-epochs (slowest lane "
        f"{rec['slowest_lane_epochs']}); ladder warmed first: {caps} "
        f"captures in {cap_s:.3f} s")
    return out, rec


def _lane_block_profile(sim, st, pts):
    """One lane-batched block at len(pts) lanes, lifted horizon: CUDA-event
    time of five back-to-back steps, and the kernels of one step under
    torch.profiler."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.dse import build_param_batch, stack_states
    b = len(pts)
    sb, pb = stack_states(st, b), build_param_batch(sim, pts)
    blk, _ = sim.lane_block(sb, pb)
    blk.load(sb, pb, np.full(b, 1e6, np.float32),
             np.full(b, 2_000_000, np.int32))
    blk.step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 5
    start.record()
    for _ in range(reps):
        blk.step()
    end.record()
    end.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        blk.step()
        torch.cuda.synchronize()
    n = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    K = sim.super_epoch
    return dict(lanes=b, block_ms=start.elapsed_time(end) / reps,
                epoch_ms=start.elapsed_time(end) / reps / K,
                kernels_per_epoch=n / K)


def check_dse():
    """Phase 6: the batched lanes (repro_torch.dse) on the card.  (a) 256
    points at memsys 16 cores x 96 requests, per-lane horizons, through
    run_sweep (autotuner and depth-2 pipeline), run_sweep(pipeline=False)
    and one monolithic run_batch: identical rows, equal to SWEEP_REF, and
    lanes 0, 85, 170 and 255 equal to single runs, whole states by bits;
    a block's time and kernels at 1 lane and at the top rung; 4 single
    runs as the sequential baseline.  (b) the shape.core family, 15 rows,
    against SWEEP_REF.  (c) 32 lanes at 64 cores x 256 requests, lane 0
    at the build's defaults equal to MEMSYS64."""
    import torch
    from repro_torch import dse
    from repro_torch.sims import memsys as tm

    card = _card()
    t_phase = time.perf_counter()
    rec = {"card": card}

    # (a) sweep-256
    sim, st = tm.build(n_cores=16, pattern="mixed", n_reqs=96)
    pts = _dse_points(256)
    u = _dse_untils(256, MEMSYS_REF["mixed"]["horizon"])
    spec = dse.SweepSpec.explicit(pts)
    build_fn = dse.memoize_build(lambda: (sim, st))
    runner = dse.runner_for(sim)
    pb = dse.build_param_batch(sim, pts)
    ladder = dse.make_ladder(len(pts))
    warm = lambda: runner.warm_ladder(st, pb, ladder)
    (rows_p, states), rec["rounds"] = _timed_sweep(
        "sweep-256 run_sweep (autotune, pipelined)", card, runner, warm,
        lambda: dse.run_sweep(build_fn, spec, until=u, return_states=True))
    rows_s, rec["rounds_unpipelined"] = _timed_sweep(
        "sweep-256 run_sweep(pipeline=False)", card, runner, warm,
        lambda: dse.run_sweep(build_fn, spec, until=u, pipeline=False))

    def mono():
        out = runner.run_batch(dse.stack_states(st, len(pts)), pb, u)
        rows = [dict(p, **r) for p, r in zip(
            pts, dse.extract_rows(sim, out, len(pts)))]
        return rows, out
    (rows_m, out_m), rec["monolithic"] = _timed_sweep(
        "sweep-256 one run_batch", card, runner, warm, mono)
    if not rows_p == rows_s == rows_m:
        raise AssertionError("sweep-256: pipelined rounds, unpipelined "
                             "rounds and run_batch give different rows")
    _check_rows("sweep-256", rows_m, SWEEP_REF["sweep256"])
    log(f"sweep-256: the three runs give identical rows, equal to "
        f"SWEEP_REF ({len(rows_m)} rows)")

    # lanes against single runs, which are also the sequential baseline
    base = sim.default_params()
    sim.run(sim.copy_state(st), until=-1.0,
            params=dse.apply_point(base, pts[0]))      # capture
    seq_s = 0.0
    for i in DSE_SAMPLED:
        p = dse.apply_point(base, pts[i])
        torch.cuda.synchronize()
        t = time.perf_counter()
        one = sim.run(sim.copy_state(st), until=float(u[i]), params=p)
        torch.cuda.synchronize()
        seq_s += time.perf_counter() - t
        for what, lane in (("run_batch", dse.lane(out_m, i)),
                           ("run_sweep", states.state(i))):
            bad = _state_diff(lane, one)
            if bad:
                raise AssertionError(f"sweep-256 lane {i} ({what}) and a "
                                     f"single run differ at {bad}")
    seq_rate = len(DSE_SAMPLED) / seq_s
    rec["sequential"] = dict(runs=len(DSE_SAMPLED), wall_s=seq_s,
                             configs_per_s=seq_rate)
    for k in ("rounds", "rounds_unpipelined", "monolithic"):
        rec[k]["batching_ratio"] = rec[k]["configs_per_s"] / seq_rate
    log(f"[{card}] sequential baseline: lanes {DSE_SAMPLED} as single runs "
        f"in {seq_s:.3f} s ({seq_rate:.3f} configs/s); each equals its "
        f"lane of run_batch and of run_sweep, whole state, f32 by bits; "
        f"batching ratio {rec['rounds']['batching_ratio']:.1f}x (pipelined "
        f"rounds), {rec['rounds_unpipelined']['batching_ratio']:.1f}x "
        f"(unpipelined), {rec['monolithic']['batching_ratio']:.1f}x "
        f"(run_batch)")
    top = rec["rounds"]["chunk"]
    rec["block"] = [_lane_block_profile(sim, st, pts[:b]) for b in (1, top)]
    for blk in rec["block"]:
        log(f"[{card}] one lane-batched block of K={sim.super_epoch} at "
            f"{blk['lanes']} lanes: {blk['block_ms']:.3f} ms (CUDA events, "
            f"{blk['epoch_ms']:.4f} ms an epoch), "
            f"{blk['kernels_per_epoch']:.2f} kernels an epoch")

    # (b) the topology family
    fam_fn = dse.memoize_build(lambda shape: tm.build_family(
        shape=shape, pattern="mixed", n_reqs=96))
    fam_spec = dse.SweepSpec.grid({"shape.core": [1, 2, 4, 8, 16],
                                   "kind.l1.extra_hit_rate": [0.0, 0.4,
                                                              0.8]})
    fam = fam_fn(shape={"core": 16})
    fam_runner = dse.runner_for(fam.sim)
    rows_f, rec["family"] = _timed_sweep(
        "family shape.core x extra_hit_rate", card, fam_runner,
        lambda: fam_runner.warm_ladder(
            [fam.state_for()], dse.stack_params([fam.params_for()]),
            dse.make_ladder(len(fam_spec))),
        lambda: dse.run_sweep(fam_fn, fam_spec, until=100000.0))
    _check_rows("family", rows_f, SWEEP_REF["family"])
    log(f"family: {len(rows_f)} rows equal to SWEEP_REF")

    # (c) 64 cores x 256 requests, 32 lanes
    ref64 = MEMSYS64
    sim64, st64 = tm.build(n_cores=ref64["n_cores"], pattern=ref64["pattern"],
                           n_reqs=ref64["n_reqs"])
    pts64 = [{"conn_latency[-1]": 30.0}] + [
        {"conn_latency[-1]": 10.0 + 30.0 * i / 31} for i in range(1, 32)]
    runner64 = dse.runner_for(sim64)
    pb64 = dse.build_param_batch(sim64, pts64)
    rows64, rec["full_width"] = _timed_sweep(
        "64 cores x 256 requests, 32 lanes", card, runner64,
        lambda: runner64.warm_ladder(st64, pb64,
                                     dse.make_ladder(len(pts64))),
        lambda: dse.run_sweep(dse.memoize_build(lambda: (sim64, st64)),
                              dse.SweepSpec.explicit(pts64), until=1e6))
    got = (rows64[0]["epochs"], rows64[0]["virtual_time"])
    if got != (ref64["epochs"], ref64["virtual_time"]):
        raise AssertionError(f"64 cores, lane 0 (the build's defaults): "
                             f"epochs and virtual time {got}, want "
                             f"MEMSYS64's {ref64['epochs']} and "
                             f"{ref64['virtual_time']}")
    log(f"64 cores: lane 0 equals MEMSYS64 ({got[0]} epochs, virtual time "
        f"{got[1]})")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[{card}] phase 6 (dse) took {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print(f"chip_smoke: repro_torch not found under {ROOT / 'src'}",
              file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    if sys.argv[1:] == ["--engine"]:
        # phase 5 alone, after the card line
        log(_card())
        print(json.dumps({"engine": check_engine()}), flush=True)
        return 0
    if sys.argv[1:] == ["--dse"]:
        # phase 6 alone, after the card line
        log(_card())
        print(json.dumps({"dse": check_dse()}), flush=True)
        return 0
    setup()
    gen = torch.Generator(device=dev).manual_seed(0)
    fa = check_flash(dev, gen)
    sd = check_ssd(dev, gen)
    f32_launches = check_small_model(dev)
    launches, model = serve_hymba(dev)
    _profile(model)
    del model
    engine = check_engine()
    dse = check_dse()

    fa_src = "src/repro/kernels/flash_attention/kernel.py:25"
    ssd_src = "src/repro/kernels/ssd/kernel.py:23"
    kernels = [
        dict(name="flash_attention_tc", route="cuda",
             source="src/repro_torch/csrc/flash_attention_tc.cu",
             replaces=fa_src, launches=launches["flash_attention"],
             **fa["bfloat16"]),
        dict(name="ssd_tc", route="cuda",
             source="src/repro_torch/csrc/ssd_tc.cu", replaces=ssd_src,
             launches=launches["ssd"], **sd["bfloat16"]),
        dict(name="flash_attention_f32", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces=fa_src, launches=f32_launches["flash_attention"],
             **fa["float32"]),
        dict(name="ssd_f32", route="cuda",
             source="src/repro_torch/csrc/ssd.cu", replaces=ssd_src,
             launches=f32_launches["ssd"], **sd["float32"]),
    ]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"engine": engine}))
    print(json.dumps({"dse": dse}))
    print(json.dumps({"kernels": [{k: kr[k] for k in keys}
                                  for kr in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
