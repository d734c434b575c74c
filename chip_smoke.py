#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

  python3 chip_smoke.py              # needs one CUDA card

Phases (each raises on failure, and the run then exits non-zero):
  1. setup: card name and power limit, build every CUDA kernel from the
     sources in the checkout (one nvcc per source, all at once, with each
     kernel's registers and spills from ptxas), the count of TF32 tensor-core
     instructions in each f32 library (``cuobjdump -sass``; none fails the
     run), TF32 off for PyTorch's own matmuls;
  2. kernels: each kernel against its plain PyTorch version on the card,
     in bf16 (wgmma) and f32 (three TF32 passes of mma.sync), at
     hymba-1.5b's prefill shapes (ragged S, S > window, and S=2048 for
     SSD) and its training shape (B=2 x S=2048, flash at the window and
     the global one), at mamba2-130m's SSD widths (where the f32 kernel is
     also held against an f64 recurrence), at the JAX package's
     kernel-test cases and at the edges of what the kernels accept, with
     the tolerances of those tests; the bf16 kernels' tiling edges (S not
     a multiple of a tile, S below one, B > 1 with GQA groups of 5 and 2,
     q, k and v as views of one fused projection, as views TMA cannot
     read and as B=1 views whose batch stride is no multiple of 8), the C
     launcher's plan against ``kernel.plan``, and one SSD call's output
     fed straight into the next; kernel, plain and library times beside
     each bound; the bf16 backward kernel (``fa_tc_bwd``) at FA_BWD_CASES:
     the log-sum-exp its forward saves, then dq, dk and dv against the
     plain backward and autograd of the plain forward, and its times at
     hymba's two training shapes beside its bound, the plain backward's
     and SDPA's backward;
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
  7. models: the rest of the model path (MoE, MLA, the dense layer 0, the
     audio and vision frontends, ring-buffer decode) at full width.  (a)
     flash at head dim 80 (hubert-xlarge's prefill, and a causal case with
     window and softcap), with kernel, plain and SDPA times, and at the
     prefill shape of every full-width arch that launches it (S=384 with
     its heads, key groups, windows and softcap: gemma2, grok-1,
     deepseek-67b, phi3-medium, internvl2), both kernels against the
     plain version; (b) one MoE layer at deepseek-v2's
     widths (160 experts, top-6, 2 shared), f32, 256 tokens on the group
     path, against the dense oracle; (c) one MLA layer at its widths, f32,
     absorbed decode against the materialised form; (d) each new arch's
     smoke config in f32, card against CPU (phi3-medium's head dim 12 runs
     padded to 16); (e) the main path: deepseek-v2-236b at full width, 6 of 60 layers (42.5
     GB bf16), served by ``ServeEngine`` like hymba in phase 3, with no
     flash launch (MLA attends in plain PyTorch) and a profiler split by
     group; (f) gemma2-27b whole (46 layers, 38.8 GB), served the same
     way, 46 flash launches a prefill, softcap 50 in each; (g) one prefill
     of grok-1 (2 layers), deepseek-67b, phi3-medium and internvl2 (4
     each; internvl2 with 256 vision tokens and then 4 decode steps) and
     hubert-xlarge whole (48 layers, 2 clips of 500 frames), flash launches
     = attention layers; (h) hymba-1.5b at full width, 4 layers, f32:
     1100 teacher-forced positions of ring-buffer decode against the
     uniform decode, within 1e-4 of max |logits| at every step.
  8. sims: the remaining simulators and the tracing layer, on the engine
     and the lanes of phases 5-6 (no hand-written kernel either).  (a)
     Onira's microbenchmarks and MLP sweep against ONIRA_REF, each CPI
     beside ``analytic_cpi``, the final state against the port's CPU run;
     (b) 256 points of taken-branch flush x memory latency through
     run_sweep (pipelined and not) and one run_batch, identical rows equal
     to ONIRA_SWEEP_REF, four lanes equal to single runs, then the
     ``shape.cpu`` family; (c) TrioSim's five 4-GPU plans and
     phi3-medium-14b whole on 16 GPUs (a network kind of 16 ports)
     against TRIOSIM_REF, each final state against the port's CPU run
     (computed by a child process while the card works); (d) the
     translation chain, the page fault's Fig. 6b backtrace and 1024
     seeded loads against XLAT_REF; (e) memsys under
     ``Monitor.run_monitored`` with a thread polling its HTTP endpoint
     (MONITOR_REF), the engine trace into a DBTracer and Daisen HTML
     under build/sims/, and (b)'s sweep again with a JsonlSink on the bus
     (identical rows) and its Chrome trace.
  9. search: closed-loop search, the lane multiplexer and checkpoints
     (``repro_torch.dse.search``, ``dse.mux``, ``ckpt``), on the lanes of
     phase 6 (no hand-written kernel either: the search, the BO surrogate,
     the routing and the checkpoint I/O are host code).  (a)
     benchmarks/search_convergence.py's exhaustive 192-point sweep and its
     seeded successive halving at memsys 8 cores x 24 requests against
     SEARCH_REF, a rung checkpoint after round 2 (``save_search``, under
     build/search/) resumed by ``load_search`` + ``adopt_handles`` to the
     identical rows, best and budget, and a repeat search that captures
     nothing; (b) the same search at 64 cores x 256 requests over 27
     points against SEARCH64_REF; (c) BatchBO (qei, ts) and RandomSearch
     against BO_REF; (d) a LaneMux of (a)'s grid and 32 points of phase
     6's 16-core build, each job's rows equal to its solo run_sweep, no
     capture over the solo runs; (e) CheckpointManager: async saves of
     (b)'s 64-core state and a small bf16/int64/non-finite tree, keep=2
     over 3 saves, restored onto the card bit for bit.
  10. train: training through the port's entry points (the forward of
     both kernels runs inside ``FlashAttentionFn`` and ``SSDFn``; flash's
     bf16 backward is the backward kernel, and the other backwards
     recompute the plain version, as the JAX package differentiates its
     XLA path).  (a) Both Functions' gradients
     against autograd of the plain versions at hymba's shapes (S=256, and
     S=2048 where the window of 1024 acts), bf16 and f32, at the kernel
     tests' tolerances of each gradient's max; (b) one f32
     ``make_train_step`` of hymba-1.5b-smoke and stablelm-1.6b-smoke on
     the card against the CPU (loss, gnorm, gradients within 1e-4 of the
     largest; updated parameters within 2 lr, AdamW's first step being a
     sign); (c) 20 steps against 10 + a resume to 20, bit for bit; (d) the
     main path: ``repro_torch.train.loop.train`` on hymba-1.5b whole, bf16,
     6 steps of B=2 x S=2048, f32 moments, block remat: finite, falling
     loss, exactly 64 flash and 64 SSD launches a step (forward and
     recompute) and 32 of flash's backward kernel, step ms, tokens/s,
     peak memory, the final checkpoint's bytes and seconds, a profiled
     step, each kernel's forward against its Function's backward; (e)
     ``python -m repro_torch.launch.train`` on the card; (f) suspect S1
     (ROADMAP queue 3): (e)'s run of hymba-smoke in bf16 from parameters
     drawn on the CPU, on the card and on the CPU, both loss curves
     within a bf16 ulp of the loss a step.
  11. scale-out: transparent parallel simulation and the campaign cache
     (``repro_torch.core.pdes``, ``dse`` ``shard=``, ``dse.cache``) on a
     mesh naming cuda:0 up to 8 times (``REPRO_TORCH_FORCE_DEVICES``; no
     kernel: the reference's ``pmin`` and ``ppermute`` are a min and a
     roll over the shard axis).  (a) build_sharded_memsys at 1, 2, 4 and
     8 shards (2 tiles x 8 requests, until 3000), 4 shards with the
     writers skewed, and 4 at the builder's defaults: window count, time,
     stats and every leaf equal to PDES_REF (the JAX package's, one
     forced host device a shard) and the whole state to the port's CPU
     run, by bits; (b) 8 shards x 16 tiles x 96 requests (128 cores) to
     completion against PDES_REF, with wall s, windows/s, cycles/s, the
     exchange's share of the wall and one profiled window's kernels and
     busy share; (c) phase 6's 256 points at shard=2 and 4, pipelined
     and not, rows identical to shard=False and equal to SWEEP_REF, one
     run_batch of 255 points padded to 256, lanes moved by the global
     rebalance, configs/s of each; (d) phase 6's first 64 points (8x
     shorter horizons) at shard=2 in two child processes sharing a fresh
     REPRO_CACHE_DIR (started beside (a), released one after the other):
     the second probes nothing, makes every rung before its first round,
     same rows.
  12. dry run: ``repro_torch.launch.dryrun`` on the card's machine (no
     kernel and no allocation: every step is traced on ``meta``).  (a)
     hymba-1.5b's training cell at phase 10 (d)'s B=2 x S=2048, f32
     moments, block remat, on a 1x1 mesh: planned argument bytes equal to
     the bytes phase 10 (d) hands its step, exactly; the planned temp
     beside the measured peak and the planned bound beside the measured
     step; (b) ``run_cell`` for deepseek-v2-236b x decode_32k on 16x16,
     argument bytes equal to the JAX package's (DRYRUN_DSV2_ARGS); (c)
     ``run_sim_cell`` on 8 placements of cuda:0 against DRYRUN_SIM_REF
     (the JAX package's compiled sim cell on 8 host devices).
To fit phase 11, the whole script runs the naive engine of phase 5 (a)
on idle_half and mixed only (the other three patterns give mixed's
results), phase 6 (a) as its pipelined sweep alone (phase 11 (c) holds
the same rows through unpipelined sweeps and a padded run_batch), phase
6 (c) at 64 requests a core (lane 0 against MEMSYS64_TRIMMED, the JAX
package's row at that size), and phase 10 (e)'s subprocess beside phase 11 (a);
``--engine`` and ``--dse`` run them whole.
Then the engine's, the DSE path's, the models', the sims', the search's,
the training's, the scale-out's and the dry run's JSON records, the
kernels' JSON record (the line before the last; the launches add phase
7's model runs and phase 10's training to phase 3's), and ``{"ok": true,
"device": {...}}`` as the last line.  ``python3 chip_smoke.py --kernels`` runs
phases 1 and 2 alone, ``--engine`` phase 5, ``--dse`` phase 6, ``--models`` phases 1 and 7, ``--sims`` phase
8, ``--search`` phase 9, ``--train`` phases 1 and 10, ``--scale`` phase
11, ``--dryrun`` phase 12; ``--times [ROOT ...]`` times the kernels of
both dtypes at TIMED_FA and TIMED_SSD, of this checkout or of each
checkout named in turn (``compare_times``).
Imports nothing of JAX.
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
# dense peak rates (data sheet) of the units each dtype's kernels run on:
# bf16 on the tensor cores; f32 as three TF32 passes on the tensor cores
# (494.7 TF32 TFLOP/s over 3).  The f32 rows also state the bound at the
# CUDA cores' f32 rate (``cuda_core_bound``)
PEAK_OPS_PER_S = {"bfloat16": 989e12,
                  "float32": 494.7e12 / 3}
CUDA_CORE_F32_OPS_PER_S = 67e12
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
# the bf16 kernels' tiling (64-key tiles; blocks of 128 (position, head)
# rows; 64-row SSD tiles): S not a multiple of a tile, S below one tile,
# B > 1 with GQA groups of 5 (hymba) and 2 (gemma2); bf16 only
FA_TILE_EDGE = [  # B, S, H, KV, hd, causal, window, cap
    (1, 1030, 25, 5, 64, True, 1024, 0.0),
    (1, 37, 25, 5, 64, True, 0, 0.0),
    (2, 300, 25, 5, 64, True, 1024, 0.0),
    (2, 384, 32, 16, 128, True, 4096, 50.0),
]
# the bf16 backward kernel (fa_tc_bwd): hymba's two training shapes at the
# window and the global layers' full length (timed: ``FA_BWD_TIMED``),
# phi3's 40/10 heads of 128, hubert's hd 80 and hd 72 padded to it,
# softcap (gemma2's 50 at hd 128, 30 and 20 below), non-causal with and
# without a (one-sided) window, ragged S and S below one tile; bf16 only
FA_BWD_CASES = [  # B, S, H, KV, hd, causal, window, cap
    (4, 2048, 25, 5, 64, True, 1024, 0.0),
    (4, 2048, 25, 5, 64, True, 0, 0.0),
    (1, 8192, 25, 5, 64, True, 1024, 0.0),
    (1, 8192, 25, 5, 64, True, 0, 0.0),
    (1, 1024, 40, 10, 128, True, 0, 0.0),
    (2, 500, 16, 16, 80, False, 0, 0.0),
    (1, 700, 8, 2, 72, True, 256, 30.0),
    (2, 384, 32, 16, 128, True, 4096, 50.0),
    (1, 1030, 25, 5, 64, True, 1024, 0.0),
    (1, 37, 25, 5, 64, False, 0, 0.0),
    (2, 300, 4, 1, 32, False, 64, 0.0),
    (1, 200, 4, 2, 16, True, 0, 20.0),
]
FA_BWD_TIMED = FA_BWD_CASES[:4]
# The backward kernel's dq, dk and dv are held against the plain backward
# (the same algebra in f32, ``flash_attention_bwd_ref``) and against
# autograd of the plain forward within the kernel tests' bf16 tolerance of
# each gradient's largest |ref| (``_held_grads``).  Its reasons: the
# operands of every product are bf16 (P and dS rounded before dV, dK and
# dQ), the f32 sums run in another order, and dQ's sum is made by atomic
# adds whose order changes from run to run.  The log-sum-exp it saves is
# held to the plain one within FA_LSE_TOL (absolute, in units of the
# score): f32 from the same bf16 inputs, exp2 and log2 on the
# special-function unit.
FA_LSE_TOL = 1e-3
SSD_TILE_EDGE = [  # B, S, H, P, N, chunk
    (1, 1030, 50, 64, 16, 128),
    (1, 20, 50, 64, 16, 128),
    (2, 300, 50, 64, 16, 128),
]
# (B, S, H, P, N, chunk) at mamba2-130m's widths
MAMBA2_SSD = (1, 512, 24, 64, 128, 256)
# the kernels' timed shapes (``--times``, both dtypes): hymba's S=256 and
# S=1536 prompts (window 1024), hubert's hd 80 and the training shape at both
# windows; SSD at hymba's S=256, S=2048 and training shapes, mamba2-130m's
TIMED_FA = [(1, 256, 25, 5, 64, True, 1024, 0.0),
            (1, 1536, 25, 5, 64, True, 1024, 0.0),
            (2, 500, 16, 16, 80, False, 0, 0.0),
            (2, 2048, 25, 5, 64, True, 1024, 0.0),
            (2, 2048, 25, 5, 64, True, 0, 0.0)]
TIMED_SSD = [(1, 256, 50, 64, 16, 128), (1, 2048, 50, 64, 16, 128),
             (2, 2048, 50, 64, 16, 128), MAMBA2_SSD]
PROMPT_LENS = (256, 200, 384, 130, 64)
MAX_NEW = 32

# phase 7: the rest of the model path, at full width.  Flash at head dim
# 80: hubert-xlarge's prefill (2 clips of 500 frames, 16 heads, no mask),
# and a causal case with a window and softcap
FA80_CASES = [  # B, S, H, KV, hd, causal, window, cap
    (2, 500, 16, 16, 80, False, 0, 0.0),
    (1, 700, 8, 2, 80, True, 256, 30.0),
]
# (a) also holds both kernels at each arch's full-width prefill shape:
# B=1, S=384 (the longest prompt phase 7 serves), one case per window
FA_ARCHS = ("gemma2-27b", "grok-1-314b", "deepseek-67b", "phi3-medium-14b",
            "internvl2-26b")
FA_ARCH_S = 384
MODELS_SMOKE = ("deepseek-67b", "gemma2-27b", "phi3-medium-14b",
                "hubert-xlarge", "deepseek-v2-236b", "grok-1-314b",
                "internvl2-26b")
MAIN_LAYERS = 6   # deepseek-v2-236b: layer 0 dense + 5 MoE, 42.5 GB bf16
# (arch, layers or None for all): one prefill each at full width
PREFILL_ONLY = (("grok-1-314b", 2), ("deepseek-67b", 4),
                ("phi3-medium-14b", 4), ("internvl2-26b", 4),
                ("hubert-xlarge", None))
RING = dict(arch="hymba-1.5b", layers=4, positions=1100, cache=1152)

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
# the naive engine's patterns in the whole script (check_engine(trimmed));
# the other three give mixed's results on both engines
NAIVE_TRIMMED = ("idle_half", "mixed")
MEMSYS64 = dict(n_cores=64, n_reqs=256, pattern="mixed", epochs=38121,
                virtual_time=135940.0)
# the same build at 64 requests a core (phase 6 (c) in the whole script):
# the JAX package's row of one run on the CPU (tests/_shard_refs.py)
MEMSYS64_TRIMMED = dict(n_cores=64, n_reqs=64, pattern="mixed",
                        virtual_time=33988.0, epochs=9513, ticks=29889,
                        progress_ticks=16448, delivered=16384)

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

# phase 8: the remaining sims and the tracing layer.  Each constant is the
# JAX package's result on the CPU; CHANGES.md has the command that
# made them.  (a) benchmarks/onira_cpi.py: run_microbenches() (insts,
# cycles, done of each program, and the run's epochs and virtual time) and
# run_mlp_sweep() (CPI by independent loads).
ONIRA_REF = dict(
    micro={"ALU": (65, 64.0, True), "RAW_HZD": (65, 416.0, True),
           "BR_LOOP": (98, 127.0, True), "LOOP1": (98, 159.0, True),
           "NESTED_BR": (62, 91.0, True), "ST_LD": (49, 224.0, True),
           "CONC_ST": (33, 42.0, True), "IND_LD": (33, 88.0, True)},
    epochs=277, virtual_time=417.0,
    mlp={1: 6.117647058823529, 2: 3.393939393939394, 4: 1.9692307692307693,
         8: 1.7345132743362832, 16: 1.731958762886598})
# (b) the 8 microbenchmarks at mem_latency 5 swept over the taken-branch
# flush (kind.cpu.flush_cycles 1..8) x memory latency (conn_latency 1..32),
# and the shape.cpu family (1, 2, 4, 8 pipelines x flush 1, 3, 8); rows are
# DSE_ROW plus ONIRA_COLS (_onira_extract), as SWEEP_REF's
ONIRA_COLS = ("cycles", "insts")
ONIRA_SWEEP_REF = {
    "sweep256": dict(
        n=256,
        sha256="de7d6b0b1167fb294f276c5f5c2bd7f6"
               "9c7a73f6556c031b3bc72c35cbe1b24f",
        sums=dict(virtual_time=295831.0, epochs=99044, ticks=212312,
                  progress_ticks=176216, delivered=53248, cycles=675136.0,
                  insts=128768),
        axes=("kind.cpu.flush_cycles", "conn_latency"),
        sample={
            0: (1.0, 1.0, 161.0, 162, 748, 634, 208, 639.0, 503),
            1: (1.0, 2.0, 225.0, 198, 764, 635, 208, 749.0, 503),
            37: (2.0, 6.0, 481.0, 284, 838, 696, 208, 1266.0, 503),
            85: (3.0, 22.0, 1505.0, 436, 839, 696, 208, 3183.0, 503),
            128: (5.0, 1.0, 222.0, 199, 809, 695, 208, 883.0, 503),
            170: (6.0, 11.0, 801.0, 370, 839, 696, 208, 2090.0, 503),
            201: (7.0, 10.0, 737.0, 375, 839, 696, 208, 2035.0, 503),
            255: (8.0, 32.0, 2145.0, 502, 839, 696, 208, 4648.0, 503),
        }),
    "family": dict(
        n=12,
        sha256="aaea177322e24b101b417af917b17851"
               "d67fd13562d9313078b456f9519bae65",
        sums=dict(virtual_time=3948.0, epochs=2430, ticks=4726,
                  progress_ticks=3874, delivered=1008, cycles=7884.0,
                  insts=3072),
        axes=("shape.cpu", "kind.cpu.flush_cycles"),
        sample={
            0: (1, 1.0, 65.0, 66, 67, 65, 0, 64.0, 65),
            2: (1, 8.0, 65.0, 66, 67, 65, 0, 64.0, 65),
            4: (2, 3.0, 417.0, 202, 230, 162, 64, 480.0, 130),
            6: (4, 1.0, 417.0, 222, 430, 358, 64, 674.0, 326),
            8: (4, 8.0, 417.0, 292, 476, 404, 64, 996.0, 326),
            11: (8, 8.0, 417.0, 315, 838, 696, 208, 1516.0, 503),
        }),
}
# (c) simulate_step: benchmarks/triosim_validation.py's PLANS (stablelm-
# 1.6b, 24 layers, batch 16, seq 1024, micro 4), and phi3-medium-14b whole
# (40 layers), batch 16, seq 2048, micro 8 on 16 GPUs: (done, step_us,
# epochs) by (arch, layers or None for all, batch, seq, micro, dp, tp, pp)
TRIOSIM_REF = {
    ("stablelm-1.6b", 24, 16, 1024, 4, 4, 1, 1): (True, 580981.0, 24),
    ("stablelm-1.6b", 24, 16, 1024, 4, 1, 4, 1): (True, 441148.0, 66),
    ("stablelm-1.6b", 24, 16, 1024, 4, 1, 1, 4): (True, 761843.0, 174),
    ("stablelm-1.6b", 24, 16, 1024, 4, 2, 2, 1): (True, 485124.0, 72),
    ("stablelm-1.6b", 24, 16, 1024, 4, 1, 2, 2): (True, 549463.0, 142),
    ("phi3-medium-14b", None, 16, 2048, 8, 2, 4, 2): (True, 2853103.0, 338),
    ("phi3-medium-14b", None, 16, 2048, 8, 2, 2, 4): (True, 3450641.0, 610),
}
# (d) run_translation_study: the two-page chain of
# tests/sims/test_stdlib_components.py, and 1024 seeded loads over 256
# pages (XLAT_SEEDED_UNTIL; epochs from the same run)
XLAT_CHAIN = (8, 4096 + 8, 64, 4096 + 64, 128)
XLAT_SEEDED = dict(n=1024, pages=256, seed=0, until=1e6)
XLAT_REF = dict(
    chain=dict(translated=5, l1_hits=3, l1_misses=2, l2_hits=0, l2_misses=2,
               walks=2, virtual_time=65.0),
    seeded=dict(translated=1024, l1_hits=16, l1_misses=1008, l2_hits=49,
                l2_misses=959, walks=959, virtual_time=27077.0,
                epochs=8897))
# (e) memsys 16 cores x 96 requests (mixed), sample_period 100, under
# Monitor.run_monitored(until=20000, chunk=1000): finish_stats,
# progress_ticks, samples taken and their sum, chunks, hang flag
MONITOR_RUN = dict(n_cores=16, pattern="mixed", n_reqs=96,
                   sample_period=100.0, until=20000.0, chunk=1000.0)
MONITOR_REF = dict(virtual_time=20000.0, epochs=4099, ticks=11185,
                   delivered=6144, reads_done=1536, hits=0, misses=1536,
                   remaining=0, outstanding=0, progress_ticks=6160,
                   sample_idx=200, buf_samples_sum=950, chunks=20,
                   hung=False)


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


def bound(nbytes, ops, dtype_name, ops_per_s=None):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / (ops_per_s or PEAK_OPS_PER_S[dtype_name])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_core_bound(nbytes, ops, dtype_name):
    """For an f32 row: the bound at the CUDA cores' f32 rate, as text."""
    if dtype_name != "float32":
        return ""
    b_ms, b_by = bound(nbytes, ops, dtype_name, CUDA_CORE_F32_OPS_PER_S)
    return f", at the CUDA cores' 67 TFLOP/s {b_ms:.4f} ms ({b_by})"


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def compare(name, out, ref, dtype_name):
    import torch
    tol = TOL[name][dtype_name]
    out, ref = out.detach().float(), ref.detach().float()
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
    entry = re.compile(r"\d(fa_tc_fwd_lse|fa_tc_fwd|fa_tc_bwd_pre|"
                       r"fa_tc_bwd_post|fa_tc_bwd|fa_fwd|ssd_tc_fwd|ssd_fwd)"
                       r"(\w*)")
    for name, text in logs.items():
        kernel = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                m = entry.search(line)
                # template arguments: head dim or padded N, then split (the
                # backward's: softcap)
                targs = re.findall(r"L([ib])(\d+)E", m.group(2)) if m else []
                flags = (("no cap", "cap") if m and m.group(1) == "fa_tc_bwd"
                         else ("whole", "split"))
                kernel = (m.group(1) if m else "?") + (
                    "<" + ", ".join(v if t == "i" else flags[v == "1"]
                                    for t, v in targs) + ">" if targs else "")
            if ("registers" in line or "spill" in line
                    or "Performance" in line):
                log(f"  {name} {kernel}: {line.strip()}")
    check_tf32_sass()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN (f32 plain versions run in full f32)")


def check_tf32_sass():
    """Evidence that the f32 kernels run on the tensor cores: the TF32
    HMMA instructions (mma.sync .tf32) in ``cuobjdump -sass`` of each f32
    library as built; none fails the run."""
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in ("flash_attention", "ssd"):
        _build.load(name)
        sass = subprocess.run([tool, "-sass", str(_build.lib_path(name))],
                              capture_output=True, text=True, check=True)
        n = sum(1 for ln in sass.stdout.splitlines()
                if re.search(r"\bHMMA\.[\w.]*TF32", ln))
        log(f"  {name} (f32): {n} TF32 tensor-core instructions (HMMA) in "
            f"its SASS")
        if n == 0:
            raise AssertionError(f"{name}: no TF32 HMMA in its SASS; the f32 "
                                 f"kernel does not run on the tensor cores")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------
def _qkv(gen, dev, B, S, H, KV, hd, dtype):
    """Random q [B,S,H,hd] and k, v [B,S,KV,hd] in ``dtype``."""
    import torch
    return tuple(torch.randn((B, S, h, hd), generator=gen, device=dev)
                 .to(dtype) for h in (H, KV, KV))


def _attn_pairs(S, causal, window):
    """(q, k) pairs the masks keep at self-attention positions."""
    if not causal:
        return S * (S if window <= 0 else min(S, window))
    if window <= 0:
        return S * (S + 1) // 2
    return sum(min(q + 1, window) for q in range(S))


def _sdpa(q, k, v, S, window):
    """One SDPA call on the same causal, windowed GQA attention (the
    library yardstick; the port never calls it)."""
    import torch
    import torch.nn.functional as F
    G = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(G, dim=2).transpose(1, 2)
    if 0 < window < S:
        i = torch.arange(S, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=mask)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)


def _batch_stride_999(t):
    """A copy of ``t[0]`` as a [1, ...] view whose batch stride is 999."""
    c = t[0].contiguous()
    return c.as_strided((1, *c.shape), (999, *c.stride()))


def check_flash_tiles(dev, gen):
    """The bf16 kernel's tiling against the plain version: FA_TILE_EDGE,
    q, k and v as views of one fused projection and as B=1 views with a
    batch stride of 999 (TMA reads both in place) and as views TMA cannot
    read (copied, counted), and the plan that ``fa_forward_tc`` launches
    with equal to ``kernel.plan``."""
    import ctypes

    import torch
    from repro_torch.kernels import _build, _tma
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = _build.load("flash_attention_tc").fa_plan_tc
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bf = torch.bfloat16
    shapes = []
    for B, S, H, KV, hd, causal, window, cap in FA_TILE_EDGE:
        q, k, v = _qkv(gen, dev, B, S, H, KV, hd, bf)
        kw = dict(causal=causal, window=window, cap=cap)
        out = fak.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        e = compare("flash_attention", out, flash_attention_ref(q, k, v, **kw),
                    "bfloat16")
        shapes.append((B, S, H, KV))
        log(f"flash_attention fa_forward_tc tile-edge B={B} S={S} H={H} "
            f"KV={KV} hd={hd} causal={causal} window={window} cap={cap} "
            f"bfloat16: max_abs_err {e:.3g}, plan {fak.plan(B, S, H, KV, sms)}")
    # views of one fused projection [B, S, (H + 2 KV) hd]
    B, S, H, KV, hd = 2, 300, 25, 5, 64
    qkv = torch.randn((B, S, (H + 2 * KV) * hd), generator=gen,
                      device=dev).to(bf)
    views = (qkv[..., :H * hd].view(B, S, H, hd),
             qkv[..., H * hd:(H + KV) * hd].view(B, S, KV, hd),
             qkv[..., (H + KV) * hd:].view(B, S, KV, hd))
    # and views 2 bytes off a 16-byte boundary, which TMA cannot read
    raw = torch.randn((B, S, H + 2 * KV, hd + 1), generator=gen,
                      device=dev).to(bf)[..., 1:]
    odd = (raw[:, :, :H], raw[:, :, H:H + KV], raw[:, :, H + KV:])
    # and B=1 views whose batch stride (never stepped) is no multiple of 8:
    # read in place, as _tma.ready and tc::tma_ready both rule
    one = tuple(_batch_stride_999(t) for t in views)
    for tag, (q, k, v), copies in (("fused views", views, 0),
                                   ("unaligned views", odd, 3),
                                   ("size-1 batch stride 999 views", one, 0)):
        c0 = _tma.copies
        out = fak.flash_attention(q, k, v, window=128)
        torch.cuda.synchronize()
        e = compare("flash_attention", out,
                    flash_attention_ref(q, k, v, window=128), "bfloat16")
        if _tma.copies - c0 != copies:
            raise AssertionError(f"flash {tag}: {_tma.copies - c0} copies, "
                                 f"want {copies}")
        log(f"flash_attention fa_forward_tc {tag} of one projection "
            f"B={q.shape[0]} S={S} H={H} KV={KV} hd={hd} window=128 "
            f"bfloat16: max_abs_err {e:.3g}, {copies} operands copied for "
            f"TMA")
    # the C launcher's plan against kernel.plan at every shape here
    shapes += [(1, 256, 25, 5), (1, 200, 25, 5), (1, 1536, 25, 5),
               (2, 2048, 25, 5), (2, 500, 16, 16), (1, 384, 32, 16),
               (1, 384, 48, 8), (1, 384, 64, 8), (1, 384, 40, 10)]
    got = (ctypes.c_int * 4)()
    for B, S, H, KV in shapes:
        _build.check(fn(B, S, H, KV, got), "fa_plan_tc")
        want = fak.plan(B, S, H, KV, sms)
        if list(got) != [int(want["split"]), want["heads"],
                         want["positions"], want["blocks"]]:
            raise AssertionError(f"plan B={B} S={S} H={H} KV={KV}: C "
                                 f"{list(got)}, kernel.plan {want}")
    log(f"flash plan: fa_plan_tc equals kernel.plan at {len(shapes)} shapes "
        f"({sms} SMs)")


def check_flash(dev, gen):
    """Both kernels against the plain version at every case; times at
    hymba's shapes.  Returns the JSON record of each dtype's kernel, from
    the S=256, window 1024 case."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    # hymba-1.5b prefill: 25 query heads, 5 KV heads of 64
    hymba = [(1, S, 25, 5, 64, True, w, 0.0)
             for S in (256, 200) for w in (0, 1024)]
    hymba.append((1, 1536, 25, 5, 64, True, 1024, 0.0))
    # the training shape, B=2 x S=2048, at the window and the global one
    hymba += [(2, 2048, 25, 5, 64, True, w, 0.0) for w in (1024, 0)]
    err, rec = {}, {}
    for tag, cases in (("hymba", hymba), ("jax-case", FA_CASES),
                       ("edge", FA_EDGE)):
        for case in cases:
            B, S, H, KV, hd, causal, window, cap = case
            for dtype in (torch.bfloat16, torch.float32):
                dn = str(dtype).split(".")[1]
                q, k, v = _qkv(gen, dev, B, S, H, KV, hd, dtype)
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
                    lib = time_ms(_sdpa(q, k, v, S, window))
                    eager = eager_ms(lambda: fak.flash_attention(q, k, v,
                                                                 **kw))
                    ops = 4 * B * H * hd * _attn_pairs(S, causal, window)
                    b_ms, b_by = bound(nbytes(q, k, v, out), ops, dn)
                    line += (f", kernel {ms:.4f} ms (eager {eager:.4f}), "
                             f"plain {plain:.4f} ms, "
                             f"sdpa {lib:.4f} ms, bound {b_ms:.4f} ms "
                             f"({b_by}), share of bound {b_ms / ms:.3f}"
                             + cuda_core_bound(nbytes(q, k, v, out), ops,
                                               dn))
                    if S == 256 and window == 1024:
                        rec[dn] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                       bound_ms=b_ms, bound_by=b_by)
                log(line)
    check_flash_tiles(dev, gen)
    for dn in rec:
        rec[dn]["max_abs_err"] = err[dn]
    rec["bfloat16_bwd"] = check_flash_bwd(dev, gen)
    return rec


def _fa_bwd_bound(B, S, H, KV, hd, causal, window):
    """(ms, by) of one backward: 10 operations a kept pair, head dim and
    query head; q, out, dout and dq, k, v, dk and dv once at 2 bytes, the
    log-sum-exp at 4."""
    nb = 2 * (4 * B * S * H * hd + 4 * B * S * KV * hd) + 4 * B * H * S
    return bound(nb, 10 * B * H * hd * _attn_pairs(S, causal, window),
                 "bfloat16")


def check_flash_bwd(dev, gen):
    """The bf16 backward kernel at FA_BWD_CASES: the log-sum-exp that the
    forward saves against the plain one, then dq, dk and dv against the
    plain backward (``flash_attention_bwd_ref``, the same algebra in f32)
    and against autograd of the plain forward, within the kernel tests'
    bf16 tolerance of each gradient's largest value; dq of two runs
    compared (atomics).  At
    FA_BWD_TIMED: the kernel's time beside its bound, the plain backward
    (the plain forward recomputed and differentiated, the route the
    Function took before) and SDPA's backward, the library yardstick that
    the port never calls.  Returns the record of hymba's first case."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention.ref import (
        attention_lse_ref, flash_attention_bwd_ref, flash_attention_ref)

    bf = torch.bfloat16
    rec = {}
    worst = 0.0
    for case in FA_BWD_CASES:
        B, S, H, KV, hd, causal, window, cap = case
        q, k, v = _qkv(gen, dev, B, S, H, KV, hd, bf)
        g = torch.randn((B, S, H, hd), generator=gen, device=dev).to(bf)
        kw = dict(causal=causal, window=window, cap=cap)
        b0 = fak.bwd_launches
        out, lse = fak.flash_attention_lse(q, k, v, **kw)
        grads = fak.flash_attention_bwd(q, k, v, out, lse, g, **kw)
        again = fak.flash_attention_bwd(q, k, v, out, lse, g, **kw)
        torch.cuda.synchronize()
        if fak.bwd_launches - b0 != 2:
            raise AssertionError(f"flash backward {case}: "
                                 f"{fak.bwd_launches - b0} launches, want 2")
        eo = compare("flash_attention", out,
                     flash_attention_ref(q, k, v, **kw), "bfloat16")
        e_lse = float((lse - attention_lse_ref(q, k, **kw)).abs().max())
        if not e_lse <= FA_LSE_TOL:
            raise AssertionError(f"flash lse {case}: max abs err {e_lse}")
        plain = flash_attention_bwd_ref(q, k, v, out, lse, g, **kw)
        e_plain = _held_grads("flash_attention", grads, plain, "bfloat16",
                              "qkv")
        del plain
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        auto = torch.autograd.grad(flash_attention_ref(*leaves, **kw),
                                   leaves, g)
        e_auto = _held_grads("flash_attention", grads, auto, "bfloat16",
                             "qkv")
        del auto, leaves
        rerun = float((grads[0].float() - again[0].float()).abs().max())
        worst = max(worst, e_plain, e_auto)
        line = (f"flash_attention fa_backward_tc B={B} S={S} H={H} KV={KV} "
                f"hd={hd} causal={causal} window={window} cap={cap} "
                f"bfloat16: output max_abs_err {eo:.3g}, lse {e_lse:.3g}; "
                f"dq, dk, dv within {e_plain:.3g} (plain backward) and "
                f"{e_auto:.3g} (autograd) of their max; dq of two runs "
                f"differs by {rerun:.3g}")
        if case in FA_BWD_TIMED:
            r = _fa_bwd_times(q, k, v, out, lse, g, case)
            line += (f"; kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f}"
                     f" ms ({r['bound_by']}), share of bound "
                     f"{r['bound_ms'] / r['ms']:.3f}, plain backward "
                     f"{r['plain_ms']:.3f} ms, sdpa backward "
                     f"{r['library_ms']:.4f} ms")
            if not rec:
                rec = dict(r, shape=list(case))
        log(line)
        del q, k, v, g, out, lse, grads, again
        torch.cuda.empty_cache()
    rec["max_abs_err"] = worst
    return rec


def _fa_bwd_times(q, k, v, out, lse, g, case):
    """The backward kernel (a CUDA graph of 20 calls), the plain backward
    (eager, 3 calls) and SDPA's backward (eager, 5 calls: autograd's
    backward does not capture) at one case."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    B, S, H, KV, hd, causal, window, cap = case
    kw = dict(causal=causal, window=window, cap=cap)
    r = dict(ms=time_ms(lambda: fak.flash_attention_bwd(q, k, v, out, lse, g,
                                                        **kw)))
    r["bound_ms"], r["bound_by"] = _fa_bwd_bound(B, S, H, KV, hd, causal,
                                                 window)

    def plain():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        torch.autograd.grad(flash_attention_ref(*leaves, **kw), leaves, g)
    r["plain_ms"] = eager_ms(plain, reps=3)
    G = H // KV
    qh = q.transpose(1, 2).detach().requires_grad_()
    kh = k.repeat_interleave(G, dim=2).transpose(1, 2).detach() \
        .requires_grad_()
    vh = v.repeat_interleave(G, dim=2).transpose(1, 2).detach() \
        .requires_grad_()
    gh = g.transpose(1, 2)
    if 0 < window < S:
        i = torch.arange(S, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    else:
        o = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    r["library_ms"] = eager_ms(lambda: torch.autograd.grad(
        o, (qh, kh, vh), gh, retain_graph=True), reps=5)
    return r


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
    cases, the recurrence) at every case; both kernels' times at hymba's
    and mamba2-130m's shapes; one call's output fed straight into the next;
    B=1 operands with a batch stride of 999, read in place.
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
    hymba.append((2, 2048, 50, 64, 16, 128))     # the training shape
    err, rec = {}, {}
    for tag, cases in (("hymba", hymba), ("mamba2-130m", [MAMBA2_SSD]),
                       ("jax-case", SSD_CASES), ("edge", SSD_EDGE),
                       ("tile-edge", SSD_TILE_EDGE)):
        for case in cases:
            B, S, H, P, N, chunk = case
            for dtype in ((torch.bfloat16,) if tag == "tile-edge" else
                          (torch.bfloat16, torch.float32)):
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
                elif tag not in ("edge", "tile-edge"):
                    err[dn] = max(err.get(dn, 0.0), e)
                if tag == "mamba2-130m" and dtype == torch.float32:
                    line += _ssd_witness(args, y, hT, chunk)
                if tag in ("hymba", "mamba2-130m"):
                    ms = time_ms(lambda: ssdk.ssd(*args, chunk=chunk))
                    plain = time_ms(lambda: ssd_chunked(*args, chunk),
                                    reps=5)
                    eager = eager_ms(lambda: ssdk.ssd(*args, chunk=chunk))
                    ops = _ssd_ops(B, S, H, P, N, chunk)
                    b_ms, b_by = bound(nbytes(*args, y, hT), ops, dn)
                    line += (f", kernel {ms:.4f} ms (eager {eager:.4f}), "
                             f"plain {plain:.4f} ms, "
                             f"bound {b_ms:.4f} ms ({b_by}), share of bound "
                             f"{b_ms / ms:.3f}"
                             + cuda_core_bound(nbytes(*args, y, hT), ops, dn))
                    if tag == "hymba" and S == 256:
                        rec[dn] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                       bound_ms=b_ms, bound_by=b_by)
                log(line)

    # one call's output straight into the next, with nothing between: the
    # second call's kernel starts early and must still see the first's y
    B, S, H, P, N, chunk = hymba[2]
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

    # B=1 operands whose batch stride (never stepped) is no multiple of 8:
    # TMA reads them in place, as _tma.ready and tc::tma_ready both rule
    from repro_torch.kernels import _tma
    B, S, H, P, N, chunk = hymba[0]
    xs, dt, A, B_, C_ = mk(B, S, H, P, N, torch.bfloat16)
    xs, B_, C_ = (_batch_stride_999(t) for t in (xs, B_, C_))
    c0 = _tma.copies
    y, hT = ssdk.ssd(xs, dt, A, B_, C_, chunk=chunk)
    torch.cuda.synchronize()
    y_ref, h_ref = ssd_chunked(xs, dt, A, B_, C_, chunk)
    e = max(compare("ssd", y, y_ref, "bfloat16"),
            compare("ssd", hT, h_ref, "bfloat16"))
    if _tma.copies != c0:
        raise AssertionError(f"ssd size-1 batch stride views: "
                             f"{_tma.copies - c0} copies, want 0")
    log(f"ssd ssd_forward_tc size-1 batch stride 999 views B={B} S={S} "
        f"H={H} P={P} N={N} chunk={chunk} bfloat16: max_abs_err {e:.3g}, 0 "
        f"operands copied for TMA")
    for dn in rec:
        rec[dn]["max_abs_err"] = err[dn]
    return rec


def kernel_times():
    """The kernels' device times (``time_ms``) at TIMED_FA and TIMED_SSD,
    bf16 and f32, through the ``repro_torch`` that ``sys.path`` finds
    first, each case's output held against its plain version.  Returns
    {case: ms}; an f32 case's key ends in "f32"."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd import kernel as ssdk
    from repro_torch.kernels.ssd.ref import ssd_chunked

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, " f32")):
        dn = str(dtype).split(".")[1]
        for B, S, H, KV, hd, causal, window, cap in TIMED_FA:
            q, k, v = _qkv(gen, dev, B, S, H, KV, hd, dtype)
            kw = dict(causal=causal, window=window, cap=cap)
            compare("flash_attention", fak.flash_attention(q, k, v, **kw),
                    flash_attention_ref(q, k, v, **kw), dn)
            out[f"flash {(B, S, H, KV, hd, causal, window, cap)}{tag}"] = \
                time_ms(lambda: fak.flash_attention(q, k, v, **kw))
        for B, S, H, P, N, chunk in TIMED_SSD:
            args = (torch.randn((B, S, H, P), generator=gen,
                                device=dev).to(dtype),
                    F.softplus(torch.randn((B, S, H), generator=gen,
                                           device=dev) - 1.0),
                    -torch.exp(torch.randn((H,), generator=gen, device=dev)
                               * 0.3),
                    torch.randn((B, S, N), generator=gen,
                                device=dev).to(dtype),
                    torch.randn((B, S, N), generator=gen,
                                device=dev).to(dtype))
            y, hT = ssdk.ssd(*args, chunk=chunk)
            y_ref, h_ref = ssd_chunked(*args, chunk)
            compare("ssd", y, y_ref, dn)
            compare("ssd", hT, h_ref, dn)
            out[f"ssd {(B, S, H, P, N, chunk)}{tag}"] = time_ms(
                lambda: ssdk.ssd(*args, chunk=chunk))
    if hasattr(fak, "flash_attention_bwd"):   # a checkout with the kernel
        for case in FA_BWD_TIMED:
            B, S, H, KV, hd, causal, window, cap = case
            q, k, v = _qkv(gen, dev, B, S, H, KV, hd, torch.bfloat16)
            g = torch.randn_like(q)
            kw = dict(causal=causal, window=window, cap=cap)
            o, lse = fak.flash_attention_lse(q, k, v, **kw)
            out[f"flash bwd {case}"] = time_ms(
                lambda: fak.flash_attention_bwd(q, k, v, o, lse, g, **kw))
    return out


def compare_times(roots):
    """``kernel_times`` of the ``repro_torch`` under each checkout in
    ``roots``, in that order, each in a child process of its own (which
    builds that checkout's kernels under its own ``build/``): to compare
    two commits on one card, unpack the other into a git-ignored directory
    and pass it, this checkout, this checkout, it.  Prints one ``TIMES
    <root> {case: ms}`` line a run."""
    for root in roots:
        subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--times-of", str(Path(root).resolve())], check=True)


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


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _init_model(cfg, dev, dtype, note=""):
    """Seeded random weights on the card, timed; logs the model's size."""
    import torch
    from repro_torch.models import transformer as tfm
    t = time.perf_counter()
    model = tfm.init_model(cfg, seed=0, device=dev, dtype=dtype)
    _sync(dev)
    n = sum(p.numel() for p in model.parameters())
    log(f"{cfg.name}: {cfg.n_layers} layers{note}, d_model {cfg.d_model}, "
        f"{n} params ({n * torch.finfo(dtype).bits / 8e9:.1f} GB "
        f"{str(dtype).split('.')[1]}, seeded random) on the card in "
        f"{time.perf_counter() - t:.2f} s")
    return model, n


def _serve(cfg, model, label):
    """``ServeEngine(max_batch=4, max_len=512)``: PROMPT_LENS prompts, MAX_NEW
    tokens each; every real logit finite.  Returns host times, tokens/s,
    peak memory, both kernels' launches (flash's also by dtype), and each
    flash launch's softcap."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.ssd import kernel as ssdk
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, model, max_batch=4, max_len=512)
    timer = eng.dom.attach(_Timer())
    rng = np.random.default_rng(0)
    counter = {"calls": 0, "nonfinite": 0}
    orig, checked = _finite_forward(tfm, counter)
    caps, orig_fa = [], fak.flash_attention

    def capped(*a, **kw):
        caps.append(kw.get("cap", 0.0))
        return orig_fa(*a, **kw)
    tfm.forward, fak.flash_attention = checked, capped
    try:
        for n in PROMPT_LENS:
            eng.submit(rng.integers(0, cfg.vocab, n), max_new=MAX_NEW)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_flash_counts()
        ssdk.launches = 0
        t = time.perf_counter()
        done = eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {"flash_attention": fak.launches, "ssd": ssdk.launches}
        flash_by_dtype = dict(fak.launches_by_dtype)
    finally:
        tfm.forward, fak.flash_attention = orig, orig_fa
    if len(done) != len(PROMPT_LENS) or \
            any(len(r.out) != MAX_NEW for r in done):
        raise AssertionError(f"{label}: requests did not all finish with "
                             f"{MAX_NEW} tokens: {[len(r.out) for r in done]}")
    if counter["nonfinite"]:
        raise AssertionError(f"{label}: {counter['nonfinite']} of "
                             f"{counter['calls']} forward calls gave "
                             f"non-finite logits")
    pre, dec = timer.spans["prefill"], timer.spans["decode"]
    toks = sum(len(r.out) for r in done)
    rec = dict(prefill_ms=pre, decode_ms_mean=sum(dec) / len(dec),
               decode_ms_min=min(dec), decode_ms_max=max(dec),
               decode_steps=len(dec), tokens=toks, wall_s=wall,
               tokens_per_s=toks / wall, launches=launches,
               flash_by_dtype=flash_by_dtype, n_prefill=len(pre),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"{label}: served {len(done)} requests x {MAX_NEW} tokens in "
        f"{wall:.3f} s: {toks / wall:.2f} tokens/s; {counter['calls']} "
        f"forward calls, all logits finite; peak device memory "
        f"{rec['peak_gib']:.2f} GiB; prefill ms (prompt lens "
        f"{list(PROMPT_LENS)}): {[round(x, 3) for x in pre]}; decode ms a "
        f"step: mean {rec['decode_ms_mean']:.3f}, min {min(dec):.3f}, max "
        f"{max(dec):.3f} over {len(dec)} steps; launches {launches}")
    return rec, caps


def serve_hymba(dev):
    """hymba-1.5b at full width and depth, bf16, served: both kernels
    launch once per layer of every prefill."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.ssd import kernel as ssdk

    cfg = get_config("hymba-1.5b")
    model, _ = _init_model(cfg, dev, torch.bfloat16)
    rec, _ = _serve(cfg, model, "hymba-1.5b serve")
    launches, n_prefill = rec["launches"], rec["n_prefill"]
    for name, n in launches.items():
        if n != cfg.n_layers * n_prefill:
            raise AssertionError(f"{name}: {n} launches in the serve run, "
                                 f"want {cfg.n_layers} x {n_prefill}")
    log(f"launches in the serve run: {launches} "
        f"(= {cfg.n_layers} layers x {n_prefill} prefills), through "
        f"{fak.entry(torch.bfloat16)[1]} and {ssdk.entry(torch.bfloat16)[1]}")
    return launches, model


OWN_KERNELS = ("fa_tc_fwd", "fa_fwd", "ssd_tc_fwd", "ssd_fwd")


def _kernel_group(name):
    if "fa_fwd" in name or "fa_tc_" in name:
        return "flash_attention"
    if "ssd_fwd" in name or "ssd_tc_" in name:
        return "ssd"
    if any(s in name for s in ("gemm", "nvjet", "cutlass", "sm90_", "cublas")):
        return "matmul"
    return "other"


def _profiled(fn, dev, labels=(), host=True):
    """Run ``fn`` once unprofiled and once under torch.profiler.  Returns
    the profile, its kernel (and copy) events, the device-busy time (the
    union of their intervals: the SSD kernels overlap by programmatic
    dependent launch), and both host walls in us.  The ``labels``' own
    spans on the device timeline (record_function annotations) are not
    kernels and are left out.  ``host=False`` traces the device alone,
    which slows the host far less than recording every host op."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    t = time.perf_counter()
    fn()
    _sync(dev)
    wall = (time.perf_counter() - t) * 1e6
    acts = [ProfilerActivity.CUDA]
    if host:
        acts.append(ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        _sync(dev)
        wall_prof = (time.perf_counter() - t) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in labels]
    busy, end = 0.0, float("-inf")
    for e in sorted(kern, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, end), e.time_range.end
        busy += max(0.0, hi - lo)
        end = max(end, hi)
    return prof, kern, busy, wall, wall_prof


def _profile(model):
    """Device busy share and kernel time by group, for one prefill and for
    decode steps with every slot active (torch.profiler's kernel events;
    the busy share is of the profiled run's wall, the unprofiled wall is
    printed beside it)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine

    cfg, rng = model.cfg, np.random.default_rng(1)

    def run(label, fn):
        prof, kern, busy, wall, wall_prof = _profiled(fn, model.device)
        groups: dict[str, float] = {}
        for e in kern:
            g = _kernel_group(e.name)
            groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us()
        own: dict[str, list[float]] = {}   # the port's kernels, by name
        for e in kern:
            name = next((n for n in OWN_KERNELS if n in e.name), None)
            if name:
                own.setdefault(name, []).append(e.time_range.elapsed_us())
        log(f"profile {label}: wall {wall:.0f} us unprofiled, "
            f"{wall_prof:.0f} us profiled; device busy {busy:.0f} us "
            f"({100 * busy / wall_prof:.1f}% of the profiled wall), "
            f"{len(kern)} kernels; device us by group: "
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


def check_engine(trimmed=False):
    """Phase 5: the Akita engine and memsys on the card.  (a) the five
    patterns at 16 cores and 96 requests, Smart Ticking and naive, against
    MEMSYS_REF, with stat_err 0 (``trimmed``, as the whole script runs it
    since PR 19: the naive engine only on NAIVE_TRIMMED; compute, stream,
    pointer and mixed give the same results, MEMSYS_REF's, on both
    engines); idle_half's whole final state on the card against the
    port's CPU run and against an eager K=1 run on the card; (b) 64 cores
    and 256 requests a core, mixed, to completion."""
    import numpy as np
    import torch
    from repro_torch.sims import memsys as tm

    t_phase = time.perf_counter()
    rec = {"patterns": {}}
    keep = {}
    out_dir = ROOT / "build" / "engine"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.glob("*.pt"):
        f.unlink()
    cpu_states = _CpuStates(out_dir, _engine_cpu_state)
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
        got = {"smart": _memsys_stats(tm, sim, smart)}
        if trimmed and pattern not in NAIVE_TRIMMED:
            if got["smart"] != ref["smart"]:
                raise AssertionError(f"memsys {pattern} smart: "
                                     f"{got['smart']} != MEMSYS_REF "
                                     f"{ref['smart']}")
            rec["patterns"][pattern] = dict(
                smart_s=dt_s, epochs=[got["smart"]["epochs"]])
            log(f"memsys {pattern} 16 cores x 96 requests: smart "
                f"{got['smart']['epochs']} epochs in {dt_s:.3f} s; "
                f"MEMSYS_REF matched (naive not run in the whole script)")
            continue
        simn, stn = tm.build(naive=True, **kw)
        naive, dt_n = _timed_run(simn, stn, horizon)
        got["naive"] = _memsys_stats(tm, simn, naive)
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
    # run (a child process's, made while the card ran the patterns) and
    # against an eager K=1 run of the same block on the card
    kw = dict(n_cores=16, pattern="idle_half", n_reqs=96)
    try:
        got = cpu_states.get("idle_half")
    finally:
        cpu_states.close()
    cpu, dt_cpu = got["state"], got["seconds"]
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


TRIMMED_REQS64 = 64      # phase 6 (c)'s requests a core in the whole script
_SWEEP_BUILD: list = []
_SWEEP_UNSHARDED: dict = {}    # phase 6 (a)'s pipelined rows and record


def _sweep_build():
    """Phase 6's 16-core x 96-request memsys build, made once a process:
    phase 11 (c) sweeps the same simulation, whose ladder phase 6 has
    already captured."""
    if not _SWEEP_BUILD:
        from repro_torch.sims import memsys as tm
        _SWEEP_BUILD.append(tm.build(n_cores=16, pattern="mixed",
                                     n_reqs=96))
    return _SWEEP_BUILD[0]


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


def _check_rows(name, rows, ref, cols=DSE_ROW):
    """Rows against a SWEEP_REF (or ONIRA_SWEEP_REF) entry; on a mismatch,
    print the sampled rows' differences and fail."""
    import hashlib
    digest = hashlib.sha256(json.dumps(rows, sort_keys=True, separators=(
        ",", ":")).encode()).hexdigest()
    sums = {c: sum(r[c] for r in rows) for c in cols}
    if (len(rows), digest, sums) == (ref["n"], ref["sha256"], ref["sums"]):
        return
    cols = ref["axes"] + cols
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


def check_dse(trimmed=False):
    """Phase 6: the batched lanes (repro_torch.dse) on the card.  (a) 256
    points at memsys 16 cores x 96 requests, per-lane horizons, through
    run_sweep (autotuner and depth-2 pipeline), run_sweep(pipeline=False)
    and one monolithic run_batch: identical rows, equal to SWEEP_REF, and
    lanes 0, 85, 170 and 255 equal to single runs, whole states by bits
    (``trimmed``, as the whole script runs it since PR 19 to fit phase 11:
    the pipelined sweep alone, whose rows and states phase 11 (c) holds
    against sharded unpipelined sweeps and a padded run_batch);
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
    sim, st = _sweep_build()
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
    _SWEEP_UNSHARDED.update(rows=rows_p, rec=rec["rounds"])
    lanes = [("run_sweep", states.state)]
    if not trimmed:
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
        lanes.append(("run_batch", lambda i: dse.lane(out_m, i)))
    _check_rows("sweep-256", rows_p, SWEEP_REF["sweep256"])
    log(f"sweep-256: {'the pipelined run' if trimmed else 'the three runs'}"
        f" give identical rows, equal to SWEEP_REF ({len(rows_p)} rows)")

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
        for what, get in lanes:
            bad = _state_diff(get(i), one)
            if bad:
                raise AssertionError(f"sweep-256 lane {i} ({what}) and a "
                                     f"single run differ at {bad}")
    seq_rate = len(DSE_SAMPLED) / seq_s
    rec["sequential"] = dict(runs=len(DSE_SAMPLED), wall_s=seq_s,
                             configs_per_s=seq_rate)
    runs = [k for k in ("rounds", "rounds_unpipelined", "monolithic")
            if k in rec]
    for k in runs:
        rec[k]["batching_ratio"] = rec[k]["configs_per_s"] / seq_rate
    log(f"[{card}] sequential baseline: lanes {DSE_SAMPLED} as single runs "
        f"in {seq_s:.3f} s ({seq_rate:.3f} configs/s); each equals its "
        f"lane of {' and of '.join(w for w, _ in lanes)}, whole state, f32 "
        f"by bits; batching ratio " + ", ".join(
            f"{rec[k]['batching_ratio']:.1f}x ({k})" for k in runs))
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

    # (c) 64 cores x 256 requests (TRIMMED_REQS64 trimmed), 32 lanes
    ref64 = MEMSYS64
    n_reqs = TRIMMED_REQS64 if trimmed else ref64["n_reqs"]
    sim64, st64 = tm.build(n_cores=ref64["n_cores"], pattern=ref64["pattern"],
                           n_reqs=n_reqs)
    pts64 = [{"conn_latency[-1]": 30.0}] + [
        {"conn_latency[-1]": 10.0 + 30.0 * i / 31} for i in range(1, 32)]
    runner64 = dse.runner_for(sim64)
    pb64 = dse.build_param_batch(sim64, pts64)
    (rows64, states64), rec["full_width"] = _timed_sweep(
        f"64 cores x {n_reqs} requests, 32 lanes", card, runner64,
        lambda: runner64.warm_ladder(st64, pb64,
                                     dse.make_ladder(len(pts64))),
        lambda: dse.run_sweep(dse.memoize_build(lambda: (sim64, st64)),
                              dse.SweepSpec.explicit(pts64), until=1e6,
                              return_states=True))
    rec["full_width"]["n_reqs"] = n_reqs
    got = (rows64[0]["epochs"], rows64[0]["virtual_time"])
    if not trimmed:
        if got != (ref64["epochs"], ref64["virtual_time"]):
            raise AssertionError(f"64 cores, lane 0 (the build's "
                                 f"defaults): epochs and virtual time "
                                 f"{got}, want MEMSYS64's {ref64['epochs']}"
                                 f" and {ref64['virtual_time']}")
        log(f"64 cores: lane 0 equals MEMSYS64 ({got[0]} epochs, virtual "
            f"time {got[1]})")
    else:
        want = {c: MEMSYS64_TRIMMED[c] for c in DSE_ROW}
        row = {c: rows64[0][c] for c in DSE_ROW}
        if row != want:
            raise AssertionError(f"64 cores x {n_reqs}, lane 0 (the "
                                 f"build's defaults): {row}, want "
                                 f"MEMSYS64_TRIMMED's {want}")
        log(f"64 cores x {n_reqs}: lane 0 equals MEMSYS64_TRIMMED, the JAX "
            f"package's row ({got[0]} epochs, virtual time {got[1]})")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[{card}] phase 6 (dse) took {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------
def _zero_flash_counts():
    """Set the flash kernel module's launch counts, total, by dtype and
    of the backward, to 0."""
    from repro_torch.kernels.flash_attention import kernel as fak
    fak.launches = fak.bwd_launches = 0
    for dn in fak.launches_by_dtype:
        fak.launches_by_dtype[dn] = 0


def _free(dev):
    import gc

    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _arch_flash_cases():
    """(arch, case) for each full-width arch of FA_ARCHS: its prefill
    attention at B=1, S=FA_ARCH_S, once for each window its layers use."""
    from repro_torch.configs import get_config
    out = []
    for arch in FA_ARCHS:
        cfg = get_config(arch)
        for w in sorted(set(cfg.layer_windows())):
            out.append((arch, (1, FA_ARCH_S, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, cfg.causal, w,
                               cfg.attn_softcap)))
    return out


def check_flash80(dev, gen):
    """(a) Both kernels against the plain version at head dim 80 and at
    each full-width arch's prefill shape; at hubert's prefill shape,
    kernel, plain and SDPA times.  Returns each dtype's record at
    hubert's shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rec = {}
    cases = [("hd80", c) for c in FA80_CASES] + _arch_flash_cases()
    for tag, case in cases:
        B, S, H, KV, hd, causal, window, cap = case
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            q, k, v = _qkv(gen, dev, B, S, H, KV, hd, dtype)
            kw = dict(causal=causal, window=window, cap=cap)
            out = fak.flash_attention(q, k, v, **kw)
            _sync(dev)
            e = compare("flash_attention", out,
                        flash_attention_ref(q, k, v, **kw), dn)
            line = (f"flash_attention {fak.entry(dtype)[1]} {tag} B={B} "
                    f"S={S} H={H} KV={KV} hd={hd} causal={causal} "
                    f"window={window} cap={cap} {dn}: max_abs_err {e:.3g}")
            if tag == "hd80" and not causal:               # hubert's prefill
                ms = time_ms(lambda: fak.flash_attention(q, k, v, **kw))
                plain = time_ms(lambda: flash_attention_ref(q, k, v, **kw),
                                reps=5)
                qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh))
                ops = 4 * B * H * hd * _attn_pairs(S, causal, window)
                b_ms, b_by = bound(nbytes(q, k, v, out), ops, dn)
                rec[dn] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=b_ms, bound_by=b_by, max_abs_err=e)
                line += (f", kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa "
                         f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}), share "
                         f"of bound {b_ms / ms:.3f}")
            log(line)
    return rec


def check_moe_full(dev, gen):
    """(b) One MoE layer at deepseek-v2's full widths, f32, ample capacity,
    256 tokens (so moe_groups=32 takes the group path): moe_block against
    the dense oracle at the reference test's bar."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import init_params

    cfg = get_config("deepseek-v2-236b", moe_capacity=8.0)
    T = 256
    G, Tg, C = moe.capacity_of(cfg, T)
    if G != cfg.moe_groups:
        raise AssertionError(f"MoE: {T} tokens took {G} groups, want "
                             f"{cfg.moe_groups}")
    params = init_params(moe.moe_specs(cfg), gen, torch.float32)
    x = torch.randn((1, T, cfg.d_model), generator=gen, device=dev) * 0.5
    out, aux = moe.moe_block(params, cfg, x)
    ref = moe.moe_block_dense_ref(params, cfg, x)
    _sync(dev)
    err = float((out - ref).abs().max())
    if not (torch.isfinite(out).all() and
            torch.allclose(out, ref, atol=2e-4, rtol=2e-3)):
        raise AssertionError(f"MoE full width: moe_block vs dense oracle "
                             f"max abs err {err} (atol 2e-4, rtol 2e-3)")
    ms = eager_ms(lambda: moe.moe_block(params, cfg, x), reps=3)
    log(f"MoE deepseek-v2 full width (E={cfg.n_experts}, top-{cfg.top_k}, "
        f"{cfg.n_shared_experts} shared, d={cfg.d_model}, "
        f"ff={cfg.expert_d_ff}) f32, T={T}: groups {G} x {Tg} tokens, "
        f"{C} slots an expert a group; moe_block vs dense oracle max abs "
        f"err {err:.3g} (|ref| max {float(ref.abs().max()):.3g}; atol 2e-4, "
        f"rtol 2e-3), aux {float(aux):.4f}; moe_block {ms:.3f} ms eager")
    del params
    _free(dev)
    return dict(max_abs_err=err, ms=ms)


def check_mla_full(dev, gen):
    """(c) One MLA layer at deepseek-v2's full widths, f32: absorbed decode
    token by token against the materialised form, by the procedure of
    test_mla_absorbed_decode_matches_materialized."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import mla
    from repro_torch.models.layers import init_params

    cfg = get_config("deepseek-v2-236b")
    params = init_params(mla.mla_specs(cfg), gen, torch.float32)
    B, S = 2, 16
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev) * 0.5
    pos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    full, _ = mla.mla_block(params, cfg, x, pos)
    cache = (torch.zeros((B, S, cfg.kv_lora), device=dev),
             torch.zeros((B, S, cfg.qk_rope_dim), device=dev))
    outs = []
    for t in range(S):
        pt = torch.full((B, 1), t, dtype=torch.int32, device=dev)
        o, cache = mla.mla_block(params, cfg, x[:, t:t + 1], pt, cache=cache,
                                 cache_len=pt + 1)
        outs.append(o)
    dec = torch.cat(outs, dim=1)
    _sync(dev)
    err = float((dec - full).abs().max())
    if not torch.allclose(dec, full, atol=3e-4, rtol=3e-3):
        raise AssertionError(f"MLA full width: absorbed decode vs "
                             f"materialised max abs err {err} (atol 3e-4, "
                             f"rtol 3e-3)")
    log(f"MLA deepseek-v2 full width (H={cfg.n_heads}, kv_lora "
        f"{cfg.kv_lora}, q_lora {cfg.q_lora}, rope {cfg.qk_rope_dim}) f32, "
        f"B={B} S={S}: absorbed decode vs materialised max abs err "
        f"{err:.3g} (|ref| max {float(full.abs().max()):.3g}; atol 3e-4, "
        f"rtol 3e-3)")
    del params
    _free(dev)
    return dict(max_abs_err=err)


def _smoke_batch(cfg, rng, B, S):
    """Numpy inputs of a smoke run: tokens, or frames, or vision + text."""
    import numpy as np
    if cfg.frontend == "audio":
        return {"features": rng.standard_normal((B, S, cfg.frontend_dim),
                                                dtype=np.float32),
                "mask": (rng.random((B, S)) < 0.3).astype(np.float32)}
    if cfg.frontend == "vision":
        nv = cfg.n_vision_tokens
        return {"tokens": rng.integers(0, cfg.vocab, (B, S - nv)),
                "vision": rng.standard_normal((B, nv, cfg.d_model),
                                              dtype=np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, (B, S))}


def _greedy(model, cfg, batch, new):
    """Prefill logits, then ``new`` greedy decode steps (uniform cache, or
    teacher-forced ``decode_unrolled`` where the caches are mixed), on the
    model's device.  -> (prefill logits, [step logits], [step tokens])."""
    import torch
    from repro_torch.models import transformer as tfm

    dev = model.device
    b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    with torch.inference_mode():
        lp, pc, _ = tfm.forward(model, cfg, b, mode="prefill")
    if not cfg.causal:
        return lp.cpu(), [], []
    B, S0 = lp.shape[:2]
    S_max = S0 + new
    steps, toks = [], []
    with torch.inference_mode():
        if tfm.needs_unrolled_decode(cfg, S_max):
            cache = tfm.init_cache_unrolled(cfg, B, S_max,
                                            dtype=torch.float32, device=dev)
            for t in range(S_max - 1):
                tok = b["tokens"][:, t:t + 1] if t < S0 else nxt[:, None]
                pos = torch.full((B, 1), t, dtype=torch.int32, device=dev)
                lg, cache = tfm.decode_unrolled(model, cfg, tok, cache, pos)
                nxt = lg[:, -1].argmax(-1)
                if t >= S0 - 1:
                    steps.append(lg.cpu())
                    toks.append(nxt.cpu())
        else:
            cache = tfm.init_cache(cfg, B, S_max, dtype=torch.float32,
                                   device=dev)
            for k, v in pc.items():
                if k in tfm.IN_PLACE:
                    cache[k][:, :, :S0] = v
                else:
                    cache[k] = v.to(cache[k].dtype)
            nxt = lp[:, -1].argmax(-1)
            for t in range(S0, S_max):
                toks.append(nxt.cpu())
                pos = torch.full((B, 1), t, dtype=torch.int32, device=dev)
                lg, cache, _ = tfm.forward(
                    model, cfg, {"tokens": nxt[:, None]}, mode="decode",
                    cache=cache, positions=pos, cache_len=pos + 1)
                nxt = lg[:, -1].argmax(-1)
                steps.append(lg.cpu())
    return lp.cpu(), steps, toks


def _router_gaps(model, cfg, batch, new):
    """The smallest gap between a token's k-th and (k+1)-th router
    probability, over every MoE call of a CPU run."""
    from repro_torch.models import moe
    gaps, orig = [], moe._route

    def spy(params, xf, K):
        probs, gates, eidx = orig(params, xf, K)
        top = probs.sort(dim=-1, descending=True).values
        gaps.append(float((top[:, K - 1] - top[:, K]).min()))
        return probs, gates, eidx
    moe._route = spy
    try:
        _greedy(model, cfg, batch, new)
    finally:
        moe._route = orig
    return min(gaps)


def check_smoke_models(dev):
    """(d) Each new arch's smoke config in f32 on the card (kernels) against
    the CPU (plain versions): prefill logits and every decode step's within
    1e-4 of their largest magnitude (hubert: 2e-2 in norm, its frontend is
    bf16), and equal greedy tokens.  Returns the flash launches by dtype,
    as the kernel module counts them."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.models import transformer as tfm

    _zero_flash_counts()
    for arch in MODELS_SMOKE:
        cfg = get_smoke_config(arch)
        padded = fak.padded_head_dim(cfg.head_dim)
        if padded != cfg.head_dim:
            log(f"smoke {cfg.name}: head_dim {cfg.head_dim} runs padded "
                f"to {padded}")
        cpu = tfm.init_model(cfg, seed=2, device="cpu",
                             dtype=torch.float32)
        gpu = copy.deepcopy(cpu).to(dev)
        batch = _smoke_batch(cfg, np.random.default_rng(2), 2, 12)
        new = 4
        ref, got = _greedy(cpu, cfg, batch, new), \
            _greedy(gpu, cfg, batch, new)
        audio = cfg.frontend == "audio"
        worst = 0.0
        for i, (a, b) in enumerate(zip([got[0]] + got[1],
                                       [ref[0]] + ref[1])):
            a, b = a[..., :cfg.vocab], b[..., :cfg.vocab]
            if audio:
                r = float((a - b).norm() / b.norm())
                ok = r <= 2e-2
            else:
                r = float((a - b).abs().max() / b.abs().max())
                ok = r <= 1e-4
            worst = max(worst, r)
            if not ok:
                raise AssertionError(f"smoke {cfg.name}: card vs CPU "
                                     f"logits at step {i} differ by "
                                     f"{r:.3g} of their scale")
        for t, (a, b) in enumerate(zip(got[2], ref[2])):
            if not torch.equal(a, b):
                gap = ""
                if cfg.n_experts:
                    gap = (f"; router top-k gap (CPU run) "
                           f"{_router_gaps(cpu, cfg, batch, new):.3g}")
                lg = ref[1][t][:, -1, :cfg.vocab]
                top2 = lg.topk(2, dim=-1).values
                raise AssertionError(
                    f"smoke {cfg.name}: greedy token differs at step "
                    f"{t}: card {a.tolist()}, CPU {b.tolist()}; top-2 "
                    f"logit gap {(top2[:, 0] - top2[:, 1]).tolist()}"
                    f"{gap}")
        log(f"smoke {cfg.name} f32: card vs CPU, prefill and {len(got[1])}"
            f" decode steps, worst logit error {worst:.3g} of scale "
            f"({'2e-2 in norm' if audio else '1e-4 of max'}); "
            f"{sum(len(t) for t in got[2])} greedy tokens equal")
        del cpu, gpu
    launches = dict(fak.launches_by_dtype)
    log(f"flash launches in (d): {launches}")
    return launches


def _profile_groups(model, cfg, dev):
    """torch.profiler split of one prefill (S=256) and one decode step with
    4 active slots: matmul kernels, MoE dispatch (every other kernel of
    ``moe_block``: routing, slot count, scatter, gather, combine, SwiGLU's
    elementwise work), attention (every kernel of ``blockwise_attention``
    and ``absorbed_attention``), other; and the device-busy share of the
    profiled run (the profiler slows the host, so the unprofiled wall is
    printed beside it)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import record_function
    from repro_torch.models import mla, moe
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import ServeEngine

    def labelled(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run
    saved = (mla.blockwise_attention, mla.absorbed_attention, moe.moe_block)
    mla.blockwise_attention = labelled("attention", saved[0])
    mla.absorbed_attention = labelled("attention", saved[1])
    moe.moe_block = labelled("moe", saved[2])

    def run(label, fn):
        prof, kern, busy, wall, wall_prof = _profiled(
            fn, dev, labels=("attention", "moe"))
        total = sum(e.time_range.elapsed_us() for e in kern)
        groups = {"matmul": 0.0, "moe dispatch": 0.0, "attention": 0.0}

        def walk(e, where):
            if e.name in ("attention", "moe"):
                where = e.name
            for k in e.kernels:
                g = _kernel_group(k.name)
                if where == "attention":
                    groups["attention"] += k.duration
                elif g == "matmul":
                    groups["matmul"] += k.duration
                elif where == "moe":
                    groups["moe dispatch"] += k.duration
            for c in e.cpu_children:
                walk(c, where)
        for e in prof.events():
            if e.device_type == DeviceType.CPU and e.cpu_parent is None:
                walk(e, None)
        groups["other"] = total - sum(groups.values())
        log(f"profile {cfg.name} {label}: wall {wall:.0f} us unprofiled, "
            f"{wall_prof:.0f} us profiled; device busy {busy:.0f} us "
            f"({100 * busy / wall_prof:.1f}% of the profiled wall), "
            f"{len(kern)} kernels; device us by group: "
            + ", ".join(f"{g} {u:.0f}" for g, u in groups.items()))
        return dict(wall_us=wall, wall_profiled_us=wall_prof, busy_us=busy,
                    busy_share=busy / wall_prof, kernels=len(kern),
                    groups=groups)

    rng = np.random.default_rng(1)
    out = {}
    try:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 256)),
                               device=dev)
        with torch.inference_mode():
            out["prefill"] = run("prefill S=256", lambda: tfm.forward(
                model, cfg, {"tokens": toks}, mode="prefill"))
        eng = ServeEngine(cfg, model, max_batch=4, max_len=512)
        for n in (256, 200, 130, 64):
            eng.submit(rng.integers(0, cfg.vocab, n), max_new=24)
        eng.step()                       # admit all four, one decode step
        out["decode"] = run("one decode step, 4 active slots", eng.step)
    finally:
        mla.blockwise_attention, mla.absorbed_attention, moe.moe_block = saved
    return out


def serve_deepseek_v2(dev):
    """(e) The main path: deepseek-v2-236b at full width, 6 layers (layer
    0 dense, 5 MoE), bf16, served; MLA runs no kernel, so flash must not
    launch.  Then the profiler split."""
    import torch
    from repro_torch.configs import get_config

    cfg = get_config("deepseek-v2-236b", n_layers=MAIN_LAYERS)
    model, n = _init_model(
        cfg, dev, torch.bfloat16,
        note=f" of 60 (layer 0 dense d_ff {cfg.first_dense_d_ff}, "
             f"{cfg.n_layers - 1} MoE; param_count {cfg.param_count()})")
    rec, _ = _serve(cfg, model, "deepseek-v2-236b serve")
    if any(rec["launches"].values()):
        raise AssertionError(f"deepseek-v2: launches {rec['launches']}, want"
                             f" none (MLA attends in plain PyTorch)")
    rec["params"] = n
    rec["profile"] = _profile_groups(model, cfg, dev)
    del model
    _free(dev)
    return rec


def serve_gemma2(dev):
    """(f) gemma2-27b at full width and depth, bf16, served: flash launches
    = 46 layers x the prefills, softcap 50 in every one."""
    import torch
    from repro_torch.configs import get_config

    cfg = get_config("gemma2-27b")
    model, n = _init_model(cfg, dev, torch.bfloat16)
    rec, caps = _serve(cfg, model, "gemma2-27b serve")
    want = cfg.n_layers * rec["n_prefill"]
    n_fa = rec["launches"]["flash_attention"]
    if n_fa != want or set(caps) != {cfg.attn_softcap}:
        raise AssertionError(f"gemma2: {n_fa} flash launches with softcaps "
                             f"{sorted(set(caps))}, want {want} with "
                             f"{cfg.attn_softcap}")
    rec["params"] = n
    del model
    _free(dev)
    return rec


def prefill_models(dev, gen):
    """(g) One prefill of each other new arch at full width (depth cut
    where the card cannot hold it), bf16: real logits finite, flash
    launches = the attention layers.  internvl2 then decodes 4 steps
    through ``forward``; hubert-xlarge runs ``forward`` only."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.models import transformer as tfm

    rng = np.random.default_rng(3)
    out, by_dtype = {}, {dn: 0 for dn in fak.launches_by_dtype}
    for arch, layers in PREFILL_ONLY:
        cfg = (get_config(arch, n_layers=layers) if layers
               else get_config(arch))
        model, n = _init_model(cfg, dev, torch.bfloat16)
        if cfg.frontend == "audio":
            B, S = 2, 500
            batch = {"features": torch.randn((B, S, cfg.frontend_dim),
                                             generator=gen, device=dev),
                     "mask": torch.as_tensor(rng.random((B, S)) < 0.3,
                                             device=dev).float()}
            mode = "train"
        else:
            B, S = 1, 384
            nv = cfg.n_vision_tokens
            batch = {"tokens": torch.as_tensor(
                rng.integers(0, cfg.vocab, (B, S - nv)), device=dev)}
            if nv:
                batch["vision"] = torch.randn((B, nv, cfg.d_model),
                                              generator=gen, device=dev
                                              ).to(torch.bfloat16)
            mode = "prefill"
        _zero_flash_counts()
        with torch.inference_mode():
            _sync(dev)
            t = time.perf_counter()
            logits, cache, _ = tfm.forward(model, cfg, batch, mode=mode)
            _sync(dev)
            ms = (time.perf_counter() - t) * 1e3
        launches = fak.launches
        for dn, count in fak.launches_by_dtype.items():
            by_dtype[dn] += count
        if not bool(torch.isfinite(logits[..., :cfg.vocab]).all()):
            raise AssertionError(f"{arch}: non-finite prefill logits")
        if launches != cfg.n_layers:
            raise AssertionError(f"{arch}: {launches} flash launches, want "
                                 f"{cfg.n_layers}")
        line = (f"{arch}: {mode} B={B} S={S}: {ms:.3f} ms, logits finite, "
                f"{launches} flash launches (hd {cfg.head_dim}, "
                f"{'causal' if cfg.causal else 'non-causal'})")
        rec = dict(layers=cfg.n_layers, params=n, ms=ms, launches=launches)
        if cfg.frontend == "vision":       # 4 decode steps after it
            S_max = S + 4
            dc = tfm.init_cache(cfg, B, S_max, device=dev)
            for k, v in cache.items():
                dc[k][:, :, :S] = v
            nxt = logits[:, -1].argmax(-1)
            with torch.inference_mode():
                for t in range(S, S_max):
                    pos = torch.full((B, 1), t, dtype=torch.int32,
                                     device=dev)
                    lg, dc, _ = tfm.forward(model, cfg,
                                            {"tokens": nxt[:, None]},
                                            mode="decode", cache=dc,
                                            positions=pos,
                                            cache_len=pos + 1)
                    if not bool(torch.isfinite(lg[..., :cfg.vocab]).all()):
                        raise AssertionError(f"{arch}: non-finite decode "
                                             f"logits at {t}")
                    nxt = lg[:, -1].argmax(-1)
            line += f"; 4 decode steps after {nv} vision tokens, finite"
        log(line)
        out[arch] = rec
        del model, logits, cache
        _free(dev)
    return out, by_dtype


def check_ring_decode(dev):
    """(h) hymba-1.5b at full width, 4 layers (windows [0, 1024, 0, 0]),
    f32: 1100 teacher-forced positions through ``decode_unrolled`` (a ring
    of 1024 slots in layer 1) against the uniform ``forward(mode="decode")``
    with a 1152-long cache and the same window; max |dlogits| <= 1e-4 x
    max |logits| at every step."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm

    cfg = get_config(RING["arch"], n_layers=RING["layers"])
    P, S_max = RING["positions"], RING["cache"]
    model = tfm.init_model(cfg, seed=4, device=dev, dtype=torch.float32)
    ring = tfm.init_cache_unrolled(cfg, 1, S_max, dtype=torch.float32,
                                   device=dev)
    full = tfm.init_cache(cfg, 1, S_max, dtype=torch.float32, device=dev)
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, (1, P)), device=dev)
    V, errs = cfg.vocab, []
    t0 = time.perf_counter()
    with torch.inference_mode():
        for t in range(P):
            pos = torch.full((1, 1), t, dtype=torch.int32, device=dev)
            lr, ring = tfm.decode_unrolled(model, cfg, toks[:, t:t + 1],
                                           ring, pos)
            lf, full, _ = tfm.forward(model, cfg,
                                      {"tokens": toks[:, t:t + 1]},
                                      mode="decode", cache=full,
                                      positions=pos, cache_len=pos + 1)
            errs.append(torch.stack([(lr - lf)[..., :V].abs().max(),
                                     lf[..., :V].abs().max()]))
    e = torch.stack(errs).cpu()
    wall = time.perf_counter() - t0
    ratio = e[:, 0] / e[:, 1]
    sizes = [lc["k"].shape[1] for lc in ring["layers"]]
    held = sorted(ring["layers"][1]["pos"][0].tolist())
    if held != list(range(P - cfg.window, P)):
        raise AssertionError(f"ring of layer 1 holds positions "
                             f"{held[:3]}...{held[-3:]}, want the last "
                             f"{cfg.window}")
    if not bool((ratio <= 1e-4).all()):
        bad = int(torch.nonzero(ratio > 1e-4)[0])
        raise AssertionError(f"ring decode: step {bad} differs by "
                             f"{float(ratio[bad]):.3g} of max |logits|")
    log(f"ring decode {cfg.name}, {cfg.n_layers} layers, windows "
        f"{cfg.layer_windows()}, f32: {P} positions, cache slots {sizes} "
        f"against {S_max}; worst max|dlogits| / max|logits| "
        f"{float(ratio.max()):.3g} (bar 1e-4), after position "
        f"{cfg.window}: {float(ratio[cfg.window:].max()):.3g}; layer 1's "
        f"ring holds positions {held[0]}..{held[-1]}; {wall:.2f} s for "
        f"both paths")
    del model
    _free(dev)
    return dict(positions=P, worst_ratio=float(ratio.max()), wall_s=wall)


def check_models(dev):
    """Phase 7: the rest of the model path.  Returns its JSON record and
    the flash launches of its model runs, by dtype."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(7)
    t_phase = time.perf_counter()
    rec = {"card": _card()}
    rec["flash_hd80"] = check_flash80(dev, gen)
    rec["moe"] = check_moe_full(dev, gen)
    rec["mla"] = check_mla_full(dev, gen)
    launches = check_smoke_models(dev)
    rec["deepseek_v2"] = serve_deepseek_v2(dev)
    rec["gemma2"] = serve_gemma2(dev)
    rec["prefill"], prefill_launches = prefill_models(dev, gen)
    for run in (rec["deepseek_v2"]["flash_by_dtype"],
                rec["gemma2"]["flash_by_dtype"], prefill_launches):
        for dn, n in run.items():
            launches[dn] += n
    rec["ring"] = check_ring_decode(dev)
    rec["launches"] = launches
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[{rec['card']}] phase 7 (models) took {rec['phase_s']:.1f} s; "
        f"flash launches of its model runs {launches}")
    return rec


# ---------------------------------------------------------------------------
# phase 8
# ---------------------------------------------------------------------------
ONIRA_AXES = {"kind.cpu.flush_cycles": [float(f) for f in range(1, 9)],
              "conn_latency": [float(lat) for lat in range(1, 33)]}
ONIRA_FAMILY_AXES = {"shape.cpu": [1, 2, 4, 8],
                     "kind.cpu.flush_cycles": [1.0, 3.0, 8.0]}
ONIRA_UNTIL = 20000.0
XLAT_FRAGMENTS = ("@Core0, instruction, load", "@L1TLB[0], translation",
                  "@L2TLB, translation", "@MMU, page-walk")


def _trio_cfg(arch, layers):
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def _trio_name(key):
    arch, *_, dp, tp, pp = key
    return f"{arch} dp{dp} tp{tp} pp{pp}"


def _engine_cpu_state(out_dir):
    """Child process of phase 5: the port's CPU run of idle_half, Smart
    Ticking, 16 cores x 96 requests, to MEMSYS_REF's horizon."""
    import os

    import torch
    from repro_torch.sims import memsys as tm
    torch.set_num_threads(2)
    sim, st = tm.build(device="cpu", n_cores=16, pattern="idle_half",
                       n_reqs=96)
    t = time.perf_counter()
    out = sim.run(st, until=MEMSYS_REF["idle_half"]["horizon"])
    tmp = Path(out_dir) / ".idle_half.tmp"
    torch.save(dict(state=out, seconds=time.perf_counter() - t), tmp)
    os.replace(tmp, Path(out_dir) / "idle_half.pt")


def _cpu_final_states(out_dir):
    """Child process of phase 8: the port's CPU final states that the
    card's are held against (onira's microbenchmarks, then each
    TRIOSIM_REF plan), one file each, written whole before it appears."""
    import os

    import torch
    from repro_torch.sims import onira as to, triosim as tt
    torch.set_num_threads(2)

    def save(name, state):
        tmp = Path(out_dir) / f".{name}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, Path(out_dir) / f"{name}.pt")

    sim, st = to.build_onira([to.MICROBENCHES[n]() for n in to.MICROBENCHES],
                             device="cpu")
    save("onira", sim.run(st, until=ONIRA_UNTIL))
    for key in TRIOSIM_REF:
        arch, layers, batch, seq, micro, dp, tp, pp = key
        t = time.perf_counter()
        r = tt.simulate_step(_trio_cfg(arch, layers), batch, seq, dp, tp, pp,
                             micro, device="cpu", return_state=True)
        save(_trio_name(key), dict(state=r["state"],
                                   seconds=time.perf_counter() - t))


class _CpuStates:
    """The port's CPU final states, computed by a spawned child process
    while the card works, so that the CPU runs cost phase 8 no time."""

    def __init__(self, out_dir, target=None):
        import multiprocessing
        self.dir = out_dir
        self.proc = multiprocessing.get_context("spawn").Process(
            target=target or _cpu_final_states, args=(str(out_dir),),
            daemon=True)
        self.proc.start()

    def get(self, name, timeout=900.0):
        import torch
        path = self.dir / f"{name}.pt"
        t = time.perf_counter()
        while not path.exists():
            if not self.proc.is_alive():
                raise AssertionError(f"the CPU child process ended "
                                     f"(exit code {self.proc.exitcode}) "
                                     f"without {name}")
            if time.perf_counter() - t > timeout:
                raise AssertionError(f"no CPU state for {name} after "
                                     f"{timeout} s")
            time.sleep(0.05)
        return torch.load(path, weights_only=False)

    def close(self):
        self.proc.join(timeout=10)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=10)


def _onira_extract(sim, s):
    """DSE_ROW plus the cycles and the instructions of all pipelines."""
    from repro_torch.dse import default_extract
    cs = s.comp_state["cpu"]
    return dict(default_extract(sim, s),
                cycles=sum(cs["halt_time"].tolist()),
                insts=int(cs["retired"].sum()))


def check_onira(card, cpu):
    """(a) benchmarks/onira_cpi.py on the card: run_microbenches and
    run_mlp_sweep against ONIRA_REF, each CPI beside the analytic model;
    the microbenchmarks' whole final state against the port's CPU run
    (from ``cpu``, a :class:`_CpuStates`)."""
    from repro_torch.sims import onira as to

    t = time.perf_counter()
    res = to.run_microbenches()
    mlp = to.run_mlp_sweep()
    wall = time.perf_counter() - t
    got = {n: (r["insts"], r["cycles"], r["done"]) for n, r in res.items()}
    if got != ONIRA_REF["micro"]:
        raise AssertionError(f"onira microbenches {got} != ONIRA_REF "
                             f"{ONIRA_REF['micro']}")
    if mlp != ONIRA_REF["mlp"]:
        raise AssertionError(f"onira MLP CPIs {mlp} != ONIRA_REF "
                             f"{ONIRA_REF['mlp']}")
    progs = [to.MICROBENCHES[n]() for n in to.MICROBENCHES]
    sim, st = to.build_onira(progs)
    out, run_s = _timed_run(sim, st, ONIRA_UNTIL)
    if (int(out.stats.epochs), float(out.time)) != \
            (ONIRA_REF["epochs"], ONIRA_REF["virtual_time"]):
        raise AssertionError(f"onira: {int(out.stats.epochs)} epochs to "
                             f"{float(out.time)}, want ONIRA_REF's")
    bad = _state_diff(out, cpu.get("onira"))
    if bad:
        raise AssertionError(f"onira: card and CPU states differ at {bad}")
    cpi = {}
    for name, r in res.items():
        a = to.analytic_cpi(name)
        cpi[name] = dict(cpi=r["cpi"], analytic=a,
                         err=abs(r["cpi"] - a) / a)
        log(f"onira {name}: {r['insts']} insts in {r['cycles']} cycles, "
            f"CPI {r['cpi']:.4f}, analytic {a:.4f}, error "
            f"{100 * cpi[name]['err']:.1f}%")
        if cpi[name]["err"] >= 0.20:
            raise AssertionError(f"onira {name}: CPI error beyond the "
                                 "reference test's 20% band")
    log(f"[{card}] onira: ONIRA_REF matched ({ONIRA_REF['epochs']} epochs, "
        f"MLP CPIs {mlp}); the final state equals the CPU run's, f32 by "
        f"bits; both entry points {wall:.3f} s, a warm run {run_s:.3f} s")
    return dict(cpi=cpi, mlp=mlp, entry_s=wall, run_s=run_s,
                epochs=ONIRA_REF["epochs"], card_equals_cpu=True)


def check_onira_sweep(card):
    """(b) the 256-point flush x memory-latency sweep through run_sweep
    (pipelined and not) and one run_batch, against ONIRA_SWEEP_REF, four
    lanes against single runs; then the shape.cpu family.  Returns the
    record, the pipelined rows and what (e) needs to run the sweep again."""
    import torch
    from repro_torch import dse
    from repro_torch.sims import onira as to

    rec = {}
    cols = DSE_ROW + ONIRA_COLS
    progs = [to.MICROBENCHES[n]() for n in to.MICROBENCHES]
    sim, st = to.build_onira(progs)
    spec = dse.SweepSpec.grid(ONIRA_AXES)
    pts = spec.points
    build_fn = dse.memoize_build(lambda: (sim, st))
    runner = dse.runner_for(sim)
    pb = dse.build_param_batch(sim, pts)
    warm = lambda: runner.warm_ladder(st, pb, dse.make_ladder(len(pts)))
    (rows_p, states), rec["rounds"] = _timed_sweep(
        "onira sweep-256 run_sweep (autotune, pipelined)", card, runner,
        warm, lambda: dse.run_sweep(build_fn, spec, until=ONIRA_UNTIL,
                                    extract=_onira_extract,
                                    return_states=True))
    rows_s, rec["rounds_unpipelined"] = _timed_sweep(
        "onira sweep-256 run_sweep(pipeline=False)", card, runner, warm,
        lambda: dse.run_sweep(build_fn, spec, until=ONIRA_UNTIL,
                              extract=_onira_extract, pipeline=False))

    def mono():
        out = runner.run_batch(dse.stack_states(st, len(pts)), pb,
                               ONIRA_UNTIL)
        return [dict(p, **r) for p, r in zip(pts, dse.extract_rows(
            sim, out, len(pts), _onira_extract))], out
    (rows_m, out_m), rec["monolithic"] = _timed_sweep(
        "onira sweep-256 one run_batch", card, runner, warm, mono)
    if not rows_p == rows_s == rows_m:
        raise AssertionError("onira sweep-256: pipelined rounds, "
                             "unpipelined rounds and run_batch give "
                             "different rows")
    _check_rows("onira sweep-256", rows_m, ONIRA_SWEEP_REF["sweep256"],
                cols)
    log(f"onira sweep-256: the three runs give identical rows, equal to "
        f"ONIRA_SWEEP_REF ({len(rows_m)} rows)")

    base = sim.default_params()
    sim.run(sim.copy_state(st), until=-1.0,
            params=dse.apply_point(base, pts[0]))      # capture
    seq_s = 0.0
    for i in DSE_SAMPLED:
        p = dse.apply_point(base, pts[i])
        torch.cuda.synchronize()
        t = time.perf_counter()
        one = sim.run(sim.copy_state(st), until=ONIRA_UNTIL, params=p)
        torch.cuda.synchronize()
        seq_s += time.perf_counter() - t
        for what, lane in (("run_batch", dse.lane(out_m, i)),
                           ("run_sweep", states.state(i))):
            bad = _state_diff(lane, one)
            if bad:
                raise AssertionError(f"onira sweep-256 lane {i} ({what}) "
                                     f"and a single run differ at {bad}")
    seq_rate = len(DSE_SAMPLED) / seq_s
    rec["sequential"] = dict(runs=len(DSE_SAMPLED), wall_s=seq_s,
                             configs_per_s=seq_rate)
    for k in ("rounds", "rounds_unpipelined", "monolithic"):
        rec[k]["batching_ratio"] = rec[k]["configs_per_s"] / seq_rate
    log(f"[{card}] onira sequential baseline: lanes {DSE_SAMPLED} as single "
        f"runs in {seq_s:.3f} s ({seq_rate:.3f} configs/s), each equal to "
        f"its lane of run_batch and run_sweep by bits; batching ratio "
        f"{rec['rounds']['batching_ratio']:.1f}x (pipelined rounds), "
        f"{rec['rounds_unpipelined']['batching_ratio']:.1f}x (unpipelined),"
        f" {rec['monolithic']['batching_ratio']:.1f}x (run_batch)")
    rec["block"] = [_lane_block_profile(sim, st, pts[:b])
                    for b in (1, rec["rounds"]["chunk"])]
    for blk in rec["block"]:
        log(f"[{card}] onira: one lane-batched block of K="
            f"{sim.super_epoch} at {blk['lanes']} lanes: "
            f"{blk['block_ms']:.3f} ms ({blk['epoch_ms']:.4f} ms an epoch), "
            f"{blk['kernels_per_epoch']:.2f} kernels an epoch")

    fam_fn = dse.memoize_build(lambda shape: to.build_onira_family(
        progs, shape=shape))
    fam_spec = dse.SweepSpec.grid(ONIRA_FAMILY_AXES)
    fam = fam_fn(shape={"cpu": 8})
    fam_runner = dse.runner_for(fam.sim)
    rows_f, rec["family"] = _timed_sweep(
        "onira family shape.cpu x flush_cycles", card, fam_runner,
        lambda: fam_runner.warm_ladder(
            [fam.state_for()], dse.stack_params([fam.params_for()]),
            dse.make_ladder(len(fam_spec))),
        lambda: dse.run_sweep(fam_fn, fam_spec, until=ONIRA_UNTIL,
                              extract=_onira_extract))
    _check_rows("onira family", rows_f, ONIRA_SWEEP_REF["family"], cols)
    log(f"onira family: {len(rows_f)} rows equal to ONIRA_SWEEP_REF")
    return rec, rows_p, (build_fn, spec)


def check_triosim(card, cpu):
    """(c) simulate_step at every TRIOSIM_REF plan: done, step time and
    epochs against the constant, the whole final state against the port's
    CPU run (from ``cpu``); the ratio to analytic_step_us, the entry
    point's wall time, a warm run's, and kernels an epoch (16 GPUs and
    the first plan)."""
    import torch
    from repro_torch.sims import opgraph, triosim as tt

    rec = {}
    for key, want in TRIOSIM_REF.items():
        arch, layers, batch, seq, micro, dp, tp, pp = key
        cfg = _trio_cfg(arch, layers)
        name = _trio_name(key)
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = tt.simulate_step(cfg, batch, seq, dp, tp, pp, micro,
                             return_state=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = (r["done"], r["step_us"], r["epochs"])
        if got != want:
            raise AssertionError(f"triosim {name}: (done, step_us, epochs) "
                                 f"{got} != TRIOSIM_REF {want}")
        sim = r["sim"]
        _, run_s = _timed_run(sim, sim.init_state(), 5e6)
        ref = cpu.get(name)
        cpu_s = ref["seconds"]
        bad = _state_diff(r["state"], ref["state"])
        if bad:
            raise AssertionError(f"triosim {name}: card and CPU states "
                                 f"differ at {bad}")
        a = opgraph.analytic_step_us(cfg, batch, seq, dp, tp, pp, micro)
        row = dict(n_gpus=dp * tp * pp, step_us=r["step_us"],
                   epochs=r["epochs"], ratio=r["step_us"] / a,
                   analytic_us=a, entry_s=wall, run_s=run_s, cpu_s=cpu_s,
                   ports=sim.kinds[1].n_ports)
        if dp * tp * pp == 16 or not rec:
            blk = _profile_block(sim, sim.init_state(), r["step_us"] / 4)
            row["kernels_per_epoch"] = blk["kernels"] / sim.super_epoch
            row["busy_share"] = blk["busy_us"] / blk["span_us"]
        rec[name] = row
        log(f"[{card}] triosim {name} ({row['n_gpus']} GPUs, a network "
            f"kind of {row['ports']} ports): step {r['step_us']:.0f} us in "
            f"{r['epochs']} epochs, {row['ratio']:.4f}x analytic; "
            f"simulate_step {wall:.3f} s, a warm run {run_s:.3f} s"
            + (f", {row['kernels_per_epoch']:.1f} kernels an epoch, "
               f"profiled busy share of a block {row['busy_share']:.3f}"
               if "kernels_per_epoch" in row else "")
            + f"; TRIOSIM_REF matched, the state equals the CPU run's "
            f"({cpu_s:.2f} s)")
    return rec


def check_xlat(card):
    """(d) run_translation_study: the two-page chain and the page fault's
    Fig. 6b backtrace, then 1024 seeded loads against XLAT_REF."""
    import contextlib
    import io

    import numpy as np
    from repro_torch.sims import xlat as tx
    from repro_torch.sims.components import PAGE

    chain = tx.run_translation_study(list(XLAT_CHAIN))
    if chain != XLAT_REF["chain"]:
        raise AssertionError(f"xlat chain {chain} != XLAT_REF "
                             f"{XLAT_REF['chain']}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            tx.run_translation_study([8, (1 << 12) * PAGE], max_vpn=1 << 10)
        except tx.PageFault:
            pass
        else:
            raise AssertionError("xlat: an unmapped page raised no "
                                 "PageFault")
    trace = buf.getvalue()
    missing = [f for f in XLAT_FRAGMENTS if f not in trace]
    if missing:
        raise AssertionError(f"xlat backtrace lacks {missing}: {trace!r}")
    # each task level prints the chain as it unwinds: show the deepest
    log("xlat page fault, enhanced backtrace:\n"
        + "Panic" + trace.split("Panic")[1].rstrip())
    n, pages = XLAT_SEEDED["n"], XLAT_SEEDED["pages"]
    rng = np.random.default_rng(XLAT_SEEDED["seed"])
    addrs = (rng.integers(0, pages, n) * PAGE
             + rng.integers(0, PAGE // 8, n) * 8).tolist()
    t = time.perf_counter()
    r = tx.run_translation_study(addrs, until=XLAT_SEEDED["until"],
                                 return_state=True)
    wall = time.perf_counter() - t
    got = {k: r[k] for k in XLAT_REF["chain"]}
    got["epochs"] = int(r["state"].stats.epochs)
    if got != XLAT_REF["seeded"]:
        raise AssertionError(f"xlat seeded {got} != XLAT_REF "
                             f"{XLAT_REF['seeded']}")
    sim = r["sim"]
    blk = _profile_block(sim, sim.init_state(), got["virtual_time"] / 2)
    K = sim.super_epoch
    rec = dict(chain=chain, seeded=got, entry_s=wall,
               epochs_per_s=K / (blk["b2b_wall_us"] * 1e-6),
               kernels_per_epoch=blk["kernels"] / K,
               busy_share=blk["busy_us"] / blk["span_us"])
    log(f"[{card}] xlat: chain and backtrace as the reference's test; "
        f"{n} seeded loads: {got['epochs']} epochs, {got['walks']} walks, "
        f"XLAT_REF matched; run_translation_study {wall:.3f} s (capture "
        f"included); blocks back to back {rec['epochs_per_s']:.0f} "
        f"epochs/s, {rec['kernels_per_epoch']:.1f} kernels an epoch, "
        f"profiled busy share of a block {rec['busy_share']:.3f}")
    return rec


def check_tracing(card, rows_off, sweep, out_dir):
    """(e) Monitor.run_monitored on memsys with the HTTP endpoint polled
    by a thread (the final stats against MONITOR_REF), the engine trace
    into a DBTracer and its Daisen HTML, then (b)'s sweep again with a
    JsonlSink on the bus (rows identical to (b)'s) and its Chrome trace."""
    import threading
    import urllib.request

    import torch
    from repro_torch import dse
    from repro_torch.core.daisen import export_db
    from repro_torch.core.monitor import Monitor
    from repro_torch.core.tracers import DBTracer, flush_engine_trace
    from repro_torch.core.tracing import TracingDomain
    from repro_torch.obs import (BUS, JsonlSink, export_chrome_trace,
                                 read_jsonl)
    from repro_torch.sims import memsys as tm

    run = MONITOR_RUN
    sim, st = tm.build(n_cores=run["n_cores"], pattern=run["pattern"],
                       n_reqs=run["n_reqs"],
                       sample_period=run["sample_period"])
    dom = TracingDomain("rtm")
    db = dom.attach(DBTracer(str(out_dir / "monitor.db")))
    mon = Monitor(sim, st, domain=dom, http_port=0)
    seen = {"/status": 0, "/bottlenecks": 0}
    epochs, errors, stop = set(), [], threading.Event()

    def poll():
        while not stop.is_set():
            for path in seen:
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{mon.http_port}{path}",
                            timeout=5) as resp:
                        body = json.loads(resp.read().decode())
                except (OSError, ValueError) as e:
                    errors.append(f"{path}: {e!r}")
                    return
                if path == "/status":
                    epochs.add(body["epochs"])
                elif not isinstance(body, list):
                    errors.append(f"{path}: {body!r}")
                    return
                seen[path] += 1
            time.sleep(0.01)

    th = threading.Thread(target=poll, daemon=True)
    th.start()
    try:
        t = time.perf_counter()
        final, hung = mon.run_monitored(until=run["until"],
                                        chunk=run["chunk"], verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        stop.set()
        th.join(timeout=10)
        mon.shutdown()
    if errors or th.is_alive() or not all(seen.values()):
        raise AssertionError(f"monitor HTTP polling: {seen}, errors "
                             f"{errors}, poller alive {th.is_alive()}")
    got = dict(tm.finish_stats(sim, final),
               progress_ticks=int(final.stats.progress_ticks),
               sample_idx=int(final.sample_idx),
               buf_samples_sum=int(final.buf_samples.sum()),
               chunks=len(mon.history), hung=hung)
    if got != MONITOR_REF:
        raise AssertionError(f"monitored memsys {got} != MONITOR_REF "
                             f"{MONITOR_REF}")
    log(f"[{card}] monitored memsys {run['n_cores']} cores x "
        f"{run['n_reqs']} requests: {got['chunks']} chunks in {wall:.3f} s, "
        f"MONITOR_REF matched; a poller got {seen} well-formed JSON "
        f"answers ({len(epochs)} distinct snapshots)")
    flush_engine_trace(sim, final, db)
    n_busy = len(db.fetch_metrics("busy_ticks"))
    n_level = len(db.fetch_metrics("buf_level"))
    n_tasks = len(db.fetch_tasks())
    html = export_db(db, str(out_dir / "monitor.html"), title="memsys")
    db.close()
    if (n_busy, n_level, n_tasks) != (
            sim.n_comp, got["sample_idx"] * sim.n_ports_g, got["chunks"]):
        raise AssertionError(f"trace DB: {n_busy} busy rows, {n_level} "
                             f"buffer levels, {n_tasks} tasks")
    log(f"trace DB: {n_busy} busy counters, {n_level} buffer levels, "
        f"{n_tasks} monitor tasks; Daisen HTML {Path(html).stat().st_size} "
        f"bytes")

    build_fn, spec = sweep
    jl = out_dir / "sweep.jsonl"
    sink = BUS.attach(JsonlSink(str(jl)))
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        rows_on = dse.run_sweep(build_fn, spec, until=ONIRA_UNTIL,
                                extract=_onira_extract)
        torch.cuda.synchronize()
        wall_on = time.perf_counter() - t
    finally:
        BUS.detach(sink)
        sink.close()
    if rows_on != rows_off:
        raise AssertionError("onira sweep-256: rows differ with telemetry "
                             "on")
    events = read_jsonl(str(jl))
    with open(export_chrome_trace(str(jl), str(out_dir / "trace.json"))) \
            as fh:
        trace = json.load(fh)["traceEvents"]
    tracks = {e["args"]["name"] for e in trace
              if e["ph"] == "M" and e["name"] == "thread_name"}
    slices = sum(e["ph"] == "X" and e["name"].startswith("round ")
                 for e in trace)
    if not ({"rounds", "compile", "transfer"} <= tracks and slices):
        raise AssertionError(f"Chrome trace: tracks {tracks}, {slices} "
                             "round slices")
    log(f"[{card}] onira sweep-256 with a JsonlSink: {len(events)} events, "
        f"rows identical to telemetry off, {wall_on:.3f} s; Chrome trace "
        f"{len(trace)} records, {slices} round slices, tracks "
        f"{sorted(tracks)}")
    return dict(monitor=dict(wall_s=wall, polls=seen,
                             snapshots=len(epochs), **got),
                trace_db=dict(busy=n_busy, levels=n_level, tasks=n_tasks),
                telemetry=dict(events=len(events), wall_s=wall_on,
                               rows_identical=True, trace_records=len(trace),
                               round_slices=slices))


def check_sims():
    """Phase 8: the remaining sims and the tracing layer on the card."""
    card = _card()
    t_phase = time.perf_counter()
    rec = {"card": card}
    out_dir = ROOT / "build" / "sims"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.iterdir():
        f.unlink()
    parts = rec["parts_s"] = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t
        return out

    cpu = _CpuStates(out_dir)
    try:
        rec["onira"] = part("onira", check_onira, card, cpu)
        rec["onira_sweep"], rows, sweep = part("onira_sweep",
                                               check_onira_sweep, card)
        rec["triosim"] = part("triosim", check_triosim, card, cpu)
    finally:
        cpu.close()
    rec["xlat"] = part("xlat", check_xlat, card)
    rec["tracing"] = part("tracing", check_tracing, card, rows, sweep,
                          out_dir)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[{card}] phase 8 (sims) took {rec['phase_s']:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    return rec


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------
# (a) benchmarks/search_convergence.py's grid and ladder: 8 crossbar
# latencies x 6 L1 boosts x 4 DRAM periods = 192 points at memsys 8 cores x
# 24 requests (mixed); MAX_H 5600, 5 rungs (MIN_H = MAX_H / 3**4), eta 3,
# seed 0, the objective est_finish, warm promotions; a checkpoint after
# round 2.  (b) the same search at full width: memsys 64 cores x 256
# requests (the R9 Nano's 64 compute units; MEMSYS64's build) over 3 x 3 x 3
# points, 4 rungs (27 -> 9 -> 3 -> 1), MAX_H 1.1x the slowest point's drain
# time.  (c) BatchBO (qei and ts) and RandomSearch at (a)'s build, 3 rounds
# of 8, the axes given as ranges.  The procedures below take the package
# (``repro_torch.dse`` here), so tests/_search_refs.py runs them on the JAX
# package to make SEARCH_REF, SEARCH64_REF and BO_REF (CHANGES.md has the
# command).
SEARCH_AXES = {
    "conn_latency[-1]": [10.0, 20.0, 30.0, 40.0, 55.0, 70.0, 85.0, 100.0],
    "kind.l1.extra_hit_rate": [0.0, 0.15, 0.3, 0.45, 0.6, 0.8],
    "period.dram": [1.0, 2.0, 3.0, 4.0],
}
SEARCH_BUILD = dict(n_cores=8, pattern="mixed", n_reqs=24)
SEARCH_MAX_H = 5600.0
SEARCH_RUNGS = 5
SEARCH_ETA = 3
SEARCH_RESUME_AFTER = 2
SEARCH_CHUNK = 256     # the ladder top of (a)'s sweep and of (d)
SEARCH64_AXES = {"conn_latency[-1]": [10.0, 55.0, 100.0],
                 "kind.l1.extra_hit_rate": [0.0, 0.3, 0.6],
                 "period.dram": [1.0, 2.0, 4.0]}
SEARCH64_BUILD = dict(n_cores=64, pattern="mixed", n_reqs=256)
SEARCH64_RUNGS = 4
# (c)'s DRAM period is an int range: at some fractional periods both
# packages' engines stall (ROADMAP queue 3, reference limit 2)
BO_AXES = {"conn_latency[-1]": (10.0, 100.0),
           "kind.l1.extra_hit_rate": (0.0, 0.8),
           "period.dram": (1, 4)}
BO_RUNS = ("qei", "ts", "random")
BO_BATCH, BO_ROUNDS = 8, 3
SEARCH_REF = {"exhaustive": {"n": 192,
                             "optimum": 356.0,
                             "budget": 363617.0,
                             "drained": True,
                             "rows_sha256": "070d5511b82991a68c3976512df78632"
                                            "0f08cb3426eb908f5b2331442d698f37"},
              "search": {"best": 356.0,
                         "best_point": {"conn_latency[-1]": 10.0,
                                        "kind.l1.extra_hit_rate": 0.8,
                                        "period.dram": 1.0},
                         "budget": 26595.0,
                         "rounds": 5,
                         "trials": 289,
                         "rows_sha256": "b9a4240ac1d100ecf06fb83e07eb5030"
                                        "e60568363cfe9f455855d1a9efa19ba7",
                         "state_sha256": "5e1d1ac110f2ed159189d139e0d2258c"
                                         "7a762306aea11706c8e526a1b2911b04"}}
SEARCH64_REF = {"max_h": 519900.0,
                "drains": [48900.0, 52744.0, 65562.0, 33197.0, 36240.0,
                           47810.0, 19447.0, 21096.0, 27478.0,
                           244740.0, 244743.0, 255491.0, 171768.0,
                           169647.0, 169487.0, 98266.0, 95857.0,
                           95973.0, 440580.0, 444424.0, 472576.0,
                           308609.0, 306806.0, 312864.0, 175919.0,
                           172922.0, 177854.0],
                "exhaustive": {"n": 27, "optimum": 19447.0,
                               "budget": 4711000.0},
                "search": {"best": 19447.0,
                           "best_point": {"conn_latency[-1]": 10.0,
                                          "kind.l1.extra_hit_rate": 0.6,
                                          "period.dram": 1.0},
                           "budget": 690776.0,
                           "rounds": 4,
                           "trials": 40,
                           "rows_sha256": "d6bacb3973ea1c2390093299c3c1f5eb"
                                          "a617e1f62e711cdbac71c80d23e224c6",
                           "state_sha256": "a63b476c1f551b756544ad2e38a23806"
                                           "bfe086953f0b39dec31d4a2d164ef5ad"}}
BO_REF = {"qei": {"best": 380.0,
                  "best_point": {"conn_latency[-1]": 10.92853528916319,
                                 "kind.l1.extra_hit_rate": 0.7933076486521994,
                                 "period.dram": 1},
                  "budget": 26154.0,
                  "rounds": 3,
                  "trials": 24,
                  "rows_sha256": "8393de51543c5f5d892b8ca8492bc200"
                                 "0d03970c199872457f34edfa42a211c7",
                  "state_sha256": "77b19c714ad9f9d726add3ff456199ee"
                                  "37d0ff1155d580eaa7a8fb116095d419"},
          "ts": {"best": 409.0,
                 "best_point": {"conn_latency[-1]": 10.136273396418545,
                                "kind.l1.extra_hit_rate": 0.7152542471246658,
                                "period.dram": 1},
                 "budget": 32391.0,
                 "rounds": 3,
                 "trials": 24,
                 "rows_sha256": "4798c71b1b1a0a37a61ad41ed2f6a680"
                                "846ef0f1313f553a21e2622b0944ef65",
                 "state_sha256": "3e60eb92e123612f1a72e92da9e37317"
                                 "6325a456c23b9f93b78054c33ad1668e"},
          "random": {"best": 380.0,
                     "best_point": {"conn_latency[-1]": 10.92853528916319,
                                    "kind.l1.extra_hit_rate": 0.7933076486521994,
                                    "period.dram": 1},
                     "budget": 37987.0,
                     "rounds": 3,
                     "trials": 24,
                     "rows_sha256": "10c5d8b47fc495e3f40ab9db2dd233ab"
                                    "521203e99f3f56a918ace589f9de6284",
                     "state_sha256": "0cb80cb6d3f105d51e7e520526241f2d"
                                     "f2a74daa3ee712ed6c9ddd8d23351556"}}


def digest(obj):
    """sha256 of a text, or of an object's canonical JSON."""
    import hashlib
    text = obj if isinstance(obj, str) else json.dumps(
        obj, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(text.encode()).hexdigest()


def search_extract(state):
    """benchmarks/search_convergence.py's extractor over ``state``'s
    requests: virtual time, requests left, and ``est_finish``, the
    completion time estimated from the requests done."""
    total = int(state.comp_state["core"]["remaining"].sum())

    def extract(sim, s):
        rem = int(s.comp_state["core"]["remaining"].sum())
        vt = float(s.time)
        return {"virtual_time": vt, "remaining": rem,
                "est_finish": vt * total / max(total - rem, 1)}
    return extract


def halving(dse, pool, max_h, rungs, state=None):
    """The seeded warm successive halving of phase 9 (a) and (b)."""
    return dse.SuccessiveHalving(pool, "est_finish", max_horizon=max_h,
                                 rungs=rungs, eta=SEARCH_ETA, seed=0,
                                 state=state)


def bo_driver(dse, which):
    """Phase 9 (c)'s drivers: BatchBO by acquisition, or RandomSearch."""
    kw = dict(horizon=SEARCH_MAX_H, batch=BO_BATCH, rounds=BO_ROUNDS, seed=0)
    if which == "random":
        return dse.RandomSearch(BO_AXES, "est_finish", **kw)
    return dse.BatchBO(BO_AXES, "est_finish", acquisition=which, **kw)


def search_summary(res, axes):
    """What SEARCH_REF, SEARCH64_REF and BO_REF hold of a search."""
    return dict(best=res.best["est_finish"],
                best_point={a: res.best[a] for a in axes},
                budget=res.budget, rounds=res.rounds, trials=len(res.rows),
                rows_sha256=digest(res.rows),
                state_sha256=digest(res.state.to_json()))


def exhaustive_summary(rows):
    """The exhaustive sweep's optimum and simulated-cycle budget."""
    return dict(n=len(rows), optimum=min(r["est_finish"] for r in rows),
                budget=sum(r["virtual_time"] for r in rows),
                drained=all(r["remaining"] == 0 for r in rows),
                rows_sha256=digest(rows))


def _held(name, got, ref):
    """``got`` must equal the JAX package's ``ref``; else name both."""
    if got != ref:
        raise AssertionError(f"{name}: {got!r} != the JAX package's "
                             f"{ref!r}")


def _search_timed(dse, runner, fn):
    """Run ``fn`` on the card, timed on the host's clock to a device sync;
    also the blocks it captured."""
    import torch
    tc = runner.trace_count
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, runner.trace_count - tc


def _dir_bytes(path):
    return sum(p.stat().st_size for p in Path(path).rglob("*")
               if p.is_file())


def _search_record(res, wall, caps, exhaustive_budget):
    return dict(wall_s=wall, rounds=res.rounds, trials=len(res.rows),
                captures=caps, budget=res.budget,
                budget_share=res.budget / exhaustive_budget,
                best=res.best["est_finish"], points_per_s=len(res.rows) / wall)


def check_search_a(card, out_dir):
    """(a) the exhaustive 192-point sweep and the seeded search against
    SEARCH_REF; a checkpoint after round 2 resumed to the identical rows,
    best and budget; a repeat search that captures nothing."""
    from repro_torch import dse
    from repro_torch.sims import memsys as tm
    bf = dse.memoize_build(lambda: tm.build(**SEARCH_BUILD))
    sim, st = bf()
    runner = dse.runner_for(sim)
    ex = search_extract(st)
    pool = dse.SweepSpec.grid(SEARCH_AXES)
    full, wall, caps = _search_timed(dse, runner, lambda: dse.run_sweep(
        bf, pool, until=SEARCH_MAX_H, extract=ex, chunk=SEARCH_CHUNK))
    exh = exhaustive_summary(full)
    _held("(a) exhaustive sweep", exh, SEARCH_REF["exhaustive"])
    rec = dict(exhaustive=dict(points=len(full), wall_s=wall, captures=caps,
                               budget=exh["budget"], optimum=exh["optimum"],
                               points_per_s=len(full) / wall))
    saves = []

    def snapshot(drv):
        if drv.state.round == SEARCH_RESUME_AFTER:
            t = time.perf_counter()
            saves.append(dse.save_search(str(out_dir / "round2"), drv))
            saves.append(time.perf_counter() - t)

    res, wall, caps = _search_timed(dse, runner, lambda: dse.run_search(
        bf, halving(dse, pool, SEARCH_MAX_H, SEARCH_RUNGS), extract=ex,
        callback=snapshot))
    _held("(a) search", search_summary(res, SEARCH_AXES),
          SEARCH_REF["search"])
    rec["search"] = _search_record(res, wall - saves[1], caps, exh["budget"])
    t = time.perf_counter()
    state, handles = dse.load_search(str(out_dir / "round2"), st)
    load_s = time.perf_counter() - t
    if any(x.device != st.time.device for h in handles.values()
           for x in dse.search.ref_leaves(h.state)):
        raise AssertionError("(a) load_search put a handle off the card")
    drv = halving(dse, pool, SEARCH_MAX_H, SEARCH_RUNGS, state=state)
    drv.adopt_handles(handles)
    resumed, wall, caps = _search_timed(dse, runner, lambda: dse.run_search(
        bf, drv, extract=ex))
    got = (resumed.rows == res.rows, resumed.best == res.best,
           resumed.budget == res.budget,
           resumed.rounds == res.rounds - SEARCH_RESUME_AFTER)
    if not all(got):
        raise AssertionError(f"(a) resumed after round 2: rows, best, "
                             f"budget, rounds equal {got}")
    rec["resume"] = dict(after_round=SEARCH_RESUME_AFTER,
                         handles=len(handles), ckpt_bytes=_dir_bytes(
                             saves[0]), save_s=saves[1], load_s=load_s,
                         wall_s=wall, captures=caps)
    again, wall, caps = _search_timed(dse, runner, lambda: dse.run_search(
        bf, halving(dse, pool, SEARCH_MAX_H, SEARCH_RUNGS), extract=ex))
    if caps or again.rows != res.rows:
        raise AssertionError(f"(a) the repeat search captured {caps} "
                             "blocks or changed its rows")
    rec["repeat"] = dict(wall_s=wall, captures=caps)
    log(f"[{card}] (a) exhaustive {len(full)} points in "
        f"{rec['exhaustive']['wall_s']:.2f} s ({rec['exhaustive']['captures']}"
        f" captures), optimum {exh['optimum']}, {exh['budget']} cycles; "
        f"search {res.rounds} rounds, {len(res.rows)} trials in "
        f"{rec['search']['wall_s']:.2f} s, best {res.best['est_finish']}, "
        f"{res.budget} cycles ({100 * rec['search']['budget_share']:.2f}% "
        f"of exhaustive): SEARCH_REF matched; resumed after round 2 "
        f"({len(handles)} handles, {rec['resume']['ckpt_bytes']} bytes) "
        f"identical; repeat {rec['repeat']['wall_s']:.2f} s, 0 captures")
    return rec, (bf, sim, st, ex, pool, full)


def check_search_b(card):
    """(b) the same search at 64 cores x 256 requests against
    SEARCH64_REF; returns the rung-end state promoted into the last rung
    (the state (e) saves)."""
    from repro_torch import dse
    from repro_torch.sims import memsys as tm
    bf = dse.memoize_build(lambda: tm.build(**SEARCH64_BUILD))
    sim, st = bf()
    runner = dse.runner_for(sim)
    pool = list(dse.SweepSpec.grid(SEARCH64_AXES))
    last = {}
    res, wall, caps = _search_timed(dse, runner, lambda: dse.run_search(
        bf, halving(dse, pool, SEARCH64_REF["max_h"], SEARCH64_RUNGS),
        extract=search_extract(st),
        callback=lambda d: last.update(d._handle_store)))
    _held("(b) search at 64 cores", search_summary(res, SEARCH64_AXES),
          SEARCH64_REF["search"])
    ref = SEARCH64_REF["exhaustive"]
    rec = _search_record(res, wall, caps, ref["budget"])
    rec.update(points=len(pool), max_h=SEARCH64_REF["max_h"],
               exhaustive_budget=ref["budget"], optimum=ref["optimum"])
    log(f"[{card}] (b) 64 cores x 256 requests: {res.rounds} rounds, "
        f"{len(res.rows)} trials in {wall:.2f} s ({caps} captures), best "
        f"{res.best['est_finish']} (the grid's optimum {ref['optimum']}), "
        f"{res.budget} cycles = {100 * rec['budget_share']:.2f}% of the "
        f"exhaustive {ref['budget']}: SEARCH64_REF matched")
    state = list(last.values())[-1].state
    return rec, state


def check_search_c(card, a):
    """(c) BatchBO (qei, ts) and RandomSearch at (a)'s build, against
    BO_REF."""
    from repro_torch import dse
    bf, sim, st, ex, *_ = a
    runner = dse.runner_for(sim)
    rec = {}
    for which in BO_RUNS:
        res, wall, caps = _search_timed(dse, runner, lambda: dse.run_search(
            bf, bo_driver(dse, which), extract=ex))
        _held(f"(c) {which}", search_summary(res, BO_AXES), BO_REF[which])
        rec[which] = dict(wall_s=wall, rounds=res.rounds,
                          trials=len(res.rows), captures=caps,
                          budget=res.budget, best=res.best["est_finish"])
        log(f"[{card}] (c) {which}: {res.rounds} rounds of {BO_BATCH} in "
            f"{wall:.2f} s ({caps} captures), best {res.best['est_finish']}"
            f": BO_REF matched")
    return rec


def check_search_d(card, a):
    """(d) LaneMux: (a)'s grid on the 8-core build and phase 6's 16-core
    build over 32 of its points, each job's rows equal to its own solo
    run_sweep ((a)'s exhaustive sweep for the first), with no capture
    over the solo runs."""
    from repro_torch import dse
    from repro_torch.sims import memsys as tm
    bf, sim, st, ex, pool, solo_a = a        # (a)'s exhaustive sweep
    sim16, st16 = tm.build(n_cores=16, pattern="mixed", n_reqs=96)
    bf16 = dse.memoize_build(lambda: (sim16, st16))
    spec16 = dse.SweepSpec.explicit(_dse_points(256)[::8])
    u16 = _dse_untils(256, MEMSYS_REF["mixed"]["horizon"])[::8]
    runners = (dse.runner_for(sim), dse.runner_for(sim16))
    chunk = SEARCH_CHUNK
    solo_b, wall_b, _ = _search_timed(dse, runners[1], lambda: dse.run_sweep(
        bf16, spec16, until=u16, chunk=chunk))
    tc = [r.trace_count for r in runners]
    mux = dse.LaneMux()
    mux.submit("search192", bf, pool, SEARCH_MAX_H, extract=ex)
    mux.submit("sweep32", bf16, spec16, u16)
    got, wall, _ = _search_timed(dse, runners[0],
                                 lambda: mux.run(chunk=chunk))
    caps = sum(r.trace_count for r in runners) - sum(tc)
    if got["search192"] != solo_a or got["sweep32"] != solo_b:
        raise AssertionError("(d) a multiplexed job's rows differ from its "
                             "solo run_sweep")
    if caps:
        raise AssertionError(f"(d) the mux captured {caps} blocks over the "
                             "solo runs")
    rec = dict(points=len(pool) + len(spec16), wall_s=wall,
               solo_b_wall_s=wall_b, captures=caps,
               points_per_s=(len(pool) + len(spec16)) / wall)
    log(f"[{card}] (d) mux of {len(pool)} + {len(spec16)} points in "
        f"{wall:.2f} s (solo: (a)'s exhaustive sweep and {wall_b:.2f} s): "
        f"rows equal to the solo runs, 0 captures over them")
    return rec


def check_search_e(card, state64, out_dir):
    """(e) CheckpointManager: async saves of (b)'s 64-core state and of a
    small tree with bf16, int64, NaN and +-inf leaves, keep=2 over 3
    saves, restored onto the card bit for bit."""
    import torch
    from repro_torch.ckpt import CheckpointManager, list_steps
    from repro_torch.core import engine
    from repro_torch.core.engine import tree_map
    from repro_torch.dse.search import ref_leaves
    dev = engine.resolve_device(None)
    on_card = tree_map(lambda x: x.to(dev), state64)
    f = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 1.5],
                     device=dev)
    tree = {"state": ref_leaves(on_card),
            "small": {"bf16": f.to(torch.bfloat16), "f32": f,
                      "i64": torch.tensor([2**40 + 1, -(2**35)],
                                          device=dev)}}
    path = out_dir / "manager"
    mgr = CheckpointManager(str(path), keep=2)
    call_s = []
    t = time.perf_counter()
    for step in range(3):
        c = time.perf_counter()
        mgr.save(tree, step)
        call_s.append(time.perf_counter() - c)
    mgr.wait()
    save_s = time.perf_counter() - t
    steps = list_steps(str(path))
    if steps != [1, 2] or mgr.latest_step() != 2:
        raise AssertionError(f"(e) keep=2 over 3 saves left steps {steps}")
    t = time.perf_counter()
    back, _ = mgr.restore(tree)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    mine, want = ref_leaves(back), ref_leaves(tree)
    for i, (x, y) in enumerate(zip(mine, want)):
        if x.device != y.device or x.dtype != y.dtype \
                or x.shape != y.shape:
            raise AssertionError(f"(e) leaf {i}: {x.device} {x.dtype} "
                                 f"{tuple(x.shape)}, saved {y.device} "
                                 f"{y.dtype} {tuple(y.shape)}")
        bits = lambda a: a.reshape(-1).view(torch.uint8)
        if not torch.equal(bits(x), bits(y)):
            raise AssertionError(f"(e) leaf {i} differs in its bits")
    rec = dict(leaves=len(want), steps=steps,
               ckpt_bytes=_dir_bytes(path / "step_00000002"),
               save_call_s=call_s, save_s=save_s, restore_s=restore_s)
    log(f"[{card}] (e) 3 async saves of {len(want)} leaves "
        f"({rec['ckpt_bytes']} bytes each) in {save_s:.3f} s (save() "
        f"returned in {max(call_s):.3f} s at most), restored onto the card "
        f"in {restore_s:.3f} s bit for bit; steps kept {steps}")
    return rec


def check_search():
    """Phase 9: closed-loop search, the lane multiplexer and checkpoints
    on the card."""
    import shutil
    card = _card()
    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "search"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    rec = {"card": card}
    parts = rec["parts_s"] = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t
        return out

    rec["a"], a = part("a", check_search_a, card, out_dir)
    rec["b"], state64 = part("b", check_search_b, card)
    rec["c"] = part("c", check_search_c, card, a)
    rec["d"] = part("d", check_search_d, card, a)
    rec["e"] = part("e", check_search_e, card, state64, out_dir)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[{card}] phase 9 (search) took {rec['phase_s']:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    return rec


# ---------------------------------------------------------------------------
# phase 10
# ---------------------------------------------------------------------------
# hymba-1.5b's attention and SSM at its training shapes: S=256, S=2048
# where the window of 1024 acts, and the main run's B=2 x S=2048 with the
# window and without it (its 3 global layers)
TRAIN_FA_CASES = [(1, 256, 25, 5, 64, True, 1024, 0.0),
                  (1, 2048, 25, 5, 64, True, 1024, 0.0),
                  (2, 2048, 25, 5, 64, True, 1024, 0.0),
                  (2, 2048, 25, 5, 64, True, 0, 0.0)]
TRAIN_SSD_CASES = [(B, S, 50, 64, 16, 128)
                   for B, S in ((1, 256), (1, 2048), (2, 2048))]
TRAIN_SMOKE = ("hymba-1.5b", "stablelm-1.6b")
TRAIN_SMOKE_LR = 1e-2
TRAIN_STEP_TOL = 1e-4     # card against CPU, f32, of the largest magnitude
TRAIN_MAIN = dict(arch="hymba-1.5b", steps=6, batch=2, seq=2048, lr=3e-4)
# (f) suspect S1 (ROADMAP queue 3): launch.train's run of hymba-smoke, bf16
# (4 steps of B=2 x S=64, lr 1e-3), from parameters drawn on the CPU from
# one seed, on the card and on the CPU.  The curves may part by one bf16
# ulp of the loss (2^-8, its relative spacing) a step: each side rounds
# its bf16 operands (activations, logits, the parameters after each
# update) in its own order, and those differences compound once a step.
S1_RUN = dict(arch="hymba-1.5b", steps=4, batch=2, seq=64, lr=1e-3, seed=0)
S1_ULP = 2.0 ** -8


def _grads_of(fn, inputs, weights):
    """(gradients, outputs) of L = sum(out * w) + sum(out^2) / 2 over
    ``fn``'s outputs, at fresh leaf copies of ``inputs``: the quadratic
    term puts ``fn``'s own outputs into the upstream gradient."""
    import torch
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o.float() * w).sum() + 0.5 * (o.float() ** 2).sum()
               for o, w in zip(outs, weights))
    return torch.autograd.grad(loss, leaves), outs


def _held_grads(name, got, ref, dn, labels):
    """Each gradient within the kernel tests' tolerance of its largest
    |ref|; returns the largest error relative to that."""
    tol = TOL[name][dn]
    worst = 0.0
    for lab, g, r in zip(labels, got, ref):
        g, r = g.float(), r.float()
        if not bool(g.isfinite().all()):
            raise AssertionError(f"{name} {dn}: non-finite d{lab}")
        scale = float(r.abs().max())
        err = float((g - r).abs().max()) / max(scale, 1e-30)
        if err > tol:
            raise AssertionError(f"{name} {dn}: d{lab} differs by {err:.3g}"
                                 f" of its max {scale:.3g} (tol {tol})")
        worst = max(worst, err)
    return worst


def check_kernel_grads(dev, gen):
    """(a) FlashAttentionFn's and SSDFn's outputs and gradients (the
    kernel's forward, the plain version's backward) against the plain
    versions and their autograd, on the card, in bf16 and f32: outputs
    within the kernel tests' tolerance as in phase 2, gradients within it
    of each gradient's max."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.ssd import kernel as ssdk
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_chunked

    rec = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for B, S, H, KV, hd, causal, window, cap in TRAIN_FA_CASES:
            qkv = _qkv(gen, dev, B, S, H, KV, hd, dtype)
            w = [torch.randn((B, S, H, hd), generator=gen, device=dev)]
            kw = dict(causal=causal, window=window, cap=cap)
            got, out = _grads_of(lambda q, k, v: fa_ops.flash_attention(
                q, k, v, None, None, **kw), qkv, w)
            ref, out_ref = _grads_of(lambda q, k, v: flash_attention_ref(
                q, k, v, **kw), qkv, w)
            eo = compare("flash_attention", out[0], out_ref[0], dn)
            e = _held_grads("flash_attention", got, ref, dn, "qkv")
            r = rec[f"flash {dn} B={B} S={S} w={window}"] = dict(out=eo,
                                                                 grad=e)
            line = (f"grad flash_attention {dn} B={B} S={S} H={H} KV={KV} "
                    f"hd={hd} window={window}: output max_abs_err {eo:.3g}; "
                    f"dq, dk, dv within {e:.3g} of their max (tol "
                    f"{TOL['flash_attention'][dn]})")
            if B == 2 and dtype == torch.bfloat16:   # the training shape
                q, k, v = qkv
                r["ms"] = time_ms(lambda: fak.flash_attention(q, k, v, **kw))
                r["sdpa_ms"] = time_ms(_sdpa(q, k, v, S, window))
                r["bound_ms"], r["bound_by"] = bound(   # q, k, v, out
                    nbytes(q, k, v) + nbytes(q),
                    4 * B * H * hd * _attn_pairs(S, causal, window), dn)
                line += (f"; kernel forward {r['ms']:.4f} ms, sdpa "
                         f"{r['sdpa_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
                         f"ms ({r['bound_by']})")
            log(line)
        for B, S, H, P, N, chunk in TRAIN_SSD_CASES:
            ins = (torch.randn((B, S, H, P), generator=gen,
                               device=dev).to(dtype),
                   F.softplus(torch.randn((B, S, H), generator=gen,
                                          device=dev) - 1.0),
                   -torch.exp(torch.randn((H,), generator=gen,
                                          device=dev) * 0.3),
                   torch.randn((B, S, N), generator=gen,
                               device=dev).to(dtype),
                   torch.randn((B, S, N), generator=gen,
                               device=dev).to(dtype))
            w = [torch.randn((B, S, H, P), generator=gen, device=dev),
                 torch.randn((B, H, P, N), generator=gen, device=dev)]
            got, out = _grads_of(lambda *a: ssd_ops.ssd(*a, chunk), ins, w)
            ref, out_ref = _grads_of(lambda *a: ssd_chunked(*a, chunk), ins,
                                     w)
            eo = max(compare("ssd", o, r, dn) for o, r in zip(out, out_ref))
            e = _held_grads("ssd", got, ref, dn,
                            ("xs", "dt", "A", "B", "C"))
            r = rec[f"ssd {dn} B={B} S={S}"] = dict(out=eo, grad=e)
            line = (f"grad ssd {dn} B={B} S={S} H={H} P={P} N={N} chunk="
                    f"{chunk}: y and state max_abs_err {eo:.3g}; dxs, ddt, "
                    f"dA, dB, dC within {e:.3g} of their max (tol "
                    f"{TOL['ssd'][dn]})")
            if B == 2 and dtype == torch.bfloat16:   # the training shape
                r["ms"] = time_ms(lambda: ssdk.ssd(*ins, chunk=chunk))
                r["bound_ms"], r["bound_by"] = bound(
                    nbytes(*ins, *out), _ssd_ops(B, S, H, P, N, chunk), dn)
                line += (f"; kernel forward {r['ms']:.4f} ms, bound "
                         f"{r['bound_ms']:.4f} ms ({r['bound_by']}), no "
                         f"single PyTorch call")
            log(line)
    return rec


def _f32_step_pair(dev, arch):
    """(b) One f32 train step of ``arch``'s smoke config on the card and
    on the CPU from the same weights, batch and state: the f32 kernels'
    training path.  Returns the record and the card's launches."""
    import copy

    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataPipeline
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.ssd import kernel as ssdk
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw_init
    from repro_torch.core.engine import ref_leaves
    from repro_torch.train.step import (TrainHParams, make_train_step,
                                        value_and_grad)

    cfg = get_smoke_config(arch)
    cpu = tfm.init_model(cfg, 3, device="cpu", dtype=torch.float32,
                         requires_grad=True)
    gpu = copy.deepcopy(cpu).to(dev)
    batch = DataPipeline(cfg, batch=2, seq=32, seed=1)(0)
    hp = TrainHParams(lr=TRAIN_SMOKE_LR)
    out = {}
    _zero_flash_counts()
    ssdk.launches = 0
    for side, model in (("cpu", cpu), ("card", gpu)):
        tb = {k: torch.as_tensor(v, device=model.device)
              for k, v in batch.items()}
        _, g = value_and_grad(cfg, model, tb)
        opt = adamw_init(tfm.param_tree(model))
        loss, gnorm, model, _ = make_train_step(cfg, hp)(model, opt, tb)
        out[side] = dict(g=[t.float().cpu() for t in ref_leaves(g)],
                         p=[t.detach().float().cpu() for t in
                            ref_leaves(tfm.param_tree(model))],
                         loss=float(loss), gnorm=float(gnorm))
    torch.cuda.synchronize()
    launches = {"flash_attention": fak.launches, "ssd": ssdk.launches}
    want = {"flash_attention": 4 * cfg.n_layers if cfg.has_attn else 0,
            "ssd": 4 * cfg.n_layers if cfg.has_ssm else 0}
    if launches != want:
        raise AssertionError(f"{arch}-smoke f32 step: launches {launches}, "
                             f"want {want} (forward and recompute, twice)")
    c, k = out["cpu"], out["card"]
    for key in ("loss", "gnorm"):
        if abs(k[key] - c[key]) > TRAIN_STEP_TOL * abs(c[key]):
            raise AssertionError(f"{arch}-smoke f32 step: {key} card "
                                 f"{k[key]} vs CPU {c[key]}")
    gmax = max(float(t.abs().max()) for t in c["g"])
    gerr = max(float((a - b).abs().max()) for a, b in zip(k["g"], c["g"]))
    if gerr > TRAIN_STEP_TOL * gmax:
        raise AssertionError(f"{arch}-smoke f32 gradients: card vs CPU "
                             f"{gerr:.3g} > {TRAIN_STEP_TOL} x {gmax:.3g}")
    pmax = max(float(t.abs().max()) for t in c["p"])
    d = [(a - b).abs() for a, b in zip(k["p"], c["p"])]
    perr = max(float(x.max()) for x in d)
    moved = sum(int((x > 1e-6).sum()) for x in d)
    total = sum(x.numel() for x in d)
    # AdamW's first step is a sign: where a gradient is within rounding
    # of 0 the two sides may move a parameter by +lr and -lr
    if perr > 2 * TRAIN_SMOKE_LR * 1.001:
        raise AssertionError(f"{arch}-smoke f32 step: a parameter moved "
                             f"{perr:.3g} apart (> 2 lr)")
    rec = dict(loss_card=k["loss"], loss_cpu=c["loss"],
               gnorm_card=k["gnorm"], gnorm_cpu=c["gnorm"],
               grad_err_of_max=gerr / gmax, param_err=perr,
               param_err_of_max=perr / pmax, moved_over_1e6=moved,
               params=total, launches=launches)
    log(f"{arch}-smoke f32 train step, card vs CPU: loss {k['loss']:.7f} "
        f"vs {c['loss']:.7f}, gnorm {k['gnorm']:.7f} vs {c['gnorm']:.7f}, "
        f"gradients within {gerr / gmax:.3g} of the largest (tol "
        f"{TRAIN_STEP_TOL}); updated parameters within {perr:.3g} "
        f"({perr / pmax:.3g} of the largest), {moved} of {total} apart by "
        f"more than 1e-6 (sign flips at |g| ~ 0); launches {launches}")
    return rec, launches


def _resume_run(dev, out_dir):
    """20 uninterrupted steps against 10 steps, a checkpoint and a resume
    to 20, on the card: True when parameters and state agree bit for
    bit."""
    import dataclasses
    import shutil

    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataPipeline
    from repro_torch.core.engine import ref_leaves
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.step import TrainHParams

    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"),
                              n_layers=2, d_model=32, n_heads=2,
                              n_kv_heads=2, head_dim=16, d_ff=64, vocab=64)
    hp = TrainHParams(lr=1e-2)
    shutil.rmtree(out_dir, ignore_errors=True)

    def run(sub, steps, every):
        return train(cfg, DataPipeline(cfg, batch=4, seq=16, seed=0),
                     LoopConfig(steps=steps, ckpt_every=every,
                                ckpt_dir=str(out_dir / sub),
                                log_every=1000), hp, device=dev)
    pa, oa, _ = run("a", 20, 100)
    run("b", 10, 10)
    pb, ob, hist = run("b", 20, 100)
    shutil.rmtree(out_dir, ignore_errors=True)
    if [h["step"] for h in hist] != list(range(10, 20)):
        raise AssertionError(f"resume ran steps {[h['step'] for h in hist]}")
    same = all(torch.equal(a, b) for a, b in
               zip(pa.parameters(), pb.parameters()))
    return same and all(torch.equal(a, b) for a, b in
                        zip(ref_leaves(oa), ref_leaves(ob)))


def check_resume(dev):
    """(c) Kill and resume bit for bit on the card, with PyTorch's default
    algorithms (no ``use_deterministic_algorithms``)."""
    t = time.perf_counter()
    if not _resume_run(dev, ROOT / "build" / "train" / "resume"):
        raise AssertionError("resume is not bit-exact on the card")
    rec = dict(bit_exact=True, s=time.perf_counter() - t)
    log(f"kill and resume on the card (20 steps against 10 + resume to 20): "
        f"parameters and AdamW state bit for bit ({rec['s']:.1f} s)")
    return rec


class _StepLaunches:
    """Tracer: both kernels' launches inside each ``train`` step task, and
    the flash backward kernel's (``flash_attention_bwd``)."""

    def __init__(self):
        self.steps: list[dict] = []
        self._t0 = None
        self.ckpt_end = None      # host clock when the last save returned

    @staticmethod
    def _now():
        from repro_torch.kernels.flash_attention import kernel as fak
        from repro_torch.kernels.ssd import kernel as ssdk
        return {"flash_attention": fak.launches, "ssd": ssdk.launches,
                "flash_attention_bwd": fak.bwd_launches}

    def on_start(self, t):
        if t.category == "train":
            self._t0 = self._now()

    def on_end(self, t):
        if t.category == "train":
            now = self._now()
            self.steps.append({k: now[k] - self._t0[k] for k in now})
        if t.category == "checkpoint":
            self.ckpt_end = time.perf_counter()

    def on_tag(self, t, tag):
        pass


def _kernel_vs_backward(dev, gen, cfg, B, S):
    """Each kernel's forward time (a CUDA graph of 20 calls) against its
    Function's backward (eager) at one hymba layer's training shapes,
    bf16: flash's backward kernel, the SSD's plain version recomputed and
    differentiated."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention.autograd import FlashAttentionFn
    from repro_torch.kernels.ssd import kernel as ssdk
    from repro_torch.kernels.ssd.autograd import SSDFn

    bf = torch.bfloat16
    H, KV, hd, w = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
    q, k, v = (t.requires_grad_() for t in _qkv(gen, dev, B, S, H, KV, hd,
                                                  bf))
    o = FlashAttentionFn.apply(q, k, v, True, w, 0.0, None)
    g = torch.randn_like(o)
    fa_fwd = time_ms(lambda: fak.flash_attention(q.detach(), k.detach(),
                                                 v.detach(), window=w))
    fa_bwd = eager_ms(lambda: torch.autograd.grad(o, (q, k, v), g,
                                                  retain_graph=True), reps=3)
    Hs, P, N, chunk = cfg.n_ssm_heads, cfg.ssm_headdim, cfg.ssm_state, \
        cfg.ssm_chunk
    ins = [torch.randn((B, S, Hs, P), generator=gen, device=dev).to(bf),
           F.softplus(torch.randn((B, S, Hs), generator=gen, device=dev)
                      - 1.0),
           -torch.exp(torch.randn((Hs,), generator=gen, device=dev) * 0.3),
           torch.randn((B, S, N), generator=gen, device=dev).to(bf),
           torch.randn((B, S, N), generator=gen, device=dev).to(bf)]
    ins = [t.requires_grad_() for t in ins]
    y, _ = SSDFn.apply(*ins, chunk)
    gy = torch.randn_like(y)
    ssd_fwd = time_ms(lambda: ssdk.ssd(*(t.detach() for t in ins),
                                       chunk=chunk))
    ssd_bwd = eager_ms(lambda: torch.autograd.grad(y, ins, gy,
                                                   retain_graph=True),
                       reps=3)
    rec = dict(flash_fwd_ms=fa_fwd, flash_bwd_ms=fa_bwd,
               ssd_fwd_ms=ssd_fwd, ssd_plain_bwd_ms=ssd_bwd)
    log(f"one hymba layer at B={B} S={S}, bf16: flash kernel forward "
        f"{fa_fwd:.4f} ms, its backward kernel {fa_bwd:.3f} ms; SSD kernel "
        f"forward {ssd_fwd:.4f} ms, its plain backward {ssd_bwd:.3f} ms")
    return rec


def train_hymba(dev, gen):
    """(d) The main path: ``repro_torch.train.loop.train`` on hymba-1.5b
    whole, bf16, TRAIN_MAIN's steps of ``DataPipeline`` batches, f32
    moments, block remat; both kernels launch twice a layer a step."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tracing import TracingDomain
    from repro_torch.data import DataPipeline
    from repro_torch.kernels.ssd import kernel as ssdk
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.step import TrainHParams, make_train_step

    m = TRAIN_MAIN
    cfg = get_config(m["arch"])
    if cfg.remat != "block":
        raise AssertionError(f"{cfg.name}: remat {cfg.remat!r}, want block")
    _free(dev)
    model, n = _init_model(cfg, dev, torch.bfloat16)
    model.requires_grad_(True)
    out_dir = ROOT / "build" / "train" / "hymba"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    need = 3 * 4 * n               # params (bf16 stored as f32), m, v
    free = shutil.disk_usage(out_dir).free
    log(f"checkpoint of {need / 1e9:.1f} GB due at the last step; "
        f"{free / 1e9:.1f} GB free under {out_dir}")
    if free < 1.1 * need:
        raise AssertionError(f"not enough disk for the final checkpoint: "
                             f"{free} bytes free, {need} needed")
    dom = TracingDomain("train")
    spy = dom.attach(_StepLaunches())
    timer = dom.attach(_Timer())
    data = DataPipeline(cfg, batch=m["batch"], seq=m["seq"], seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts()
    ssdk.launches = 0
    t = time.perf_counter()
    model, opt, hist = train(
        cfg, data, LoopConfig(steps=m["steps"], ckpt_every=10 ** 9,
                              ckpt_dir=str(out_dir), keep=1, log_every=1),
        TrainHParams(lr=m["lr"]), domain=dom, resume=False,
        params=model, device=dev)
    t_end = time.perf_counter()
    wall = t_end - t
    peak = torch.cuda.max_memory_allocated()
    launches = _StepLaunches._now()
    ck = [d for d in out_dir.iterdir() if d.name.startswith("step_")]
    ck_bytes = sum(f.stat().st_size for d in ck for f in d.iterdir())
    copy_s = timer.spans["checkpoint"][0] / 1e3
    write_s = t_end - spy.ckpt_end
    shutil.rmtree(out_dir, ignore_errors=True)
    losses = [h["loss"] for h in hist]
    gnorms = [h["gnorm"] for h in hist]
    if len(hist) != m["steps"] or not all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"hymba training: losses {losses}, gnorms "
                             f"{gnorms}")
    if not np.mean(losses[-2:]) < np.mean(losses[:2]):
        raise AssertionError(f"hymba training: the loss did not fall: "
                             f"{losses}")
    want = {"flash_attention": 2 * cfg.n_layers, "ssd": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers}
    if any(s != want for s in spy.steps):
        raise AssertionError(f"hymba training: launches a step "
                             f"{spy.steps}, want {want}")
    if len(ck) != 1 or ck[0].name != f"step_{m['steps'] - 1:08d}":
        raise AssertionError(f"hymba training: checkpoints {ck}")
    dts = [h["dt"] * 1e3 for h in hist[1:]]
    toks = m["batch"] * m["seq"]
    flops = 8 * n * toks          # forward, recompute, backward (2 x 3)
    b_ms = flops / PEAK_OPS_PER_S["bfloat16"] * 1e3
    rec = dict(arch=cfg.name, params=n, batch=m["batch"], seq=m["seq"],
               steps=m["steps"], lr=m["lr"], losses=losses, gnorms=gnorms,
               step_ms=dts, step_ms_mean=sum(dts) / len(dts),
               first_step_ms=hist[0]["dt"] * 1e3,
               tokens_per_s=toks / (sum(dts) / len(dts) / 1e3),
               peak_gib=peak / 2 ** 30, launches=launches,
               launches_per_step=spy.steps[0], wall_s=wall,
               ckpt_bytes=ck_bytes, ckpt_host_copy_s=copy_s,
               ckpt_write_s=write_s, bound_ms=b_ms, bound_flop=flops)
    log(f"hymba-1.5b training, {m['steps']} steps of B={m['batch']} x "
        f"S={m['seq']} bf16: losses {[round(x, 4) for x in losses]}, "
        f"gnorms {[round(x, 4) for x in gnorms]}; step ms (steps 2-"
        f"{m['steps']}) {[round(x, 1) for x in dts]}, mean "
        f"{rec['step_ms_mean']:.1f} (first {rec['first_step_ms']:.1f}), "
        f"{rec['tokens_per_s']:.0f} tokens/s; bound {b_ms:.1f} ms "
        f"(8 N T = {flops:.3g} FLOP at 989 TFLOP/s, a floor); peak "
        f"{rec['peak_gib']:.2f} GiB; launches a step {spy.steps[0]}; final "
        f"checkpoint {ck_bytes} bytes: host copy {copy_s:.1f} s, write "
        f"{write_s:.1f} s")

    # one more step, profiled: device busy share and time by group
    step = make_train_step(cfg, TrainHParams(lr=m["lr"]))
    tb = {k: torch.as_tensor(v, device=dev) for k, v in data(0).items()}
    state = {"o": opt}
    # what the step is handed: phase 12 (a) plans the same bytes
    rec["step_arg_bytes"] = _step_arg_bytes(model, opt, tb)

    def one():
        _, _, _, state["o"] = step(model, state["o"], tb)
    # unprofiled: the host's time to enqueue a step (it reads nothing
    # back) against the step's wall to a device sync.  The card can idle
    # only while its queue is empty, so only within the enqueue time; an
    # enqueue time near the wall is ambiguous (a full launch queue blocks
    # the host too).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    enq_us = (time.perf_counter() - t0) * 1e6
    torch.cuda.synchronize()
    wall_e = (time.perf_counter() - t0) * 1e6
    log(f"unprofiled hymba train step: the host enqueued it in "
        f"{enq_us:.0f} us of its {wall_e:.0f} us wall "
        f"({100 * enq_us / wall_e:.1f}%)")
    prof, kern, busy, wall_u, wall_p = _profiled(one, dev)
    groups: dict[str, float] = {}
    for e in kern:
        grp = _kernel_group(e.name)
        groups[grp] = groups.get(grp, 0.0) + e.time_range.elapsed_us()
    rec["profile"] = dict(wall_us=wall_u, wall_profiled_us=wall_p,
                          busy_us=busy, busy_share=busy / wall_p,
                          kernels=len(kern), group_us=groups,
                          host_enqueue_us=enq_us, enqueue_wall_us=wall_e)
    log(f"profile hymba train step: wall {wall_u:.0f} us unprofiled, "
        f"{wall_p:.0f} us profiled; device busy {busy:.0f} us "
        f"({100 * busy / wall_p:.1f}% of the profiled wall), {len(kern)} "
        f"kernels; device us by group: " + ", ".join(
            f"{g} {u:.0f}" for g, u in sorted(groups.items(),
                                                 key=lambda kv: -kv[1])))
    ev = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(ev[0], "self_device_time_total")
           else "self_cuda_time_total")
    log(ev.table(sort_by=key, row_limit=12))
    del prof, kern
    # the device traced alone: its wall stays near the unprofiled one, so
    # its busy share is read against a wall of the same run
    _, kern, busy, wall_u, wall_p = _profiled(one, dev, host=False)
    rec["profile"]["device_only"] = dict(
        wall_us=wall_u, wall_profiled_us=wall_p, busy_us=busy,
        busy_share=busy / wall_p, kernels=len(kern))
    log(f"profile hymba train step, device traced alone: wall {wall_u:.0f} "
        f"us unprofiled, {wall_p:.0f} us profiled; device busy {busy:.0f} "
        f"us ({100 * busy / wall_p:.1f}% of the profiled wall), {len(kern)} "
        f"kernels")
    del model, opt, state, kern
    _free(dev)
    rec["layer"] = _kernel_vs_backward(dev, gen, cfg, m["batch"], m["seq"])
    return rec


def _step_arg_bytes(model, opt, batch):
    """Bytes of a train step's arguments: parameters, optimizer state (its
    int32 count too) and batch."""
    from repro_torch.core.engine import ref_leaves
    from repro_torch.models.transformer import param_tree
    return sum(t.numel() * t.element_size() for tree in
               (param_tree(model), opt, batch) for t in ref_leaves(tree))


class LaunchTrain:
    """(e) ``python -m repro_torch.launch.train`` on the card, as a user
    runs it: started when made, held by ``finish``.  The whole script
    finishes it beside phase 11 (a) (since PR 19, to fit phase 11)."""

    def __init__(self):
        import os
        import shutil
        self.dir = ROOT / "build" / "train" / "launch"
        shutil.rmtree(self.dir, ignore_errors=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "hymba-1.5b", "--smoke", "--steps", "4", "--batch", "2",
               "--seq", "64", "--ckpt", str(self.dir), "--no-resume"]
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        self.t = time.perf_counter()
        self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)

    def finish(self):
        import shutil
        try:
            out, err = self.proc.communicate(timeout=600)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.communicate()
        wall = time.perf_counter() - self.t
        shutil.rmtree(self.dir, ignore_errors=True)
        log(out.strip())
        if self.proc.returncode != 0 or "done: loss" not in out:
            raise AssertionError(f"launch.train exited "
                                 f"{self.proc.returncode}: {err[-2000:]}")
        return dict(rc=self.proc.returncode, wall_s=wall,
                    done=out.strip().splitlines()[-1])


def check_s1(dev):
    """(f) S1: the same bf16 training run on the card and on the CPU, from
    parameters drawn on the CPU and copied to the card.  Both loss curves,
    their largest gap, and a failure if step k's gap passes
    (k + 1) S1_ULP |loss_cpu(k)|."""
    import copy
    import shutil

    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataPipeline
    from repro_torch.models import transformer as tfm
    from repro_torch.train.loop import LoopConfig, train
    from repro_torch.train.step import TrainHParams

    r = S1_RUN
    cfg = get_smoke_config(r["arch"])
    cpu = tfm.init_model(cfg, r["seed"], device="cpu", dtype=torch.bfloat16,
                         requires_grad=True)
    card = copy.deepcopy(cpu).to(dev)
    curves, launches = {}, {}
    out_dir = ROOT / "build" / "train" / "s1"
    for side, model in (("cpu", cpu), ("card", card)):
        shutil.rmtree(out_dir, ignore_errors=True)
        before = _StepLaunches._now()
        _, _, hist = train(
            cfg, DataPipeline(cfg, batch=r["batch"], seq=r["seq"]),
            LoopConfig(steps=r["steps"], ckpt_every=10 ** 9,
                       ckpt_dir=str(out_dir / side), log_every=10 ** 9),
            TrainHParams(lr=r["lr"]), resume=False, params=model,
            device=model.device)
        curves[side] = [h["loss"] for h in hist]
        launches[side] = {k: v - before[k]
                          for k, v in _StepLaunches._now().items()}
    shutil.rmtree(out_dir, ignore_errors=True)
    gaps = [abs(a - b) for a, b in zip(curves["card"], curves["cpu"])]
    tols = [(k + 1) * S1_ULP * abs(c) for k, c in enumerate(curves["cpu"])]
    rec = dict(cpu=curves["cpu"], card=curves["card"], gaps=gaps, tols=tols,
               max_gap=max(gaps), within=all(g <= t for g, t in
                                             zip(gaps, tols)),
               launches=launches["card"])
    # the card's run goes through both kernels (forward and block-remat
    # recompute, a layer a step), the CPU's through neither
    want = {k: 2 * cfg.n_layers * r["steps"] for k in launches["card"]}
    want["flash_attention_bwd"] = cfg.n_layers * r["steps"]
    if launches["card"] != want or any(launches["cpu"].values()):
        raise AssertionError(f"S1: launches {launches}, want {want} on the "
                             f"card and none on the CPU")
    log(f"S1: hymba-1.5b-smoke bf16, {r['steps']} steps of B={r['batch']} x "
        f"S={r['seq']}, lr {r['lr']}, parameters drawn on the CPU (seed "
        f"{r['seed']}): losses on the CPU {curves['cpu']}, on the card "
        f"{curves['card']}; gaps {[f'{g:.4g}' for g in gaps]}, largest "
        f"{max(gaps):.4g}, tolerance (k + 1) 2^-8 |loss| = "
        f"{[f'{t:.4g}' for t in tols]}; kernel launches on the card "
        f"{launches['card']}")
    if not rec["within"]:
        raise AssertionError(f"S1: the card's loss curve parts from the "
                             f"CPU's beyond bf16 rounding: {rec}")
    return rec


def check_train(dev, launch=None):
    """Phase 10: training on the card.  ``launch`` (a list) takes the
    running (e) instead of waiting for it: the whole script finishes it
    in phase 11."""
    import torch
    card = _card()
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(10)
    rec = {"card": card}
    parts = rec["parts_s"] = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t
        return out

    rec["a"] = part("a", check_kernel_grads, dev, gen)
    rec["b"] = {}
    f32 = {"flash_attention": 0, "ssd": 0}
    t = time.perf_counter()
    for arch in TRAIN_SMOKE:
        rec["b"][arch], n = _f32_step_pair(dev, arch)
        f32 = {k: f32[k] + n[k] for k in f32}
    parts["b"] = time.perf_counter() - t
    rec["f32_launches"] = f32
    rec["c"] = part("c", check_resume, dev)
    rec["f"] = part("f", check_s1, dev)
    rec["d"] = part("d", train_hymba, dev, gen)
    if launch is None:
        rec["e"] = part("e", lambda: LaunchTrain().finish())
    else:
        launch.append(LaunchTrain())
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[{card}] phase 10 (train) took {rec['phase_s']:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    return rec


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phase 11
# ---------------------------------------------------------------------------
# (a) the sharded conservative PDES (repro_torch.core.pdes) on
# build_sharded_memsys: the reference tests' cell (2 tiles x 8 requests a
# shard, until 3000) at 1, 2, 4 and 8 shards, and 4 shards at the
# builder's defaults (4 tiles x 32 requests); (b) 8 shards x 16 tiles x 96
# requests (128 cores and 8 remote writers; phase 5's 16 x 96 tile on
# every shard) to completion.  PDES_REF: the JAX package's runs on the CPU
# with as many forced host devices as shards (pdes_summary of the final
# state: windows, per-shard time, stats, DRAM reads and writer backlog,
# and the sha256 of every leaf); CHANGES.md has the command that made it.
PDES_CASES = {
    "s1": dict(n_shards=1, tiles_per_shard=2, n_reqs=8, until=3000.0),
    "s2": dict(n_shards=2, tiles_per_shard=2, n_reqs=8, until=3000.0),
    "s4": dict(n_shards=4, tiles_per_shard=2, n_reqs=8, until=3000.0),
    "s8": dict(n_shards=8, tiles_per_shard=2, n_reqs=8, until=3000.0),
    "s4_default": dict(n_shards=4, tiles_per_shard=4, n_reqs=32,
                       until=3000.0),
    "s4_skew": dict(n_shards=4, tiles_per_shard=2, n_reqs=8, until=3000.0,
                    skew=True),
    "big": dict(n_shards=8, tiles_per_shard=16, n_reqs=96, until=1e6),
}
PDES_REF = {
    "s1": dict(
        windows=18, time=[310.0], epochs=[97], ticks=[152],
        progress_ticks=[74], delivered=[80], served=[16],
        writer_remaining=[0], core_remaining=[0],
        sha256="c15cd3789aed838349cf59e66d8b5381"
               "50e8e58e4b2eed8a82a7004a6da39fb3"),
    "s2": dict(
        windows=18, time=[310.0, 310.0], epochs=[97, 97], ticks=[152, 152],
        progress_ticks=[74, 74], delivered=[80, 80], served=[16, 16],
        writer_remaining=[0, 0], core_remaining=[0, 0],
        sha256="18964586722879d01c8d15038bf44364"
               "00857f3aa24dbca3986deb2bc8110dc0"),
    "s4": dict(
        windows=18, time=[310.0, 310.0, 310.0, 310.0], epochs=[97, 97, 97,
        97], ticks=[152, 152, 152, 152], progress_ticks=[74, 74, 74, 74],
        delivered=[80, 80, 80, 80], served=[16, 16, 16, 16],
        writer_remaining=[0, 0, 0, 0], core_remaining=[0, 0, 0, 0],
        sha256="e6214471dc4bee57e82241aab1fcb3eb"
               "1e91e66f16d78ab4519013f275862da5"),
    "s8": dict(
        windows=18, time=[310.0, 310.0, 310.0, 310.0, 310.0, 310.0, 310.0,
        310.0], epochs=[97, 97, 97, 97, 97, 97, 97, 97], ticks=[152, 152, 152,
        152, 152, 152, 152, 152], progress_ticks=[74, 74, 74, 74, 74, 74, 74,
        74], delivered=[80, 80, 80, 80, 80, 80, 80, 80], served=[16, 16, 16,
        16, 16, 16, 16, 16], writer_remaining=[0, 0, 0, 0, 0, 0, 0, 0],
        core_remaining=[0, 0, 0, 0, 0, 0, 0, 0],
        sha256="c71e381675b5ebbdd56c2b4427e02daa"
               "a9551e3c8b971ac65f024d5e320a6112"),
    "s4_default": dict(
        windows=98, time=[1222.0, 1222.0, 1222.0, 1222.0], epochs=[475, 475,
        475, 475], ticks=[1014, 1014, 1014, 1014], progress_ticks=[548, 548,
        548, 548], delivered=[552, 552, 552, 552], served=[128, 128, 128,
        128], writer_remaining=[0, 0, 0, 0], core_remaining=[0, 0, 0, 0],
        sha256="c0546f0784731e552b000a5c4ae7c1d2"
               "c25a8171df6dc3d179392f662687258a"),
    "s4_skew": dict(
        windows=18, time=[310.0, 310.0, 310.0, 310.0], epochs=[93, 97, 94,
        92], ticks=[149, 150, 147, 144], progress_ticks=[74, 73, 72, 71],
        delivered=[77, 79, 77, 75], served=[16, 16, 16, 16],
        writer_remaining=[0, 0, 0, 0], core_remaining=[0, 0, 0, 0],
        sha256="0dc7748a6f9cae18099a5adbd0939ae6"
               "129b1ed9e24ffc8f2ad4a5b207ff3e80"),
    "big": dict(
        windows=390, time=[3679.0, 3679.0, 3679.0, 3679.0, 3679.0, 3679.0,
        3679.0, 3679.0], epochs=[2545, 2545, 2545, 2545, 2545, 2545, 2545,
        2545], ticks=[11194, 11194, 11194, 11194, 11194, 11194, 11194, 11194],
        progress_ticks=[6256, 6256, 6256, 6256, 6256, 6256, 6256, 6256],
        delivered=[6248, 6248, 6248, 6248, 6248, 6248, 6248, 6248],
        served=[1536, 1536, 1536, 1536, 1536, 1536, 1536, 1536],
        writer_remaining=[0, 0, 0, 0, 0, 0, 0, 0], core_remaining=[0, 0, 0, 0,
        0, 0, 0, 0],
        sha256="155110861531078a729360fa784be325"
               "f5adb5947d83211b9cdb9855cd307763"),
}


def pdes_skew(n_shards, n_reqs):
    """The ``skew`` cases' per-shard writer state, as numpy arrays: shard
    i writes ``n_reqs - i`` times from address ``i << 16``, so every
    shard differs and each DRAM's remote port holds its left neighbour's
    addresses (a rotation the wrong way shows)."""
    import numpy as np
    i = np.arange(n_shards, dtype=np.int32)[:, None]
    return {"remaining": (n_reqs - i).astype(np.int32),
            "addr": (i << 16).astype(np.int32)}


def pdes_summary(leaves, windows):
    """A sharded final state (leaves as numpy arrays keyed by path, either
    package's) reduced to what PDES_REF holds: the window count, each
    shard's time, stats, DRAM reads and writer backlog, and the sha256 of
    every leaf's path, dtype, shape and bytes (f32 by its bits)."""
    import hashlib

    import numpy as np
    h = hashlib.sha256()
    for k in sorted(leaves):
        a = np.ascontiguousarray(leaves[k])
        h.update(f"{k}|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    per = lambda k: [int(x) for x in np.asarray(leaves[k]).reshape(
        len(leaves["time"]), -1).sum(axis=1)]
    return dict(windows=int(windows),
                time=[float(x) for x in leaves["time"]],
                epochs=per("stats.epochs"), ticks=per("stats.ticks"),
                progress_ticks=per("stats.progress_ticks"),
                delivered=per("stats.delivered"),
                served=per("comp_state.dram.served"),
                writer_remaining=per("comp_state.writer.remaining"),
                core_remaining=per("comp_state.core.remaining"),
                sha256=h.hexdigest())


PDES_A = ("s1", "s2", "s4", "s8", "s4_default", "s4_skew")
SCALE_PLACEMENTS = 8       # phase 11's mesh: cuda:0 named up to 8 times
SCALE_SHARDS = (2, 4)      # (c)'s shard= values
SCALE_PROFILED_WINDOW = 50     # (b)'s window under torch.profiler
SCALE_TIMED_WINDOWS = 100      # (b)'s instrumented run: its first windows


def _pdes_build(name, mesh):
    """build_sharded_memsys for a PDES_CASES entry on ``mesh``, its
    initial state (the writers skewed where the case says so) and its
    horizon."""
    import torch
    from repro_torch.sims import memsys as tm
    c = dict(PDES_CASES[name])
    until, skew = c.pop("until"), c.pop("skew", False)
    ss = tm.build_sharded_memsys(mesh=mesh, **c)
    st = ss.init_state()
    if skew:
        for k, v in pdes_skew(c["n_shards"], c["n_reqs"]).items():
            st.comp_state["writer"][k] = torch.from_numpy(v).to(
                st.time.device)
    return ss, st, until


def _pdes_summary(out, w):
    return pdes_summary({k: v.cpu().numpy() for k, v in _leaves(out).items()},
                        w)


def _pdes_held(name, out, w):
    got = _pdes_summary(out, w)
    ref = PDES_REF[name]
    if got != ref:
        raise AssertionError(f"PDES {name}: " + ", ".join(
            f"{k} {got[k]!r} != {ref[k]!r}" for k in ref if got[k] != ref[k]))


def _pdes_cpu_states(out_dir):
    """Child process of phase 11: the port's CPU final states of the (a)
    cases, each on a mesh of as many CPU placements as shards."""
    import os

    import torch
    torch.set_num_threads(2)
    for name in PDES_A:
        n = PDES_CASES[name]["n_shards"]
        ss, st, until = _pdes_build(name, (torch.device("cpu"),) * n)
        tmp = Path(out_dir) / f".pdes_{name}.tmp"
        torch.save(ss.run(st, until=until), tmp)
        os.replace(tmp, Path(out_dir) / f"pdes_{name}.pt")


def check_pdes_parity(card, states):
    """Phase 11 (a): every case of PDES_A on a mesh naming cuda:0 once a
    shard, against PDES_REF; the first run makes the block (a capture),
    the second is timed.  Each final state goes into ``states``, which
    ``check_pdes_cpu`` holds against the port's CPU runs."""
    import torch
    from repro_torch.launch.mesh import make_sim_mesh
    rec = {}
    for name in PDES_A:
        n = PDES_CASES[name]["n_shards"]
        ss, st, until = _pdes_build(name, make_sim_mesh(n))
        t = time.perf_counter()
        out, w = ss.run(st, until=until, return_windows=True)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t
        _pdes_held(name, out, w)
        states[name] = out
        t = time.perf_counter()
        out2, w2 = ss.run(st, until=until, return_windows=True)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t
        if w2 != w or _state_diff(out2, out):
            raise AssertionError(f"PDES {name}: a second run differs")
        rec[name] = dict(shards=n, placements=len(ss.mesh), windows=w,
                         time=float(out.time[0]), cold_s=cold, wall_s=warm)
        log(f"[{card}] PDES {name}: {n} shards on {len(ss.mesh)} "
            f"placements of {ss.mesh[0]}, {w} windows to time "
            f"{float(out.time[0])}, equal to PDES_REF; {cold:.3f} s with "
            f"the block's capture, {warm:.3f} s after")
    return rec


def check_pdes_cpu(card, states, cpu):
    """Phase 11 (a), continued: each card state against the port's CPU run
    of the same case (a child process's, made while the card worked),
    whole state by bits."""
    for name, out in states.items():
        bad = _state_diff(out, cpu.get(f"pdes_{name}"))
        if bad:
            raise AssertionError(f"PDES {name}: the card's and the CPU's "
                                 f"final states differ at {bad}")
    log(f"[{card}] PDES: the card's final states of {list(states)} equal "
        f"the port's CPU runs, whole state, f32 by bits")


def _profile_window(ss, blocks, t_glob, horizon, step):
    """One window traced on the device alone (torch.profiler's CUDA
    activity): its kernels, their busy time (the union of their
    intervals) and the traced wall.  Tracing stretches a window of ~6,000
    graph kernels many times over, so the busy share is read from CUDA
    events instead (check_pdes_big)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(blocks, t_glob, horizon)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        raise AssertionError("torch.profiler saw no kernel in a window")
    busy, end_t = 0.0, float("-inf")
    for e in sorted(kern, key=lambda e: e.time_range.start):
        lo, hi = max(e.time_range.start, end_t), e.time_range.end
        busy += max(0.0, hi - lo)
        end_t = max(end_t, hi)
    span = end_t - min(e.time_range.start for e in kern)
    return dict(kernels=len(kern), busy_us=busy, span_us=span,
                traced_wall_us=wall)


def _replay_ms(blk, reps=5):
    """Device time of one replay of a block's graph: CUDA events around
    ``reps`` replays back to back (a replay runs every epoch whether or
    not a lane is live, so a finished state times as a live one does)."""
    import torch
    blk.graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        blk.graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_pdes_big(card):
    """Phase 11 (b): 8 shards x 16 tiles x 96 requests on a mesh naming
    cuda:0 8 times, to completion, against PDES_REF["big"]: a clean timed
    run, then its first SCALE_TIMED_WINDOWS windows again with the
    exchange timed apart (a sync on each side), the block steps counted and window
    SCALE_PROFILED_WINDOW traced on the device.  The device-busy share of a window is the block replays'
    device time (CUDA events) over the clean run's mean window; the
    exchange's ~40 small kernels are left out of it, so it is a lower
    bound."""
    import torch
    from repro_torch.launch.mesh import make_sim_mesh
    ss, st, until = _pdes_build("big", make_sim_mesh(8))
    t = time.perf_counter()
    ss.run(st, until=-1.0)                  # makes (captures) the block
    torch.cuda.synchronize()
    cap_s = time.perf_counter() - t
    t = time.perf_counter()
    out, w = ss.run(st, until=until, return_windows=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    _pdes_held("big", out, w)
    vt = float(out.time[0])

    exch = dict(s=0.0)
    step, exchange = ss._step_window, ss._exchange
    prof, n = {}, dict(w=0)

    def timed_exchange(blocks, t_end):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exchange(blocks, t_end)
        torch.cuda.synchronize()
        exch["s"] += time.perf_counter() - t0

    def counted_step(blocks, t_glob, horizon):
        n["w"] += 1
        if n["w"] == SCALE_PROFILED_WINDOW:
            prof.update(_profile_window(ss, blocks, t_glob, horizon, step))
        else:
            step(blocks, t_glob, horizon)
    (blk,) = ss.sim._lane_blocks.values()
    replay = blk.step
    steps = dict(n=0)

    def counted_replay():
        steps["n"] += 1
        replay()
    ss._exchange, ss._step_window = timed_exchange, counted_step
    blk.step = counted_replay
    try:
        t = time.perf_counter()
        _, w2 = ss.run(st, until=until, max_windows=SCALE_TIMED_WINDOWS,
                       return_windows=True)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t
    finally:
        del ss._exchange, ss._step_window, blk.step
    block_ms = _replay_ms(blk)
    window_ms = wall / w * 1e3
    busy = steps["n"] / w2 * block_ms / window_ms
    rec = dict(shards=8, tiles_per_shard=16, n_reqs=96, cores=128,
               windows=w, virtual_time=vt, capture_s=cap_s, wall_s=wall,
               windows_per_s=w / wall, cycles_per_s=vt / wall,
               instrumented_windows=w2, instrumented_wall_s=wall2,
               exchange_s=exch["s"],
               exchange_share=exch["s"] / wall2,
               block=dict(epochs=ss.sim.super_epoch, lanes=blk.b,
                          replay_ms=block_ms,
                          steps_per_window=steps["n"] / w2),
               window=dict(prof, number=SCALE_PROFILED_WINDOW,
                           mean_ms=window_ms, busy_share=busy))
    log(f"[{card}] PDES big: 8 shards x 16 tiles x 96 requests (128 cores, "
        f"8 writers) equal to PDES_REF: {w} windows to time {vt} in "
        f"{wall:.3f} s ({rec['windows_per_s']:.1f} windows/s, "
        f"{rec['cycles_per_s']:.1f} cycles/s; the block's capture "
        f"{cap_s:.3f} s apart); its first {w2} windows again with the "
        f"exchange timed apart: {wall2:.3f} s, of which the exchange "
        f"{exch['s']:.3f} s "
        f"({100 * rec['exchange_share']:.1f}%); a window "
        f"{window_ms:.3f} ms, {steps['n'] / w2:.3f} block steps of "
        f"{block_ms:.3f} ms device time each (K={ss.sim.super_epoch}, "
        f"{blk.b} lanes; CUDA events): the device busy at least "
        f"{100 * busy:.1f}% of a window; window "
        f"{SCALE_PROFILED_WINDOW} traced on the device: {prof['kernels']} "
        f"kernels, busy {prof['busy_us']:.0f} us of a traced wall of "
        f"{prof['traced_wall_us']:.0f} us")
    return rec


def check_sharded_lanes(card):
    """Phase 11 (c): phase 6's 256 points at shard=False (phase 6 (a)'s
    pipelined run when it ran in this process: the same simulation and
    points), then shard=2 and 4 on the mesh (pipelined and not) through
    run_sweep: identical rows, equal to SWEEP_REF; one run_batch of 255
    points at shard=4 (padded to 256) equal to the first 255 rows;
    shard.rebalance events that move lanes; configs/s of each.  Returns
    the record."""
    from repro_torch import dse
    from repro_torch.obs.bus import capture
    from repro_torch.sims import memsys as tm
    sim, st = _sweep_build()
    pts = _dse_points(256)
    u = _dse_untils(256, MEMSYS_REF["mixed"]["horizon"])
    spec = dse.SweepSpec.explicit(pts)
    build_fn = dse.memoize_build(lambda: (sim, st))
    runner = dse.runner_for(sim)
    pb = dse.build_param_batch(sim, pts)
    ladder = dse.make_ladder(len(pts))
    rec, moved = {}, {}
    runs = [(f"shard{d}" + ("" if pipe else "_unpipelined"), d, pipe)
            for d in SCALE_SHARDS for pipe in (True, False)]
    rows0 = _SWEEP_UNSHARDED.get("rows")
    if rows0 is None:
        runs.insert(0, ("unsharded", False, None))
    else:
        rec["unsharded"] = dict(_SWEEP_UNSHARDED["rec"], phase=6,
                                lanes_moved=0)
        moved["unsharded"] = 0
    for key, d, pipe in runs:
        with capture() as sink:
            rows, rec[key] = _timed_sweep(
                f"scale sweep-256 {key}", card, runner,
                lambda: runner.warm_ladder(st, pb, ladder, shard=d),
                lambda: dse.run_sweep(build_fn, spec, until=u, shard=d,
                                      pipeline=pipe))
        ev = [e for e in sink.events if e["kind"] == "shard.rebalance"]
        moved[key] = sum(e["moved"] for e in ev)
        rec[key].update(shard=d or 1, rebalances=len(ev),
                        lanes_moved=moved[key])
        if rows0 is None:
            rows0 = rows
        elif rows != rows0:
            raise AssertionError(f"sweep-256 {key}: rows differ from "
                                 "shard=False")
        _check_rows(f"scale sweep-256 {key}", rows, SWEEP_REF["sweep256"])
    if not sum(moved.values()):
        raise AssertionError(f"no shard.rebalance event moved a lane: "
                             f"{moved}")

    def mono():
        out = runner.run_batch(dse.stack_states(st, 255),
                               dse.build_param_batch(sim, pts[:255]),
                               u[:255], shard=max(SCALE_SHARDS))
        return [dict(p, **r) for p, r in zip(
            pts, dse.extract_rows(sim, out, 255))]
    rows_m, rec["run_batch255"] = _timed_sweep(
        "scale run_batch 255 points shard=4 (padded to 256)", card, runner,
        lambda: runner.warm_ladder(st, pb, [256], shard=max(SCALE_SHARDS)),
        mono)
    if rows_m != rows0[:255] or (256, max(SCALE_SHARDS)) not in runner.made:
        raise AssertionError("run_batch of 255 points at shard=4: rows "
                             "differ from shard=False or no padding to 256")
    base = rec["unsharded"]["configs_per_s"]
    log(f"[{card}] sharded lanes: rows identical to shard=False and equal "
        f"to SWEEP_REF; lanes moved {moved}; configs/s " + ", ".join(
            f"{k} {r['configs_per_s']:.2f} ({r['configs_per_s'] / base:.2f}x)"
            for k, r in rec.items()))
    return rec


SCALE_CACHE_POINTS = 64     # (d)'s sweep: phase 6's first 64 points,
SCALE_CACHE_TOP = MEMSYS_REF["mixed"]["horizon"] / 8   # horizons cut 8x
SCALE_CACHE_K = 16          # the children's block: a quarter of the capture


def _rows_sha256(rows):
    import hashlib
    return hashlib.sha256(json.dumps(rows, sort_keys=True, separators=(
        ",", ":")).encode()).hexdigest()


def _cache_sweep():
    """(d)'s points and per-lane horizons: enough points to autotune,
    horizons 8x shorter than phase 6's.  Still long enough that the
    autotuner picks (and persists) its winner: while it probes rungs 32
    and 16, the other lanes wait in the pool, so lanes remain when the
    probes end."""
    n = SCALE_CACHE_POINTS
    return _dse_points(256)[:n], _dse_untils(256, SCALE_CACHE_TOP)[:n]


def scale_cache_child(go):
    """Phase 11 (d)'s child process: _cache_sweep at shard=2 (two
    placements of cuda:0) with the cache dir of REPRO_CACHE_DIR, under the
    bus, once the file ``go`` exists (the child imports, reaches the card
    and builds before that): autotune probes, blocks made before and
    after the first round, rungs used, wall s, the rows' sha256 and the
    store's counts.  Its block is SCALE_CACHE_K epochs (rows do not depend
    on it), so that a rung's capture costs a quarter of phase 6's."""
    import torch
    from repro_torch import dse
    from repro_torch.dse import cache as dse_cache
    from repro_torch.obs.bus import capture
    from repro_torch.sims import memsys as tm
    assert dse_cache.active(), "REPRO_CACHE_DIR not picked up"
    sim, st = tm.build(n_cores=16, pattern="mixed", n_reqs=96,
                       super_epoch=SCALE_CACHE_K)
    pts, u = _cache_sweep()
    torch.cuda.synchronize()
    while not Path(go).exists():
        time.sleep(0.05)
    t = time.perf_counter()
    with capture() as sink:
        rows = dse.run_sweep(dse.memoize_build(lambda: (sim, st)),
                             dse.SweepSpec.explicit(pts), until=u, shard=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    ev = sink.events
    first = min(i for i, e in enumerate(ev) if e["kind"] == "round.end")
    made = lambda es: sorted(e["b"] for e in es if e["kind"] == "compile")
    return dict(
        wall_s=wall, probes=sum(e["kind"] == "autotune.probe" for e in ev),
        made_before=made(ev[:first]), made_after=made(ev[first:]),
        used=sorted({e["rung"] for e in ev if e["kind"] == "round.end"}),
        rows_sha256=_rows_sha256(rows), artifacts=dse_cache.stats())


class _ScaleCache:
    """Phase 11 (d): scale_cache_child in two processes sharing a fresh
    REPRO_CACHE_DIR, both started when this is made, so that their
    imports, CUDA start-up and builds run while the card does (a); each
    sweeps only once released, the second after the first has ended.
    ``finish`` releases them and holds them: the second runs no autotune
    probe, makes every rung it uses before its first round (none after),
    hits the store, and both give the rows of the same sweep in this
    process (phase 6's simulation, unsharded)."""

    def __init__(self, card):
        import os
        import shutil
        self.card = card
        self.dir = ROOT / "build" / "scale" / "cache"
        shutil.rmtree(self.dir, ignore_errors=True)
        self.dir.mkdir(parents=True)
        env = dict(os.environ, REPRO_CACHE_DIR=str(self.dir / "store"),
                   REPRO_TORCH_FORCE_DEVICES="2")
        self.procs = []
        for i in (1, 2):
            code = (f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); "
                    "import chip_smoke; print(json.dumps("
                    f"chip_smoke.scale_cache_child({str(self.go(i))!r})))")
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

    def go(self, i):
        return self.dir / f"go{i}"

    def _run(self, i):
        self.go(i).touch()
        proc = self.procs[i - 1]
        out, err = proc.communicate(timeout=600)
        if proc.returncode:
            raise AssertionError(f"cache child {i} failed: {err[-3000:]}")
        return json.loads(out.strip().splitlines()[-1])

    def finish(self):
        from repro_torch import dse
        first, second = self._run(1), self._run(2)
        out = [first, second]
        sim, st = _sweep_build()
        pts, u = _cache_sweep()
        ref = _rows_sha256(dse.run_sweep(dse.memoize_build(lambda: (sim, st)),
                                         dse.SweepSpec.explicit(pts),
                                         until=u))
        problems = [what for what, bad in (
            ("rows differ from this process's",
             {first["rows_sha256"], second["rows_sha256"]} != {ref}),
            ("the first process ran no probe", not first["probes"]),
            ("the second process probed", second["probes"]),
            ("the second made a block after its first round",
             second["made_after"]),
            ("a rung used was not made first",
             not set(second["used"]) <= set(second["made_before"])),
            ("the second process hit no artifact",
             not second["artifacts"]["hits"])) if bad]
        if problems:
            raise AssertionError(f"cache: {problems}: {out}")
        log(f"[{self.card}] cache: process 1 {first['wall_s']:.3f} s of "
            f"sweep ({first['probes']} autotune probes, blocks made "
            f"{first['made_before']} before and {first['made_after']} "
            f"after its first round), process 2 {second['wall_s']:.3f} s "
            f"({second['probes']} probes, {len(second['made_before'])} "
            f"blocks {second['made_before']} all made before its first "
            f"round); identical rows, equal to this process's")
        return dict(first=first, second=second)

    def close(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def check_scale(after_a=None):
    """Phase 11: transparent parallel simulation and the campaign cache on
    a mesh naming cuda:0 up to SCALE_PLACEMENTS times
    (REPRO_TORCH_FORCE_DEVICES).  No kernel: the reference's collectives
    (pmin, ppermute) are a min and a roll, its lanes a vmap.
    ``after_a`` runs after (a) (the whole script finishes phase 10 (e)
    there)."""
    import os
    card = _card()
    t_phase = time.perf_counter()
    rec = {"card": card}
    out_dir = ROOT / "build" / "scale"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.glob("*.pt"):
        f.unlink()
    parts = rec["parts_s"] = {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        parts[name] = time.perf_counter() - t
        return out

    old = os.environ.get("REPRO_TORCH_FORCE_DEVICES")
    os.environ["REPRO_TORCH_FORCE_DEVICES"] = str(SCALE_PLACEMENTS)
    cpu = _CpuStates(out_dir, _pdes_cpu_states)
    # (d)'s children start now and wait, so that their start-up overlaps
    # (a), whose times are not read as performance
    cache = _ScaleCache(card)
    try:
        states = {}
        rec["pdes"] = part("pdes", check_pdes_parity, card, states)
        if after_a is not None:
            after_a()
        rec["big"] = part("big", check_pdes_big, card)
        rec["lanes"] = part("lanes", check_sharded_lanes, card)
        rec["cache"] = part("cache", cache.finish)
        part("pdes_cpu", check_pdes_cpu, card, states, cpu)
    finally:
        cache.close()
        cpu.close()
        if old is None:
            del os.environ["REPRO_TORCH_FORCE_DEVICES"]
        else:
            os.environ["REPRO_TORCH_FORCE_DEVICES"] = old
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[{card}] phase 11 (scale-out) took {rec['phase_s']:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    return rec


# ---------------------------------------------------------------------------
# phase 12
# ---------------------------------------------------------------------------
# (b) the JAX package's per-device argument bytes of deepseek-v2-236b x
# decode_32k on the 16x16 mesh: the shard shapes of its abstract arguments
# under its own PartitionSpecs on a jax AbstractMesh
# (tests/test_torch_sharding.py, ref_argument_bytes)
DRYRUN_DSV2_ARGS = 5_418_813_504
# (c) the JAX package's sim cell on 8 forced host devices: the compiled
# module's argument bytes and its parsed collectives a window
# (``JAX_PLATFORMS=cpu PYTHONPATH=src python tests/_dryrun_refs.py sim 8``)
DRYRUN_SIM_REF = dict(argument_bytes=10_416,
                      collective_by_op={"all-reduce": 14.0,
                                        "collective-permute": 256.0},
                      collective_op_count=3)
DRYRUN_SIM_SHARDS = 8


def _phase10_arg_bytes(dev):
    """What phase 10 (d) hands its step, made as it makes it: hymba-1.5b's
    bf16 parameters, f32 AdamW state and one DataPipeline batch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataPipeline
    from repro_torch.models.transformer import param_tree
    from repro_torch.optim import adamw_init
    m = TRAIN_MAIN
    cfg = get_config(m["arch"])
    _free(dev)
    model, _ = _init_model(cfg, dev, torch.bfloat16)
    opt = adamw_init(param_tree(model))
    data = DataPipeline(cfg, batch=m["batch"], seq=m["seq"], seed=0)
    tb = {k: torch.as_tensor(v, device=dev) for k, v in data(0).items()}
    n = _step_arg_bytes(model, opt, tb)
    del model, opt, tb
    _free(dev)
    return n


def check_dryrun(dev, train=None):
    """Phase 12: the dry run (``repro_torch.launch.dryrun``) on the card's
    machine: every step is traced on ``meta``, so nothing is allocated on
    the card and no kernel launches.  (a) hymba-1.5b's training cell at
    phase 10 (d)'s B x S, f32 moments and block remat, on a 1x1 mesh: its
    planned argument bytes equal the bytes phase 10 (d) hands its step,
    exactly; the planned temp beside the measured peak and the planned
    bound beside the measured step (from ``train``, phase 10's record,
    when it ran in this process); (b) ``run_cell`` for deepseek-v2-236b x
    decode_32k on 16x16, argument bytes equal to DRYRUN_DSV2_ARGS; (c)
    ``run_sim_cell`` on DRYRUN_SIM_SHARDS placements of the card against
    DRYRUN_SIM_REF."""
    import dataclasses
    import math
    import os

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.ssd import kernel as ssdk
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import LogicalMesh
    from repro_torch.train.step import TrainHParams
    card = _card()
    t_phase = time.perf_counter()
    rec = {"card": card}
    parts = rec["parts_s"] = {}
    before = (fak.launches, ssdk.launches)

    # (a)
    t = time.perf_counter()
    m = TRAIN_MAIN
    cfg = get_config(m["arch"])
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=m["seq"],
                                global_batch=m["batch"])
    (plan,), trace_s, _ = dryrun.plan_cells(
        cfg, shape, [LogicalMesh((1, 1), ("data", "model"))],
        TrainHParams(lr=m["lr"]))
    an = roofline.analyze(plan, cfg, shape, 1)
    d = (train or {}).get("d")
    held = d["step_arg_bytes"] if d else _phase10_arg_bytes(dev)
    if plan.argument_bytes != held:
        raise AssertionError(f"dry run (a): planned argument bytes "
                             f"{plan.argument_bytes}, phase 10 (d)'s step "
                             f"is handed {held}")
    planned_gib = (plan.argument_bytes + plan.temp_bytes) / 2 ** 30
    bound_ms = an["step_lower_bound_s"] * 1e3
    rec["a"] = dict(arch=cfg.name, batch=m["batch"], seq=m["seq"],
                    argument_bytes=plan.argument_bytes, held_bytes=held,
                    temp_bytes=plan.temp_bytes, planned_gib=planned_gib,
                    measured_peak_gib=d["peak_gib"] if d else None,
                    bound_ms=bound_ms, dominant=an["dominant"],
                    compute_ms=an["compute_s"] * 1e3,
                    memory_ms=an["memory_s"] * 1e3,
                    step_ms=d["step_ms_mean"] if d else None,
                    trace_s=trace_s)
    log(f"dry run (a): {cfg.name} train B={m['batch']} x S={m['seq']} on "
        f"1x1: planned arguments {plan.argument_bytes} B = phase 10 (d)'s "
        f"{held} B; planned arguments + temp {planned_gib:.2f} GiB against "
        + (f"a measured peak of {d['peak_gib']:.2f} GiB" if d else
           "a peak not measured in this run (phase 10 did not run)")
        + f"; planned bound {bound_ms:.1f} ms ({an['dominant']}: compute "
        f"{rec['a']['compute_ms']:.1f}, memory {rec['a']['memory_ms']:.1f})"
        + (f" against a measured step of {d['step_ms_mean']:.1f} ms" if d
           else " (the step not measured in this run)")
        + f"; traced in {trace_s:.1f} s")
    parts["a"] = time.perf_counter() - t

    # (b)
    t = time.perf_counter()
    r = dryrun.run_cell("deepseek-v2-236b", "decode_32k", False)
    mem = r.get("memory_per_device") or {}
    if r["status"] != "ok" or mem.get("argument_bytes") != DRYRUN_DSV2_ARGS:
        raise AssertionError(f"dry run (b): {r.get('status')}, argument "
                             f"bytes {mem.get('argument_bytes')}, want "
                             f"{DRYRUN_DSV2_ARGS}")
    terms = [r[k] for k in ("compute_s", "memory_s", "collective_s")]
    if not all(math.isfinite(x) and x > 0 for x in terms):
        raise AssertionError(f"dry run (b): terms {terms}")
    rec["b"] = {k: r[k] for k in (
        "arch", "shape", "mesh", "trace_s", "memory_per_device",
        "compute_s", "memory_s", "collective_s", "dominant",
        "collective_by_op", "step_lower_bound_s", "roofline_fraction")}
    parts["b"] = time.perf_counter() - t

    # (c)
    t = time.perf_counter()
    old = os.environ.get("REPRO_TORCH_FORCE_DEVICES")
    os.environ["REPRO_TORCH_FORCE_DEVICES"] = str(DRYRUN_SIM_SHARDS)
    try:
        r = dryrun.run_sim_cell(False)
    finally:
        if old is None:
            del os.environ["REPRO_TORCH_FORCE_DEVICES"]
        else:
            os.environ["REPRO_TORCH_FORCE_DEVICES"] = old
    got = dict(argument_bytes=r["argument_bytes_per_shard"],
               collective_by_op=r["collective_by_op"],
               collective_op_count=r["collective_op_count"])
    if r["shape"] != f"{DRYRUN_SIM_SHARDS}shards" or got != DRYRUN_SIM_REF:
        raise AssertionError(f"dry run (c): {r['shape']} {got}, want "
                             f"{DRYRUN_SIM_REF}")
    rec["c"] = r
    parts["c"] = time.perf_counter() - t

    if (fak.launches, ssdk.launches) != before:
        raise AssertionError(f"the dry run launched a kernel: flash "
                             f"{before[0]} -> {fak.launches}, ssd "
                             f"{before[1]} -> {ssdk.launches}")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[{card}] phase 12 (dry run) took {rec['phase_s']:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()))
    return rec


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--times-of"] and len(sys.argv) == 3:
        # compare_times' child: that checkout's repro_torch, not this one's
        sys.path.insert(0, str(Path(sys.argv[2]) / "src"))
        import repro_torch
        log(_card())
        log(f"times of {repro_torch.__file__}")
        print(f"TIMES {sys.argv[2]} {json.dumps(kernel_times())}", flush=True)
        return 0
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print(f"chip_smoke: repro_torch not found under {ROOT / 'src'}",
              file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    if sys.argv[1:] == ["--kernels"]:
        # phases 1 and 2 alone: builds, every kernel case, the bf16
        # kernels' tiling edges, their plan, and the kernels' record
        setup()
        gen = torch.Generator(device=dev).manual_seed(0)
        print(json.dumps({"kernels": {"flash_attention": check_flash(dev, gen),
                                      "ssd": check_ssd(dev, gen)}}),
              flush=True)
        return 0
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
    if sys.argv[1:] == ["--sims"]:
        # phase 8 alone, after the card line
        log(_card())
        print(json.dumps({"sims": check_sims()}), flush=True)
        return 0
    if sys.argv[1:] == ["--search"]:
        # phase 9 alone, after the card line
        log(_card())
        print(json.dumps({"search": check_search()}), flush=True)
        return 0
    if sys.argv[1:] == ["--models"]:
        # phase 7 alone, after phase 1 (the builds, TF32 off)
        setup()
        print(json.dumps({"models": check_models(dev)}), flush=True)
        return 0
    if sys.argv[1:] == ["--scale"]:
        # phase 11 alone, after the card line
        log(_card())
        print(json.dumps({"scale": check_scale()}), flush=True)
        return 0
    if sys.argv[1:] == ["--train"]:
        # phase 10 alone, after phase 1 (the builds, TF32 off)
        setup()
        print(json.dumps({"train": check_train(dev)}), flush=True)
        return 0
    if sys.argv[1:2] == ["--times"]:
        # the kernels' times at TIMED_FA and TIMED_SSD, bf16 and f32, of
        # this checkout or of each checkout named
        compare_times(sys.argv[2:] or [str(ROOT)])
        return 0
    if sys.argv[1:] == ["--dryrun"]:
        # phase 12 alone, after the card line
        log(_card())
        print(json.dumps({"dryrun": check_dryrun(dev)}), flush=True)
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    setup()
    gen = torch.Generator(device=dev).manual_seed(0)
    fa = check_flash(dev, gen)
    sd = check_ssd(dev, gen)
    f32_launches = check_small_model(dev)
    launches, model = serve_hymba(dev)
    _profile(model)
    del model
    engine = check_engine(trimmed=True)
    dse = check_dse(trimmed=True)
    models = check_models(dev)
    sims = check_sims()
    search = check_search()
    launch = []
    train = check_train(dev, launch)

    def finish_launch():
        t = time.perf_counter()
        train["e"] = launch[0].finish()
        train["parts_s"]["e_wait"] = time.perf_counter() - t
    scale = check_scale(finish_launch)
    dry = check_dryrun(dev, train)
    fa_bf16 = launches["flash_attention"] + \
        models["launches"]["bfloat16"] + \
        train["d"]["launches"]["flash_attention"]
    fa_f32 = f32_launches["flash_attention"] + \
        models["launches"]["float32"] + \
        train["f32_launches"]["flash_attention"]

    fa_src = "src/repro/kernels/flash_attention/kernel.py:25"
    ssd_src = "src/repro/kernels/ssd/kernel.py:23"
    kernels = [
        dict(name="flash_attention_tc", route="cuda",
             source="src/repro_torch/csrc/flash_attention_tc.cu",
             replaces=fa_src, launches=fa_bf16, **fa["bfloat16"]),
        dict(name="ssd_tc", route="cuda",
             source="src/repro_torch/csrc/ssd_tc.cu", replaces=ssd_src,
             launches=launches["ssd"] + train["d"]["launches"]["ssd"],
             **sd["bfloat16"]),
        dict(name="flash_attention_tc_bwd", route="cuda",
             source="src/repro_torch/csrc/flash_attention_tc.cu",
             replaces="none (XLA's autodiff of blockwise_attention, "
                      "src/repro/models/attention.py)",
             launches=train["d"]["launches"]["flash_attention_bwd"],
             **fa["bfloat16_bwd"]),
        dict(name="flash_attention_f32", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces=fa_src, launches=fa_f32, **fa["float32"]),
        dict(name="ssd_f32", route="cuda",
             source="src/repro_torch/csrc/ssd.cu", replaces=ssd_src,
             launches=f32_launches["ssd"] + train["f32_launches"]["ssd"],
             **sd["float32"]),
    ]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"engine": engine}))
    print(json.dumps({"dse": dse}))
    print(json.dumps({"models": models}))
    print(json.dumps({"sims": sims}))
    print(json.dumps({"search": search}))
    print(json.dumps({"train": train}))
    print(json.dumps({"scale": scale}))
    print(json.dumps({"dryrun": dry}))
    print(json.dumps({"kernels": [{k: kr[k] for k in keys}
                                  for kr in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
