// Flash-attention forward on Hopper's tensor cores, bf16 (sm_90a).
//
// Replaces the Pallas TPU kernel `_fa_kernel` (src/repro/kernels/
// flash_attention/kernel.py:25, launched by `flash_attention` at :70) for
// bf16 inputs; flash_attention.cu keeps the f32 path.  Same function:
// scores in f32 scaled by `scale`, optional tanh softcap, causal mask
// kp <= qp and sliding-window mask qp - kp < window (masked scores are
// -1e30 as in the reference, keys past the ragged edge -inf), GQA query
// head h reads KV head h / (H / KV), online softmax with running max,
// denominator and f32 accumulator, output acc / max(l, 1e-30) in bf16.
// Any Sq, Sk; `window` is a runtime int.
//
// What bounds it on the H100: causal attention does 2*S*S*hd FLOPs per
// query head against (2*H + 2*KV)*S*hd*2 bytes; at hymba's 25 query and 5
// KV heads that is about 0.42*S FLOP per byte, so the bound is bytes below
// S ~ 700 and the tensor cores' 989 TFLOP/s above (with a window w the
// pairs per row stop growing at w, and so does the ratio).  Past the
// bound, the softmax's exp: one MUFU ex2 per score, 16 an SM a cycle,
// costs about as long as the two products of a 64-key tile.
//
// Design (warp-specialised, wgmma fed by TMA; FlashAttention-3's shape):
//  - A block is 3 warpgroups.  The third is the producer: after
//    setmaxnreg.dec to 40 registers, one of its threads issues every TMA
//    load (cp.async.bulk.tensor) of the block: the Q tile once, then K/V
//    tiles of 64 keys into a ring of 3 stages, each stage guarded by a
//    "full" mbarrier (K and V apart) and an "empty" one that each
//    consumer warp arrives on.  The other two warpgroups are consumers
//    (setmaxnreg.inc to 232), 64 query rows each.
//  - Q.K^T is wgmma.mma_async m64n64k16 with Q and K both K-major in
//    shared memory; P.V is m64n{hd}k16 with P in registers (rounded to
//    bf16 straight from the S accumulators) and V MN-major in shared
//    memory (the transposed-B mode of 16-bit types).  S and the output
//    accumulator stay in registers; the softmax is done by the thread that
//    holds a score, two shuffles a row a tile.
//  - Software pipeline: Q.K^T of tile i+1 and P.V of tile i are issued
//    together; the softmax of tile i+1 runs while P.V of tile i does, and
//    O is rescaled once that P.V is done.  The two consumer warpgroups
//    take turns to issue (named barriers 3 and 4), so one's softmax
//    overlaps the other's products.
//  - The softcap is cap (1 - 2 / (2^(2x log2 e) + 1)) on the special
//    function unit (f32 tanhf per score took half the kernel's time), the
//    branch on it taken once a tile; the mask only on tiles that cut the
//    diagonal, the window edge or the ragged end (TMA fills keys past Sk
//    with zeros; they get -inf).  Tiles fully outside the causal or window
//    range are never loaded.  Position tiles are issued last-first.
//  - Layout: the head dim is cut into parts of W columns, each a TMA box
//    and a tile of rows of 2W bytes in TMA's 2W-byte swizzle, which the
//    wgmma descriptors name: W = 64 (128-byte swizzle) at hd 64 and 128,
//    32 (64-byte) at hd 32, 16 (32-byte) at hd 16 and 80.  hd 80 = 5 x 16
//    in the k steps and one n80 product, but its 160-byte rows fit no
//    swizzle, so it takes five 32-byte parts.
//  - GQA: a block serves Gp query heads of one KV group (Gp the largest
//    divisor of H/KV up to 16: hymba 5, gemma2 2) from the same K/V stage.
//    Its 128 rows are (position, head) pairs, npos = 128/Gp positions of
//    Gp heads, so the Q box (W, Gp, npos) and the output box are single
//    TMA copies of a [B,S,H,hd] tensor (rows past npos*Gp are unused).
//  - The output is normalised, rounded to bf16 into the Q tile (the same
//    swizzle) and written by one TMA store, which clips the ragged end.
//  - When the blocks are fewer than the SMs (hymba's S=256 prompt: 55
//    blocks of 25 positions), the block takes 64 rows and the two
//    consumer warpgroups split the key tiles, even and odd, each with its
//    own online softmax; the partial states are merged through shared
//    memory at the end (fa_plan below, kernel.py's `plan`).
//  - Launched with programmatic dependent launch: the blocks are placed
//    while the kernel before drains and wait for it before any load.
//  - Shared memory: 128*hd*2 bytes of Q and 3 x 2 x 64*hd*2 of K/V: 64 KB
//    at hd 64, 128 KB at hd 128; one block an SM (384 threads at 168
//    registers fill the register file).
//  - mma.sync, ldmatrix and cp.async are not used.
// Registers (ptxas -v, CUDA 12.9, sm_90a): 168 a thread at launch for
// every head dim and both modes, no spills (the consumers run at 232
// after setmaxnreg); phase 1 of chip_smoke.py prints them for each build.
#include <math.h>

#include "wgmma.cuh"

namespace {

using tc::bf16;

constexpr int kBK = 64;        // keys per K/V tile
constexpr int kStages = 3;     // K/V tiles in the ring
constexpr int kRows = 128;     // query rows of a block (64 when split)
constexpr int kThreads = 384;  // two consumer warpgroups, one producer
constexpr int kMaxHeads = 16;  // query heads a block may serve
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The head dim in NP parts of W columns: one TMA box and one swizzled
// tile of RB = 2W-byte rows each
template <int HD>
struct Part {
  static constexpr int W = HD % 64 == 0 ? 64 : (HD == 32 ? 32 : 16);
  static constexpr int NP = HD / W;
  static constexpr int RB = 2 * W;
};

// Byte offsets in the (1024-aligned) dynamic shared memory
template <int HD>
struct Smem {
  static constexpr int TILE = kBK * HD * 2;       // one K or V stage
  static constexpr int K = kRows * HD * 2;        // after the Q tile
  static constexpr int V = K + kStages * TILE;
  static constexpr int BAR = V + kStages * TILE;  // 1 + 3 * kStages mbarriers
  static constexpr int BYTES = BAR + (1 + 3 * kStages) * 8 + 1024;
};

struct FaParams {
  CUtensorMap q, k, v, o;  // [B,S,heads,hd] as (hd, heads|S, S|heads, B)
  int Sq, Sk, KV, G, Gp, npos, nsub;
  int causal, window;
  float scale, cap;
};

// tanh(x) = 1 - 2 / (2^(2x log2 e) + 1) on the special-function unit; an
// absolute error of ~1e-7, as f32 tanhf, at any x (2^.. -> inf gives 1)
__device__ __forceinline__ float fast_tanh_l2(float x2) {  // x2 = 2x log2 e
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(tc::exp2(x2) + 1.f));
  return 1.f - 2.f * r;
}

// The online softmax of one warp's 16 rows (two a thread: gid, gid + 8)
// over a 64-key tile of S in the wgmma accumulator layout
struct Softmax {
  const FaParams& p;
  int pos0, pos1, tig;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  // S -> scaled (log2 domain), softcapped, masked; the running max and
  // denominator; P as bf16 fragments of P.V; O's rescale factors c0, c1
  __device__ __forceinline__ void tile(float (&sc)[32], int k0, int q0,
                                       int q_end, uint32_t (&pf)[4][4],
                                       float& c0, float& c1) {
    // exp(x) = 2^(x log2 e): scores are kept multiplied by log2 e
    if (p.cap > 0.f) {  // cap tanh(s scale / cap)
      const float k2 = 2.f * p.scale / p.cap * kLog2e, cap2 = p.cap * kLog2e;
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = fast_tanh_l2(sc[e] * k2) * cap2;
    } else {
      const float scale2 = p.scale * kLog2e;
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] *= scale2;
    }
    // the mask, on tiles that cut the diagonal, the window or the end
    if (k0 + kBK > p.Sk || (p.causal && k0 + kBK - 1 > q0) ||
        (p.window > 0 && q_end - k0 >= p.window)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int kp = k0 + (e >> 2) * 8 + 2 * tig + (e & 1);
        const int qp = (e & 2) ? pos1 : pos0;
        bool ok = true;
        if (p.causal) ok = ok && kp <= qp;
        if (p.window > 0) ok = ok && (qp - kp < p.window);
        sc[e] = kp >= p.Sk ? -INFINITY : (ok ? sc[e] : kNeg);
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    c0 = tc::exp2(m0 - mx0);
    c1 = tc::exp2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    // P = exp(S - m) in f32 for the denominator, bf16 for P.V
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j] = tc::exp2(sc[4 * j] - m0);
      sc[4 * j + 1] = tc::exp2(sc[4 * j + 1] - m0);
      sc[4 * j + 2] = tc::exp2(sc[4 * j + 2] - m1);
      sc[4 * j + 3] = tc::exp2(sc[4 * j + 3] - m1);
      s0 += sc[4 * j] + sc[4 * j + 1];
      s1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * c0 + s0;
    l1 = l1 * c1 + s1;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pf[kk][0] = tc::pack(sc[8 * kk], sc[8 * kk + 1]);
      pf[kk][1] = tc::pack(sc[8 * kk + 2], sc[8 * kk + 3]);
      pf[kk][2] = tc::pack(sc[8 * kk + 4], sc[8 * kk + 5]);
      pf[kk][3] = tc::pack(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  }
};

// ------------------------------------------------------------- kernel
template <int HD, bool SPLIT>
__global__ void __launch_bounds__(kThreads, 1)
    fa_tc_fwd(const __grid_constant__ FaParams p) {
  using Pt = Part<HD>;
  using L = Smem<HD>;
  constexpr int W = Pt::W, RB = Pt::RB, NP = Pt::NP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = sm;  // [NP][kRows][RB]; the output tile at the end
  unsigned char* Ks = sm + L::K;  // [kStages][NP][kBK][RB]
  unsigned char* Vs = sm + L::V;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int tid = threadIdx.x, wg = tid / 128;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * p.npos;
  const int sub = blockIdx.y % p.nsub;
  const int kvh = blockIdx.y / p.nsub % p.KV;
  const int b = blockIdx.y / (p.nsub * p.KV);
  const int h0 = kvh * p.G + sub * p.Gp;  // the block's first query head
  // key range any row of this block can see, in whole tiles
  const int q_end = q0 + p.npos - 1;  // last position of the block
  const int kv_hi = p.causal ? min(p.Sk, min(p.Sq, q_end + 1)) : p.Sk;
  int kv_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  kv_lo = kv_lo / kBK * kBK;
  const int nt = kv_hi > kv_lo ? (kv_hi - kv_lo + kBK - 1) / kBK : 0;

  if (tid == 0) {
    tc::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      tc::mbar_init(&k_full[s], 1);
      tc::mbar_init(&v_full[s], 1);
      // every warp that reads a stage arrives once it is done with it
      tc::mbar_init(&empty[s], SPLIT ? 4 : 8);
    }
    tc::mbar_init_fence();
  }
  __syncthreads();
  tc::launch_dependents();  // the next kernel's blocks may get ready
  tc::grid_wait();          // the kernel before has written q, k, v

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      tc::mbar_expect_tx(q_full, NP * p.Gp * p.npos * RB);
      for (int j = 0; j < NP; ++j)
        tc::tma_load4(Qs + j * kRows * RB, &p.q, q_full, j * W, h0, q0, b);
      for (int i = 0; i < nt; ++i) {
        const int s = i % kStages, r = i / kStages;
        if (r > 0) tc::mbar_wait(&empty[s], (r - 1) & 1);
        const int k0 = kv_lo + i * kBK;
        tc::mbar_expect_tx(&k_full[s], L::TILE);
        for (int j = 0; j < NP; ++j)
          tc::tma_load4(Ks + s * L::TILE + j * kBK * RB, &p.k, &k_full[s],
                        j * W, k0, kvh, b);
        tc::mbar_expect_tx(&v_full[s], L::TILE);
        for (int j = 0; j < NP; ++j)
          tc::tma_load4(Vs + s * L::TILE + j * kBK * RB, &p.v, &v_full[s],
                        j * W, k0, kvh, b);
      }
    }
  } else {
    // -------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = tid % 128 / 32, lane = tid & 31;
    const int gid = lane >> 2, tig = lane & 3;
    // the block rows of accumulator registers 0-1 and 2-3, their positions
    const int r0 = (SPLIT ? 0 : wg * 64) + warp * 16 + gid, r1 = r0 + 8;
    const int pos0 = q0 + r0 / p.Gp, pos1 = q0 + r1 / p.Gp;
    const uint32_t qa = tc::smem_u32(Qs) + (SPLIT ? 0 : wg * 64 * RB);
    const uint32_t ka = tc::smem_u32(Ks), va = tc::smem_u32(Vs);

    float o[HD / 2];
#pragma unroll
    for (int n = 0; n < HD / 2; ++n) o[n] = 0.f;
    Softmax sm_{p, pos0, pos1, tig};
    float sc[32];         // S of the tile in flight, then its P in f32
    uint32_t pa[4][4];    // P of the tile whose P.V runs, bf16 fragments
    uint32_t pn[4][4];    // P of the next tile, made while that P.V runs

    // S = Q K^T of tile i (landed) into sc, issued and committed
    auto issue_qk = [&](int i) {
      const int s = i % kStages;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const uint32_t off = (ks * 16 % W) * 2, part = ks * 16 / W;
        tc::wgmma_ss_n64(
            sc, tc::desc_k(qa + part * kRows * RB + off, RB),
            tc::desc_k(ka + s * L::TILE + part * kBK * RB + off, RB), ks > 0);
      }
      tc::wg_commit();
    };

    // Software pipeline (FlashAttention-3): while the tensor cores run
    // P.V of tile i, this warpgroup does the softmax of tile i + step,
    // whose Q.K^T was issued with it.  O is rescaled once P.V is done.
    const int step = SPLIT ? 2 : 1;
    int i = SPLIT ? wg : 0;  // split: warpgroup wg takes tiles wg, wg + 2..
    tc::mbar_wait(q_full, 0);
    if (i < nt) {
      tc::mbar_wait(&k_full[i % kStages], (i / kStages) & 1);
      tc::wg_fence();
      issue_qk(i);
      tc::wg_wait<0>();
      tc::fence_regs<32>(sc);
      float c0, c1;
      sm_.tile(sc, kv_lo + i * kBK, q0, q_end, pa, c0, c1);
    }
    // The two warpgroups take turns to issue their products (named
    // barriers 3 and 4, FlashAttention-3's ping-pong): one's softmax runs
    // while the other's products hold the tensor cores.  Warpgroup 0 goes
    // first; the one arrival left over at the end is harmless.
    if (wg == 1) tc::bar_arrive(3, 256);
    for (; i < nt; i += step) {
      const int s = i % kStages, n = i + step;
      const bool more = n < nt;
      tc::mbar_wait(&v_full[s], (i / kStages) & 1);
      if (more) tc::mbar_wait(&k_full[n % kStages], (n / kStages) & 1);
      tc::bar_sync(3 + wg, 256);  // this warpgroup's turn
      tc::fence_regs<HD / 2>(o);
      tc::wg_fence();
      if (more) issue_qk(n);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // O += P V, V's parts kBK*RB apart
        tc::wgmma_rs<HD>(o, pa[kk],
                         tc::desc_mn(va + s * L::TILE + kk * 16 * RB,
                                     kBK * RB, RB));
      tc::wg_commit();
      tc::bar_arrive(4 - wg, 256);  // the other's turn
      float c0 = 1.f, c1 = 1.f;
      if (more) {
        tc::wg_wait<1>();  // S of tile n; P.V of tile i still runs
        tc::fence_regs<32>(sc);
        sm_.tile(sc, kv_lo + n * kBK, q0, q_end, pn, c0, c1);
      }
      tc::wg_wait<0>();
      tc::fence_regs<HD / 2>(o);
      if (lane == 0) tc::mbar_arrive(&empty[s]);  // this warp is done
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pn[kk][e];
    }
    float m0 = sm_.m0, m1 = sm_.m1, l0 = sm_.l0, l1 = sm_.l1;

    if (SPLIT) {  // warpgroup 1 hands its state to 0 through the K/V ring
      float* x = reinterpret_cast<float*>(Ks);
      const int t = tid % 128;
      tc::bar_sync(1, 256);  // both are done with the ring
      if (wg == 1) {
        x[0 * 128 + t] = m0;
        x[1 * 128 + t] = m1;
        x[2 * 128 + t] = l0;
        x[3 * 128 + t] = l1;
#pragma unroll
        for (int n = 0; n < HD / 2; ++n) x[(4 + n) * 128 + t] = o[n];
      }
      tc::bar_sync(1, 256);
      if (wg == 0) {
        const float pm0 = x[t], pm1 = x[128 + t];
        const float mm0 = fmaxf(m0, pm0), mm1 = fmaxf(m1, pm1);
        const float a0 = tc::exp2(m0 - mm0), b0 = tc::exp2(pm0 - mm0);
        const float a1 = tc::exp2(m1 - mm1), b1 = tc::exp2(pm1 - mm1);
        l0 = l0 * a0 + x[2 * 128 + t] * b0;
        l1 = l1 * a1 + x[3 * 128 + t] * b1;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          o[4 * n] = o[4 * n] * a0 + x[(4 + 4 * n) * 128 + t] * b0;
          o[4 * n + 1] = o[4 * n + 1] * a0 + x[(5 + 4 * n) * 128 + t] * b0;
          o[4 * n + 2] = o[4 * n + 2] * a1 + x[(6 + 4 * n) * 128 + t] * b1;
          o[4 * n + 3] = o[4 * n + 3] * a1 + x[(7 + 4 * n) * 128 + t] * b1;
        }
      }
    }

    if (!SPLIT || wg == 0) {
      // each row's denominator is spread over the 4 lanes of its quad
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
      // bf16 rows into this warpgroup's rows of the Q tile, as TMA reads
      // them back for the store
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const int col = n * 8 + 2 * tig;
        unsigned char* part = Qs + (col / W) * kRows * RB;
        const uint32_t byte = (col % W) * 2;
        *reinterpret_cast<__nv_bfloat162*>(part + tc::swz(r0, byte, RB)) =
            __floats2bfloat162_rn(o[4 * n] * i0, o[4 * n + 1] * i0);
        *reinterpret_cast<__nv_bfloat162*>(part + tc::swz(r1, byte, RB)) =
            __floats2bfloat162_rn(o[4 * n + 2] * i1, o[4 * n + 3] * i1);
      }
      tc::fence_async_shared();
      tc::bar_sync(2, SPLIT ? 128 : 256);
      if (tid == 0) {
        for (int j = 0; j < NP; ++j)
          tc::tma_store4(&p.o, Qs + j * kRows * RB, j * W, h0, q0, b);
        tc::tma_commit();
        tc::tma_wait_all();
      }
    }
  }
}

// ------------------------------------------------------------- launch
struct Plan {
  int split, Gp, npos, tiles, nsub;
};

// Query heads a block serves, positions a block and whether the two
// consumer warpgroups split the key tiles; kernel.py's `plan` is the same
// rule
Plan fa_plan(int B, int Sq, int H, int KV, int sms) {
  const int G = H / KV;
  int Gp = 1;
  for (int d = 1; d <= kMaxHeads && d <= G; ++d)
    if (G % d == 0) Gp = d;
  const int npos_full = kRows / Gp;
  const long long blocks =
      (long long)B * KV * (G / Gp) * ((Sq + npos_full - 1) / npos_full);
  const int split = blocks < sms;
  const int npos = (split ? kRows / 2 : kRows) / Gp;
  return {split, Gp, npos, (Sq + npos - 1) / npos, G / Gp};
}

struct FaArgs {
  const void *q, *k, *v;
  void* o;
  int B, Sq, Sk, H, KV;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh;
  int causal, window;
  float scale, cap;
};

template <int HD, bool SPLIT>
int launch(const FaArgs& a, const Plan& pl, cudaStream_t st) {
  using Pt = Part<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once a process
      fa_tc_fwd<HD, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<HD>::BYTES);
  if (attr != cudaSuccess) return attr;
  FaParams p;
  const cuuint32_t qbox[4] = {(cuuint32_t)Pt::W, (cuuint32_t)pl.Gp,
                              (cuuint32_t)pl.npos, 1};
  const cuuint32_t kbox[4] = {(cuuint32_t)Pt::W, kBK, 1, 1};
  // q and o as (hd, H, Sq, B), k and v as (hd, Sk, KV, B)
  const cuuint64_t qdim[4] = {HD, (cuuint64_t)a.H, (cuuint64_t)a.Sq,
                              (cuuint64_t)a.B};
  const cuuint64_t kdim[4] = {HD, (cuuint64_t)a.Sk, (cuuint64_t)a.KV,
                              (cuuint64_t)a.B};
  const cuuint64_t qs[3] = {tc::stride_bytes(a.qsh, a.H),
                            tc::stride_bytes(a.qss, a.Sq),
                            tc::stride_bytes(a.qsb, a.B)};
  const cuuint64_t os[3] = {tc::stride_bytes(a.osh, a.H),
                            tc::stride_bytes(a.oss, a.Sq),
                            tc::stride_bytes(a.osb, a.B)};
  const cuuint64_t ks[3] = {tc::stride_bytes(a.kss, a.Sk),
                            tc::stride_bytes(a.ksh, a.KV),
                            tc::stride_bytes(a.ksb, a.B)};
  const cuuint64_t vs[3] = {tc::stride_bytes(a.vss, a.Sk),
                            tc::stride_bytes(a.vsh, a.KV),
                            tc::stride_bytes(a.vsb, a.B)};
  int rc;
  if ((rc = tc::encode_map(&p.q, 4, a.q, qdim, qs, qbox, Pt::RB)) ||
      (rc = tc::encode_map(&p.o, 4, a.o, qdim, os, qbox, Pt::RB)) ||
      (rc = tc::encode_map(&p.k, 4, a.k, kdim, ks, kbox, Pt::RB)) ||
      (rc = tc::encode_map(&p.v, 4, a.v, kdim, vs, kbox, Pt::RB)))
    return tc::kMapError + rc;
  p.Sq = a.Sq;
  p.Sk = a.Sk;
  p.KV = a.KV;
  p.G = a.H / a.KV;
  p.Gp = pl.Gp;
  p.npos = pl.npos;
  p.nsub = pl.nsub;
  p.causal = a.causal;
  p.window = a.window;
  p.scale = a.scale;
  p.cap = a.cap;
  return tc::launch_pdl(fa_tc_fwd<HD, SPLIT>,
                        dim3(pl.tiles, a.B * a.KV * pl.nsub), dim3(kThreads),
                        Smem<HD>::BYTES, st, p);
}

template <int HD>
int launch_hd(const FaArgs& a, cudaStream_t st) {
  const Plan pl = fa_plan(a.B, a.Sq, a.H, a.KV, tc::sm_count());
  return pl.split ? launch<HD, true>(a, pl, st) : launch<HD, false>(a, pl, st);
}

}  // namespace

// The plan fa_forward_tc launches with on this card: split, heads a
// block, positions a block, blocks (chip_smoke.py holds kernel.py's
// `plan` to it)
extern "C" int fa_plan_tc(int B, int Sq, int H, int KV, int* out) {
  if (B < 1 || Sq < 1 || KV < 1 || H % KV) return cudaErrorInvalidValue;
  const Plan pl = fa_plan(B, Sq, H, KV, tc::sm_count());
  out[0] = pl.split;
  out[1] = pl.Gp;
  out[2] = pl.npos;
  out[3] = pl.tiles * B * KV * pl.nsub;
  return 0;
}

// q [B,Sq,H,hd], k and v [B,Sk,KV,hd] with a contiguous head dim, o
// [B,Sq,H,hd]; every base 16-byte aligned and the stride of every dim of
// more than one element a multiple of 8 elements (TMA, tc::tma_ready),
// which the launcher sees to
extern "C" int fa_forward_tc(const void* q, const void* k, const void* v,
                             void* o, int B, int Sq, int Sk, int H, int KV,
                             int hd, long long qsb, long long qss,
                             long long qsh, long long ksb, long long kss,
                             long long ksh, long long vsb, long long vss,
                             long long vsh, long long osb, long long oss,
                             long long osh, int causal, int window,
                             float scale, float cap, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV)
    return cudaErrorInvalidValue;
  const long long nq[3] = {B, Sq, H}, nk[3] = {B, Sk, KV};
  if (!tc::tma_ready(q, {qsb, qss, qsh}, nq) ||
      !tc::tma_ready(k, {ksb, kss, ksh}, nk) ||
      !tc::tma_ready(v, {vsb, vss, vsh}, nk) ||
      !tc::tma_ready(o, {osb, oss, osh}, nq))
    return cudaErrorMisalignedAddress;
  const FaArgs a{q,   k,   v,   o,   B,   Sq,  Sk,  H,      KV,     qsb,
                 qss, qsh, ksb, kss, ksh, vsb, vss, vsh,    osb,    oss,
                 osh, causal, window, scale, cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_hd<16>(a, st);
    case 32: return launch_hd<32>(a, st);
    case 64: return launch_hd<64>(a, st);
    case 80: return launch_hd<80>(a, st);  // hubert-xlarge
    case 128: return launch_hd<128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
