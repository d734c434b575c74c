// Flash-attention forward for Hopper (sm_90a), self-attention prefill, f32,
// on the tensor cores in three TF32 passes.
//
// Replaces the Pallas TPU kernel `_fa_kernel` (src/repro/kernels/
// flash_attention/kernel.py:25, launched by `flash_attention` at :70) for
// f32 inputs; bf16 goes to flash_attention_tc.cu.  Same function: scores
// in f32 scaled by `scale`, optional tanh softcap, causal mask kp <= qp and
// sliding-window mask qp - kp < window (masked scores are -1e30, as in the
// reference), GQA query head h reads KV head h / (H / KV), online softmax
// with running max, denominator and f32 accumulator, output
// acc / max(l, 1e-30).  Positions are the self-attention iota.  `window`
// is a runtime int and is honoured in every layer (the reference's ops.py
// drops a traced window to 0).  Any Sq, Sk: the ragged q and kv edges are
// masked here (keys past Sk score -inf), no divisibility asserts.
//
// Precision: both products, Q.K^T and P.V, run as three TF32 passes of
// mma.sync.m16n8k8 (tf32.cuh): each f32 operand is split into two TF32
// parts, about 22 significant bits a product, accumulated in f32.  One TF32
// pass misses the f32 tolerance of 2e-5 many times over; three hold it with
// a wide margin (tests/test_torch_flash_attention.py emulates both on the
// CPU).
// The softmax runs in the log2 domain (scores times scale * log2 e,
// ex2.approx, ~2^-22 relative), which the same emulation holds to 2e-5.
//
// What bounds it on the H100: causal attention does 4*S*S/2*hd FLOPs per
// query head against (2*H + 2*KV)*S*hd*4 bytes, about 0.2*S FLOP per byte at
// hymba's 25 query and 5 KV heads; the tensor cores run f32 work at 494.7/3
// = 165 TFLOP/s in three passes (the CUDA cores at 67), so prompts above
// S ~ 250 are bound by operations.  mma.sync, not wgmma: wgmma's TF32 takes
// only K-major operands from shared memory, and V, stored [keys, hd], is
// MN-major for P.V, so P.V would need a transposed copy of every V tile,
// and the two TF32 parts of each operand a tile of their own.  mma.sync
// takes every operand from registers, split once it is loaded.
//
// Design (FlashAttention-2's forward on 4 warps):
//  - A block owns 64 (position, head) rows, 16 a warp: the query heads of
//    one KV group packed as in the bf16 kernel's plan (`heads` = the largest
//    divisor of H/KV up to 16, `npos` = 64 / heads positions of them), so one
//    K/V tile serves every head of the group.  Rows past npos * heads are
//    idle.
//  - K and V tiles of BK keys (64, or 32 at hd 128) are staged by cp.async
//    in two stages, the next tile's copies in flight while this one is used;
//    rows of hd + 4 floats, so every fragment read below is free of bank
//    conflicts.  cp.async, not TMA: TMA writes dense or swizzled rows, and
//    the fragments here read padded rows with plain loads.  Views whose
//    rows are not 16-byte aligned are copied 4 bytes at a time (`vec`).
//  - Q stays in registers as f32 fragments, split per use.  S = Q.K^T per
//    warp: 16 rows x BK keys; the softmax on the accumulators (row max and
//    sum over the 4 lanes of a row); then P.V with P taken straight from
//    the accumulators as the A operand: an accumulator lane holds keys 2tig
//    and 2tig+1, which serve as k = tig and tig+4, and V's B fragment reads
//    rows 2tig and 2tig+1 to match.
//  - Where blocks of 64 rows would be fewer than the SMs (hymba's S=256),
//    blocks take 32 rows and their 4 warps are 2 row groups x 2 halves of
//    each key tile, whose softmax states are merged at the end (`split`):
//    the blocks that see the most keys, which set the time, then run half
//    their products a warp.
//  - Key tiles wholly outside the causal or window range of the block are
//    skipped; the mask is computed only in tiles that cross an edge, and
//    the softcap is one branch a tile.
//  - Blocks are issued heaviest first: the last positions, which see the
//    most keys under a causal mask, take the lowest block indices, so the
//    grid's tail is made of light blocks (the order changes nothing that a
//    block computes).
#include <math.h>

#include "tc.cuh"
#include "tf32.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // (position, head) rows a block, 16 a warp
constexpr int kMaxPacked = 16;  // query heads of one KV group a block
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct FaArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  int B, Sq, Sk, H, KV;
  long long qsb, qss, qsh;  // strides in elements; head dim is contiguous
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  long long osb, oss, osh;
  int causal, window;
  float scale, cap;
  int heads, npos, packs;  // heads a block, positions a block, packs a group
  int vec;                 // K and V rows copied 16 bytes at a time
};

// SPLIT: the block's 4 warps are 2 row groups x 2 key halves of each tile
// (32 rows a block), else 4 row groups (64 rows)
template <int HD, bool SPLIT>
struct Geo {
  static constexpr int BK = HD <= 80 ? 64 : 32;  // keys a tile
  static constexpr int LD = HD + 4;              // floats a staged row
  static constexpr int TILE = BK * LD;           // floats of a K or V tile
  static constexpr int BYTES = 2 * 2 * TILE * 4;  // two stages of K and V
  static constexpr int KS = HD / 8;  // k-steps of Q.K^T, n-tiles of P.V
  static constexpr int HK = SPLIT ? BK / 2 : BK;  // keys of a tile a warp
  static constexpr int NT = HK / 8;  // n-tiles of Q.K^T, k-steps of P.V
  // the key halves' merge: each lane's m, l (2 rows) and o, in the stages
  static_assert(!SPLIT || (4 + 4 * KS) * 2 * 32 <= 2 * 2 * TILE, "merge");
};

template <int HD, bool SPLIT>
__global__ void __launch_bounds__(kThreads) fa_fwd(const FaArgs a) {
  using G = Geo<HD, SPLIT>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31;
  // row group and key half of this warp
  const int warp = SPLIT ? (tid >> 5) & 1 : tid >> 5;
  const int half = SPLIT ? tid >> 6 : 0;
  const int gid = lane >> 2, tig = lane & 3;

  // the block: batch b, KV head kvh, pack of query heads, positions
  // block index = (position blocks from the last) x groups + group
  const int groups = a.B * a.KV * a.packs, grp = blockIdx.x % groups;
  const int pack = grp % a.packs;
  const int kvh = (grp / a.packs) % a.KV;
  const int b = grp / (a.packs * a.KV);
  const int nq = (a.Sq + a.npos - 1) / a.npos;
  const int q0 = (nq - 1 - (int)(blockIdx.x / groups)) * a.npos;
  const int h0 = kvh * (a.H / a.KV) + pack * a.heads;

  // this lane's two rows, gid and gid + 8 of its warp's 16
  int qp[2], hh[2];
  bool valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    qp[i] = q0 + r / a.heads;
    hh[i] = h0 + r % a.heads;
    valid[i] = r < a.npos * a.heads && qp[i] < a.Sq;
  }
  // Q as A fragments: (row, dim ks*8 + tig) and (row, ks*8 + tig + 4)
  float qf[G::KS][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float* Q = a.q + b * a.qsb + (long long)qp[i] * a.qss +
                     (long long)hh[i] * a.qsh;
#pragma unroll
    for (int ks = 0; ks < G::KS; ++ks) {
      qf[ks][i] = valid[i] ? Q[ks * 8 + tig] : 0.f;
      qf[ks][2 + i] = valid[i] ? Q[ks * 8 + tig + 4] : 0.f;
    }
  }
  float o[G::KS][4];
#pragma unroll
  for (int dt = 0; dt < G::KS; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  // key range any row of this block can see, in whole tiles
  const int q_last = min(a.Sq, q0 + a.npos) - 1;
  const int kv_hi = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int kv_lo =
      (a.window > 0 ? max(0, q0 - a.window + 1) : 0) / G::BK * G::BK;
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + G::BK - 1) / G::BK : 0;

  const float* K = a.k + b * a.ksb + kvh * a.ksh;
  const float* V = a.v + b * a.vsb + kvh * a.vsh;
  auto issue = [&](int t) {  // tile t's K and V into stage t & 1
    const int k0 = kv_lo + t * G::BK;
    float* Ks = sm + (t & 1) * 2 * G::TILE;
    float* Vs = Ks + G::TILE;
    if (a.vec) {
      constexpr int C4 = HD / 4;  // 16-byte pieces a row
      for (int e = tid; e < G::BK * C4; e += kThreads) {
        const int j = e / C4, d = (e % C4) * 4, key = k0 + j;
        const bool in = key < a.Sk;
        const long long kr = in ? key : 0;
        tf32::cp16(Ks + j * G::LD + d, K + kr * a.kss + d, in);
        tf32::cp16(Vs + j * G::LD + d, V + kr * a.vss + d, in);
      }
    } else {
      for (int e = tid; e < G::BK * HD; e += kThreads) {
        const int j = e / HD, d = e % HD, key = k0 + j;
        const bool in = key < a.Sk;
        const long long kr = in ? key : 0;
        tf32::cp4(Ks + j * G::LD + d, K + kr * a.kss + d, in);
        tf32::cp4(Vs + j * G::LD + d, V + kr * a.vss + d, in);
      }
    }
    tf32::cp_commit();
  };

  const float sl2 = a.scale * kLog2e, rcap = a.cap > 0.f ? 1.f / a.cap : 0.f;
  if (ntiles > 0) issue(0);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      issue(t + 1);
      tf32::cp_wait<1>();
    } else {
      tf32::cp_wait<0>();
    }
    __syncthreads();  // tile t has landed for every thread
    // this warp's keys of the tile: all, or its half
    const int k0 = kv_lo + t * G::BK + half * G::HK;
    const float* Ks = sm + (t & 1) * 2 * G::TILE + half * G::HK * G::LD;
    const float* Vs = Ks + G::TILE;

    // S = Q.K^T: 16 rows x HK keys a warp
    float s[G::NT][4];
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < G::KS; ++ks) {
      const tf32::A qa(qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3]);
      tf32::B kb[G::NT];
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt) {
        const float* kr = Ks + (nt * 8 + gid) * G::LD + ks * 8 + tig;
        kb[nt] = tf32::B(kr[0], kr[4]);
      }
      tf32::mma3(s, qa, kb);
    }

    // scores in the log2 domain; the softcap one branch a tile
    if (a.cap > 0.f) {
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = tanhf(s[nt][e] * a.scale * rcap) * a.cap * kLog2e;
    } else {
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] *= sl2;
    }
    // the mask, only in a tile that crosses an edge of the block's range
    const bool edge = (a.causal && k0 + G::HK - 1 > q0) ||
                      (a.window > 0 && q_last - k0 >= a.window) ||
                      k0 + G::HK > a.Sk;
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + nt * 8 + 2 * tig + (e & 1), q = qp[e >> 1];
          bool ok = true;
          if (a.causal) ok = ok && kp <= q;
          if (a.window > 0) ok = ok && q - kp < a.window;
          s[nt][e] = ok ? s[nt][e] : kNeg;
          if (kp >= a.Sk) s[nt][e] = -INFINITY;  // past the ragged edge
        }
    }

    // online softmax: row max over the 4 lanes of a row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = tc::exp2(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = tc::exp2(s[nt][e] - mx[e >> 1]);
      l[0] += s[nt][0] + s[nt][1];
      l[1] += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int dt = 0; dt < G::KS; ++dt) {
      o[dt][0] *= corr[0];
      o[dt][1] *= corr[0];
      o[dt][2] *= corr[1];
      o[dt][3] *= corr[1];
    }

    // O += P.V: P from the accumulators (keys 2tig, 2tig+1 as k = tig,
    // tig + 4), V rows 2tig and 2tig+1 to match
#pragma unroll
    for (int kk = 0; kk < G::NT; ++kk) {
      const tf32::A pa(s[kk][0], s[kk][2], s[kk][1], s[kk][3]);
      const float* vr = Vs + (kk * 8 + 2 * tig) * G::LD + gid;
      tf32::B vb[G::KS];
#pragma unroll
      for (int dt = 0; dt < G::KS; ++dt)
        vb[dt] = tf32::B(vr[dt * 8], vr[G::LD + dt * 8]);
      tf32::mma3(o, pa, vb);
    }
    __syncthreads();  // stage t & 1 consumed before tile t + 2 reuses it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if constexpr (SPLIT) {
    // the key halves' softmax states merged: the upper half hands its m, l
    // and o over through the stages (component-major, lane-minor)
    float* mg = sm + warp * 32 + lane;
    auto at = [&](int i) -> float& { return mg[i * 2 * 32]; };
    if (half == 1) {
      at(0) = m[0];
      at(1) = m[1];
      at(2) = l[0];
      at(3) = l[1];
#pragma unroll
      for (int dt = 0; dt < G::KS; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) at(4 + 4 * dt + e) = o[dt][e];
    }
    __syncthreads();
    if (half == 1) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = at(i), mm = fmaxf(m[i], m1);
      const float f0 = tc::exp2(m[i] - mm), f1 = tc::exp2(m1 - mm);
      l[i] = l[i] * f0 + at(2 + i) * f1;
#pragma unroll
      for (int dt = 0; dt < G::KS; ++dt) {
        o[dt][2 * i] = o[dt][2 * i] * f0 + at(4 + 4 * dt + 2 * i) * f1;
        o[dt][2 * i + 1] =
            o[dt][2 * i + 1] * f0 + at(4 + 4 * dt + 2 * i + 1) * f1;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!valid[i]) continue;
    float* O = a.o + b * a.osb + (long long)qp[i] * a.oss +
               (long long)hh[i] * a.osh;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dt = 0; dt < G::KS; ++dt)
      *reinterpret_cast<float2*>(O + dt * 8 + 2 * tig) =
          make_float2(o[dt][2 * i] / den, o[dt][2 * i + 1] / den);
  }
}

template <int HD, bool SPLIT>
cudaError_t launch_hd(const FaArgs& a, cudaStream_t st) {
  using G = Geo<HD, SPLIT>;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once a process
      fa_fwd<HD, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::BYTES);
  if (attr != cudaSuccess) return attr;
  const long long grid =
      (long long)a.B * a.KV * a.packs * ((a.Sq + a.npos - 1) / a.npos);
  if (grid >= (1ll << 31)) return cudaErrorInvalidConfiguration;
  fa_fwd<HD, SPLIT><<<(unsigned)grid, kThreads, G::BYTES, st>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const FaArgs& a, bool split, cudaStream_t st) {
  return split ? launch_hd<HD, true>(a, st) : launch_hd<HD, false>(a, st);
}

cudaError_t launch(const FaArgs& a, int hd, bool split, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_hd<16>(a, split, st);
    case 32: return launch_hd<32>(a, split, st);
    case 64: return launch_hd<64>(a, split, st);
    case 80: return launch_hd<80>(a, split, st);  // hubert-xlarge
    case 128: return launch_hd<128>(a, split, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,Sq,H,hd], k and v [B,Sk,KV,hd] f32, head dim contiguous, any other
// strides; o [B,Sq,H,hd] f32 with an even head dim stride (the launcher
// allocates it contiguous).
extern "C" int fa_forward(const float* q, const float* k, const float* v,
                          float* o,
                          int B, int Sq, int Sk, int H, int KV,
                          int hd, long long qsb, long long qss, long long qsh,
                          long long ksb, long long kss, long long ksh,
                          long long vsb, long long vss, long long vsh,
                          long long osb, long long oss, long long osh,
                          int causal, int window, float scale, float cap,
                          void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV)
    return cudaErrorInvalidValue;
  const int G = H / KV;
  int heads = 1;
  for (int d = 1; d <= G && d <= kMaxPacked; ++d)
    if (G % d == 0) heads = d;
  const long long nb[3] = {B, Sk, KV};
  const bool vec = tc::tma_ready(k, {ksb, kss, ksh}, nb, 4) &&
                   tc::tma_ready(v, {vsb, vss, vsh}, nb, 4);
  // blocks of 64 rows, or of 32 with the key halves split where those
  // would leave SMs idle (the last positions' blocks, which see the most
  // keys, then run half their products a warp)
  const int packs = G / heads;
  const long long blocks = (long long)B * KV * packs *
                           ((Sq + kRows / heads - 1) / (kRows / heads));
  const bool split = blocks < tc::sm_count();
  const int npos = (split ? kRows / 2 : kRows) / heads;
  FaArgs a{q,   k,   v,      o,      B,     Sq,         Sk,     H,   KV,
           qsb, qss, qsh,    ksb,    kss,   ksh,        vsb,    vss, vsh,
           osb, oss, osh,    causal, window, scale,     cap,    heads,
           npos,             packs,         vec ? 1 : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch(a, hd, split, st);
}
