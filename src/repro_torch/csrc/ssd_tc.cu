// Mamba-2 SSD chunk scan on Hopper, bf16 (sm_90a), in one launch.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` (src/repro/kernels/ssd/
// kernel.py:23, launched by `ssd` at :73) for bf16 x, B and C; ssd.cu
// keeps the f32 path.  Same function, per chunk of l steps:
//   cum = cumsum(dt * A)
//   y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra)
//       + exp(cum_i) C_i . h_prev                                 (inter)
//   h  <- h exp(cum_end) + sum_j x_j (B_j dt_j exp(cum_end - cum_j))
// y in bf16, the final state in f32.  Any S: the last chunk may be
// partial, and cum_end, the decay-to-end and the state update use its last
// valid row.  P <= 64, N <= 128, chunk <= 1024, any of them ragged.
//
// What bounds it on the H100: bytes, at every S.  Per step the function
// reads x and writes y (4*H*P bytes) and reads B, C and dt; its products
// are about H*(l*(N+P) + 4*P*N) FLOPs a step, so at hymba's widths (H=50,
// P=64, N=16, l=128) it does ~56 FLOP per byte, under the ~295 at which
// the tensor cores would bind.  What holds this design back is neither:
// a chunk's step is a chain of dependent phases (the cumsum, the state,
// the score tiles, y's store), latency-bound on the SM's 8 compute warps.
//
// Design: row p of the state h [P, N] depends only on column p of x, so
// one block per (PS columns of P, head, batch) runs every chunk of its
// slice and carries the [PS, N] state from chunk to chunk on chip: one
// launch a call, x read from device memory once, y written once, no state
// in device memory between chunks.  PS = 16 where N > 32, else 32, or 64
// where blocks of 32 would outnumber the SMs at N <= 16 (ps_for): 100
// blocks at hymba's B=1 and at B=2.
//  - Compute warpgroups take the chunks in turn: three at N <= 16 with 32
//    columns of P (hymba's B=1: 100 blocks, so each block needs the most
//    overlap), else two (ng_for).  A chunk's state contribution
//    x^T (B o w) comes first; the state entering it arrives from the
//    warpgroup that ran the chunk before, through one shared-memory slot
//    and two mbarriers used in turn; the state after it goes on the same
//    way.  Only that hand-over is serial: the cumsum and the score tiles
//    of neighbouring chunks run at once.
//  - A producer warpgroup (setmaxnreg.dec to 40, 24 beside three compute
//    warpgroups; one thread a compute warpgroup) loads by TMA, in the
//    order a compute warpgroup consumes them, into that warpgroup's two
//    rings guarded by mbarriers: C tiles of 64 rows (2 stages) and (B, x)
//    tile pairs of 64 rows (4 stages; 3 at N = 128, so that two groups fit
//    the shared memory): each chunk's (B, x) tiles for its state, then
//    each row tile's C and the (B, x) tiles at and before it (re-read from
//    L2).
//  - Each compute warpgroup (setmaxnreg.inc to 232, or 160 of three) runs
//    a chunk 64 rows at a time, 16 a warp.  C.B^T is wgmma m64n64k16 from
//    the C and B tiles; its decay exp(cum_i - cum_j), dt_j and the causal
//    mask are applied on the accumulators (factored about each warp's
//    first row r into exp(cum_i - cum_r) exp(cum_r - cum_j) dt_j, both
//    <= 1 for keys before r; the warp's own 16 rows take the exp whole);
//    then (L o C.B^T).x is wgmma m64n{PS}k16 with the scores from
//    registers and x MN-major from its tile.
//  - Kept on mma.sync.m16n8k16 (16-row tiles, under wgmma's 64 rows):
//    exp(cum_i) C_i.h_prev, whose B fragments come from the state in
//    registers, and the state's x^T (B o w), whose M is the block's PS
//    state rows.  Where N >= 64 each of the warpgroup's four warps takes
//    a quarter of its N columns over every key; at smaller N (too few
//    8-column tiles to share) its 16-key steps go to the four warps in
//    turn, and the parts are summed in order through shared memory.
//  - Each warp stores its 16 rows of y by TMA from shared memory, clipped
//    at S; rows that end inside a chunk that is not the last are stored
//    by the threads, so that no store reaches the next chunk's rows.
//  - Precision: x, B and C go in as they are (bf16).  An f32 value that
//    feeds a product (the decayed scores, B o w, the state) is split into
//    hi = bf16(v) and lo = bf16(v - hi), each multiplied by the same bf16
//    partner (at N=128 one bf16 term reached the whole 5e-2 tolerance).
//    The chunk's cumsum is taken in f64 and rounded once; y is rounded to
//    bf16 once.
//  - Shared tiles are in TMA's swizzle (rows of 32, 64 or 128 bytes; N is
//    padded to 16, 32, 64 or 128, one or two 64-column parts), as the
//    wgmma descriptors and the ldmatrix addresses read them.
//  - Launched with programmatic dependent launch: blocks are placed while
//    the kernel before drains and wait for it before any load.
// Registers (ptxas -v, CUDA 12.9, sm_90a): 168 a thread at launch (128
// with three compute warpgroups, 12 bytes of spill stores); no spills at
// N padded to 16, 32 and 64 otherwise, 20 bytes at 128; phase 1 of
// chip_smoke.py prints them for each build.
#include <math.h>

#include "wgmma.cuh"

namespace {

using tc::bf16;

constexpr int kR = 64;              // rows of a tile (C, B, x, y)
constexpr int kGT = 128;            // threads of a warpgroup
constexpr int kCStages = 2;
constexpr int kMaxP = 64, kMaxN = 128, kMaxChunk = 1024;
constexpr int kPer = kMaxChunk / kGT;  // dt values a thread prefetches

// N padded to NP = 16, 32, 64 or 128: parts of W columns, rows of RB bytes.
// PS columns of P a block and NG chunk groups, compute warpgroups that
// take chunks in turn (ps_for and ng_for below).  NB stages of (B, x)
// tiles: 3 at NP = 128, where 4 would not leave two groups room.  COLS:
// the state's x^T (B o w) splits its N columns over a group's four warps
// (NP >= 64), else its 16-key steps, whose four partial states are summed
// through shared memory (HC).
template <int NP, int PS_, int NG_>
struct Geo {
  static constexpr int W = NP < 64 ? NP : 64;
  static constexpr int RB = 2 * W;
  static constexpr int PS = PS_;
  static constexpr int MT = PS / 16;      // 16-row tiles of the state
  static constexpr int PN = PS / 8;       // 8-column tiles of y
  static constexpr int HV = MT * NP / 8;  // float4s of state a thread holds
  static constexpr int NG = NG_;
  static constexpr int NB = NP == 128 ? 3 : 4;
  static constexpr bool COLS = NP >= 64;
  static constexpr int NW = COLS ? NP / 32 : NP / 8;  // state columns of 8
                                                      // a warp computes
  static constexpr int XRB = 2 * PS;      // bytes of an x or y row
  static constexpr int T = kR * NP * 2;   // a B or C tile
  static constexpr int X = kR * XRB;      // an x tile
  static constexpr int YW = 16 * XRB;     // a warp's y rows
  // byte offsets of one group's part of the 1024-aligned shared memory
  static constexpr int C = 0;
  static constexpr int B = C + kCStages * T;
  static constexpr int XS = B + NB * T;
  static constexpr int Y = XS + NB * X;            // 2 a warp
  static constexpr int DT = Y + 4 * 2 * YW;        // dt, cum: kMaxChunk each
  static constexpr int HC = DT + 2 * kMaxChunk * 4;   // 4 warps' states
  static constexpr int WT = HC + (COLS ? 0 : 4 * HV * 32 * 16);  // 4 doubles
  static constexpr int BAR = WT + 4 * 8;               // 2 (C + B) stages
  static constexpr int GROUP = (BAR + 2 * (kCStages + NB) * 8 + 1023) /
                               1024 * 1024;
  static constexpr int SLOT = NG * GROUP;  // the state handed over
  static constexpr int HBAR = SLOT + HV * 32 * 16;
  static constexpr int BYTES = HBAR + 16 + 1024;
};

struct SsdParams {
  CUtensorMap x, bm, cm, y;  // x, y as (P, H, S, B); B, C as (N, S, B)
  const float* dt;           // [B,S,H]
  const float* A;            // [H]
  float* state;              // [B,H,P,N] contiguous
  bf16* yp;                  // [B,S,H,Py] contiguous
  int S, H, P, N, Py, chunk;
  long long dsb, dss, dsh;
};

// shared address of an ldmatrix lane's row piece in a B or C tile
template <int NP>
__device__ __forceinline__ const unsigned char* at_bc(const unsigned char* t,
                                                      tc::RC rc) {
  constexpr int W = NP < 64 ? NP : 64;
  return t + (rc.c / W) * (kR * 2 * W) + tc::swz(rc.r, (rc.c % W) * 2, 2 * W);
}

// a register of two bf16 B values (rows k, k + 1) times w_k, w_{k+1},
// split into hi and lo bf16 terms
__device__ __forceinline__ void scale_split(uint32_t v, float w0, float w1,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  tc::pack_split(f.x * w0, f.y * w1, hi, lo);
}

// setmaxnreg counts: the producer warpgroup gives registers up to the
// NG compute warpgroups (each count a multiple of 8; all of them fit the
// 65,536 registers of the SM)
template <int NG>
struct Regs {
  static constexpr int WARPGROUPS = NG + 1;
  static constexpr int PRODUCER = NG == 3 ? 24 : 40;
  static constexpr int COMPUTE = NG == 3 ? 160 : 232;
};

template <int NP, int PS_, int NG_>
__global__ void __launch_bounds__(Regs<NG_>::WARPGROUPS* kGT, 1)
    ssd_tc_fwd(const __grid_constant__ SsdParams p) {
  using G = Geo<NP, PS_, NG_>;
  constexpr int NT = NP / 8;  // 8-column tiles of the state
  constexpr int PS = G::PS, MT = G::MT, PN = G::PN, HV = G::HV;
  constexpr int NG = G::NG, XRB = G::XRB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (tc::smem_u32(smem_raw) & 1023)) & 1023);
  float4* slot = reinterpret_cast<float4*>(sm + G::SLOT);  // [HV][32]
  // hand-over j (the state entering chunk j + 1) completes h_full[j & 1]
  uint64_t* h_full = reinterpret_cast<uint64_t*>(sm + G::HBAR);

  const int tid = threadIdx.x, g = tid / kGT;
  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int nc = (p.S + p.chunk - 1) / p.chunk;
  // group q's part of shared memory and its two rings
  auto part = [&](int q) { return sm + q * G::GROUP; };
  auto bars = [&](int q) {
    return reinterpret_cast<uint64_t*>(part(q) + G::BAR);
  };

  if (tid == 0) {
    for (int q = 0; q < NG; ++q) {
      uint64_t* bq = bars(q);  // c_full, c_empty, b_full, b_empty
      for (int s = 0; s < kCStages; ++s) {
        tc::mbar_init(&bq[s], 1);
        tc::mbar_init(&bq[kCStages + s], 4);
      }
      for (int s = 0; s < G::NB; ++s) {
        tc::mbar_init(&bq[2 * kCStages + s], 1);
        tc::mbar_init(&bq[2 * kCStages + G::NB + s], 4);
      }
    }
    tc::mbar_init(&h_full[0], G::COLS ? 4 : 1);  // the warps that write
    tc::mbar_init(&h_full[1], G::COLS ? 4 : 1);
    tc::mbar_init_fence();
  }
  __syncthreads();
  tc::launch_dependents();  // the next kernel's blocks may get ready
  tc::grid_wait();          // the kernel before has written x, dt, B, C

  if (g == Regs<NG>::WARPGROUPS - 1) {
    // ------------------------------------------------------- producers
    // thread 32 q of the warpgroup feeds group q's rings, in the order
    // the group consumes them: each chunk's (B, x) tiles for its state,
    // then each 64-row tile's C and the (B, x) tiles at and before it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        Regs<NG>::PRODUCER));
    const int q = (tid - g * kGT) / 32;
    if ((tid & 31) == 0 && q < NG) {
      unsigned char* Cs = part(q) + G::C;
      unsigned char* Bs = part(q) + G::B;
      unsigned char* Xs = part(q) + G::XS;
      uint64_t* bq = bars(q);
      int ic = 0, ib = 0;  // tiles issued into each ring
      auto load_bx = [&](int row) {
        const int s = ib % G::NB, r = ib / G::NB;
        if (r > 0)
          tc::mbar_wait(&bq[2 * kCStages + G::NB + s], (r - 1) & 1);
        tc::mbar_expect_tx(&bq[2 * kCStages + s], G::T + G::X);
        for (int j = 0; j < NP / G::W; ++j)
          tc::tma_load3(Bs + s * G::T + j * kR * G::RB, &p.bm,
                        &bq[2 * kCStages + s], j * G::W, row, b);
        tc::tma_load4(Xs + s * G::X, &p.x, &bq[2 * kCStages + s], p0, h,
                      row, b);
        ++ib;
      };
      for (int c = q; c < nc; c += NG) {
        const int c0 = c * p.chunk, len = min(p.chunk, p.S - c0);
        const int nt = (len + kR - 1) / kR;
        for (int t = 0; t < nt; ++t) load_bx(c0 + t * kR);
        for (int rt = 0; rt < nt; ++rt, ++ic) {
          const int s = ic % kCStages, r = ic / kCStages;
          if (r > 0) tc::mbar_wait(&bq[kCStages + s], (r - 1) & 1);
          tc::mbar_expect_tx(&bq[s], G::T);
          for (int j = 0; j < NP / G::W; ++j)
            tc::tma_load3(Cs + s * G::T + j * kR * G::RB, &p.cm, &bq[s],
                          j * G::W, c0 + rt * kR, b);
          for (int t = 0; t <= rt; ++t) load_bx(c0 + t * kR);
        }
      }
    }
  } else if (g < NG) {
    // ------------------------------------------------- a chunk group
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        Regs<NG>::COMPUTE));
    const int t = tid % kGT, wq = t >> 5, lane = tid & 31;
    const int gid = lane >> 2, tig = lane & 3, bar = 1 + g;
    unsigned char* Cs = part(g) + G::C;
    unsigned char* Bs = part(g) + G::B;
    unsigned char* Xs = part(g) + G::XS;
    unsigned char* Yw = part(g) + G::Y + wq * 2 * G::YW;  // 2 y tiles
    float* dts = reinterpret_cast<float*>(part(g) + G::DT);
    float* cum = dts + kMaxChunk;
    float4* hcs = reinterpret_cast<float4*>(part(g) + G::HC);
    double* wtot = reinterpret_cast<double*>(part(g) + G::WT);
    uint64_t* bq = bars(g);
    uint64_t *c_full = bq, *c_empty = bq + kCStages;
    uint64_t *b_full = bq + 2 * kCStages, *b_empty = b_full + G::NB;
    const uint32_t ca_ = tc::smem_u32(Cs), ba_ = tc::smem_u32(Bs),
                   xa_ = tc::smem_u32(Xs);
    const float Ah = p.A[h];
    const float* DT = p.dt + b * p.dsb + h * p.dsh;
    float dnext[kPer];  // the group's next chunk's dt, loaded ahead
    if (g < nc) {
      const int len = min(p.chunk, p.S - g * p.chunk);
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        dnext[k] = t + k * kGT < len
                       ? DT[(long long)(g * p.chunk + t + k * kGT) * p.dss]
                       : 0.f;
    }
    int ic = 0, ib = 0, iy = 0;  // tiles consumed, y tiles this warp stored

    for (int c = g; c < nc; c += NG) {
      const int c0 = c * p.chunk, len = min(p.chunk, p.S - c0);
      const int nt = (len + kR - 1) / kR;
      tc::chunk_cumsum<kGT>(dnext, Ah, len, p.chunk, dts, cum, wtot, t, bar);
      if (c + NG < nc) {  // the group's next chunk's dt, while this one runs
        const int c1 = c0 + NG * p.chunk, len1 = min(p.chunk, p.S - c1);
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          if (t + k * kGT < len1)
            dnext[k] = DT[(long long)(c1 + t + k * kGT) * p.dss];
      }
      const float cum_end = cum[len - 1];

      // the chunk's state contribution x^T (B o w), w_j = dt_j exp(cum_end
      // - cum_j), all PS state rows in each warp: where COLS, warp wq takes
      // its NW / 2 16-column steps over every key, else the 16-key step
      // kk = wq of each tile over every column
      constexpr int NW = G::NW, NS = NW / 2;
      float hc[MT][NW][4] = {};
      for (int tt = 0; tt < nt; ++tt, ++ib) {
        const int bs = ib % G::NB;
        tc::mbar_wait(&b_full[bs], (ib / G::NB) & 1);
        const unsigned char* Bb = Bs + bs * G::T;
        const unsigned char* Xb = Xs + bs * G::X;
        const int j0 = tt * kR;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (!G::COLS && kk != wq) continue;
          float w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + kk * 16 + 2 * tig + (q & 1) + (q >> 1) * 8;
            w[q] = j < len ? dts[j] * __expf(cum_end - cum[j]) : 0.f;
          }
          uint32_t xa[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const tc::RC rc = tc::a_kmajor(mt * 16, kk * 16, lane);
            tc::ldsm_x4_t(xa[mt], Xb + tc::swz(rc.r, rc.c * 2, XRB));
          }
#pragma unroll
          for (int ns = 0; ns < NS; ++ns) {
            const int np = G::COLS ? wq * NS + ns : ns;
            uint32_t bb[4], bh[4], bl[4];
            tc::ldsm_x4_t(bb, at_bc<NP>(Bb, tc::b_kmajor(kk * 16, np * 16,
                                                          lane)));
            scale_split(bb[0], w[0], w[1], bh[0], bl[0]);
            scale_split(bb[1], w[2], w[3], bh[1], bl[1]);
            scale_split(bb[2], w[0], w[1], bh[2], bl[2]);
            scale_split(bb[3], w[2], w[3], bh[3], bl[3]);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              tc::mma(hc[mt][2 * ns], xa[mt], bh[0], bh[1]);
              tc::mma(hc[mt][2 * ns + 1], xa[mt], bh[2], bh[3]);
              tc::mma(hc[mt][2 * ns], xa[mt], bl[0], bl[1]);
              tc::mma(hc[mt][2 * ns + 1], xa[mt], bl[2], bl[3]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) tc::mbar_arrive(&b_empty[bs]);  // warp done with it
      }
      // hsum: this warp's columns where COLS, else the four warps' parts
      // summed in order
      float4 hsum[MT * NW];
      if constexpr (G::COLS) {
#pragma unroll
        for (int k = 0; k < MT * NW; ++k)
          hsum[k] = make_float4(hc[k / NW][k % NW][0], hc[k / NW][k % NW][1],
                                hc[k / NW][k % NW][2], hc[k / NW][k % NW][3]);
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < NT; ++n)
            hcs[(wq * HV + mt * NT + n) * 32 + lane] =
                make_float4(hc[mt][n][0], hc[mt][n][1], hc[mt][n][2],
                            hc[mt][n][3]);
        tc::bar_sync(bar, kGT);
#pragma unroll
        for (int k = 0; k < MT * NT; ++k) {
          float4 v = hcs[k * 32 + lane];
#pragma unroll
          for (int q = 1; q < 4; ++q) {
            const float4 u = hcs[(q * HV + k) * 32 + lane];
            v.x += u.x;
            v.y += u.y;
            v.z += u.z;
            v.w += u.w;
          }
          hsum[k] = v;
        }
      }
      // whether this warp writes the state's 8-column tile n (its own
      // columns where COLS, else warp 0 all of them)
      auto writes = [&](int n) { return G::COLS ? n / NW == wq : wq == 0; };

      // the state entering the chunk, from the group that ran the chunk
      // before (chunk 0: zero); then the state after it, for the next
      float4 hprev[MT * NT];
#pragma unroll
      for (int k = 0; k < MT * NT; ++k)
        hprev[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c > 0) {  // hand-over c - 1; the one before on its barrier,
                    // c - 3, this group has waited for or made itself
        tc::mbar_wait(&h_full[(c - 1) & 1], ((c - 1) >> 1) & 1);
#pragma unroll
        for (int k = 0; k < MT * NT; ++k) hprev[k] = slot[k * 32 + lane];
      }
      const float dec = __expf(cum_end);
      tc::bar_sync(bar, kGT);  // the group has read the slot and hcs
      if (c + 1 < nc) {
        if (G::COLS || wq == 0) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int n = 0; n < NT; ++n) {
              if (!writes(n)) continue;
              const float4 hp = hprev[mt * NT + n];
              const float4 hs = hsum[mt * NW + n % NW];
              slot[(mt * NT + n) * 32 + lane] =
                  make_float4(hp.x * dec + hs.x, hp.y * dec + hs.y,
                              hp.z * dec + hs.z, hp.w * dec + hs.w);
            }
          __syncwarp();
          if (lane == 0) tc::mbar_arrive(&h_full[c & 1]);
        }
      } else {  // the final state, f32
        float* St = p.state + ((long long)b * p.H + h) * p.P * p.N;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            if (!writes(n)) continue;
            const float4 hp = hprev[mt * NT + n], hs = hsum[mt * NW + n % NW];
            const float v[4] = {hp.x * dec + hs.x, hp.y * dec + hs.y,
                                hp.z * dec + hs.z, hp.w * dec + hs.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int pp = p0 + mt * 16 + gid + (e >> 1) * 8;
              const int nn = n * 8 + 2 * tig + (e & 1);
              if (pp < p.P && nn < p.N) St[pp * p.N + nn] = v[e];
            }
          }
      }

      // h_prev as bf16 hi/lo B fragments of C.h^T: k = n, columns p
      uint32_t hh[NP / 16][PN][2], hl[NP / 16][PN][2];
#pragma unroll
      for (int ks = 0; ks < NP / 16; ++ks)
#pragma unroll
        for (int pt = 0; pt < PN; ++pt) {
          const float4 a0 = hprev[(pt >> 1) * NT + 2 * ks];
          const float4 a1 = hprev[(pt >> 1) * NT + 2 * ks + 1];
          const bool up = pt & 1;  // rows gid + 8: the float4's z, w
          tc::pack_split(up ? a0.z : a0.x, up ? a0.w : a0.y, hh[ks][pt][0],
                         hl[ks][pt][0]);
          tc::pack_split(up ? a1.z : a1.x, up ? a1.w : a1.y, hh[ks][pt][1],
                         hl[ks][pt][1]);
        }

      // y, a 64-row tile at a time: the group's four warps 16 rows each
      for (int rt = 0; rt < nt; ++rt, ++ic) {
        const int i0 = rt * kR, w0 = i0 + wq * 16;  // this warp's rows
        const int cs = ic % kCStages;
        tc::mbar_wait(&c_full[cs], (ic / kCStages) & 1);
        const unsigned char* Cb = Cs + cs * G::T;
        const int ra = w0 + gid, rb = ra + 8;  // chunk rows
        float y[PN][4] = {};

        for (int tt = 0; tt <= rt; ++tt, ++ib) {
          const int bs = ib % G::NB;
          tc::mbar_wait(&b_full[bs], (ib / G::NB) & 1);
          const int j0 = tt * kR;
          // C.B^T: 64 rows x 64 keys, wgmma from the C and B tiles (both
          // K-major over N)
          float sc[32];
          tc::wg_fence();
#pragma unroll
          for (int ks = 0; ks < NP / 16; ++ks) {
            const uint32_t pt_ = ks * 16 / G::W, off = (ks * 16 % G::W) * 2;
            tc::wgmma_ss_n64(
                sc, tc::desc_k(ca_ + cs * G::T + pt_ * kR * G::RB + off, G::RB),
                tc::desc_k(ba_ + bs * G::T + pt_ * kR * G::RB + off, G::RB),
                ks > 0);
          }
          tc::wg_commit();
          tc::wg_wait<0>();
          tc::fence_regs<32>(sc);
          // decay exp(cum_i - cum_j) and dt_j; zero above the diagonal
          // and past the end (selected, never multiplied).  Factored about
          // the warp's first row r = w0 as exp(cum_i - cum_r) (<= 1, two a
          // thread) times exp(cum_r - cum_j) dt_j (one a column): both
          // stay in range for keys j <= r.  The 8-column steps that reach
          // the warp's own rows take exp(cum_i - cum_j) whole.
          const float cr = cum[min(w0, len - 1)];
          const float cia = cum[min(ra, len - 1)];
          const float cib = cum[min(rb, len - 1)];
          const float ea = __expf(cia - cr), eb = __expf(cib - cr);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int jc = j0 + j * 8 + 2 * tig;
            float* v = sc + 4 * j;
            if (j0 + j * 8 + 7 < w0) {  // every key of the step before r
              const float g0_ = __expf(cr - cum[jc]) * dts[jc];
              const float g1_ = __expf(cr - cum[jc + 1]) * dts[jc + 1];
              v[0] = ra < len ? v[0] * ea * g0_ : 0.f;
              v[1] = ra < len ? v[1] * ea * g1_ : 0.f;
              v[2] = rb < len ? v[2] * eb * g0_ : 0.f;
              v[3] = rb < len ? v[3] * eb * g1_ : 0.f;
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = e < 2 ? ra : rb, jj = jc + (e & 1);
                v[e] = jj <= i && i < len
                           ? v[e] * __expf((e < 2 ? cia : cib) - cum[jj]) *
                                 dts[jj]
                           : 0.f;
              }
            }
          }
          // y += scores . x, the scores as two bf16 terms (register A
          // fragments), x MN-major from its tile
          uint32_t ah[4][4], al[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              tc::pack_split(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1],
                             ah[kk][q], al[kk][q]);
          tc::fence_regs<PS / 2>(&y[0][0]);
          tc::wg_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t xd = tc::desc_mn(xa_ + bs * G::X + kk * 16 * XRB,
                                            kR * XRB, XRB);
            tc::wgmma_rs<PS>(&y[0][0], ah[kk], xd);
            tc::wgmma_rs<PS>(&y[0][0], al[kk], xd);
          }
          tc::wg_commit();
          tc::wg_wait<0>();
          tc::fence_regs<PS / 2>(&y[0][0]);
          __syncwarp();
          if (lane == 0) tc::mbar_arrive(&b_empty[bs]);  // warp done with it
        }

        if (c > 0 && w0 < len) {  // y += exp(cum_i) C_i . h_prev
          float ti[PN][4] = {};
#pragma unroll
          for (int ks = 0; ks < NP / 16; ++ks) {
            uint32_t ca[4];
            tc::ldsm_x4(ca, at_bc<NP>(Cb, tc::a_rowmajor(wq * 16, ks * 16,
                                                          lane)));
#pragma unroll
            for (int pt = 0; pt < PN; ++pt) {
              tc::mma(ti[pt], ca, hh[ks][pt][0], hh[ks][pt][1]);
              tc::mma(ti[pt], ca, hl[ks][pt][0], hl[ks][pt][1]);
            }
          }
          const float ea = ra < len ? __expf(cum[ra]) : 0.f;
          const float eb = rb < len ? __expf(cum[rb]) : 0.f;
#pragma unroll
          for (int pt = 0; pt < PN; ++pt) {
            y[pt][0] += ea * ti[pt][0];
            y[pt][1] += ea * ti[pt][1];
            y[pt][2] += eb * ti[pt][2];
            y[pt][3] += eb * ti[pt][3];
          }
        }
        __syncwarp();
        if (lane == 0) tc::mbar_arrive(&c_empty[cs]);

        // this warp's 16 rows of y: by TMA from shared memory (clipped at
        // S), except rows that end inside a chunk that is not the last,
        // which the threads store, so that no store reaches the next
        // chunk's rows (those past the chunk are never written here)
        if (w0 < len && (w0 + 16 <= len || c0 + len == p.S)) {
          unsigned char* Yb = Yw + (iy & 1) * G::YW;
          if (lane == 0) tc::tma_wait_read<1>();  // the store 2 tiles ago
          __syncwarp();
#pragma unroll
          for (int pt = 0; pt < PN; ++pt) {
            const uint32_t byte = (pt * 8 + 2 * tig) * 2;
            *reinterpret_cast<__nv_bfloat162*>(Yb + tc::swz(gid, byte, XRB)) =
                __floats2bfloat162_rn(y[pt][0], y[pt][1]);
            *reinterpret_cast<__nv_bfloat162*>(
                Yb + tc::swz(gid + 8, byte, XRB)) =
                __floats2bfloat162_rn(y[pt][2], y[pt][3]);
          }
          tc::fence_async_shared();
          __syncwarp();
          if (lane == 0) {
            tc::tma_store4(&p.y, Yb, p0, h, c0 + w0, b);
            tc::tma_commit();
          }
          ++iy;
        } else if (w0 < len) {
          const long long yss = (long long)p.H * p.Py;
          bf16* Y = p.yp + ((long long)b * p.S + c0) * yss +
                    (long long)h * p.Py;
#pragma unroll
          for (int pt = 0; pt < PN; ++pt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = half ? rb : ra, col = p0 + pt * 8 + 2 * tig;
              if (r < len && col < p.Py)
                *reinterpret_cast<__nv_bfloat162*>(Y + r * yss + col) =
                    __floats2bfloat162_rn(y[pt][2 * half],
                                          y[pt][2 * half + 1]);
            }
        }
      }
    }
    if (lane == 0) tc::tma_wait_all();
  }
}

template <int NP, int PS, int NG>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, float* state, int B, int S, int H, int P,
           int N, int chunk, const long long* st3, cudaStream_t st) {
  using G = Geo<NP, PS, NG>;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once a process
      ssd_tc_fwd<NP, PS, NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::BYTES);
  if (attr != cudaSuccess) return attr;
  // st3: x's (b, s, h), dt's (b, s, h), B's (b, s), C's (b, s) strides
  SsdParams p;
  p.Py = (P + 7) / 8 * 8;
  const cuuint64_t xdim[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t xs[3] = {tc::stride_bytes(st3[2], H),
                            tc::stride_bytes(st3[1], S),
                            tc::stride_bytes(st3[0], B)};
  const cuuint64_t ydim[4] = {(cuuint64_t)p.Py, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t ys[3] = {tc::stride_bytes(p.Py, H),
                            tc::stride_bytes((long long)H * p.Py, S),
                            tc::stride_bytes((long long)S * H * p.Py, B)};
  const cuuint32_t xbox[4] = {G::PS, 1, kR, 1};
  const cuuint32_t ybox[4] = {G::PS, 1, 16, 1};  // one warp's rows
  const cuuint64_t ndim[3] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t bs[2] = {tc::stride_bytes(st3[7], S),
                            tc::stride_bytes(st3[6], B)};
  const cuuint64_t cs[2] = {tc::stride_bytes(st3[9], S),
                            tc::stride_bytes(st3[8], B)};
  const cuuint32_t bbox[3] = {(cuuint32_t)G::W, kR, 1};
  int rc;
  if ((rc = tc::encode_map(&p.x, 4, x, xdim, xs, xbox, G::XRB)) ||
      (rc = tc::encode_map(&p.y, 4, y, ydim, ys, ybox, G::XRB)) ||
      (rc = tc::encode_map(&p.bm, 3, Bm, ndim, bs, bbox, G::RB)) ||
      (rc = tc::encode_map(&p.cm, 3, Cm, ndim, cs, bbox, G::RB)))
    return tc::kMapError + rc;
  p.dt = dt;
  p.A = A;
  p.state = state;
  p.yp = static_cast<bf16*>(y);
  p.S = S;
  p.H = H;
  p.P = P;
  p.N = N;
  p.chunk = chunk;
  p.dsb = st3[3];
  p.dss = st3[4];
  p.dsh = st3[5];
  return tc::launch_pdl(ssd_tc_fwd<NP, PS, NG>,
                        dim3((P + PS - 1) / PS, H, B),
                        dim3(Regs<NG>::WARPGROUPS * kGT),
                        G::BYTES, st, p);
}

// Columns of P a block: 16 where N > 32 (the state slice [PS, N] in
// registers), else 32, or, at N <= 16 (whose smaller tiles leave the shared
// memory for it), 64 when blocks of 32 would outnumber the SMs (B=2 at
// hymba's widths: one wave of 100 blocks, not two of 200)
int ps_for(int np, int B, int H, int P, int sms) {
  if (np > 32) return 16;
  const bool waves = (long long)B * H * ((P + 31) / 32) > sms;
  return np == 16 && waves ? 64 : 32;
}

// Chunk groups of a block: three where N <= 16 and PS = 32 (the blocks are
// fewest, so each needs the most overlap, and the tiles leave the shared
// memory for it), else two
constexpr int ng_for(int np, int ps) {
  return np == 16 && ps == 32 ? 3 : 2;
}

}  // namespace

// x [B,S,H,P], B and C [B,S,N] (bf16, last dim contiguous, every base
// 16-byte aligned and the stride of every other dim of more than one
// element a multiple of 8 elements: TMA, tc::tma_ready, which the
// launcher sees to), dt [B,S,H] and A [H] f32; y
// [B,S,H,round8(P)] bf16 and the state [B,H,P,N] f32, both contiguous.
// `work` is not used (one launch keeps no scratch).
extern "C" int ssd_forward_tc(const void* x, const float* dt, const float* A,
                              const void* Bm, const void* Cm, void* y,
                              float* state, float* work, int B, int S, int H,
                              int P, int N, int chunk, long long xsb,
                              long long xss, long long xsh, long long dsb,
                              long long dss, long long dsh, long long bsb,
                              long long bss, long long csb, long long css,
                              void* stream) {
  (void)work;
  if (B < 1 || H < 1 || S < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      chunk < 1 || chunk > kMaxChunk)
    return cudaErrorInvalidValue;
  const long long nx[3] = {B, S, H}, nb[3] = {B, S, 1};
  if (!tc::tma_ready(x, {xsb, xss, xsh}, nx) ||
      !tc::tma_ready(Bm, {bsb, bss, 0}, nb) ||
      !tc::tma_ready(Cm, {csb, css, 0}, nb) || !tc::tma_ready(y, {0, 0, 0}, nb))
    return cudaErrorMisalignedAddress;
  const long long st3[10] = {xsb, xss, xsh, dsb, dss, dsh, bsb, bss, csb, css};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int np = N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : 128;
  const int ps = ps_for(np, B, H, P, tc::sm_count());
#define SSD_LAUNCH(NP_, PS_)                                          \
  launch<NP_, PS_, ng_for(NP_, PS_)>(x, dt, A, Bm, Cm, y, state, B, S, H, \
                                     P, N, chunk, st3, st)
  switch (np * 1000 + ps) {
    case 16064: return SSD_LAUNCH(16, 64);
    case 16032: return SSD_LAUNCH(16, 32);
    case 32032: return SSD_LAUNCH(32, 32);
    case 64016: return SSD_LAUNCH(64, 16);
    default: return SSD_LAUNCH(128, 16);
  }
#undef SSD_LAUNCH
}
