// Mamba-2 SSD chunk scan on Hopper (sm_90a), f32, in one launch, on the
// tensor cores in three TF32 passes.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` (src/repro/kernels/ssd/
// kernel.py:23, launched by `ssd` at :73) for f32 x, B and C; bf16 goes to
// ssd_tc.cu.  Same function, per chunk of l steps:
//   cum = cumsum(dt * A)
//   y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra)
//       + exp(cum_i) C_i . h_prev                                 (inter)
//   h  <- h exp(cum_end) + sum_j x_j (B_j dt_j exp(cum_end - cum_j))
// where masked entries of the decay matrix are 0, as exp(-1e30) is in the
// reference.  y and the final state are f32.  Any S: the last chunk may be
// partial, and cum_end, the decay-to-end and the state update use its last
// valid row (the reference asserts S % chunk).  P <= 64, N <= 128, chunk
// <= 1024, any of them ragged.
//
// Precision: C.B^T, the scores' product with x, C.h_prev and the state's
// x^T (B o w) run as three TF32 passes of mma.sync.m16n8k8 (tf32.cuh),
// about 22 significant bits a product, accumulated in f32.  One TF32 pass
// misses the f32 tolerance of 1e-4 many times over; three hold it (tests/
// test_torch_ssd.py emulates both on the CPU).  The chunk's cumsum is taken
// in f64 and rounded once: |cum| reaches the hundreds within a chunk, where
// the order of an f32 scan moves exp(cum_i - cum_j) past 1e-4 (mamba2-130m).
//
// What bounds it on the H100: bytes.  Per step the function reads x and
// writes y (8*H*P bytes) and reads B, C and dt; its products are about
// H*(l*(N+P) + 4*P*N) FLOPs a step, ~28 FLOP a byte at hymba's widths (H=50,
// P=64, N=16, l=128), under the ~49 at which three TF32 passes at 165
// TFLOP/s would bind.  What holds it back is latency: a chunk is a chain of
// dependent phases (the cumsum, the state, each tile's loads, the scores,
// y), and hymba's batch 1 gives few blocks.
//
// Design: the single pass of ssd_tc.cu with f32 operands.  Row p of the
// state h [P, N] depends only on column p of x, so one block per (PS
// columns of P, head, batch) runs every chunk of its slice and carries the
// [PS, N] state from chunk to chunk on chip: one launch a call, x read from
// device memory once, y written once, no state in device memory between
// chunks.  PS = 16 where N > 16 (N padded to NP = 32, 64 or 128), else 32,
// or 64 where blocks of 32 would outnumber the SMs (ps_for).
//  - Chunk groups of 4 warps take the chunks in turn: three at NP = 16 with
//    PS = 32, else two (ng_for).  A group first computes its chunk's state
//    contribution x^T (B o w); the state entering the chunk arrives from
//    the group that ran the chunk before through one of two shared-memory
//    slots and an mbarrier (arrivals of the 4 warps), and the state after
//    it goes on the same way, so only that hand-over is serial: the
//    cumsum, the state contribution and the score tiles of neighbouring
//    chunks run at once.  The group keeps its own copy of the entering
//    state for C.h_prev.
//  - Each group loads tiles of 64 rows (C, B: NP + 8 floats a row; x:
//    PS + 4) by cp.async, zero past the chunk and past N and P: all of a
//    chunk's at once, over its cumsum, where they fit the shared memory
//    (every hymba shape), else one tile for each step below (N = 128 at
//    chunk 256); the next chunk's dt is prefetched into registers.  Then
//    the state's x^T (B o w) over every key, its MT x NT output tiles of
//    16 x 8 split over the 4 warps; then y, 16 rows a warp, two 8-key
//    steps at a time: C.B^T, the decay exp(cum_i - cum_j), dt_j and the
//    causal mask on the accumulators (steps above the warp's rows
//    skipped), and (L o C.B^T).x with the scores taken straight from the
//    accumulators as the A operand; at the diagonal tile C.h_prev.
//    Padded rows and two-float reads keep the fragment loads free of bank
//    conflicts, except the state's B reads (two-way).  Views whose rows
//    are not 16-byte aligned (odd P or N) are copied 4 bytes at a time.
#include <math.h>

#include "tc.cuh"
#include "tf32.cuh"

namespace {

constexpr int kR = 64;    // rows of a tile (C, B, x, y)
constexpr int kGT = 128;  // threads of a chunk group
constexpr int kMaxP = 64, kMaxN = 128, kMaxChunk = 1024;
constexpr int kPer = kMaxChunk / kGT;  // dt values a thread prefetches
constexpr int kSmem = 232448;          // shared memory a block may have


// N padded to NP = 16, 32, 64 or 128, PS columns of P a block
template <int NP, int PS>
struct Geo {
  static constexpr int CS = NP + 8;  // floats a row of C, B, h
  static constexpr int XS = PS + 4;  // floats a row of x
  static constexpr int MT = PS / 16, NT = NP / 8;
  static constexpr int TW = MT * NT / 4;  // state tiles a warp
  static constexpr int PN = PS / 8;       // 8-column tiles of y
  static constexpr int KS = NP / 8;       // 8-wide k-steps over N
  // accumulator sets a product's k-steps alternate over, so that its
  // dependent chains of mma are half as long where they are few: the state
  // (HS, a warp's TW tiles), y and C.h_prev (YS, PN tiles) and C.B^T (SS,
  // its two 8-key steps at a time)
  static constexpr int HS = TW < 4 ? 2 : 1;
  static constexpr int YS = PN <= 2 ? 2 : 1;
  static constexpr int SS = KS >= 8 ? 2 : 1;
  static constexpr int TILE_F = kR * CS;  // floats of a C or B tile
  static constexpr int X_F = kR * XS;
  static constexpr int H_F = PS * CS;     // a state slice
  static_assert(MT * NT % 4 == 0, "the state tiles split over 4 warps");
  // floats of one group's part: dt, cum and w of a chunk, `tiles` tiles of
  // each of C, B and x, the entering state and 4 doubles
  __host__ __device__ static int group_floats(int chunk, int tiles) {
    const int ca = (chunk + 3) / 4 * 4;
    return 3 * ca + tiles * (2 * TILE_F + X_F) + H_F + 8;
  }
  static int bytes(int chunk, int ng, int tiles) {  // + 2 mbarriers
    return 4 * (ng * group_floats(chunk, tiles) + 2 * H_F) + 16;
  }
  // tiles of each kind a group holds: all of a chunk's where they fit the
  // shared memory (loaded once a chunk, over its cumsum), else one (loaded
  // as each product needs it)
  static int tiles_for(int chunk, int ng) {
    const int nt = (chunk + kR - 1) / kR;
    return bytes(chunk, ng, nt) <= kSmem ? nt : 1;
  }
};

struct SsdArgs {
  const float* x;   // [B,S,H,P]
  const float* dt;  // [B,S,H]
  const float* A;   // [H]
  const float* Bm;  // [B,S,N]
  const float* Cm;  // [B,S,N]
  float* y;         // [B,S,H,P] contiguous
  float* state;     // [B,H,P,N] contiguous
  int S, H, P, N, chunk;
  long long xsb, xss, xsh;  // strides in elements; last dims contiguous
  long long dsb, dss, dsh;
  long long bsb, bss;
  long long csb, css;
  int vx, vb, vc;  // rows of x, B, C copied 16 bytes at a time
  int tiles;       // tiles of each of C, B and x a group holds
};

// rows [r0, r0 + kR) of a chunk of `len` rows into a tile of `cols` columns
// (of which `valid` exist) and rows of `ld` floats, zero elsewhere; thread
// t of a group
__device__ __forceinline__ void load_tile(float* dst, int ld, int cols,
                                          const float* src, long long rs,
                                          int r0, int len, int valid,
                                          bool vec, int t) {
  if (vec) {
    const int c4 = cols / 4;
    for (int e = t; e < kR * c4; e += kGT) {
      const int r = e / c4, c = (e % c4) * 4;
      const bool in = r0 + r < len && c < valid;
      tf32::cp16(dst + r * ld + c, in ? src + (r0 + r) * rs + c : src, in);
    }
  } else {
    for (int e = t; e < kR * cols; e += kGT) {
      const int r = e / cols, c = e % cols;
      const bool in = r0 + r < len && c < valid;
      tf32::cp4(dst + r * ld + c, in ? src + (r0 + r) * rs + c : src, in);
    }
  }
}

template <int NP, int PS, int NG>
__global__ void __launch_bounds__(NG* kGT, 1) ssd_fwd(const SsdArgs a) {
  using G = Geo<NP, PS>;
  constexpr int CS = G::CS, XS = G::XS, NT = G::NT, TW = G::TW, PN = G::PN;
  constexpr int HS = G::HS, YS = G::YS, SS = G::SS;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int GF = G::group_floats(a.chunk, a.tiles);
  const int ca = (a.chunk + 3) / 4 * 4;
  float* slots = sm + NG * GF;  // two [PS][CS] states handed over
  uint64_t* h_full = reinterpret_cast<uint64_t*>(slots + 2 * G::H_F);

  const int tid = threadIdx.x, g = tid / kGT, t = tid % kGT;
  const int wq = t >> 5, lane = t & 31, gid = lane >> 2, tig = lane & 3;
  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int nc = (a.S + a.chunk - 1) / a.chunk;
  if (tid == 0) {  // hand-over c completes h_full[c & 1] (4 warps arrive)
    tc::mbar_init(&h_full[0], 4);
    tc::mbar_init(&h_full[1], 4);
    tc::mbar_init_fence();
  }
  __syncthreads();

  float* dts = sm + g * GF;
  float* cum = dts + ca;
  float* wts = cum + ca;
  float* Cs = wts + ca;  // a.tiles tiles of each
  float* Bs = Cs + a.tiles * G::TILE_F;
  float* Xs = Bs + a.tiles * G::TILE_F;
  float* Hp = Xs + a.tiles * G::X_F;  // the state entering the group's chunk
  double* wtot = reinterpret_cast<double*>(Hp + G::H_F);
  const int bar = 1 + g;
  const float Ah = a.A[h];
  const float* DT = a.dt + b * a.dsb + h * a.dsh;
  const float* X = a.x + b * a.xsb + h * a.xsh + p0;
  const float* Bm = a.Bm + b * a.bsb;
  const float* Cm = a.Cm + b * a.csb;
  const int pv = min(PS, a.P - p0);  // valid columns of the slice
  float dnext[kPer];  // the group's next chunk's dt, loaded ahead
  auto fetch_dt = [&](int c) {
    const int c0 = c * a.chunk, len = min(a.chunk, a.S - c0);
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      dnext[k] = t + k * kGT < len
                     ? DT[(long long)(c0 + t + k * kGT) * a.dss] : 0.f;
  };
  if (g < nc) fetch_dt(g);

  for (int c = g; c < nc; c += NG) {
    const int c0 = c * a.chunk, len = min(a.chunk, a.S - c0);
    const int nt = (len + kR - 1) / kR;
    const bool res = nt <= a.tiles;  // the chunk's tiles all fit
    const float* Xc = X + c0 * a.xss;
    const float* Bc = Bm + c0 * a.bss;
    const float* Cc = Cm + c0 * a.css;
    tc::bar_sync(bar, kGT);  // the group's last chunk is done with its parts
    if (res) {  // every tile of the chunk, in flight over the cumsum
      for (int k = 0; k < nt; ++k) {
        load_tile(Cs + k * G::TILE_F, CS, NP, Cc, a.css, k * kR, len, a.N,
                  a.vc, t);
        load_tile(Bs + k * G::TILE_F, CS, NP, Bc, a.bss, k * kR, len, a.N,
                  a.vb, t);
        load_tile(Xs + k * G::X_F, XS, PS, Xc, a.xss, k * kR, len, pv, a.vx,
                  t);
      }
      tf32::cp_commit();
    }
    tc::chunk_cumsum<kGT>(dnext, Ah, len, a.chunk, dts, cum, wtot, t, bar);
    if (c + NG < nc) fetch_dt(c + NG);  // while this chunk runs
    const float cum_end = cum[len - 1];
    for (int j = t; j < len; j += kGT) wts[j] = dts[j] * expf(cum_end - cum[j]);

    // ---- the chunk's state contribution x^T (B o w): warp wq owns state
    // tiles wq, wq + 4, ... (16 rows of P x 8 of N); keys 2tig and 2tig+1 of
    // each 8-key step serve as k = tig and tig + 4
    float hc[HS][TW][4] = {};
    for (int jt = 0; jt < nt; ++jt) {
      const float* Bt = Bs + (res ? jt : 0) * G::TILE_F;
      const float* Xt = Xs + (res ? jt : 0) * G::X_F;
      if (!res) {
        load_tile(Bs, CS, NP, Bc, a.bss, jt * kR, len, a.N, a.vb, t);
        load_tile(Xs, XS, PS, Xc, a.xss, jt * kR, len, pv, a.vx, t);
        tf32::cp_commit();
      }
      if (!res || jt == 0) {
        tf32::cp_wait<0>();
        tc::bar_sync(bar, kGT);  // the tiles and w are in
      }
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        const int j = ks * 8 + 2 * tig, jj = jt * kR + j;
        const float w0 = jj < len ? wts[jj] : 0.f;
        const float w1 = jj + 1 < len ? wts[jj + 1] : 0.f;
#pragma unroll
        for (int i = 0; i < TW; ++i) {
          const int mt = (wq + 4 * i) / NT, n8 = (wq + 4 * i) % NT;
          const float* xr = Xt + j * XS + mt * 16 + gid;
          const float* br = Bt + j * CS + n8 * 8 + gid;
          tf32::mma3(hc[ks % HS][i],
                     tf32::A(xr[0], xr[8], xr[XS], xr[XS + 8]),
                     tf32::B(br[0] * w0, br[CS] * w1));
        }
      }
      if (!res) tc::bar_sync(bar, kGT);  // B and x consumed
    }

    // ---- hand-over: the state entering this chunk from the group before
    // (chunk 0: zero) into Hp, and the state after it to the next group or,
    // at the last chunk, to the output
    if (c > 0) tc::mbar_wait(&h_full[(c - 1) & 1], ((c - 1) >> 1) & 1);
    const float* sprev = slots + ((c - 1) & 1) * G::H_F;
    float* snext = slots + (c & 1) * G::H_F;
    const float dec = expf(cum_end);
    float* St = a.state + ((long long)b * a.H + h) * a.P * a.N;
#pragma unroll
    for (int i = 0; i < TW; ++i) {
      const int mt = (wq + 4 * i) / NT, n8 = (wq + 4 * i) % NT;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = mt * 16 + gid + 8 * half, n = n8 * 8 + 2 * tig;
        const float2 hp = c > 0
            ? *reinterpret_cast<const float2*>(sprev + p * CS + n)
            : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(Hp + p * CS + n) = hp;
        float h0 = hc[0][i][2 * half], h1 = hc[0][i][2 * half + 1];
#pragma unroll
        for (int u = 1; u < HS; ++u) {
          h0 += hc[u][i][2 * half];
          h1 += hc[u][i][2 * half + 1];
        }
        const float2 hn = make_float2(hp.x * dec + h0, hp.y * dec + h1);
        if (c + 1 < nc) {
          *reinterpret_cast<float2*>(snext + p * CS + n) = hn;
        } else if (p < pv) {  // the final state, f32
          float* sr = St + (long long)(p0 + p) * a.N;
          if (n < a.N) sr[n] = hn.x;
          if (n + 1 < a.N) sr[n + 1] = hn.y;
        }
      }
    }
    if (c + 1 < nc) {
      __syncwarp();
      if (lane == 0) tc::mbar_arrive(&h_full[c & 1]);
    }
    if (res) tc::bar_sync(bar, kGT);  // Hp is in (else the next load's)

    // ---- y, 64 rows a tile, 16 a warp
    for (int it = 0; it < nt; ++it) {
      const int w0 = it * kR + wq * 16;  // this warp's first row
      const int ra = w0 + gid, rb = ra + 8;
      const bool rows = w0 < len;
      float y[YS][PN][4] = {};
      const float* Ct = Cs + (res ? it : 0) * G::TILE_F;
      for (int jt = 0; jt <= it; ++jt) {
        const float* Bt = Bs + (res ? jt : 0) * G::TILE_F;
        const float* Xt = Xs + (res ? jt : 0) * G::X_F;
        if (!res) {
          if (jt == 0)
            load_tile(Cs, CS, NP, Cc, a.css, it * kR, len, a.N, a.vc, t);
          load_tile(Bs, CS, NP, Bc, a.bss, jt * kR, len, a.N, a.vb, t);
          load_tile(Xs, XS, PS, Xc, a.xss, jt * kR, len, pv, a.vx, t);
          tf32::cp_commit();
          tf32::cp_wait<0>();
          tc::bar_sync(bar, kGT);  // the tiles (and Hp) are in
        }
        const int j0 = jt * kR;
        const float* Ca = Ct + (wq * 16 + gid) * CS + 2 * tig;
        if (rows) {
          // the 8-key steps of this tile that reach the warp's rows (all 8
          // below the diagonal tile), two at a time: C.B^T for the two
          // steps, their decay, then their part of y, so that the loop's
          // body stays small (every group runs the whole chunk's code)
          const int nn = jt < it ? 8 : 2 * wq + 2;
          const float cia = cum[min(ra, len - 1)], cib = cum[min(rb, len - 1)];
#pragma unroll 1
          for (int n8 = 0; n8 < nn; n8 += 2) {
            // C.B^T: state dims 2tig and 2tig+1 of each 8-wide step serve
            // as k = tig and tig + 4 (two-float reads)
            float sc[SS][2][4] = {};
#pragma unroll
            for (int ks = 0; ks < G::KS; ++ks) {
              const float2 c0v = *reinterpret_cast<const float2*>(Ca + ks * 8);
              const float2 c1v =
                  *reinterpret_cast<const float2*>(Ca + 8 * CS + ks * 8);
              const tf32::A ca_(c0v.x, c1v.x, c0v.y, c1v.y);
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const float2 bv = *reinterpret_cast<const float2*>(
                    Bt + ((n8 + u) * 8 + gid) * CS + ks * 8 + 2 * tig);
                tf32::mma3(sc[ks % SS][u], ca_, tf32::B(bv.x, bv.y));
              }
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              // decay exp(cum_i - cum_j) and dt_j; zero above the diagonal
              // and past the end (selected, never multiplied)
              float v[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = e < 2 ? ra : rb;
                const int j = j0 + (n8 + u) * 8 + 2 * tig + (e & 1);
                float x = sc[0][u][e];
#pragma unroll
                for (int w = 1; w < SS; ++w) x += sc[w][u][e];
                v[e] = j <= i && i < len
                           ? x * __expf((e < 2 ? cia : cib) - cum[j]) * dts[j]
                           : 0.f;
              }
              // y += scores . x: keys 2tig and 2tig+1 of the step as k = tig
              // and tig + 4, x rows 2tig and 2tig+1 to match
              const tf32::A sa(v[0], v[2], v[1], v[3]);
              const float* xr = Xt + ((n8 + u) * 8 + 2 * tig) * XS + gid;
#pragma unroll
              for (int pt = 0; pt < PN; ++pt)
                tf32::mma3(y[u % YS][pt], sa,
                           tf32::B(xr[pt * 8], xr[XS + pt * 8]));
            }
          }
          if (jt == it && c > 0) {  // y += exp(cum_i) C_i . h_prev
            float ti[YS][PN][4] = {};
#pragma unroll
            for (int ks = 0; ks < G::KS; ++ks) {
              const float2 c0v = *reinterpret_cast<const float2*>(Ca + ks * 8);
              const float2 c1v =
                  *reinterpret_cast<const float2*>(Ca + 8 * CS + ks * 8);
              const tf32::A ca_(c0v.x, c1v.x, c0v.y, c1v.y);
#pragma unroll
              for (int pt = 0; pt < PN; ++pt) {
                const float2 hv = *reinterpret_cast<const float2*>(
                    Hp + (pt * 8 + gid) * CS + ks * 8 + 2 * tig);
                tf32::mma3(ti[ks % YS][pt], ca_, tf32::B(hv.x, hv.y));
              }
            }
            const float ea = ra < len ? expf(cum[ra]) : 0.f;
            const float eb = rb < len ? expf(cum[rb]) : 0.f;
#pragma unroll
            for (int u = 0; u < YS; ++u)
#pragma unroll
              for (int pt = 0; pt < PN; ++pt) {
                y[u][pt][0] += ea * ti[u][pt][0];
                y[u][pt][1] += ea * ti[u][pt][1];
                y[u][pt][2] += eb * ti[u][pt][2];
                y[u][pt][3] += eb * ti[u][pt][3];
              }
          }
        }
        if (!res) tc::bar_sync(bar, kGT);  // C, B and x consumed
      }
      if (!rows) continue;
      // this warp's 16 rows of y
      const long long yss = (long long)a.H * a.P;
      float* Y =
          a.y + ((long long)b * a.S + c0) * yss + (long long)h * a.P + p0;
#pragma unroll
      for (int pt = 0; pt < PN; ++pt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? rb : ra, col = pt * 8 + 2 * tig;
          if (r >= len) continue;
          float* yr = Y + r * yss + col;
          float v0 = y[0][pt][2 * half], v1 = y[0][pt][2 * half + 1];
#pragma unroll
          for (int u = 1; u < YS; ++u) {
            v0 += y[u][pt][2 * half];
            v1 += y[u][pt][2 * half + 1];
          }
          if (col < pv) yr[0] = v0;
          if (col + 1 < pv) yr[1] = v1;
        }
    }
  }
}

template <int NP, int PS, int NG>
int launch(SsdArgs a, int B, cudaStream_t st) {
  using G = Geo<NP, PS>;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once a process
      ssd_fwd<NP, PS, NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return attr;
  a.tiles = G::tiles_for(a.chunk, NG);
  ssd_fwd<NP, PS, NG><<<dim3((a.P + PS - 1) / PS, a.H, B), NG * kGT,
                        G::bytes(a.chunk, NG, a.tiles), st>>>(a);
  return cudaGetLastError();
}

// Columns of P a block: 16 where N > 16 (whose larger tiles fill the shared
// memory), else 32, or 64 when blocks of 32 would outnumber the SMs (B=2
// at hymba's widths: one wave of 100 blocks, not two of 200)
int ps_for(int np, int B, int H, int P, int sms) {
  if (np > 16) return 16;
  return (long long)B * H * ((P + 31) / 32) > sms ? 64 : 32;
}

// Chunk groups of a block: three where N <= 16 and PS = 32 (the blocks are
// fewest, so each needs the most overlap), else two
constexpr int ng_for(int np, int ps) { return np == 16 && ps == 32 ? 3 : 2; }

}  // namespace

// x [B,S,H,P], dt [B,S,H], A [H], B and C [B,S,N] f32, last dims contiguous,
// any other strides; y [B,S,H,P] and the state [B,H,P,N] f32, contiguous.
extern "C" int ssd_forward(const float* x, const float* dt, const float* A,
                           const float* Bm, const float* Cm, float* y,
                           float* state, int B, int S, int H, int P,
                           int N, int chunk, long long xsb, long long xss,
                           long long xsh, long long dsb, long long dss,
                           long long dsh, long long bsb, long long bss,
                           long long csb, long long css, void* stream) {
  if (B < 1 || H < 1 || S < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      chunk < 1 || chunk > kMaxChunk)
    return cudaErrorInvalidValue;
  const long long nx[3] = {B, S, H}, nb[3] = {B, S, 1};
  SsdArgs a{x,   dt,  A,   Bm,  Cm,  y,   state, S,   H,   P,   N,   chunk,
            xsb, xss, xsh, dsb, dss, dsh, bsb,   bss, csb, css,
            P % 4 == 0 && tc::tma_ready(x, {xsb, xss, xsh}, nx, 4),
            N % 4 == 0 && tc::tma_ready(Bm, {bsb, bss, 0}, nb, 4),
            N % 4 == 0 && tc::tma_ready(Cm, {csb, css, 0}, nb, 4), 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int np = N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : 128;
  const int ps = ps_for(np, B, H, P, tc::sm_count());
#define SSD_LAUNCH(NP_, PS_) launch<NP_, PS_, ng_for(NP_, PS_)>(a, B, st)
  switch (np * 1000 + ps) {
    case 16064: return SSD_LAUNCH(16, 64);
    case 16032: return SSD_LAUNCH(16, 32);
    case 32016: return SSD_LAUNCH(32, 16);
    case 64016: return SSD_LAUNCH(64, 16);
    default: return SSD_LAUNCH(128, 16);
  }
#undef SSD_LAUNCH
}
