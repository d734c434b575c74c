// Mamba-2 SSD chunk scan on Hopper's tensor cores, bf16 (sm_90a).
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
// the tensor cores would bind.  Both grow linearly in S, so the bound
// stays bytes at any S; only a chunk above ~600 would turn it.
//
// Design: the GPU form of the chunked scan (arXiv:2405.21060 section 6),
// three kernels on the caller's stream:
//  1. ssd_tc_state, one block per (chunk, head, batch, 32 columns of the
//     state): the chunk's cumsum, and its state contribution
//     x^T (B o w), w_j = dt_j exp(cum_end - cum_j), in f32 into `hs`;
//     cum_end into `cend`.
//  2. ssd_tc_pass, one thread per state entry: walks the chunks in order,
//     h_c = h_{c-1} exp(cum_end_c) + contrib_c, writes the state entering
//     each chunk as two bf16 terms (below) and the final state in f32.
//     nc <= 2 at hymba's served lengths.
//  3. ssd_tc_scan, one block per (64-row tile of a chunk, head, batch):
//     C.B^T, decay, dt and the causal mask on 64x64 score tiles made in
//     registers, scores.x, then exp(cum_i) C.h_prev^T, and the bf16 store.
//     The [l,l] matrix never exists in memory.
// All three launch with programmatic dependent launch (Hopper): the scan's
// blocks start beside the first two kernels, do the intra-chunk part, and
// wait (griddepcontrol.wait) only before they read the entering state.
// ssd_tc_state waits for the kernel before it to finish before it lets the
// other two launch, so the scan's early reads of x, dt, B and C never race
// the kernel that wrote them.
// Every product is mma.sync.m16n8k16 with f32 accumulators; x, B and C go
// in as they are (bf16).  An f32 value that feeds a product (the decayed
// scores, B o w, the state) is split into two bf16 terms, hi = bf16(v) and
// lo = bf16(v - hi), each multiplied by the same bf16 partner: with one
// bf16 term the error at N=128 reached the whole 5e-2 tolerance.  Tiles
// of 64 rows of x, B and C, and the split states, are staged by 16-byte
// cp.async, double-buffered, with rows padded by 16 bytes for
// conflict-free ldmatrix.  N and P are padded to 16 with zeros inside the
// kernels.  Row tiles of a chunk are issued last-first, the longest first.
// Grid at hymba's S=256 (H=50, N=16, chunk 128): 100 blocks for (1), 200
// for (2), 200 for (3); at mamba2-130m's N=128, (1) has 4 column slices.
// Shared memory at P=64, N=16, chunk 128: 34,816 bytes for (1) and 34,816
// for (3); at N=128, chunk 1024: 41,984 and 113,664.
// Registers (ptxas -v, CUDA 12.8, sm_90a): 64 for ssd_tc_state, 48 for
// ssd_tc_pass, 161 for ssd_tc_scan, no spills; phase 1 of chip_smoke.py
// prints them for each build.
#include <math.h>

#include "tc.cuh"

namespace {

using tc::bf16;

constexpr int kT = 128;  // threads of the chunk kernels: 4 warps
constexpr int kR = 64;   // chunk rows per tile
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kNS = 32;  // state columns per block of ssd_tc_state
constexpr int kPassThreads = 256;

struct SsdArgs {
  const bf16* x;    // [B,S,H,P]
  const float* dt;  // [B,S,H]
  const float* A;   // [H]
  const bf16* Bm;   // [B,S,N]
  const bf16* Cm;   // [B,S,N]
  bf16* y;          // [B,S,H,P] contiguous
  float* state;     // [B,H,P,N] contiguous
  float* hs;    // [B,H,nc,P,N]: chunk contributions
  bf16* h_hi;   // [B,H,nc,P,N]: state entering each chunk, bf16 hi term
  bf16* h_lo;   // [B,H,nc,P,N]: and its lo term
  float* cend;  // [B,H,nc]: cumsum of dt*A at each chunk's last row
  int S, H, P, N, chunk, nc, Pp, Np;  // Pp, Np: P and N rounded up to 16
  long long xsb, xss, xsh;  // strides in elements; last dims contiguous
  long long dsb, dss, dsh;
  long long bsb, bss;
  long long csb, css;
  bool vec;    // x, B, C rows are 16-byte aligned
  bool vec_h;  // so are the rows of h_hi and h_lo
};

// dt of the chunk's rows [0, n) into dts and the inclusive cumsum of dt*A
// into cum.  The sum is taken in f64 and rounded once: |cum| reaches the
// hundreds within a chunk, where the order of an f32 scan moves
// exp(cum_i - cum_j) by ~1e-4.  Each thread sums a run of ceil(chunk/kT)
// rows, then the runs are scanned across the block; the order depends on
// the chunk only, so every kernel that scans a prefix gets the same cum.
__device__ void chunk_cumsum(const SsdArgs& a, const float* DT, float Ah,
                             int c0, int n, float* dts, float* cum) {
  __shared__ double warp_total[kT / 32];
  for (int t = threadIdx.x; t < n; t += kT) dts[t] = DT[(c0 + t) * a.dss];
  __syncthreads();
  const int per = (a.chunk + kT - 1) / kT, t0 = threadIdx.x * per;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double own = 0.0;
  for (int i = 0; i < per && t0 + i < n; ++i) own += (double)(dts[t0 + i] * Ah);
  double v = own;  // inclusive scan of the runs within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) warp_total[warp] = v;
  __syncthreads();
  double run = __shfl_up_sync(0xffffffffu, v, 1);  // the runs before
  if (lane == 0) run = 0.0;
  for (int w = 0; w < warp; ++w) run += warp_total[w];
  for (int i = 0; i < per && t0 + i < n; ++i) {
    run += (double)(dts[t0 + i] * Ah);
    cum[t0 + i] = (float)run;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kT) ssd_tc_state(SsdArgs a) {
  // Wait first: the scan reads x, dt, B and C before its own grid_wait, so
  // the pass and the scan may launch only once the kernel that wrote them
  // has finished.
  tc::grid_wait();
  tc::launch_dependents();
  constexpr int LDS = kNS + tc::kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDP = a.Pp + tc::kPad;
  bf16* Xs = reinterpret_cast<bf16*>(smem_raw);  // [2][kR][LDP]
  bf16* Bs = Xs + 2 * kR * LDP;  // [2][kR][LDS]: B, then hi of B o w
  bf16* Bl = Bs + 2 * kR * LDS;  // [kR][LDS]: lo of B o w
  float* dts = reinterpret_cast<float*>(Bl + kR * LDS);  // dt, then w
  float* cum = dts + a.chunk;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nsl = (a.Np + kNS - 1) / kNS;  // column slices of the state
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z / nsl;
  const int n0 = blockIdx.z % nsl * kNS, ns = min(kNS, a.Np - n0);
  const int c0 = c * a.chunk, len = min(a.chunk, a.S - c0);
  const bf16* X = a.x + b * a.xsb + h * a.xsh + c0 * a.xss;
  const bf16* Bm = a.Bm + b * a.bsb + c0 * a.bss + n0;
  const int ntile = (len + kR - 1) / kR;

  auto load = [&](int t) {
    const int j0 = t * kR, buf = t & 1;
    tc::load_tile<kT>(Xs + buf * kR * LDP, LDP, X + j0 * a.xss, a.xss, kR,
                      len - j0, a.P, a.Pp, a.vec, tid);
    tc::load_tile<kT>(Bs + buf * kR * LDS, LDS, Bm + j0 * a.bss, a.bss, kR,
                      len - j0, a.N - n0, ns, a.vec, tid);
  };
  load(0);
  tc::cp_async_commit();
  chunk_cumsum(a, a.dt + b * a.dsb + h * a.dsh, a.A[h], c0, len, dts, cum);
  const float cum_end = cum[len - 1];
  for (int t = tid; t < len; t += kT) dts[t] *= __expf(cum_end - cum[t]);

  // contrib[p][n] = sum_j x[j][p] (B o w)[j][n]; warp w owns rows 16w.. of P
  const int wp = warp * 16;
  float acc[kNS / 8][4];
#pragma unroll
  for (int n = 0; n < kNS / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int t = 0; t < ntile; ++t) {
    if (t + 1 < ntile) load(t + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    bf16* Bb = Bs + (t & 1) * kR * LDS;
    const bf16* Xb = Xs + (t & 1) * kR * LDP;
    const int j0 = t * kR;
    for (int e = tid; e < kR * (ns / 8); e += kT) {  // 8 columns at a time
      const int r = e / (ns / 8), n = (e - r * (ns / 8)) * 8;
      const float w = j0 + r < len ? dts[j0 + r] : 0.f;
      uint4 raw = *reinterpret_cast<const uint4*>(Bb + r * LDS + n), hi, lo;
      const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint32_t* ho = reinterpret_cast<uint32_t*>(&hi);
      uint32_t* lw = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = __bfloat1622float2(in[i]);
        tc::pack_split(v.x * w, v.y * w, ho[i], lw[i]);
      }
      *reinterpret_cast<uint4*>(Bb + r * LDS + n) = hi;
      *reinterpret_cast<uint4*>(Bl + r * LDS + n) = lo;
    }
    __syncthreads();
    if (wp < a.Pp) {
#pragma unroll
      for (int kk = 0; kk < kR / 16; ++kk) {
        uint32_t xa[4], bh[kNS / 16][4], bl[kNS / 16][4];
        tc::ldsm_x4_t(xa, tc::a_kmajor(Xb, LDP, wp, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < kNS / 16; ++np) {
          if (np * 16 < ns) {
            tc::ldsm_x4_t(bh[np], tc::b_kmajor(Bb, LDS, kk * 16, np * 16, lane));
            tc::ldsm_x4_t(bl[np], tc::b_kmajor(Bl, LDS, kk * 16, np * 16, lane));
          }
        }
#pragma unroll
        for (int np = 0; np < kNS / 16; ++np) {
          if (np * 16 < ns) {
            tc::mma(acc[2 * np], xa, bh[np][0], bh[np][1]);
            tc::mma(acc[2 * np + 1], xa, bh[np][2], bh[np][3]);
            tc::mma(acc[2 * np], xa, bl[np][0], bl[np][1]);
            tc::mma(acc[2 * np + 1], xa, bl[np][2], bl[np][3]);
          }
        }
      }
    }
    __syncthreads();  // buffer t & 1 and Bl are refilled next
  }

  const long long bhc = ((long long)b * a.H + h) * a.nc + c;
  float* Hc = a.hs + bhc * a.P * a.N;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNS / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = wp + gid + (e >> 1) * 8, n = n0 + nt * 8 + 2 * tig + (e & 1);
      if (p < a.P && n < a.N) Hc[p * a.N + n] = acc[nt][e];
    }
  }
  if (tid == 0 && n0 == 0) a.cend[bhc] = cum_end;
}

__global__ void __launch_bounds__(kPassThreads) ssd_tc_pass(SsdArgs a) {
  tc::launch_dependents();
  tc::grid_wait();  // every chunk's contribution is written
  const int PN = a.P * a.N;
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= PN) return;
  const long long bh = (long long)blockIdx.z * a.H + blockIdx.y;
  const float* Hc = a.hs + bh * a.nc * PN + e;
  bf16* hi = a.h_hi + bh * a.nc * PN + e;
  bf16* lo = a.h_lo + bh * a.nc * PN + e;
  const float* ce = a.cend + bh * a.nc;
  // loads of a batch of chunks are issued together, then the chain runs
  constexpr int kBatch = 8;
  float hcur = 0.f;
  for (int c0 = 0; c0 < a.nc; c0 += kBatch) {
    float contrib[kBatch], dec[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool in = c0 + i < a.nc;
      contrib[i] = in ? Hc[(long long)(c0 + i) * PN] : 0.f;
      dec[i] = in ? expf(ce[c0 + i]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 + i < a.nc) {
        const bf16 h = __float2bfloat16_rn(hcur);
        hi[(long long)(c0 + i) * PN] = h;
        lo[(long long)(c0 + i) * PN] =
            __float2bfloat16_rn(hcur - __bfloat162float(h));
        hcur = hcur * dec[i] + contrib[i];
      }
    }
  }
  a.state[bh * PN + e] = hcur;
}

__global__ void __launch_bounds__(kT) ssd_tc_scan(SsdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDP = a.Pp + tc::kPad, LDN = a.Np + tc::kPad;
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);  // [kR][LDN]
  bf16* Bs = Cs + kR * LDN;                      // [2][kR][LDN]
  bf16* Xs = Bs + 2 * kR * LDN;                  // [2][kR][LDP]
  bf16* Hh = Xs + 2 * kR * LDP;                  // [Pp][LDN] state, hi
  bf16* Hl = Hh + a.Pp * LDN;                    // [Pp][LDN] state, lo
  float* dts = reinterpret_cast<float*>(Hl + a.Pp * LDN);
  float* cum = dts + a.chunk;

  tc::launch_dependents();  // the next kernel's blocks may get ready
  const int nrt = (a.chunk + kR - 1) / kR;
  const int c = blockIdx.x / nrt, rt = nrt - 1 - blockIdx.x % nrt;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * a.chunk, len = min(a.chunk, a.S - c0), i0 = rt * kR;
  if (i0 >= len) {  // a row tile past the end of the last chunk
    tc::grid_wait();
    return;
  }
  const int iend = min(i0 + kR, len);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const bf16* X = a.x + b * a.xsb + h * a.xsh + c0 * a.xss;
  const bf16* Bm = a.Bm + b * a.bsb + c0 * a.bss;

  tc::load_tile<kT>(Cs, LDN, a.Cm + b * a.csb + (c0 + i0) * a.css, a.css, kR,
                    iend - i0, a.N, a.Np, a.vec, tid);
  auto load = [&](int t) {
    const int j0 = t * kR, buf = t & 1;
    tc::load_tile<kT>(Bs + buf * kR * LDN, LDN, Bm + j0 * a.bss, a.bss, kR,
                      iend - j0, a.N, a.Np, a.vec, tid);
    tc::load_tile<kT>(Xs + buf * kR * LDP, LDP, X + j0 * a.xss, a.xss, kR,
                      iend - j0, a.P, a.Pp, a.vec, tid);
  };
  load(0);
  tc::cp_async_commit();
  chunk_cumsum(a, a.dt + b * a.dsb + h * a.dsh, a.A[h], c0, iend, dts, cum);

  const int wr = warp * 16;  // this warp's rows of the tile
  const int ra = i0 + wr + gid, rb = ra + 8;  // chunk rows of regs 0-1, 2-3
  float y[kMaxP / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxP / 8; ++n) y[n][0] = y[n][1] = y[n][2] = y[n][3] = 0.f;

  for (int t = 0; t <= rt; ++t) {
    if (t < rt) load(t + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    const bf16* Bb = Bs + (t & 1) * kR * LDN;
    const bf16* Xb = Xs + (t & 1) * kR * LDP;
    const int j0 = t * kR;

    // C.B^T for 16 rows x 64 keys
    float s[kR / 8][4];
#pragma unroll
    for (int j = 0; j < kR / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int ks = 0; ks < a.Np / 16; ++ks) {
      uint32_t ca[4], bb[kR / 16][4];
      tc::ldsm_x4(ca, tc::a_rowmajor(Cs, LDN, wr, ks * 16, lane));
#pragma unroll
      for (int np = 0; np < kR / 16; ++np)
        tc::ldsm_x4(bb[np], tc::b_nmajor(Bb, LDN, ks * 16, np * 16, lane));
#pragma unroll
      for (int np = 0; np < kR / 16; ++np) {
        tc::mma(s[2 * np], ca, bb[np][0], bb[np][1]);
        tc::mma(s[2 * np + 1], ca, bb[np][2], bb[np][3]);
      }
    }
    // decay exp(cum_i - cum_j) and dt_j; zero above the diagonal and past
    // the end (masked before the exp, which would overflow there)
#pragma unroll
    for (int j = 0; j < kR / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? ra : rb, jj = j0 + j * 8 + 2 * tig + (e & 1);
        float v = 0.f;
        if (jj <= i && i < iend)
          v = s[j][e] * __expf(cum[i] - cum[jj]) * dts[jj];
        s[j][e] = v;
      }
    }
    // y += scores . x, the scores as two bf16 terms
#pragma unroll
    for (int kk = 0; kk < kR / 16; ++kk) {
      uint32_t ah[4], al[4];
      tc::pack_split(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      tc::pack_split(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      tc::pack_split(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      tc::pack_split(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
      uint32_t xb[kMaxP / 16][4];
#pragma unroll
      for (int np = 0; np < kMaxP / 16; ++np)
        if (np * 16 < a.Pp)
          tc::ldsm_x4_t(xb[np], tc::b_kmajor(Xb, LDP, kk * 16, np * 16, lane));
#pragma unroll
      for (int np = 0; np < kMaxP / 16; ++np) {
        if (np * 16 < a.Pp) {
          tc::mma(y[2 * np], ah, xb[np][0], xb[np][1]);
          tc::mma(y[2 * np + 1], ah, xb[np][2], xb[np][3]);
          tc::mma(y[2 * np], al, xb[np][0], xb[np][1]);
          tc::mma(y[2 * np + 1], al, xb[np][2], xb[np][3]);
        }
      }
    }
    __syncthreads();  // buffer t & 1 is refilled at t + 2
  }
  tc::cp_async_wait<0>();

  // Up to here the block only read the inputs, so it may have run beside
  // ssd_tc_state and ssd_tc_pass; the entering state needs both done.
  tc::grid_wait();
  const bool inter = c > 0;  // the state entering chunk 0 is zero
  if (inter) {  // y += exp(cum_i) C_i . h_prev
    const long long off = (((long long)b * a.H + h) * a.nc + c) * a.P * a.N;
    tc::load_tile<kT>(Hh, LDN, a.h_hi + off, a.N, a.Pp, a.P, a.N, a.Np,
                      a.vec_h, tid);
    tc::load_tile<kT>(Hl, LDN, a.h_lo + off, a.N, a.Pp, a.P, a.N, a.Np,
                      a.vec_h, tid);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    float ti[kMaxP / 8][4];
#pragma unroll
    for (int n = 0; n < kMaxP / 8; ++n)
      ti[n][0] = ti[n][1] = ti[n][2] = ti[n][3] = 0.f;
    for (int ks = 0; ks < a.Np / 16; ++ks) {
      uint32_t ca[4];
      tc::ldsm_x4(ca, tc::a_rowmajor(Cs, LDN, wr, ks * 16, lane));
#pragma unroll
      for (int np = 0; np < kMaxP / 16; ++np) {
        if (np * 16 < a.Pp) {
          uint32_t hb[4], hl[4];
          tc::ldsm_x4(hb, tc::b_nmajor(Hh, LDN, ks * 16, np * 16, lane));
          tc::ldsm_x4(hl, tc::b_nmajor(Hl, LDN, ks * 16, np * 16, lane));
          tc::mma(ti[2 * np], ca, hb[0], hb[1]);
          tc::mma(ti[2 * np + 1], ca, hb[2], hb[3]);
          tc::mma(ti[2 * np], ca, hl[0], hl[1]);
          tc::mma(ti[2 * np + 1], ca, hl[2], hl[3]);
        }
      }
    }
    const float ea = ra < iend ? __expf(cum[ra]) : 0.f;
    const float eb = rb < iend ? __expf(cum[rb]) : 0.f;
#pragma unroll
    for (int n = 0; n < kMaxP / 8; ++n) {
      y[n][0] += ea * ti[n][0];
      y[n][1] += ea * ti[n][1];
      y[n][2] += eb * ti[n][2];
      y[n][3] += eb * ti[n][3];
    }
  }

  const long long yss = (long long)a.H * a.P;
  bf16* Y = a.y + ((long long)b * a.S + c0) * yss + (long long)h * a.P;
#pragma unroll
  for (int n = 0; n < kMaxP / 8; ++n) {
    const int p = n * 8 + 2 * tig;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rb : ra;
      if (r >= iend || p >= a.P) continue;
      bf16* dst = Y + r * yss + p;
      const float v0 = y[n][2 * half], v1 = y[n][2 * half + 1];
      if (p + 1 < a.P && (a.P & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      } else {
        dst[0] = __float2bfloat16_rn(v0);
        if (p + 1 < a.P) dst[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

int round16(int v) { return (v + 15) / 16 * 16; }

size_t state_smem(int chunk, int Pp) {  // under 48 KB for every shape
  return sizeof(bf16) * (2 * kR * (Pp + tc::kPad) + 3 * kR * (kNS + tc::kPad)) +
         sizeof(float) * 2 * chunk;
}

size_t scan_smem(int chunk, int Pp, int Np) {
  return sizeof(bf16) * (3 * kR * (Np + tc::kPad) + 2 * kR * (Pp + tc::kPad) +
                         2 * Pp * (Np + tc::kPad)) +
         sizeof(float) * 2 * chunk;
}


}  // namespace

// work: B*H*nc*(2*P*N + 1) floats of scratch, nc = ceil(S / chunk)
extern "C" int ssd_forward_tc(const void* x, const float* dt, const float* A,
                              const void* Bm, const void* Cm, void* y,
                              float* state, float* work, int B, int S, int H,
                              int P, int N, int chunk, long long xsb,
                              long long xss, long long xsh, long long dsb,
                              long long dss, long long dsh, long long bsb,
                              long long bss, long long csb, long long css,
                              void* stream) {
  if (B < 1 || H < 1 || S < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      chunk < 1 || chunk > 1024)
    return cudaErrorInvalidValue;
  const int nc = (S + chunk - 1) / chunk;
  const bool vec = tc::aligned16(x, xsb, xss, xsh) &&
                   tc::aligned16(Bm, bsb, bss, 0) &&
                   tc::aligned16(Cm, csb, css, 0);
  // contributions (f32), the split entering states (2 x bf16), cend
  const long long X = (long long)B * H * nc * P * N;
  bf16* h_hi = reinterpret_cast<bf16*>(work + X);
  SsdArgs a{static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
            static_cast<const bf16*>(Cm), static_cast<bf16*>(y), state, work,
            h_hi, h_hi + X, work + 2 * X, S, H, P, N, chunk, nc,
            round16(P), round16(N), xsb, xss, xsh, dsb, dss, dsh, bsb, bss,
            csb, css, vec, N % 8 == 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static const cudaError_t attr = cudaFuncSetAttribute(  // once a process
      ssd_tc_scan, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)scan_smem(1024, kMaxP, kMaxN));
  if (attr != cudaSuccess) return attr;
  const size_t sm1 = state_smem(chunk, a.Pp);
  const size_t sm3 = scan_smem(chunk, a.Pp, a.Np);
  cudaError_t err;

  // Every kernel launches early (programmatic dependent launch): the
  // scan's intra-chunk work overlaps the two kernels before it, and each
  // kernel's blocks are placed while the kernel before drains.
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  const int nsl = (a.Np + kNS - 1) / kNS;
  cfg.gridDim = dim3(nc, H, B * nsl);
  cfg.blockDim = dim3(kT);
  cfg.dynamicSmemBytes = sm1;
  if ((err = cudaLaunchKernelEx(&cfg, ssd_tc_state, a)) != cudaSuccess)
    return err;
  cfg.gridDim = dim3((P * N + kPassThreads - 1) / kPassThreads, H, B);
  cfg.blockDim = dim3(kPassThreads);
  cfg.dynamicSmemBytes = 0;
  if ((err = cudaLaunchKernelEx(&cfg, ssd_tc_pass, a)) != cudaSuccess)
    return err;
  const int nrt = (chunk + kR - 1) / kR;
  cfg.gridDim = dim3(nc * nrt, H, B);
  cfg.blockDim = dim3(kT);
  cfg.dynamicSmemBytes = sm3;
  if ((err = cudaLaunchKernelEx(&cfg, ssd_tc_scan, a)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}
