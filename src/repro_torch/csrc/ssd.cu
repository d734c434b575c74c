// Mamba-2 SSD chunk-scan forward for Hopper (sm_90a), f32.
//
// Replaces the Pallas TPU kernel `_ssd_kernel` (src/repro/kernels/ssd/
// kernel.py:23, launched by `ssd` at :73) for f32 inputs, which need the
// f32 tolerance of 1e-4 that no tensor-core format holds; bf16 goes to
// ssd_tc.cu.  Same function, chunk by chunk with the state h [P,N] in f32
// carried across chunks:
//   cum = cumsum(dt * A)
//   y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j      (intra)
//       + exp(cum_i) C_i . h                                      (inter)
//   h  <- h exp(cum_end) + sum_j x_j (B_j dt_j exp(cum_end - cum_j))
// where masked entries of the decay matrix are 0, as exp(-1e30) is in the
// reference.  y and the final state are f32.  Any S: the last chunk may
// be partial, and cum_end, the decay-to-end and the state update use its
// last valid row (the reference asserts S % chunk).
//
// What bounds it on the H100: per (b, h) the work is about l*l*(N+P) +
// 2*l*P*N FMAs per chunk of l steps on ~l*(P+2N) input elements, roughly
// 60-100 FLOP per byte at hymba's shapes: below the 295 FLOP/byte ridge, so
// the bound is memory, but only B*H blocks (50 at hymba's batch 1) can run,
// so this version is limited by parallelism and CUDA-core FMA latency, not
// by either roof.  What the design does about it: one block per (b, h)
// walks the chunks in order with h in shared memory (4 KB at P=64, N=16;
// 32 KB at N=128), so the state never goes back to device memory between
// chunks.  The [l,l] decay matrix is never materialised: each 32x32 tile
// of decay-masked scores is computed on the fly, used, and dropped, so the
// shared memory stays under 90 KB for any chunk up to 1024 and N <= 128.
// Tiles of the causal upper triangle are skipped.
#include <math.h>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 32;     // rows per sub-tile of a chunk
constexpr int kMaxP = 64;  // largest head dim P
constexpr int kMaxN = 128;  // largest state size N
constexpr int kMaxY = kR * kMaxP / kThreads;   // y outputs per thread
constexpr int kMaxH = kMaxP * kMaxN / kThreads;  // state entries per thread

struct SsdArgs {
  const float* x;   // [B,S,H,P]
  const float* dt;  // [B,S,H]
  const float* A;   // [H]
  const float* Bm;  // [B,S,N]
  const float* Cm;  // [B,S,N]
  float* y;         // [B,S,H,P] contiguous
  float* state;    // [B,H,P,N] contiguous
  int S, H, P, N, chunk;
  long long xsb, xss, xsh;  // strides in elements; last dims contiguous
  long long dsb, dss, dsh;
  long long bsb, bss;
  long long csb, css;
};

__global__ void __launch_bounds__(kThreads) ssd_fwd(SsdArgs a) {
  extern __shared__ float smem[];
  const int P = a.P, N = a.N, NS = N + 1, chunk = a.chunk;
  float* cum = smem;              // [chunk]
  float* dts = cum + chunk;       // [chunk]
  float* sC = dts + chunk;        // [kR][NS]
  float* sB = sC + kR * NS;       // [kR][NS]
  float* sX = sB + kR * NS;       // [kR][P]
  float* sS = sX + kR * P;        // [kR][kR + 1] decay-masked scores
  float* sW = sS + kR * (kR + 1);  // [kR] weights to the chunk end
  float* sh = sW + kR;            // [P][NS] state

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const float* X = a.x + b * a.xsb + h * a.xsh;
  const float* DT = a.dt + b * a.dsb + h * a.dsh;
  const float* Bm = a.Bm + b * a.bsb;
  const float* Cm = a.Cm + b * a.csb;
  float* Y = a.y + (long long)b * a.S * a.H * P + (long long)h * P;
  const long long yss = (long long)a.H * P;
  const float Ah = a.A[h];
  const int nY = (kR * P + kThreads - 1) / kThreads;
  const int nH = (P * N + kThreads - 1) / kThreads;

  for (int e = tid; e < P * NS; e += kThreads) sh[e] = 0.f;

  // rows [j0, j0 + kR) of the chunk at c0 into sB / sX (zero past len)
  auto load_bx = [&](int c0, int j0, int len) {
    for (int e = tid; e < kR * N; e += kThreads) {
      const int j = e / N, n = e % N;
      sB[j * NS + n] =
          j0 + j < len ? Bm[(c0 + j0 + j) * a.bss + n] : 0.f;
    }
    for (int e = tid; e < kR * P; e += kThreads) {
      const int j = e / P, p = e % P;
      sX[j * P + p] =
          j0 + j < len ? X[(c0 + j0 + j) * a.xss + p] : 0.f;
    }
  };

  for (int c0 = 0; c0 < a.S; c0 += chunk) {
    const int len = min(chunk, a.S - c0);
    __syncthreads();  // previous chunk done with cum, dts and sh
    for (int t = tid; t < len; t += kThreads) dts[t] = DT[(c0 + t) * a.dss];
    __syncthreads();
    if (warp == 0) {  // inclusive scan of dt * A, accumulated in f64
      double carry = 0.0;
      for (int base = 0; base < len; base += 32) {
        const int t = base + lane;
        double v = t < len ? (double)(dts[t] * Ah) : 0.0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        if (t < len) cum[t] = (float)v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cum_end = cum[len - 1];

    // ---- outputs, 32 rows at a time ----
    for (int i0 = 0; i0 < len; i0 += kR) {
      __syncthreads();  // sC free
      for (int e = tid; e < kR * N; e += kThreads) {
        const int i = e / N, n = e % N;
        sC[i * NS + n] =
            i0 + i < len ? Cm[(c0 + i0 + i) * a.css + n] : 0.f;
      }
      float yacc[kMaxY];
#pragma unroll
      for (int q = 0; q < kMaxY; ++q) yacc[q] = 0.f;

      for (int j0 = 0; j0 <= i0; j0 += kR) {  // causal: tiles j0 <= i0
        __syncthreads();  // sB, sX, sS free; sC visible
        load_bx(c0, j0, len);
        __syncthreads();
        for (int e = tid; e < kR * kR; e += kThreads) {
          const int i = e / kR, j = e % kR, ii = i0 + i, jj = j0 + j;
          float v = 0.f;
          if (ii < len && jj < len && ii >= jj) {
            float cb = 0.f;
            for (int n = 0; n < N; ++n) cb = fmaf(sC[i * NS + n], sB[j * NS + n], cb);
            v = cb * expf(cum[ii] - cum[jj]) * dts[jj];
          }
          sS[i * (kR + 1) + j] = v;
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kMaxY; ++q) {
          const int e = tid + q * kThreads;
          if (q < nY && e < kR * P) {
            const int i = e / P, p = e % P;
            float acc = yacc[q];
#pragma unroll 8
            for (int j = 0; j < kR; ++j)
              acc = fmaf(sS[i * (kR + 1) + j], sX[j * P + p], acc);
            yacc[q] = acc;
          }
        }
      }
      // inter-chunk term from the state entering this chunk, then store
#pragma unroll
      for (int q = 0; q < kMaxY; ++q) {
        const int e = tid + q * kThreads;
        if (q < nY && e < kR * P) {
          const int i = e / P, p = e % P;
          if (i0 + i < len) {
            float dot = 0.f;
            for (int n = 0; n < N; ++n) dot = fmaf(sC[i * NS + n], sh[p * NS + n], dot);
            const float yv = yacc[q] + expf(cum[i0 + i]) * dot;
            Y[(c0 + i0 + i) * yss + p] = yv;
          }
        }
      }
    }

    // ---- state update to the chunk end ----
    float hacc[kMaxH];
#pragma unroll
    for (int q = 0; q < kMaxH; ++q) hacc[q] = 0.f;
    for (int j0 = 0; j0 < len; j0 += kR) {
      __syncthreads();  // sB, sX, sW free
      load_bx(c0, j0, len);
      if (tid < kR)
        sW[tid] = j0 + tid < len
                      ? dts[j0 + tid] * expf(cum_end - cum[j0 + tid]) : 0.f;
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kMaxH; ++q) {
        const int e = tid + q * kThreads;
        if (q < nH && e < P * N) {
          const int p = e / N, n = e % N;
          float acc = hacc[q];
#pragma unroll 8
          for (int j = 0; j < kR; ++j)
            acc = fmaf(sX[j * P + p], sB[j * NS + n] * sW[j], acc);
          hacc[q] = acc;
        }
      }
    }
    __syncthreads();  // every inter term has read the old state
    const float dec_end = expf(cum_end);
#pragma unroll
    for (int q = 0; q < kMaxH; ++q) {
      const int e = tid + q * kThreads;
      if (q < nH && e < P * N) {
        const int p = e / N, n = e % N;
        sh[p * NS + n] = sh[p * NS + n] * dec_end + hacc[q];
      }
    }
  }

  __syncthreads();
  float* St = a.state + ((long long)b * a.H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) St[e] = sh[(e / N) * NS + e % N];
}

size_t smem_bytes(int chunk, int P, int N) {
  const int NS = N + 1;
  return sizeof(float) * (2 * chunk + 2 * kR * NS + kR * P + kR * (kR + 1) +
                          kR + P * NS);
}

cudaError_t launch(const SsdArgs& a, int B, cudaStream_t st) {
  const size_t smem = smem_bytes(a.chunk, a.P, a.N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_fwd<<<dim3(a.H, B), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssd_forward(const float* x, const float* dt, const float* A,
                           const float* Bm, const float* Cm, float* y,
                           float* state, int B, int S, int H, int P,
                           int N, int chunk, long long xsb, long long xss,
                           long long xsh, long long dsb, long long dss,
                           long long dsh, long long bsb, long long bss,
                           long long csb, long long css, void* stream) {
  if (P > kMaxP || N > kMaxN || chunk < 1 || chunk > 1024 || S < 1)
    return cudaErrorInvalidValue;
  SsdArgs a{x,   dt,  A,   Bm,  Cm,  y,   state, S,   H,   P,   N,   chunk,
            xsb, xss, xsh, dsb, dss, dsh, bsb,   bss, csb, css};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch(a, B, st);
}
