// Building blocks of the port's tensor-core kernels for bf16 (sm_90a); the
// f32 kernels (tf32.cuh) share its barriers, mbarriers, exp2, the SSD cumsum
// and the 16-byte rule.
//
// Hopper's data movement: tensor maps built on the host
// (cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point, so nothing links against libcuda), TMA tile loads and stores
// (cp.async.bulk.tensor) and the mbarriers that report a load's bytes.
// The warp-level product mma.sync.m16n8k16 with its ldmatrix fragment
// loads, for ssd_tc.cu's 16-row tiles (the warpgroup product wgmma is in
// wgmma.cuh), f32 accumulators.
//
// Shared tiles are written by TMA with its 32-, 64- or 128-byte swizzle:
// a tile of rows of RB = 32, 64 or 128 bytes, 1024-byte aligned, holds
// byte b of row r at swz(r, b, RB).  wgmma's descriptors name the same
// layouts; ldmatrix lane addresses and epilogue stores apply swz().
//
// Fragment layout of mma.sync m16n8k16 (lane = 4 * gid + tig), which is
// also a wgmma warp's 16 rows of A in registers and of its accumulator:
//   A 16x16 row-major, 4 regs of 2 bf16: (gid, 2tig..+1), (gid+8, 2tig..),
//     (gid, 2tig+8..), (gid+8, 2tig+8..);
//   B 16x8, 2 regs: (k 2tig..+1, n gid), (k 2tig+8..+9, n gid);
//   C/D 16x8 f32, 4 floats: (gid, 2tig), (gid, 2tig+1), (gid+8, 2tig),
//     (gid+8, 2tig+1).
// ldmatrix.x4 lane patterns (row, column of the 8-element piece a lane
// addresses) for one A tile, or two 8-wide B tiles:
//   a_rowmajor   A[m][k] stored as rows m            (ldmatrix)
//   a_kmajor     A[m][k] stored as rows k            (ldmatrix.trans)
//   b_kmajor     B[k][n] stored as rows k, n inner   (ldmatrix.trans)
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- host
// A tensor map for bf16 data of `rank` dims (innermost first; strides in
// bytes for dims 1..rank-1), a box of `box` elements, zero fill outside
// the tensor.  Returns 0 or the driver's CUresult.
inline int encode_map(CUtensorMap* map, int rank, const void* base,
                      const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box, int swizzle_bytes) {
  using Fn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                          void*, const cuuint64_t*, const cuuint64_t*,
                          const cuuint32_t*, const cuuint32_t*,
                          CUtensorMapInterleave, CUtensorMapSwizzle,
                          CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static const Fn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<Fn>(p);
  }();
  if (!fn) return CUDA_ERROR_NOT_FOUND;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUtensorMapSwizzle swz =
      swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : swizzle_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                            : CU_TENSOR_MAP_SWIZZLE_NONE;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// what the C entry points return when a tensor map cannot be made
constexpr int kMapError = 10000;  // + the CUresult

// The byte stride of a bf16 dim of `n` elements for a tensor map: a dim
// of size 1 is never stepped, so any multiple of 16 bytes serves.
inline cuuint64_t stride_bytes(long long s, long long n) {
  return n == 1 ? 16 : (cuuint64_t)s * 2;
}

// Whether TMA reads a bf16 tensor in place: a 16-byte aligned base and,
// for each outer dim of more than one element, a stride of whole 16 bytes
// (kernels/_tma.py's `ready` applies the same rule).  s[i], n[i]: stride
// in elements and size of outer dim i; `per` elements make 16 bytes (4 for
// the f32 kernels' 16-byte cp.async copies, which follow the same rule).
inline bool tma_ready(const void* p, const long long (&s)[3],
                      const long long (&n)[3], int per = 8) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (n[i] > 1 && s[i] % per) return false;
  return true;
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// Launch on `st` with programmatic dependent launch: the blocks are placed
// while the kernel before drains, and wait for it in grid_wait().
template <typename Kernel, typename Params>
cudaError_t launch_pdl(Kernel kernel, dim3 grid, dim3 block, int smem,
                       cudaStream_t st, const Params& p) {
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// -------------------------------------------------------------- device
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Programmatic dependent launch (sm_90): a kernel launched with the
// programmatic-serialization attribute may start while the kernel before
// it runs; it must call grid_wait() before it reads what that kernel wrote
// or writes what it reads, and the kernel before lets it start early with
// launch_dependents().
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// barrier `id` (1..15) for the `n` threads of one group of warps: wait
// for all n, or arrive without waiting
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// mbarriers in shared memory: a phase completes when `count` threads have
// arrived and every byte announced by expect_tx has landed
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2, %3;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity), "r"(0x989680)
      : "memory");
  return ok != 0;
}
// Wait for the completion of the phase of parity `parity` (the k-th
// completion, k = 1, 2, ..., has parity (k - 1) & 1).  A wait of more
// than 2^34 cycles (~9 s) is a broken pipeline, not a slow one: the
// kernel traps, and its launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// SSD (ssd_tc.cu, ssd.cu): the chunk's dt (from `dnext`, prefetched) into
// dts and the inclusive cumsum of dt*A into cum, by one group of kGT
// threads (thread t, barrier `bar`; wtot: a double a warp).  The sum is
// taken in f64 and rounded once: |cum| reaches the hundreds within a chunk,
// where the order of an f32 scan moves exp(cum_i - cum_j) by ~1e-4.  Each
// thread sums a run of ceil(chunk/kGT) rows, then the runs are scanned
// across the warps.
template <int kGT, int kPer>
__device__ __forceinline__ void chunk_cumsum(const float (&dnext)[kPer],
                                             float Ah, int n, int chunk,
                                             float* dts, float* cum,
                                             double* wtot, int t, int bar) {
  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (t + k * kGT < n) dts[t + k * kGT] = dnext[k];
  tc::bar_sync(bar, kGT);
  const int per = (chunk + kGT - 1) / kGT, t0 = t * per;
  double own = 0.0;
  for (int i = 0; i < per && t0 + i < n; ++i)
    own += (double)(dts[t0 + i] * Ah);
  double v = own;  // inclusive scan of the runs within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) wtot[warp] = v;
  tc::bar_sync(bar, kGT);
  double run = __shfl_up_sync(0xffffffffu, v, 1);  // the runs before
  if (lane == 0) run = 0.0;
  for (int w = 0; w < warp; ++w) run += wtot[w];
  for (int i = 0; i < per && t0 + i < n; ++i) {
    run += (double)(dts[t0 + i] * Ah);
    cum[t0 + i] = (float)run;
  }
  tc::bar_sync(bar, kGT);
}

// shared-memory writes by threads, made visible to TMA and wgmma
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA: a box of the tensor at the given coordinates (innermost first)
// into shared memory; the bytes are reported to `bar`
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// TMA store of a box from shared memory; what falls outside the tensor is
// not written.  Commit, then wait before the buffer is reused.
__device__ __forceinline__ void tma_store4(const CUtensorMap* map,
                                           const void* src, int c0, int c1,
                                           int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>  // at most N stores still reading shared memory
__device__ __forceinline__ void tma_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void tma_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Byte offset of byte b of row r in a TMA-swizzled tile of RB-byte rows
// (RB = 32, 64, 128): the 16-byte piece index is XORed with bits 7.. of
// the offset, as CU_TENSOR_MAP_SWIZZLE_{RB}B lays it out.
__device__ __forceinline__ uint32_t swz(uint32_t r, uint32_t b, uint32_t rb) {
  const uint32_t a = r * rb + b;
  return a ^ ((a >> 3) & (rb - 16));
}

// ldmatrix reads shared memory: volatile and a memory clobber keep it
// between the waits that publish and the arrivals that recycle a tile.
// The mma below is a pure function of registers.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a * b  (16x8x16, bf16 operands, f32 accumulators)
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (the softmax's exp, in the log2 domain)
__device__ __forceinline__ float exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (row, column) a lane addresses for ldmatrix.x4 of the 16x16 tile whose
// first indices are (m0, k0) for A and (k0, n0) for B (table above)
struct RC {
  int r, c;
};
__device__ __forceinline__ RC a_rowmajor(int m0, int k0, int lane) {
  return {m0 + (lane & 15), k0 + (lane >> 4) * 8};
}
__device__ __forceinline__ RC a_kmajor(int m0, int k0, int lane) {
  return {k0 + (lane & 7) + (lane >> 4) * 8, m0 + ((lane >> 3) & 1) * 8};
}
// B tiles n0..n0+7 -> regs 0,1 and n0+8..n0+15 -> regs 2,3
__device__ __forceinline__ RC b_kmajor(int k0, int n0, int lane) {
  return {k0 + (lane & 7) + ((lane >> 3) & 1) * 8, n0 + (lane >> 4) * 8};
}

// two floats -> one register of two bf16, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// v = hi + lo with hi = bf16(v), lo = bf16(v - hi): about 16 significant
// bits in two bf16 operands, for an f32 value that feeds a product
__device__ __forceinline__ void pack_split(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const bf16 ha = __float2bfloat16_rn(a), hb = __float2bfloat16_rn(b);
  __nv_bfloat162 h, l;
  h.x = ha;
  h.y = hb;
  l = __floats2bfloat162_rn(a - __bfloat162float(ha),
                            b - __bfloat162float(hb));
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

}  // namespace tc
