// Building blocks of the port's tensor-core kernels for bf16 (sm_90a):
// 16-byte asynchronous copies into shared memory (cp.async), fragment
// loads from shared memory (ldmatrix) and the warp-level bf16 product
// mma.sync.m16n8k16 with f32 accumulators.
//
// Fragment layout of m16n8k16 (lane = 4 * gid + tig):
//   A 16x16 row-major, 4 regs of 2 bf16: (gid, 2tig..+1), (gid+8, 2tig..),
//     (gid, 2tig+8..), (gid+8, 2tig+8..);
//   B 16x8, 2 regs: (k 2tig..+1, n gid), (k 2tig+8..+9, n gid);
//   C/D 16x8 f32, 4 floats: (gid, 2tig), (gid, 2tig+1), (gid+8, 2tig),
//     (gid+8, 2tig+1).
// The lane addresses below load one A tile, or two 8-wide B tiles, with a
// single ldmatrix.x4 from a row-major shared tile of `ld` elements a row:
//   a_rowmajor   A[m][k] stored as rows m            (ldmatrix)
//   a_kmajor     A[m][k] stored as rows k            (ldmatrix.trans)
//   b_nmajor     B[k][n] stored as rows n, k inner   (ldmatrix)
//   b_kmajor     B[k][n] stored as rows k, n inner   (ldmatrix.trans)
// Shared tiles are padded by 8 elements a row, so the 8 rows an ldmatrix
// phase reads start in 8 different 16-byte bank groups.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // elements of padding at the end of a shared row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch (sm_90): a kernel launched with the
// programmatic-serialization attribute may start while the kernel before
// it runs; it must call grid_wait() before it reads what that kernel wrote
// (and before it exits, so that the stream's order still holds), and the
// kernel before lets it start early with launch_dependents().
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// barrier `id` (1..15) for the `n` threads of one group of warps
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ldmatrix reads shared memory: volatile and a memory clobber keep it
// between the barriers that publish and recycle a tile.  The mma below is
// a pure function of registers, so the compiler may schedule it freely.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
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

// Lane addresses for ldmatrix.x4 of the 16x16 tile whose first indices
// are (m0, k0) for A and (k0, n0) for B, in a shared tile with `ld`
// elements a row (see the table above).
__device__ __forceinline__ const bf16* a_rowmajor(const bf16* s, int ld,
                                                  int m0, int k0, int lane) {
  return s + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8;
}
__device__ __forceinline__ const bf16* a_kmajor(const bf16* s, int ld,
                                                int m0, int k0, int lane) {
  return s + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + m0 +
         ((lane >> 3) & 1) * 8;
}
// B tiles n0..n0+7 -> regs 0,1 and n0+8..n0+15 -> regs 2,3
__device__ __forceinline__ const bf16* b_nmajor(const bf16* s, int ld,
                                                int k0, int n0, int lane) {
  return s + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
         ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ const bf16* b_kmajor(const bf16* s, int ld,
                                                int k0, int n0, int lane) {
  return s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
         (lane >> 4) * 8;
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

// Stage rows x cpad bf16 into shared (row stride ld) from global (row
// stride gs elements, unit column stride).  Rows >= nrows and columns >=
// ncols are zero.  Whole 16-byte pieces go by cp.async when `vec` says the
// rows are 16-byte aligned; a ragged or unaligned piece by plain loads.
// cpad is a multiple of 8.  THREADS threads, numbered tid, share the work;
// the caller commits and waits.
template <int THREADS>
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          long long gs, int rows, int nrows,
                                          int ncols, int cpad, bool vec,
                                          int tid) {
  const int per_row = cpad / 8;
  for (int e = tid; e < rows * per_row; e += THREADS) {
    const int r = e / per_row, c = (e - r * per_row) * 8;
    bf16* d = dst + r * ld + c;
    if (r >= nrows || c >= ncols) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const bf16* s = src + r * gs + c;
    if (vec && c + 8 <= ncols) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        d[i] = c + i < ncols ? s[i] : __float2bfloat16_rn(0.f);
    }
  }
}

// 16-byte aligned base and strides that keep every row 16-byte aligned
__host__ __forceinline__ bool aligned16(const void* p, long long s0,
                                        long long s1, long long s2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 8 == 0 &&
         s1 % 8 == 0 && s2 % 8 == 0;
}

}  // namespace tc
