// Building blocks of the port's f32 kernels on the tensor cores (sm_90a):
// three TF32 passes of mma.sync.m16n8k8, and cp.async tile loads.
//
// One TF32 product keeps 11 significant bits of each operand, which misses
// the f32 kernels' tolerances (2e-5 attention, 1e-4 SSD) many times over
// (tests/test_torch_{flash_attention,ssd}.py emulate it).  Three
// passes hold them: an f32 value a is split into big = tf32(a) and small =
// tf32(a - big), both rounded to nearest with ties away from zero (as
// cvt.rna.tf32.f32 rounds), and
//   a.b ~ small_a.big_b + big_a.small_b + big_a.big_b,
// accumulated in f32 in that order (CUTLASS's 3xTF32): about 22 significant
// bits a product, at a third of the TF32 rate (494.7 / 3 TFLOP/s on an H100
// SXM against the CUDA cores' 67).
//
// Fragment layout of mma.sync m16n8k8 .tf32 (lane = 4 * gid + tig):
//   A 16x8 row-major, 4 regs: (gid, tig), (gid+8, tig), (gid, tig+4),
//     (gid+8, tig+4);
//   B 8x8, 2 regs: (k tig, n gid), (k tig+4, n gid);
//   C/D 16x8 f32, 4 floats: (gid, 2tig), (gid, 2tig+1), (gid+8, 2tig),
//     (gid+8, 2tig+1).
// A sum over k may take its k in any order, so the kernels map k = tig and
// k = tig + 4 to whichever two indices a lane holds (e.g. 2tig and 2tig+1 of
// an accumulator), as long as both operands of the product use one map.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// a rounded to TF32 (10 explicit mantissa bits), nearest, ties away from
// zero: what cvt.rna.tf32.f32 computes for finite a, in two integer
// operations (ptxas expands the cvt into several, with NaN and infinity
// checks that the kernels' finite operands do not need; a NaN still
// propagates through the small part)
__device__ __forceinline__ uint32_t rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = big + small, both TF32
__device__ __forceinline__ void split(float a, uint32_t& big,
                                      uint32_t& small) {
  big = rna(a);
  small = rna(a - __uint_as_float(big));
}

// A fragment of four f32 values, split
struct A {
  uint32_t b[4], s[4];
  __device__ __forceinline__ A(float a0, float a1, float a2, float a3) {
    split(a0, b[0], s[0]);
    split(a1, b[1], s[1]);
    split(a2, b[2], s[2]);
    split(a3, b[3], s[3]);
  }
};

// B fragment of two f32 values, split
struct B {
  uint32_t b0, b1, s0, s1;
  __device__ __forceinline__ B() {}
  __device__ __forceinline__ B(float v0, float v1) {
    split(v0, b0, s0);
    split(v1, b1, s1);
  }
};

// d += a * b  (16x8x8, TF32 operands, f32 accumulators)
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in three passes: small_a.big_b, big_a.small_b, big_a.big_b
__device__ __forceinline__ void mma3(float d[4], const A& a, const B& b) {
  mma(d, a.s, b.b0, b.b1);
  mma(d, a.b, b.s0, b.s1);
  mma(d, a.b, b.b0, b.b1);
}

// d[n] += a * b[n] for n < N in three passes, each pass over every n
// before the next: the N products are independent, so no mma waits on the
// one just issued (a pass's result is an input of the next pass's mma on
// the same accumulator)
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], const A& a,
                                     const B (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], a.s, b[n].b0, b[n].b1);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], a.b, b[n].s0, b[n].s1);
#pragma unroll
  for (int n = 0; n < N; ++n) mma(d[n], a.b, b[n].b0, b[n].b1);
}

// cp.async of 16 or 4 bytes into shared memory; with `in` false nothing is
// read and the bytes are zero (src must still be a valid address)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(in ? 16 : 0)
      : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool in) {
  asm volatile(
      "cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(in ? 4 : 0)
      : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // at most N committed groups still in flight
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32
