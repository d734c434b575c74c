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
// pairs per row stop growing at w, and so does the ratio).
//
// Design (FlashAttention-2 on mma.sync):
//  - Q.K^T and P.V run on the tensor cores as mma.sync.m16n8k16 with bf16
//    operands and f32 accumulators.  wgmma is not used yet.  Each warp
//    owns 16 query rows; its Q fragments stay in registers for the whole
//    key loop, S and the output accumulator live in registers, and P is
//    rounded to bf16 only as the A operand of P.V, straight from the S
//    accumulators (no trip through shared memory).  The softmax is done
//    once per score by the lane that holds it: the row max and sum need
//    two shuffles per row per 64-key tile.
//  - K/V tiles of 64 keys in a ring of 3 in shared memory, filled by
//    16-byte cp.async: tiles j+1 and j+2 stream in while tile j is
//    computed, and one barrier a tile both publishes a tile and frees the
//    oldest buffer.  Rows are padded by 16 bytes so ldmatrix reads are
//    conflict-free.
//  - Tiles fully outside the causal or window range are skipped; the mask
//    is evaluated only on tiles that cut the diagonal, the window edge or
//    the ragged end.
//  - Blocks of 64 query rows (4 warps) that share each K/V tile; query
//    tiles are issued last-first, so the longest causal rows start
//    earliest.  When these blocks are fewer than the SMs (short prompts:
//    at hymba's S=256 the grid is 25 heads x 4 tiles = 100 blocks), a
//    block gets a second group of 4 warps that takes every other key tile
//    with its own K/V ring, and the two partial softmax states are merged
//    at the end: the longest causal row walks half as many tiles in a row.
//    Blocks of 32 rows (200 blocks) were measured slower, since each K/V
//    tile then feeds half the rows.
//  - Shared memory: (64 + 6 * 64 * groups) * (hd + 8) * 2 bytes: 64,512 at
//    hd=64 with one key group, 119,808 with two.
//  - Any head dim that is a multiple of 16 fits: the products step through
//    it 16 (k) or 8 (n) at a time, and a row of hd + 8 bf16 is a whole
//    number of 16-byte pieces, whose 8 rows an ldmatrix reads fall in 8
//    different bank groups when (hd + 8) / 8 is odd (hd 80: 11).  The
//    launcher instantiates 16, 32, 64, 80 (hubert-xlarge) and 128.
//  - Launched with programmatic dependent launch, so its blocks are placed
//    while the kernel before it drains; they wait for it before reading.
// Registers (ptxas -v, CUDA 12.8, sm_90a), one key group / two: 189 / 181
// at hd=128, 145 / 134 at hd=64, 101 / 111 at hd=32, 94 / 94 at hd=16, no
// spills; phase 1 of chip_smoke.py prints them for each build.
#include <math.h>

#include "tc.cuh"

namespace {

using tc::bf16;

constexpr int kWarps = 4;         // warps of a key group, 16 query rows each
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBK = 64;           // keys per tile
constexpr int kStages = 3;        // K/V tiles in flight or in use
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct FaArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int B, Sq, Sk, H, KV;
  long long qsb, qss, qsh;  // strides in elements; head dim is contiguous
  long long ksb, kss, ksh;
  long long vsb, vss, vsh;
  long long osb, oss, osh;
  int causal, window;
  float scale, cap;
  bool vec;  // q, k, v rows are 16-byte aligned
};

// KG key groups of 4 warps share the block's 64 query rows; group g takes
// the key tiles g, g + KG, ... and the groups' partial softmax states are
// merged at the end.
template <int HD, int KG>
__global__ void __launch_bounds__(KG * kWarps * 32) fa_tc_fwd(FaArgs a) {
  constexpr int LD = HD + tc::kPad, T = kWarps * 32;
  tc::launch_dependents();  // the next kernel's blocks may get ready
  tc::grid_wait();          // the kernel before has written q, k, v
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // key group and thread within it (constants when there is one group)
  const int g = KG == 1 ? 0 : threadIdx.x / T;
  const int gt = KG == 1 ? threadIdx.x : threadIdx.x % T;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][LD]
  // the group's K and V rings, [kStages][kBK][LD] each
  bf16* Ks = Qs + kBQ * LD + g * 2 * kStages * kBK * LD;
  bf16* Vs = Ks + kStages * kBK * LD;

  const int warp = gt >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int kvh = h / (a.H / a.KV);
  const bf16* Q = a.q + b * a.qsb + h * a.qsh + q0 * a.qss;
  const bf16* K = a.k + b * a.ksb + kvh * a.ksh;
  const bf16* V = a.v + b * a.vsb + kvh * a.vsh;

  // key range any row of this block can see, in whole tiles
  const int q_last = min(a.Sq, q0 + kBQ) - 1;
  const int kv_hi = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  int kv_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  kv_lo = kv_lo / kBK * kBK;
  const int nt = kv_hi > kv_lo ? (kv_hi - kv_lo + kBK - 1) / kBK : 0;
  const int ng = nt > g ? (nt - g + KG - 1) / KG : 0;  // this group's tiles

  auto load_kv = [&](int i) {  // the group's i-th tile
    const int k0 = kv_lo + (g + i * KG) * kBK, buf = i % kStages;
    tc::load_tile<T>(Ks + buf * kBK * LD, LD, K + k0 * a.kss, a.kss, kBK,
                     a.Sk - k0, HD, HD, a.vec, gt);
    tc::load_tile<T>(Vs + buf * kBK * LD, LD, V + k0 * a.vss, a.vss, kBK,
                     a.Sk - k0, HD, HD, a.vec, gt);
  };
  tc::load_tile<KG * T>(Qs, LD, Q, a.qss, kBQ, a.Sq - q0, HD, HD, a.vec,
                        threadIdx.x);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {  // one copy group per tile
    if (i < ng) load_kv(i);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<kStages - 2>();  // Q, which every group reads
  __syncthreads();

  uint32_t qf[HD / 16][4];
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;  // rows gid and gid + 8
  // exp(x) = 2^(x log2 e): scores are kept multiplied by log2 e
  const float scale2 = a.scale * kLog2e, cap2 = a.cap * kLog2e;
  const int r0 = q0 + warp * 16 + gid, r1 = r0 + 8;

#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    tc::ldsm_x4(qf[ks], tc::a_rowmajor(Qs, LD, warp * 16, ks * 16, lane));
  for (int i = 0; i < ng; ++i) {
    tc::cp_async_wait<kStages - 2>();  // tile i has landed
    if (KG == 1)  // the group, all done with tile i - 1
      __syncthreads();
    else
      tc::bar_sync(1 + g, T);
    if (i + kStages - 1 < ng) load_kv(i + kStages - 1);  // into i - 1's
    tc::cp_async_commit();
    const bf16* Kb = Ks + (i % kStages) * kBK * LD;
    const bf16* Vb = Vs + (i % kStages) * kBK * LD;
    const int k0 = kv_lo + (g + i * KG) * kBK;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t kb[kBK / 16][4];
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np)
        tc::ldsm_x4(kb[np], tc::b_nmajor(Kb, LD, ks * 16, np * 16, lane));
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        tc::mma(s[2 * np], qf[ks], kb[np][0], kb[np][1]);
        tc::mma(s[2 * np + 1], qf[ks], kb[np][2], kb[np][3]);
      }
    }

    // scale (to the log2 domain), softcap, mask; row max
    const bool edge = k0 + kBK > a.Sk || (a.causal && k0 + kBK - 1 > q0) ||
                      (a.window > 0 && q0 + kBQ - 1 - k0 >= a.window);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sc = s[j][e] * scale2;
        if (a.cap > 0.f) sc = tanhf(s[j][e] * a.scale / a.cap) * cap2;
        if (edge) {
          const int kp = k0 + j * 8 + 2 * tig + (e & 1);
          const int qp = e < 2 ? r0 : r1;
          bool ok = true;
          if (a.causal) ok = ok && kp <= qp;
          if (a.window > 0) ok = ok && (qp - kp < a.window);
          sc = ok ? sc : kNeg;
          if (kp >= a.Sk) sc = -INFINITY;
        }
        s[j][e] = sc;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float c0 = tc::exp2(m0 - mx0), c1 = tc::exp2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }
    // P = exp(S - m) in f32 for the denominator, bf16 for P.V
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = tc::exp2(s[j][0] - m0);
      s[j][1] = tc::exp2(s[j][1] - m0);
      s[j][2] = tc::exp2(s[j][2] - m1);
      s[j][3] = tc::exp2(s[j][3] - m1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = tc::pack(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = tc::pack(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = tc::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = tc::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      uint32_t vb[HD / 16][4];
#pragma unroll
      for (int np = 0; np < HD / 16; ++np)
        tc::ldsm_x4_t(vb[np], tc::b_kmajor(Vb, LD, kk * 16, np * 16, lane));
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        tc::mma(o[2 * np], pa, vb[np][0], vb[np][1]);
        tc::mma(o[2 * np + 1], pa, vb[np][2], vb[np][3]);
      }
    }
  }
  tc::cp_async_wait<0>();  // no copy outlives the block

  if (KG > 1) {  // group 1 hands its state to group 0 through its K ring
    float* x = reinterpret_cast<float*>(Ks);
    if (g == 1) {
      tc::bar_sync(2, T);  // the group's last tile is read by every warp
      x[0 * T + gt] = m0;
      x[1 * T + gt] = m1;
      x[2 * T + gt] = l0;
      x[3 * T + gt] = l1;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[(4 + 4 * n + e) * T + gt] = o[n][e];
    }
    __syncthreads();
    if (g == 1) return;
    x = reinterpret_cast<float*>(Qs + kBQ * LD + 2 * kStages * kBK * LD);
    const float pm0 = x[0 * T + gt], pm1 = x[1 * T + gt];
    const float mm0 = fmaxf(m0, pm0), mm1 = fmaxf(m1, pm1);
    const float a0 = tc::exp2(m0 - mm0), b0 = tc::exp2(pm0 - mm0);
    const float a1 = tc::exp2(m1 - mm1), b1 = tc::exp2(pm1 - mm1);
    l0 = l0 * a0 + x[2 * T + gt] * b0;
    l1 = l1 * a1 + x[3 * T + gt] * b1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] = o[n][0] * a0 + x[(4 + 4 * n) * T + gt] * b0;
      o[n][1] = o[n][1] * a0 + x[(5 + 4 * n) * T + gt] * b0;
      o[n][2] = o[n][2] * a1 + x[(6 + 4 * n) * T + gt] * b1;
      o[n][3] = o[n][3] * a1 + x[(7 + 4 * n) * T + gt] * b1;
    }
  }

  // each row's denominator is spread over the 4 lanes of its quad
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* O = a.o + b * a.osb + h * a.osh;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * tig;
    if (r0 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(O + r0 * a.oss + col) =
          __floats2bfloat162_rn(o[n][0] * i0, o[n][1] * i0);
    if (r1 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(O + r1 * a.oss + col) =
          __floats2bfloat162_rn(o[n][2] * i1, o[n][3] * i1);
  }
}

template <int HD, int KG>
cudaError_t launch_groups(const FaArgs& a, cudaStream_t st) {
  constexpr int smem =
      (kBQ + KG * 2 * kStages * kBK) * (HD + tc::kPad) * sizeof(bf16);
  static const cudaError_t attr = cudaFuncSetAttribute(  // once a process
      fa_tc_fwd<HD, KG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  // programmatic dependent launch: the blocks are placed while the kernel
  // before drains, and wait for it in grid_wait()
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.Sq + kBQ - 1) / kBQ, a.B * a.H);
  cfg.blockDim = dim3(KG * kWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fa_tc_fwd<HD, KG>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

int sm_count() {
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

// Two key groups when the row blocks alone cannot fill the SMs (short
// prompts: the longest causal row then walks half as many tiles in a row)
template <int HD>
cudaError_t launch_hd(const FaArgs& a, cudaStream_t st) {
  const long long blocks = (long long)a.B * a.H * ((a.Sq + kBQ - 1) / kBQ);
  if (blocks < sm_count()) return launch_groups<HD, 2>(a, st);
  return launch_groups<HD, 1>(a, st);
}

}  // namespace

extern "C" int fa_forward_tc(const void* q, const void* k, const void* v,
                             void* o, int B, int Sq, int Sk, int H, int KV,
                             int hd, long long qsb, long long qss,
                             long long qsh, long long ksb, long long kss,
                             long long ksh, long long vsb, long long vss,
                             long long vsh, long long osb, long long oss,
                             long long osh, int causal, int window,
                             float scale, float cap, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H % KV) return cudaErrorInvalidValue;
  const bool vec = tc::aligned16(q, qsb, qss, qsh) &&
                   tc::aligned16(k, ksb, kss, ksh) &&
                   tc::aligned16(v, vsb, vss, vsh);
  FaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
           static_cast<const bf16*>(v), static_cast<bf16*>(o),
           B, Sq, Sk, H, KV, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
           osb, oss, osh, causal, window, scale, cap, vec};
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
