// Flash-attention forward for Hopper (sm_90a), self-attention prefill, f32.
//
// Replaces the Pallas TPU kernel `_fa_kernel` (src/repro/kernels/
// flash_attention/kernel.py:25, launched by `flash_attention` at :70) for
// f32 inputs, which need the f32 tolerance of 2e-5 that no tensor-core
// format holds; bf16 goes to flash_attention_tc.cu.  Same function: scores
// in f32 scaled by `scale`, optional tanh softcap, causal mask kp <= qp and
// sliding-window mask qp - kp < window (masked scores are -1e30, as in the
// reference), GQA query head h reads KV head h / (H / KV), online softmax
// with running max, denominator and f32 accumulator, output
// acc / max(l, 1e-30).  Positions are the self-attention iota.  `window`
// is a runtime int and is honoured in every layer (the reference's ops.py
// drops a traced window to 0).  Any Sq, Sk: the ragged q and kv edges are
// masked here, no divisibility asserts.
//
// What bounds it on the H100: causal attention does 2*S*S*hd FLOPs per
// query head against (2*H + 2*KV)*S*hd*2 bytes; at hymba's 25 query and 5
// KV heads that is about 0.42*S FLOP per byte, so prompts below S ~ 700
// are bound by bytes and longer ones by the tensor cores' 989 TFLOP/s.
// In f32 the peak is the CUDA cores' 67 TFLOP/s, and this kernel runs at
// low occupancy, so it sits far above either bound.  What the design does
// about it: K and V tiles are staged once in shared memory and reused by
// all query rows of the block; each query row is split across hd/16
// lanes (8 at hd 80) that interleave their dims so shared-memory reads
// are conflict-free; key tiles fully outside the causal or window range
// are skipped, which halves causal work.
#include <math.h>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kBK = 32;        // keys per shared-memory tile
constexpr float kNeg = -1e30f;

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
};

// Lanes per query row: hd / 16 where that is a power of two, else 8
// (hd 80: 10 dims a lane).  The row's lanes reduce their partial dot
// products by power-of-two shuffles, and the rows must tile the block.
template <int HD>
__host__ __device__ constexpr int lanes_per_row() {
  return ((HD / 16) & (HD / 16 - 1)) == 0 ? HD / 16 : 8;
}

template <int HD>
__global__ void __launch_bounds__(kThreads) fa_fwd(FaArgs a) {
  constexpr int TPR = lanes_per_row<HD>();  // lanes per query row
  constexpr int DPT = HD / TPR;             // dims per lane
  constexpr int BQ = kThreads / TPR;        // query rows per block
  static_assert(HD % TPR == 0 && 32 % TPR == 0, "rows must tile a warp");
  __shared__ float Ks[kBK][HD];
  __shared__ float Vs[kBK][HD];

  const int tid = threadIdx.x;
  const int r = tid / TPR, g = tid % TPR;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int kvh = h / (a.H / a.KV);
  const int q0 = blockIdx.x * BQ;
  const int qp = q0 + r;
  const bool valid_q = qp < a.Sq;

  const float* Q = a.q + b * a.qsb + h * a.qsh;
  const float* K = a.k + b * a.ksb + kvh * a.ksh;
  const float* V = a.v + b * a.vsb + kvh * a.vsh;

  // lane g of a row owns dims g, g + TPR, g + 2*TPR, ...
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = valid_q ? Q[qp * a.qss + g + TPR * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNeg, l = 0.f;

  // key range any row of this block can see
  const int q_last = min(a.Sq, q0 + BQ) - 1;
  const int kv_hi = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  int kv_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  kv_lo = kv_lo / kBK * kBK;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD, key = k0 + j;
      const bool in = key < a.Sk;
      Ks[j][d] = in ? K[key * a.kss + d] : 0.f;
      Vs[j][d] = in ? V[key * a.vss + d] : 0.f;
    }
    __syncthreads();

    float s[kBK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part = fmaf(qr[i], Ks[j][g + TPR * i], part);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      float sc = part * a.scale;
      if (a.cap > 0.f) sc = tanhf(sc / a.cap) * a.cap;
      const int kp = k0 + j;
      bool ok = true;
      if (a.causal) ok = ok && kp <= qp;
      if (a.window > 0) ok = ok && (qp - kp < a.window);
      sc = ok ? sc : kNeg;
      if (kp >= a.Sk) sc = -INFINITY;  // padding past the ragged edge
      s[j] = sc;
      mx = fmaxf(mx, sc);
    }
    const float corr = expf(m - mx);
    l *= corr;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - mx);
      l += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, Vs[j][g + TPR * i], acc[i]);
    }
    m = mx;
  }

  if (valid_q) {
    float* O = a.o + b * a.osb + h * a.osh + qp * a.oss;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) O[g + TPR * i] = acc[i] / den;
  }
}

template <int HD>
void launch_hd(const FaArgs& a, cudaStream_t st) {
  constexpr int BQ = kThreads / lanes_per_row<HD>();
  fa_fwd<HD><<<dim3((a.Sq + BQ - 1) / BQ, a.B * a.H), kThreads, 0, st>>>(a);
}

cudaError_t launch(const FaArgs& a, int hd, cudaStream_t st) {
  switch (hd) {
    case 16: launch_hd<16>(a, st); break;
    case 32: launch_hd<32>(a, st); break;
    case 64: launch_hd<64>(a, st); break;
    case 80: launch_hd<80>(a, st); break;  // hubert-xlarge
    case 128: launch_hd<128>(a, st); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int fa_forward(const float* q, const float* k, const float* v,
                          float* o,
                          int B, int Sq, int Sk, int H, int KV,
                          int hd, long long qsb, long long qss, long long qsh,
                          long long ksb, long long kss, long long ksh,
                          long long vsb, long long vss, long long vsh,
                          long long osb, long long oss, long long osh,
                          int causal, int window, float scale, float cap,
                          void* stream) {
  FaArgs a{q,   k,   v,   o,   B,   Sq,  Sk,  H,      KV,     qsb,   qss,
           qsh, ksb, kss, ksh, vsb, vss, vsh, osb,    oss,    osh,   causal,
           window, scale, cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch(a, hd, st);
}
