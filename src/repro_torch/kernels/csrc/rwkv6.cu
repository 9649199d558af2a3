// RWKV6 (Finch) recurrence for Hopper (sm_90a), one token at a time:
//
//   out_t = r_t S_{t-1} + ((r_t * u) . k_t) v_t
//   S_t   = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
//
// over r, k, v, logw (B, L, H, hd) fp32, u (H, hd), the carried state
// s0 (B, H, hd, hd) -> out (B, L, H, hd), sT (B, H, hd, hd).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6.py
// (rwkv6_chunked / _kernel), which walks chunks of c tokens in a
// sequential grid axis with the (hd, hd) state in VMEM scratch, and forms
// each chunk's intra-chunk scores from exp(la_prev_t - la_j), a difference
// of cumulative log decays.
//
// Bound.  Bytes: r, k, v, logw and out once each plus the state read and
// written, 16*L*H*hd + 8*H*hd^2 bytes per row, against ~5*hd^2 flops per
// token and head: under 1.5 flops per byte at hd = 64, far below the fp32
// rate, so the card's memory rate bounds it.  In practice the bound is
// latency: one block walks its row's L tokens in order.
//
// Design.  One block per (row, head), B*H blocks (256 for rwkv6-7b at 4
// rows), 4*hd threads.  The state lives in registers for the whole
// sequence: thread (col, q) holds S[q + 4i][col] for i < hd/4, so each
// token's output column is four partial dot products summed by two warp
// shuffles, and the state update needs no synchronisation.  Tokens are
// staged TT at a time into shared memory with 16-byte loads (exp(logw)
// taken there); the scan over a staged tile reads shared memory only, so
// the only barriers are at tile boundaries.  The per-token form is the
// definition (the sequential oracle ``rwkv6_ref``): it takes any L with no
// chunk rule, and its decay is one exp per token and channel, never a
// difference of cumulative sums, which loses digits as the sums grow and
// overflows exp() past ~88 nats of decay.
#include <cuda_runtime.h>

namespace {

template <int HD>
__global__ void __launch_bounds__(4 * HD) rwkv6_scan(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ logw,
    const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ out, float* __restrict__ sT, int L, int H) {
  constexpr int kThreads = 4 * HD;
  constexpr int KPT = HD / 4;         // state rows per thread
  constexpr int TT = 2048 / HD;       // tokens per staged tile (8 KB each)
  constexpr int V4 = HD / 4;          // float4s per token row
  __shared__ __align__(16) float sr[TT][HD];
  __shared__ __align__(16) float sk[TT][HD];
  __shared__ __align__(16) float sv[TT][HD];
  __shared__ __align__(16) float sw[TT][HD];
  __shared__ __align__(16) float so[TT][HD];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int col = threadIdx.x >> 2, q = threadIdx.x & 3;
  const float* s_in = s0 + (size_t)bh * HD * HD;
  float s[KPT], uk[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    s[i] = s_in[(q + 4 * i) * HD + col];
    uk[i] = u[h * HD + q + 4 * i];
  }

  for (int t0 = 0; t0 < L; t0 += TT) {
    const int n = min(TT, L - t0);
    for (int i = threadIdx.x; i < n * V4; i += kThreads) {
      const int t = i / V4, c = (i % V4) * 4;
      const size_t off = ((size_t)(b * L + t0 + t) * H + h) * HD + c;
      *reinterpret_cast<float4*>(&sr[t][c]) = *reinterpret_cast<const float4*>(r + off);
      *reinterpret_cast<float4*>(&sk[t][c]) = *reinterpret_cast<const float4*>(k + off);
      *reinterpret_cast<float4*>(&sv[t][c]) = *reinterpret_cast<const float4*>(v + off);
      float4 w = *reinterpret_cast<const float4*>(logw + off);
      w.x = expf(w.x);
      w.y = expf(w.y);
      w.z = expf(w.z);
      w.w = expf(w.w);
      *reinterpret_cast<float4*>(&sw[t][c]) = w;
    }
    __syncthreads();                  // tile staged
    for (int t = 0; t < n; ++t) {
      const float vc = sv[t][col];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int kk = q + 4 * i;     // four neighbouring rows per warp: no bank conflict
        const float kv = sk[t][kk] * vc;
        acc += sr[t][kk] * (s[i] + uk[i] * kv);
        s[i] = s[i] * sw[t][kk] + kv;
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (q == 0) so[t][col] = acc;
    }
    __syncthreads();                  // tile scanned: so[] complete, staging free
    for (int i = threadIdx.x; i < n * V4; i += kThreads) {
      const int t = i / V4, c = (i % V4) * 4;
      const size_t off = ((size_t)(b * L + t0 + t) * H + h) * HD + c;
      *reinterpret_cast<float4*>(out + off) = *reinterpret_cast<const float4*>(&so[t][c]);
    }
  }
  float* s_out = sT + (size_t)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < KPT; ++i) s_out[(q + 4 * i) * HD + col] = s[i];
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* logw,
           const float* u, const float* s0, float* out, float* sT, int B,
           int L, int H, cudaStream_t st) {
  rwkv6_scan<HD><<<B * H, 4 * HD, 0, st>>>(r, k, v, logw, u, s0, out, sT, L, H);
  return (int)cudaGetLastError();
}

}  // namespace

// All pointers 16-byte aligned and contiguous; HD one of 16, 32, 64, 128
// (else returns cudaErrorInvalidValue); L >= 1.
extern "C" int rwkv6_forward(const float* r, const float* k, const float* v,
                             const float* logw, const float* u,
                             const float* s0, float* out, float* sT, int B,
                             int L, int H, int HD, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 16: return launch<16>(r, k, v, logw, u, s0, out, sT, B, L, H, st);
    case 32: return launch<32>(r, k, v, logw, u, s0, out, sT, B, L, H, st);
    case 64: return launch<64>(r, k, v, logw, u, s0, out, sT, B, L, H, st);
    case 128: return launch<128>(r, k, v, logw, u, s0, out, sT, B, L, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
