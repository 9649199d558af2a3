// Fused RSA demux exit for Hopper (sm_90a):
//
//   out[n, t] = LN_exit( gelu_tanh( norm(h[t]) @ W1h + kb[n] ) @ W2 + b2 )
//
// Replaces the Pallas TPU kernel src/repro/kernels/demux_rsa.py
// (demux_rsa / _kernel_full) with its fused entry norm (the backbone's
// final norm: RMSNorm, or LayerNorm with a bias) and exit LayerNorm (the
// demux's own).  kb = k @ W1k + b1 is an (N, F) matrix computed outside,
// as in the reference.
//
// Layouts: h (T, D); W1h (D, F); kb (N, F); W2 (F, D); b2 (D,); out
// (N, T, D).  All fp32.  Scratch: stats (T, 2), zp (S, T, F), g (N, T, F),
// yp (S, N*T, D) with S = kSplit.
//
// Bound.  Bytes: the two weight matrices, 2*D*F*4 = 37.7 MB at qwen2-1.5b
// width (F = 2D; 268 MB at rwkv6-7b's D = 4096), against ~2*T*D*F*(1 + N)
// flops — under 2 flops per byte at T <= 32, far below the fp32 rate.  So
// the design is about streaming the weights at full rate.
//
// Design.  The Pallas grid (N, T/bt, F/bf) runs F sequentially; copied
// literally it would launch N blocks at decode, each streaming all the
// weights.  Here both products split their reduction axis over kSplit
// blocks as well as their output columns, so ~400-800 small blocks keep
// enough loads in flight to hide DRAM latency, and the partial sums are
// added in a fixed order by the next kernel (deterministic, no atomics).
// Each block covers kTT rows of T (first product) or kRT rows of N*T
// (second), so the weights are read from DRAM once only while T <= kTT
// and N*T <= kRT, as at decode (T = backbone rows).  A prefill chunk
// (T = 32, N*T = 64) has 4 row tiles in each product, and each tile
// streams its W1h or W2 slice again (from L2 where it still holds it):
//   0. demux_ln_stats (LN entry only): one block per row t: its mean and
//      inverse standard deviation -> stats.
//   1. demux_hidden_partial: zp[s] = norm(h) @ W1h over the s-th D slice,
//      blocks over (F tiles, D slices, T tiles).  The LN entry normalises
//      each staged h element with its row's stats, scale and bias.  The
//      RMS entry stages h * (1 + scale): its per-row factor
//      rsqrt(mean(h^2) + eps) is a scalar per row, applied after the
//      product, in step 2.
//   2. demux_gelu: one block per row t: (RMS entry) the row's inverse rms,
//      the sum of the S partials, + kb[n], GELU -> g (N, T, F).
//   3. demux_out_partial: yp[s] = g @ W2 over the s-th F slice, blocks
//      over (D tiles, F slices, row tiles).
//   4. demux_exit: one block per output row: the sum of the S partials
//      + b2, then the exit LayerNorm over the whole D row.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSplit = 8;   // reduction-axis split of both products
constexpr int kDC = 64;     // depth chunk staged in shared memory
// demux_hidden_partial tiles
constexpr int kFB = 32;     // F columns per block
constexpr int kTT = 8;      // T rows per block
// demux_out_partial tiles
constexpr int kDB = 32;     // D columns per block
constexpr int kRT = 16;     // N*T rows per block
constexpr int kRowThreads = 256;
// entry norm kinds (the wrapper's entry_kind None / 'rms' / 'ln')
constexpr int kEntryRms = 1, kEntryLn = 2;      // 0: no entry norm

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_sum(v);
  __syncthreads();             // red reusable
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kRowThreads / 32; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True)
  return x * (0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x)))));
}

__host__ __device__ __forceinline__ int slice_len(int n) {
  // rows of the reduction axis per split, a multiple of kDC
  return ((n + kSplit - 1) / kSplit + kDC - 1) / kDC * kDC;
}

__global__ void __launch_bounds__(kRowThreads) demux_ln_stats(
    const float* __restrict__ h, float* __restrict__ stats, int D) {
  __shared__ float red[kRowThreads / 32];
  const int t = blockIdx.x;
  const float* row = h + (size_t)t * D;
  float s = 0.f;
  for (int d = threadIdx.x; d < D; d += kRowThreads) s += row[d];
  const float mu = block_sum(s, red) / D;
  s = 0.f;
  for (int d = threadIdx.x; d < D; d += kRowThreads) {
    const float c = row[d] - mu;
    s += c * c;
  }
  const float inv = rsqrtf(block_sum(s, red) / D + 1e-6f);
  if (threadIdx.x == 0) {
    stats[2 * t] = mu;
    stats[2 * t + 1] = inv;
  }
}

__global__ void __launch_bounds__(kThreads) demux_hidden_partial(
    const float* __restrict__ h, int entry_kind,
    const float* __restrict__ entry_scale,
    const float* __restrict__ entry_bias, const float* __restrict__ stats,
    const float* __restrict__ w1h, float* __restrict__ zp, int T, int D,
    int F) {
  __shared__ float sh[kTT][kDC];
  __shared__ float sw[kDC][kFB];
  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * kFB, s = blockIdx.y, t0 = blockIdx.z * kTT;
  const int rows = min(kTT, T - t0);
  const int len = slice_len(D), d_lo = s * len, d_hi = min(D, d_lo + len);
  constexpr int kPer = kTT * kFB / kThreads;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  for (int d0 = d_lo; d0 < d_hi; d0 += kDC) {
    __syncthreads();           // previous chunk consumed
    for (int i = tid; i < kTT * kDC; i += kThreads) {
      const int r = i / kDC, c = i % kDC, d = d0 + c;
      float x = 0.f;
      if (r < rows && d < d_hi) {
        x = h[(size_t)(t0 + r) * D + d];
        if (entry_kind == kEntryRms) {
          x *= 1.f + entry_scale[d];
        } else if (entry_kind == kEntryLn) {
          const float* st = stats + 2 * (t0 + r);
          x = (x - st[0]) * st[1] * entry_scale[d] + entry_bias[d];
        }
      }
      sh[r][c] = x;
    }
    for (int i = tid; i < kDC * kFB; i += kThreads) {
      const int k = i / kFB, c = i % kFB, d = d0 + k, f = f0 + c;
      sw[k][c] = (d < d_hi && f < F) ? w1h[(size_t)d * F + f] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = tid + i * kThreads, r = p / kFB, c = p % kFB;
      float a = acc[i];
#pragma unroll 16
      for (int k = 0; k < kDC; ++k) a += sh[r][k] * sw[k][c];
      acc[i] = a;
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int p = tid + i * kThreads, r = p / kFB, c = p % kFB;
    if (r < rows && f0 + c < F)
      zp[((size_t)s * T + t0 + r) * F + f0 + c] = acc[i];
  }
}

__global__ void __launch_bounds__(kRowThreads) demux_gelu(
    const float* __restrict__ h, int entry_kind,
    const float* __restrict__ zp, const float* __restrict__ kb,
    float* __restrict__ g, int T, int N, int D, int F) {
  __shared__ float red[kRowThreads / 32];
  const int t = blockIdx.x;
  float inv = 1.f;
  if (entry_kind == kEntryRms) {  // entry RMSNorm: rsqrt(mean(h^2) + 1e-6)
    float s = 0.f;
    for (int d = threadIdx.x; d < D; d += kRowThreads) {
      const float x = h[(size_t)t * D + d];
      s += x * x;
    }
    inv = rsqrtf(block_sum(s, red) / D + 1e-6f);
  }
  for (int f = threadIdx.x; f < F; f += kRowThreads) {
    float z = 0.f;
    for (int s = 0; s < kSplit; ++s) z += zp[((size_t)s * T + t) * F + f];
    z *= inv;
    for (int n = 0; n < N; ++n)
      g[((size_t)n * T + t) * F + f] = gelu_tanh(z + kb[(size_t)n * F + f]);
  }
}

__global__ void __launch_bounds__(kThreads) demux_out_partial(
    const float* __restrict__ g, const float* __restrict__ w2,
    float* __restrict__ yp, int NT, int D, int F) {
  __shared__ float sg[kRT][kDC + 1];
  __shared__ float sw[kDC][kDB];
  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kDB, s = blockIdx.y, r0 = blockIdx.z * kRT;
  const int rows = min(kRT, NT - r0);
  const int len = slice_len(F), f_lo = s * len, f_hi = min(F, f_lo + len);
  constexpr int kPer = kRT * kDB / kThreads;
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  for (int f0 = f_lo; f0 < f_hi; f0 += kDC) {
    __syncthreads();
    for (int i = tid; i < kRT * kDC; i += kThreads) {
      const int r = i / kDC, k = i % kDC;
      sg[r][k] = (r < rows && f0 + k < f_hi) ? g[(size_t)(r0 + r) * F + f0 + k] : 0.f;
    }
    for (int i = tid; i < kDC * kDB; i += kThreads) {
      const int k = i / kDB, c = i % kDB;
      sw[k][c] = (f0 + k < f_hi && d0 + c < D) ? w2[(size_t)(f0 + k) * D + d0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int p = tid + i * kThreads, r = p / kDB, c = p % kDB;
      float a = acc[i];
#pragma unroll 16
      for (int k = 0; k < kDC; ++k) a += sg[r][k] * sw[k][c];
      acc[i] = a;
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int p = tid + i * kThreads, r = p / kDB, c = p % kDB;
    if (r < rows && d0 + c < D)
      yp[((size_t)s * NT + r0 + r) * D + d0 + c] = acc[i];
  }
}

__global__ void __launch_bounds__(kRowThreads) demux_exit(
    const float* __restrict__ yp, const float* __restrict__ b2,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ out, int NT, int D) {
  __shared__ float red[kRowThreads / 32];
  extern __shared__ float row[];            // D floats
  const int r = blockIdx.x;
  float s = 0.f;
  for (int d = threadIdx.x; d < D; d += kRowThreads) {
    float y = b2[d];
    for (int k = 0; k < kSplit; ++k) y += yp[((size_t)k * NT + r) * D + d];
    row[d] = y;
    s += y;
  }
  if (!scale) {
    for (int d = threadIdx.x; d < D; d += kRowThreads) out[(size_t)r * D + d] = row[d];
    return;
  }
  const float mu = block_sum(s, red) / D;
  s = 0.f;
  for (int d = threadIdx.x; d < D; d += kRowThreads) {
    const float c = row[d] - mu;
    s += c * c;
  }
  const float inv = rsqrtf(block_sum(s, red) / D + 1e-6f);
  for (int d = threadIdx.x; d < D; d += kRowThreads)
    out[(size_t)r * D + d] = (row[d] - mu) * inv * scale[d] + bias[d];
}

}  // namespace

// entry_kind: 0 none, 1 RMSNorm (entry_scale), 2 LayerNorm (entry_scale,
// entry_bias; stats holds 2*T floats).  exit_scale / exit_bias: demux
// LayerNorm, or nullptr for none.  zp holds kSplit*T*F floats, g N*T*F,
// yp kSplit*N*T*D.
extern "C" int demux_rsa_split() { return kSplit; }

extern "C" int demux_rsa_forward(
    const float* h, const float* entry_scale, const float* entry_bias,
    const float* w1h, const float* kb, const float* w2, const float* b2,
    const float* exit_scale, const float* exit_bias, float* stats,
    float* zp, float* g, float* yp, float* out, int entry_kind, int T, int N,
    int D, int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int NT = N * T;
  if (entry_kind == kEntryLn) demux_ln_stats<<<T, kRowThreads, 0, st>>>(h, stats, D);
  dim3 g1((F + kFB - 1) / kFB, kSplit, (T + kTT - 1) / kTT);
  demux_hidden_partial<<<g1, kThreads, 0, st>>>(h, entry_kind, entry_scale, entry_bias,
                                                stats, w1h, zp, T, D, F);
  demux_gelu<<<T, kRowThreads, 0, st>>>(h, entry_kind, zp, kb, g, T, N, D, F);
  dim3 g3((D + kDB - 1) / kDB, kSplit, (NT + kRT - 1) / kRT);
  demux_out_partial<<<g3, kThreads, 0, st>>>(g, w2, yp, NT, D, F);
  const size_t smem = sizeof(float) * (size_t)D;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        demux_exit, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  demux_exit<<<NT, kRowThreads, smem, st>>>(yp, b2, exit_scale, exit_bias, out, NT, D);
  return (int)cudaGetLastError();
}
