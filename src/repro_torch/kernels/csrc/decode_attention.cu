// Flash-decode: one query per row against a contiguous ring KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, _kernel): decode_split_kernel + decode_combine_kernel.
//
// Layouts (as in the reference, read in place): q (B, 1, H, Dh) fp32;
// k, v (B, C, Hkv, Dh) fp32, the ring cache itself (the Pallas wrapper's
// (B, Hkv, C, Dh) transposed copy is not made: a slot's head row is
// addressed with stride Hkv * Dh); slot_pos (C,) int32, the absolute
// position each slot holds (-1 = empty; not monotone once the ring wraps);
// q_pos a plain int argument, so no position specialises the kernel.
//
// Design.  The cache axis is split: block (row, KV head, split) walks its
// split's slots in tiles of kTile.  Each tile's K and V rows go to shared
// memory once for the G = H / Hkv query heads of that KV head (GQA never
// repeats K/V), scores and an online softmax run in fp32, and the
// accumulator stays in registers (one head dimension per thread).  With
// one split the block writes the normalised output; with several it
// writes its (acc, m, l) and decode_combine_kernel merges the splits per
// (row, head) by their log-sum-exp.  The split count is chosen by the
// wrapper (kernels/decode_attention.py) to give ~2 blocks per SM, since
// B * Hkv alone is 8 at the main path's width.  The mask value is the
// finite -2**30 of the reference, not -inf: a query that sees no slot
// returns the uniform mean of V over all C slots, as the plain version
// does, instead of NaN.
//
// Bound.  One query per (row, head) reads each visible slot's K and V row
// once per KV head: ~2 * Dh * 4 bytes per (row, KV head, slot) against
// 4 * Dh * G flops, ~3 flops per byte at G = 6, so bytes bound it.  At the
// main path's shape (B = 4, C = 124) that is ~1 MB, a fraction of a
// microsecond at 3.35 TB/s: in practice the launch latency and the
// combine pass bound it.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 16;        // cache slots per shared-memory tile
constexpr int kMaxG = 16;        // query heads per KV head
constexpr int kMaxDpt = 2;       // head dims per thread: Dh <= 256
constexpr float kNegInf = -1073741824.0f;   // -2**30, as the reference

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int* slot_pos;
  float* part_acc;     // (B, H, nsplit, Dh); nsplit == 1: unused
  float* part_ml;      // (B, H, nsplit, 2) running max and sum
  float* out;          // (B, H, Dh)
  int B, C, H, Hkv, Dh, q_pos, causal, window, nsplit, split_len;
  float scale;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int G, int Dh) {
  const int ldk = Dh + 4;
  return sizeof(float) * (size_t)(G * ldk + kTile * ldk + kTile * Dh +
                                  G * kTile + 3 * G);
}

__global__ void __launch_bounds__(kThreads) decode_split_kernel(Args a) {
  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.H / a.Hkv;
  const int ldk = a.Dh + 4;      // padded row stride: fewer bank conflicts
  const int d4 = a.Dh / 4;
  const int s_begin = split * a.split_len;
  const int s_end = min(a.C, s_begin + a.split_len);

  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // G x ldk, pre-scaled q
  float* sk = sq + G * ldk;                     // kTile x ldk
  float* sv = sk + kTile * ldk;                 // kTile x Dh
  float* sp = sv + kTile * a.Dh;                // G x kTile scores / probs
  float* sm = sp + G * kTile;                   // running max
  float* sl = sm + G;                           // running sum
  float* salpha = sl + G;                       // per-tile rescale
  __shared__ int spos[kTile];

  for (int i = tid; i < G * d4; i += kThreads) {
    const int g = i / d4, c = i % d4;
    float4 x = reinterpret_cast<const float4*>(
        a.q + ((size_t)b * a.H + kvh * G + g) * a.Dh)[c];
    x.x *= a.scale; x.y *= a.scale; x.z *= a.scale; x.w *= a.scale;
    reinterpret_cast<float4*>(sq + g * ldk)[c] = x;
  }
  if (tid < G) {
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
  }

  float acc[kMaxG][kMaxDpt];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int j = 0; j < kMaxDpt; ++j) acc[g][j] = 0.f;

  for (int s0 = s_begin; s0 < s_end; s0 += kTile) {
    const int n = min(kTile, s_end - s0);
    __syncthreads();             // previous tile fully consumed
    for (int i = tid; i < n * d4; i += kThreads) {
      const int s = i / d4, c = i % d4;
      const size_t off = (((size_t)b * a.C + s0 + s) * a.Hkv + kvh) * a.Dh;
      reinterpret_cast<float4*>(sk + s * ldk)[c] =
          reinterpret_cast<const float4*>(a.k + off)[c];
      reinterpret_cast<float4*>(sv + s * a.Dh)[c] =
          reinterpret_cast<const float4*>(a.v + off)[c];
    }
    if (tid < n) spos[tid] = a.slot_pos[s0 + tid];
    __syncthreads();

    // scores: one (query head, slot) dot product per thread
    for (int p = tid; p < G * n; p += kThreads) {
      const int g = p / n, s = p % n;
      const float4* qr = reinterpret_cast<const float4*>(sq + g * ldk);
      const float4* kr = reinterpret_cast<const float4*>(sk + s * ldk);
      float dot = 0.f;
      for (int c = 0; c < d4; ++c) {
        const float4 x = qr[c], y = kr[c];
        dot += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
      const int pos = spos[s];
      bool ok = pos >= 0;
      if (a.causal) ok = ok && pos <= a.q_pos;
      if (a.window > 0) ok = ok && pos > a.q_pos - a.window;
      sp[g * kTile + s] = ok ? dot : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < G; g += kThreads / 32) {
      const float sc = lane < n ? sp[g * kTile + lane] : kNegInf;
      const float m_prev = sm[g];
      const float m_new = fmaxf(m_prev, warp_max(sc));
      const float e = lane < n ? expf(sc - m_new) : 0.f;
      if (lane < n) sp[g * kTile + lane] = e;
      const float sum = warp_sum(e);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sl[g] = sl[g] * alpha + sum;
        sm[g] = m_new;
        salpha[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kMaxDpt; ++j) {
      const int d = tid + j * kThreads;
      if (d >= a.Dh) continue;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float v = acc[g][j] * salpha[g];
        for (int s = 0; s < n; ++s) v += sp[g * kTile + s] * sv[s * a.Dh + d];
        acc[g][j] = v;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxDpt; ++j) {
    const int d = tid + j * kThreads;
    if (d >= a.Dh) continue;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const size_t bh = (size_t)b * a.H + kvh * G + g;
      if (a.nsplit == 1)
        a.out[bh * a.Dh + d] = acc[g][j] / fmaxf(sl[g], 1e-30f);
      else
        a.part_acc[(bh * a.nsplit + split) * a.Dh + d] = acc[g][j];
    }
  }
  if (a.nsplit > 1 && tid < G) {
    const size_t bh = (size_t)b * a.H + kvh * G + tid;
    a.part_ml[(bh * a.nsplit + split) * 2] = sm[tid];
    a.part_ml[(bh * a.nsplit + split) * 2 + 1] = sl[tid];
  }
}

// one block per (row, head): merge the splits by their log-sum-exp
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(Args a) {
  const size_t bh = blockIdx.x;
  const float* ml = a.part_ml + bh * a.nsplit * 2;
  float m = kNegInf;
  for (int s = 0; s < a.nsplit; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f;
  for (int s = 0; s < a.nsplit; ++s) l += ml[2 * s + 1] * expf(ml[2 * s] - m);
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < a.Dh; d += kThreads) {
    float o = 0.f;
    for (int s = 0; s < a.nsplit; ++s)
      o += a.part_acc[(bh * a.nsplit + s) * a.Dh + d] * expf(ml[2 * s] - m);
    a.out[bh * a.Dh + d] = o * inv;
  }
}

}  // namespace

extern "C" int decode_attention_forward(
    const float* q, const float* k, const float* v, const int* slot_pos,
    float* part_acc, float* part_ml, float* out, int B, int C, int H,
    int Hkv, int Dh, int q_pos, int causal, int window, int nsplit,
    int split_len, float scale, void* stream) {
  if (Dh % 4 || Dh > kThreads * kMaxDpt || H % Hkv || H / Hkv > kMaxG ||
      C < 1 || nsplit < 1 || split_len < 1 ||
      (long long)nsplit * split_len < C ||
      (long long)(nsplit - 1) * split_len >= C ||
      (nsplit > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, slot_pos, part_acc, part_ml, out,
         B, C, H, Hkv, Dh, q_pos, causal, window, nsplit, split_len, scale};
  const size_t smem = smem_bytes(H / Hkv, Dh);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  decode_split_kernel<<<dim3(B, Hkv, nsplit), kThreads, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  decode_combine_kernel<<<B * H, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
