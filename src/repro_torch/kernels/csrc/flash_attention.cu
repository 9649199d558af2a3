// Flash attention (causal / sliding-window / bidirectional, GQA, logit
// softcap) over fresh K/V, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, _kernel): flash_attention_kernel.
//
// Layouts (as in the reference, read in place): q (B, Lq, H, Dh) fp32;
// k, v (B, Lk, Hkv, Dh) fp32; out (B, Lq, H, Dh).  Query i sits at
// position q_offset + i, key j at position j.  Mask, as the reference:
// key j < Lk, and j <= q (causal), j > q - window (window > 0); the
// softcap tanh(s / c) * c applies to the scaled logit before the mask.
//
// Design.  One block per (query tile of kBQ rows, head, row).  Its KV head
// is h / G (G = H / Hkv): K/V are never broadcast to H heads.  The TPU
// grid's sequential KV axis becomes a loop inside the block over K/V tiles
// of kBK keys: each tile's K and V go to shared memory, scores and an
// online softmax run in fp32, and the accumulator stays in registers (one
// head dimension per thread).  The loop visits only the K tiles that meet
// the tile's causal / window band (the Pallas docstring claims this skip,
// its grid does not make it).  The mask value is the finite -2**30 of the
// reference: a query that sees no key returns the uniform mean of V over
// all Lk keys, as the plain version does; a tile holding such a query
// therefore visits every K tile.  Lq and Lk need not be tile multiples:
// rows past Lq are not computed and keys past Lk are never loaded.
//
// Bound.  Each (query, visible key) pair costs 4 * Dh flops; K and V are
// read once per query tile and head (from L2 after the first).  A causal
// 116-token prefill at the main path's width is ~27 flops per input byte,
// above the card's fp32 balance (~20): bound by operations, on the CUDA
// cores (fp32, no tensor-core path in this first version).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 16;          // query rows per block
constexpr int kBK = 32;          // keys per shared-memory tile
constexpr int kMaxDpt = 2;       // head dims per thread: Dh <= 256
constexpr float kNegInf = -1073741824.0f;   // -2**30, as the reference

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  int B, Lq, Lk, H, Hkv, Dh, causal, window, q_offset;
  float scale, softcap;     // softcap <= 0: none
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int Dh) {
  const int ldk = Dh + 4;
  return sizeof(float) * (size_t)(kBQ * ldk + kBK * ldk + kBK * Dh +
                                  kBQ * kBK + 3 * kBQ);
}

__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Args a) {
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kvh = h / (a.H / a.Hkv);
  const int rows = min(kBQ, a.Lq - q0);
  const int ldk = a.Dh + 4;      // padded row stride: fewer bank conflicts
  const int d4 = a.Dh / 4;

  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // kBQ x ldk, pre-scaled q
  float* sk = sq + kBQ * ldk;                   // kBK x ldk
  float* sv = sk + kBK * ldk;                   // kBK x Dh
  float* sp = sv + kBK * a.Dh;                  // kBQ x kBK scores / probs
  float* sm = sp + kBQ * kBK;                   // running max
  float* sl = sm + kBQ;                         // running sum
  float* salpha = sl + kBQ;                     // per-tile rescale

  for (int i = tid; i < rows * d4; i += kThreads) {
    const int r = i / d4, c = i % d4;
    float4 x = reinterpret_cast<const float4*>(
        a.q + (((size_t)b * a.Lq + q0 + r) * a.H + h) * a.Dh)[c];
    x.x *= a.scale; x.y *= a.scale; x.z *= a.scale; x.w *= a.scale;
    reinterpret_cast<float4*>(sq + r * ldk)[c] = x;
  }
  if (tid < kBQ) {
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
  }

  // keys the tile's queries can see: [k_lo, k_hi]; every key when one of
  // them sees none (its output is then the mean of V over all keys)
  int k_lo = a.Lk, k_hi = -1;
  bool blind = false;
  for (int r = 0; r < rows; ++r) {
    const int qp = a.q_offset + q0 + r;
    const int lo = a.window > 0 ? max(0, qp - a.window + 1) : 0;
    const int hi = a.causal ? min(a.Lk - 1, qp) : a.Lk - 1;
    blind = blind || lo > hi;
    k_lo = min(k_lo, lo);
    k_hi = max(k_hi, hi);
  }
  if (blind) {
    k_lo = 0;
    k_hi = a.Lk - 1;
  }

  float acc[kBQ][kMaxDpt];
#pragma unroll
  for (int r = 0; r < kBQ; ++r)
#pragma unroll
    for (int j = 0; j < kMaxDpt; ++j) acc[r][j] = 0.f;

  for (int k0 = (k_lo / kBK) * kBK; k0 <= k_hi; k0 += kBK) {
    const int n = min(kBK, a.Lk - k0);
    __syncthreads();             // previous tile fully consumed
    for (int i = tid; i < n * d4; i += kThreads) {
      const int s = i / d4, c = i % d4;
      const size_t off = (((size_t)b * a.Lk + k0 + s) * a.Hkv + kvh) * a.Dh;
      reinterpret_cast<float4*>(sk + s * ldk)[c] =
          reinterpret_cast<const float4*>(a.k + off)[c];
      reinterpret_cast<float4*>(sv + s * a.Dh)[c] =
          reinterpret_cast<const float4*>(a.v + off)[c];
    }
    __syncthreads();

    // scores: one (query row, key) dot product per thread
    for (int p = tid; p < rows * n; p += kThreads) {
      const int r = p / n, s = p % n;
      const float4* qr = reinterpret_cast<const float4*>(sq + r * ldk);
      const float4* kr = reinterpret_cast<const float4*>(sk + s * ldk);
      float dot = 0.f;
      for (int c = 0; c < d4; ++c) {
        const float4 x = qr[c], y = kr[c];
        dot += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
      if (a.softcap > 0.f) dot = tanhf(dot / a.softcap) * a.softcap;
      const int qp = a.q_offset + q0 + r, kp = k0 + s;
      bool ok = true;
      if (a.causal) ok = kp <= qp;
      if (a.window > 0) ok = ok && kp > qp - a.window;
      sp[r * kBK + s] = ok ? dot : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per query row, one key per lane
    for (int r = warp; r < rows; r += kThreads / 32) {
      const float sc = lane < n ? sp[r * kBK + lane] : kNegInf;
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, warp_max(sc));
      const float e = lane < n ? expf(sc - m_new) : 0.f;
      if (lane < n) sp[r * kBK + lane] = e;
      const float sum = warp_sum(e);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sl[r] = sl[r] * alpha + sum;
        sm[r] = m_new;
        salpha[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kMaxDpt; ++j) {
      const int d = tid + j * kThreads;
      if (d >= a.Dh) continue;
#pragma unroll
      for (int r = 0; r < kBQ; ++r) {
        if (r >= rows) break;
        float v = acc[r][j] * salpha[r];
        for (int s = 0; s < n; ++s) v += sp[r * kBK + s] * sv[s * a.Dh + d];
        acc[r][j] = v;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxDpt; ++j) {
    const int d = tid + j * kThreads;
    if (d >= a.Dh) continue;
#pragma unroll
    for (int r = 0; r < kBQ; ++r) {
      if (r >= rows) break;
      a.out[(((size_t)b * a.Lq + q0 + r) * a.H + h) * a.Dh + d] =
          acc[r][j] / fmaxf(sl[r], 1e-30f);
    }
  }
}

}  // namespace

extern "C" int flash_attention_forward(
    const float* q, const float* k, const float* v, float* out, int B,
    int Lq, int Lk, int H, int Hkv, int Dh, int causal, int window,
    int q_offset, float softcap, float scale, void* stream) {
  if (Dh % 4 || Dh > kThreads * kMaxDpt || H % Hkv || Lq < 1 || Lk < 1 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, B, Lq, Lk, H, Hkv, Dh, causal, window, q_offset,
         scale, softcap};
  const size_t smem = smem_bytes(Dh);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
