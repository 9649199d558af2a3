// The flash-attention tile step on the tensor cores, shared by
// flash_attention.cu (K/V of fresh rows) and paged_attention.cu's chunk
// kernel (K/V gathered through a block table): one warp's share of S = Q K^T,
// the online softmax and O += P V over one key tile, in the fp32-exact
// 3xTF32 split of tf32.cuh; and the log-sum-exp merge of key splits.
//
// Layout (FA2, mma.sync m16n8k8): a warp holds MT m-tiles of 16 query rows.
// Thread (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 of each
// m-tile and, of each group j of 8 keys, keys 2t and 2t + 1:
// s[m][j][e] is key 8j + 2t + (e & 1) of row g + 8 (e >> 1); o[m][n][e] is
// head dims 8n + 2t + (e & 1) of the same rows.  Q lies in shared memory as
// TF32 hi and lo, pre-scaled, rows LD floats apart.  K and V elements come
// through loaders k(key, dim) -> float, so a kernel can widen and scale
// stored page elements as it reads them.  Scores are in log2 units.
#pragma once
#include <cuda_bf16.h>

#include "tf32.cuh"

namespace {

// an fp32 result stored as the output's type (bf16: rounded to nearest even,
// as PyTorch's and JAX's casts)
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// two fp32 results stored as the output's type (8- or 4-byte aligned)
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// a stored K / V element widened to fp32 (exactly), and four bf16 values
// held in a uint2
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float4 widen4(uint2 u) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

constexpr float kNegMask = -1073741824.0f;     // -2**30, as the reference
constexpr float kLog2e = 1.4426950408889634f;

// per padded head dim D: keys a tile, blocks an SM (launch bounds), m-tiles
// of 16 query rows a warp (kernels/flash_attention.py TILES)
template <int D> struct Cfg;
template <> struct Cfg<32> { static constexpr int BK = 64, kMinBlocks = 2, MT = 2; };
template <> struct Cfg<64> { static constexpr int BK = 32, kMinBlocks = 2, MT = 2; };
template <> struct Cfg<128> { static constexpr int BK = 16, kMinBlocks = 2, MT = 1; };
template <> struct Cfg<256> { static constexpr int BK = 16, kMinBlocks = 1, MT = 1; };

// S = Q K^T; qh, ql point at the thread's first row (r0 + g) and column t.
// Each K fragment, split once, serves the MT m-tiles.
template <int MT, int NT, int DT, int LD, class KLoad>
__device__ __forceinline__ void tile_scores(float (&s)[MT][NT][4],
                                            const float* qh, const float* ql,
                                            KLoad k) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      s[m][j][0] = s[m][j][1] = s[m][j][2] = s[m][j][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DT; ++kd) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int o16 = 16 * m * LD + 8 * kd;
      ah[m][0] = __float_as_uint(qh[o16]);
      ah[m][1] = __float_as_uint(qh[o16 + 8 * LD]);
      ah[m][2] = __float_as_uint(qh[o16 + 4]);
      ah[m][3] = __float_as_uint(qh[o16 + 8 * LD + 4]);
      al[m][0] = __float_as_uint(ql[o16]);
      al[m][1] = __float_as_uint(ql[o16 + 8 * LD]);
      al[m][2] = __float_as_uint(ql[o16 + 4]);
      al[m][3] = __float_as_uint(ql[o16 + 8 * LD + 4]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh[2], bl[2];
      split(k(8 * j + g, 8 * kd + t), bh[0], bl[0]);
      split(k(8 * j + g, 8 * kd + t + 4), bh[1], bl[1]);
#pragma unroll
      for (int m = 0; m < MT; ++m) mma3(s[m][j], ah[m], al[m], bh, bl);
    }
  }
}

// Online softmax over a tile of masked scores (log2 units; -inf for keys
// that do not exist, which weigh exactly 0): the running max and this
// thread's share of the running sum move on, O is rescaled, and s becomes
// the tile's probabilities.  Every tile holds an existing key, so the new
// max is finite.
template <int MT, int NT, int DT>
__device__ __forceinline__ void tile_softmax(float (&s)[MT][NT][4],
                                             float (&o)[MT][DT][4],
                                             float (&m_run)[MT][2],
                                             float (&l_run)[MT][2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[m][j][0], s[m][j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[m][j][2], s[m][j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m_run[m][0], mx0), mn1 = fmaxf(m_run[m][1], mx1);
    const float al0 = exp2f(m_run[m][0] - mn0), al1 = exp2f(m_run[m][1] - mn1);
    m_run[m][0] = mn0;
    m_run[m][1] = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[m][j][0] = exp2f(s[m][j][0] - mn0);
      s[m][j][1] = exp2f(s[m][j][1] - mn0);
      s[m][j][2] = exp2f(s[m][j][2] - mn1);
      s[m][j][3] = exp2f(s[m][j][3] - mn1);
      ps0 += s[m][j][0] + s[m][j][1];
      ps1 += s[m][j][2] + s[m][j][3];
    }
    // this thread's columns; quad-summed at the end
    l_run[m][0] = l_run[m][0] * al0 + ps0;
    l_run[m][1] = l_run[m][1] * al1 + ps1;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o[m][n][0] *= al0;
      o[m][n][1] *= al0;
      o[m][n][2] *= al1;
      o[m][n][3] *= al1;
    }
  }
}

// O += P V.  k-slots (t, t+4) of key group j hold keys (2t, 2t+1), so the
// product reads V rows 2t and 2t + 1 (a permutation of the sum, no
// shuffle); each V fragment, split once, serves the MT m-tiles.
template <int MT, int NT, int DT, class VLoad>
__device__ __forceinline__ void tile_pv(float (&o)[MT][DT][4],
                                        const float (&s)[MT][NT][4],
                                        VLoad v) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      split(s[m][j][0], ph[m][0], pl[m][0]);
      split(s[m][j][2], ph[m][1], pl[m][1]);
      split(s[m][j][1], ph[m][2], pl[m][2]);
      split(s[m][j][3], ph[m][3], pl[m][3]);
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      uint32_t bh[2], bl[2];
      split(v(8 * j + 2 * t, 8 * n + g), bh[0], bl[0]);
      split(v(8 * j + 2 * t + 1, 8 * n + g), bh[1], bl[1]);
#pragma unroll
      for (int m = 0; m < MT; ++m) mma3(o[m][n], ph[m], pl[m], bh, bl);
    }
  }
}

// One warp merges the nsplit partials of one output row by their
// log-sum-exp, in split order (deterministic, no atomics): part_o
// (nsplit, nrows, Dh) unnormalised, part_ml (nsplit, nrows, 2) the running
// max (log2 units) and sum; out in fp32 or bf16 (rounded once).
template <class TO>
__device__ __forceinline__ void merge_splits(const float* part_o,
                                             const float* part_ml, TO* out,
                                             size_t nrows, size_t row, int Dh,
                                             int nsplit, int lane) {
  float m = -INFINITY;
  for (int s = 0; s < nsplit; ++s)
    m = fmaxf(m, part_ml[2 * (s * nrows + row)]);
  float l = 0.f;
  for (int s = 0; s < nsplit; ++s)
    l += part_ml[2 * (s * nrows + row) + 1] *
         exp2f(part_ml[2 * (s * nrows + row)] - m);
  const float inv = 1.f / l;
  for (int d = lane; d < Dh; d += 32) {
    float acc = 0.f;
    for (int s = 0; s < nsplit; ++s)
      acc += part_o[(s * nrows + row) * Dh + d] *
             exp2f(part_ml[2 * (s * nrows + row)] - m);
    store1(out + row * Dh + d, acc * inv);
  }
}

}  // namespace
