// RWKV6 (Finch) recurrence for Hopper (sm_90a), one token at a time:
//
//   out_t = r_t S_{t-1} + ((r_t * u) . k_t) v_t
//   S_t   = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
//
// over r, k, v, logw (B, L, H, hd), u (H, hd), the carried state s0
// (B, H, hd, hd) -> out (B, L, H, hd), sT (B, H, hd, hd).  r, k, v and out
// are fp32 or bf16 (one instantiation each); logw, u, s0 and sT are fp32.
// As the Pallas kernel, bf16 r, k and v are widened to fp32 (exactly), the
// recurrence runs in fp32 and out is rounded to bf16 once, where it is
// written; the state stays fp32.
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
// rate, so the card's memory rate bounds it.  In practice a prefill is
// bound by issue: each token of each (row, head) takes 3 * hd^2 fp32
// instructions on the CUDA cores (below) and the tokens run in order; a
// decode step is bound by moving the state.
//
// Design.
//  * Column split.  Column j of S and out[:, j] depend on r, k, w, u and
//    v[:, j] only, so a (row, head) splits exactly over HD / CB blocks of
//    CB columns, with no merge.  Cfg sets CB per head dim: hd 128 runs 2
//    blocks of 64 columns; hd 64 runs one block of all 64, which measured
//    faster on the card than 2 blocks of 32 (a split stages r, k and w
//    and runs the staging pass once per block, and 256 blocks of 4 warps
//    already fill the SMs at rwkv6-7b's 4 rows).
//  * The state lives in registers for the whole sequence.  Thread (cg,
//    rg) holds a KPT x CPT tile of S: rows rg * KPT + [0, KPT), columns
//    CPT * cg + [0, CPT) of the block's CB.  It reads its rows' r, k and w
//    as 16-byte shared loads and its columns of v likewise: 3 * KPT / 4 +
//    CPT / 4 loads for 3 * KPT * CPT operations a token (the per-column
//    layout before took ~49 scalar loads for 64).  Each row group's KPT
//    floats are padded by 4, so the row groups of a warp fall on distinct
//    banks.
//  * Three instructions an element.  The bonus (r_t * u) . k_t is one
//    scalar a token, summed in the staging pass, so a thread's token is
//    acc += r_i S_ij (one FMA) and S_ij = S_ij w_i + k_i v_j (a multiply
//    and an FMA).  The threads' partial sums go to shared memory, and at
//    the tile's end out = sum over row groups (in order) + bonus * v.
//    The token loop is unrolled by two, so two tokens' loads and
//    arithmetic interleave.
//  * Double-buffered staging.  Tokens come TT at a time through a
//    two-stage cp.async ring: tile t + 1 lands while tile t is scanned.
//    The staging pass of a landed tile takes exp(logw) in place and the
//    tile's bonuses.  The state moves with 16-byte coalesced loads and
//    stores.
//  * bf16 operands.  cp.async copies bytes and cannot widen, so bf16 rows
//    of r, k and v land as loaded in a raw stage of their own (half the
//    bytes of fp32), and the staging pass widens them into the fp32 tile
//    the scan reads (one more barrier a tile); logw lands in fp32 as
//    before.  The scan itself is the fp32 one.
// The per-token form is the definition (the sequential oracle
// ``rwkv6_ref``): it takes any L with no chunk rule, and its decay is one
// exp per token and channel, never a difference of cumulative sums, which
// loses digits as the sums grow and overflows exp() past ~88 nats of
// decay.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tf32.cuh"     // cp_async16 / commit / wait

namespace {

// per head dim: columns a block (CB), row groups (RG), columns a thread
// (CPT), tokens a stage (TT); rows a thread KPT = HD / RG (kernels/rwkv6.py
// PLAN)
template <int HD> struct Cfg;
template <> struct Cfg<16> { static constexpr int CB = 16, RG = 4, CPT = 4, TT = 8; };
template <> struct Cfg<32> { static constexpr int CB = 32, RG = 4, CPT = 4, TT = 8; };
template <> struct Cfg<64> { static constexpr int CB = 64, RG = 8, CPT = 4, TT = 16; };
template <> struct Cfg<128> { static constexpr int CB = 64, RG = 16, CPT = 4, TT = 8; };

// T: the type of r, k, v and out (float or bf16)
template <int HD, typename T> struct Shape {
  static constexpr int CB = Cfg<HD>::CB, RG = Cfg<HD>::RG, KPT = HD / RG;
  static constexpr int CPT = Cfg<HD>::CPT, C4 = CPT / 4, TT = Cfg<HD>::TT;
  static constexpr int NQ = CB / 4;              // column quads a block
  static constexpr int NC = CB / CPT;            // column groups a block
  static constexpr int kThreads = NC * RG;
  static constexpr int RS = RG * (KPT + 4);      // padded (r, k, w) token row
  static constexpr int SF = TT * (3 * RS + CB);  // floats a stage
  static constexpr bool kF32 = std::is_same<T, float>::value;
  // bf16 a raw stage: r and k rows (HD each) and v's CB columns, as loaded
  static constexpr int SR = kF32 ? 0 : TT * (2 * HD + CB);
  // two stages, the partial sums (TT x RG x CB), the bonuses, u; bf16: two
  // raw stages
  static constexpr int kSmem =
      4 * (2 * SF + TT * RG * CB + TT + HD) + 2 * (int)sizeof(T) * SR;
  static_assert(KPT % 4 == 0 && CPT % 4 == 0 && HD % CB == 0 &&
                CB % CPT == 0 && kThreads >= TT, "shape");
};

struct Args {
  const void* r;        // r, k, v, out: float or bf16 (the kernel's T)
  const void* k;
  const void* v;
  const float* logw;
  const float* u;
  const float* s0;
  void* out;
  float* sT;
  int L, H;
};

// four fp32 values stored as T (bf16: rounded to nearest even)
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<const unsigned*>(&lo),
      *reinterpret_cast<const unsigned*>(&hi));
}

// four consecutive bf16 values (8-byte aligned) widened to fp32, exactly
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// element e of a token's (r, k, w) row in the padded layout
template <int KPT>
__device__ __forceinline__ int padded(int e) {
  return (e / KPT) * (KPT + 4) + e % KPT;
}

// Issue the copies of tokens [t0, t0 + TT) into stage st: r, k, logw whole
// (padded rows), v's CB columns from c0; past L, zeros.  bf16 r, k and v
// go to the raw stage raw as loaded (rows of HD, HD and CB values).
template <int HD, typename T>
__device__ __forceinline__ void stage_tile(const Args& a, float* st, T* raw,
                                           int b, int h, int c0, int t0) {
  using S = Shape<HD, T>;
  constexpr int H4 = HD / 4, TT = S::TT;
  const T* r = static_cast<const T*>(a.r);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  for (int i = threadIdx.x; i < TT * H4; i += S::kThreads) {
    const int t = i / H4, c = 4 * (i % H4);
    const bool ok = t0 + t < a.L;
    const size_t off =
        ((size_t)(b * a.L + (ok ? t0 + t : 0)) * a.H + h) * HD + c;
    float* dst = st + t * S::RS + padded<S::KPT>(c);
    if constexpr (S::kF32) {
      cp_async16(dst, r + off, ok);
      cp_async16(dst + TT * S::RS, k + off, ok);
    } else if (c % 8 == 0) {     // 16 bytes: eight bf16 values
      cp_async16(raw + t * HD + c, r + off, ok);
      cp_async16(raw + (TT + t) * HD + c, k + off, ok);
    }
    cp_async16(dst + 2 * TT * S::RS, a.logw + off, ok);
  }
  constexpr int VQ = S::kF32 ? S::NQ : S::CB / 8;   // 16-byte copies a row
  constexpr int VE = 16 / (int)sizeof(T);
  for (int i = threadIdx.x; i < TT * VQ; i += S::kThreads) {
    const int t = i / VQ, c = VE * (i % VQ);
    const bool ok = t0 + t < a.L;
    const size_t off =
        ((size_t)(b * a.L + (ok ? t0 + t : 0)) * a.H + h) * HD + c0 + c;
    if constexpr (S::kF32)
      cp_async16(st + 3 * TT * S::RS + t * S::CB + c, v + off, ok);
    else
      cp_async16(raw + 2 * TT * HD + t * S::CB + c, v + off, ok);
  }
  cp_async_commit();
}

template <int HD, typename T>
__global__ void __launch_bounds__(Shape<HD, T>::kThreads) rwkv6_scan(Args a) {
  using S = Shape<HD, T>;
  constexpr int CB = S::CB, RG = S::RG, KPT = S::KPT, NQ = S::NQ;
  constexpr int CPT = S::CPT, C4 = S::C4, NC = S::NC, TT = S::TT;
  constexpr int RS = S::RS, SF = S::SF, NT = S::kThreads;
  constexpr int TPT = NT / TT;          // threads a token's bonus
  constexpr int EPT = HD / TPT;         // elements each sums
  constexpr unsigned kMask = NT >= 32 ? 0xffffffffu : (1u << NT) - 1u;
  static_assert(EPT % 4 == 0 && TPT <= 32, "bonus split");
  extern __shared__ float4 smem4[];
  float* stages = reinterpret_cast<float*>(smem4);
  float* part = stages + 2 * SF;                 // TT x RG x CB
  float* bonus = part + TT * RG * CB;            // TT
  float* su = bonus + TT;                        // HD
  T* raws = reinterpret_cast<T*>(su + HD);       // bf16: two raw stages

  const int cs = HD / CB;
  const int bh = blockIdx.x / cs, c0 = (blockIdx.x % cs) * CB;
  const int b = bh / a.H, h = bh % a.H;
  const int tid = threadIdx.x, cg = tid % NC, rg = tid / NC;
  const int ntiles = (a.L + TT - 1) / TT;
  stage_tile<HD, T>(a, stages, raws, b, h, c0, 0);

  for (int i = tid; i < HD; i += NT) su[i] = a.u[h * HD + i];
  float4 s[KPT][C4];
  const float* s_in = a.s0 + ((size_t)bh * HD + rg * KPT) * HD + c0 + CPT * cg;
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int j = 0; j < C4; ++j)
      s[i][j] = reinterpret_cast<const float4*>(s_in + (size_t)i * HD)[j];

  for (int j = 0; j < ntiles; ++j) {
    const int t0 = j * TT, n = min(TT, a.L - t0);
    cp_async_wait<0>();
    __syncthreads();     // tile j landed; stage j + 1 and the partials free
    if (j + 1 < ntiles)
      stage_tile<HD, T>(a, stages + ((j + 1) & 1) * SF,
                        raws + ((j + 1) & 1) * S::SR, b, h, c0, t0 + TT);
    float* sr = stages + (j & 1) * SF;
    float* sk = sr + TT * RS;
    float* sw = sk + TT * RS;
    float* sv = sw + TT * RS;

    // staging pass: w = exp(logw) in place (bf16: r, k and v widened into
    // the fp32 tile first); bonus_t = (r_t * u) . k_t
    const T* raw = raws + (j & 1) * S::SR;
    for (int i = tid; i < TT * (HD / 4); i += NT) {
      const int t = i / (HD / 4), e = 4 * (i % (HD / 4));
      const int p = t * RS + padded<KPT>(e);
      float4* w = reinterpret_cast<float4*>(sw + p);
      float4 x = *w;
      x.x = expf(x.x); x.y = expf(x.y); x.z = expf(x.z); x.w = expf(x.w);
      *w = x;
      if constexpr (!S::kF32) {
        *reinterpret_cast<float4*>(sr + p) = widen4(raw + t * HD + e);
        *reinterpret_cast<float4*>(sk + p) = widen4(raw + (TT + t) * HD + e);
      }
    }
    if constexpr (!S::kF32) {
      for (int i = tid; i < TT * NQ; i += NT) {
        const int t = i / NQ, c = 4 * (i % NQ);
        *reinterpret_cast<float4*>(sv + t * CB + c) =
            widen4(raw + 2 * TT * HD + t * CB + c);
      }
      __syncthreads();   // the widened r and k ready for the bonuses
    }
    {
      const int t = tid / TPT, e0 = (tid % TPT) * EPT;
      float acc = 0.f;
#pragma unroll
      for (int e = e0; e < e0 + EPT; e += 4) {
        const int p = t * RS + padded<KPT>(e);
        const float4 r4 = *reinterpret_cast<const float4*>(sr + p);
        const float4 k4 = *reinterpret_cast<const float4*>(sk + p);
        const float4 u4 = *reinterpret_cast<const float4*>(su + e);
        acc += r4.x * u4.x * k4.x + r4.y * u4.y * k4.y + r4.z * u4.z * k4.z +
               r4.w * u4.w * k4.w;
      }
#pragma unroll
      for (int o = 1; o < TPT; o <<= 1)
        acc += __shfl_xor_sync(kMask, acc, o);
      if (tid % TPT == 0) bonus[t] = acc;
    }
    __syncthreads();     // w and the bonuses ready

    // the scan: rows rg * KPT + [0, KPT), columns CPT * cg + [0, CPT)
    const float* rrow = sr + rg * (KPT + 4);
    const float* krow = sk + rg * (KPT + 4);
    const float* wrow = sw + rg * (KPT + 4);
#pragma unroll 2
    for (int t = 0; t < n; ++t) {
      float4 vv[C4], acc[C4];
#pragma unroll
      for (int j = 0; j < C4; ++j) {
        vv[j] = reinterpret_cast<const float4*>(sv + t * CB + CPT * cg)[j];
        acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i4 = 0; i4 < KPT / 4; ++i4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rrow + t * RS + 4 * i4);
        const float4 k4 = *reinterpret_cast<const float4*>(krow + t * RS + 4 * i4);
        const float4 w4 = *reinterpret_cast<const float4*>(wrow + t * RS + 4 * i4);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < C4; ++j) {
            float4& x = s[4 * i4 + e][j];
            acc[j].x = fmaf(rr[e], x.x, acc[j].x);
            acc[j].y = fmaf(rr[e], x.y, acc[j].y);
            acc[j].z = fmaf(rr[e], x.z, acc[j].z);
            acc[j].w = fmaf(rr[e], x.w, acc[j].w);
            x.x = fmaf(x.x, ww[e], kk[e] * vv[j].x);
            x.y = fmaf(x.y, ww[e], kk[e] * vv[j].y);
            x.z = fmaf(x.z, ww[e], kk[e] * vv[j].z);
            x.w = fmaf(x.w, ww[e], kk[e] * vv[j].w);
          }
      }
#pragma unroll
      for (int j = 0; j < C4; ++j)
        reinterpret_cast<float4*>(part + (t * RG + rg) * CB + CPT * cg)[j] =
            acc[j];
    }
    __syncthreads();     // the tile's partial sums complete

    // out = the row groups' partials, in order, + bonus * v
    for (int i = tid; i < n * NQ; i += NT) {
      const int t = i / NQ, c = 4 * (i % NQ);
      float4 o = *reinterpret_cast<const float4*>(part + t * RG * CB + c);
#pragma unroll
      for (int g = 1; g < RG; ++g) {
        const float4 p = *reinterpret_cast<const float4*>(
            part + (t * RG + g) * CB + c);
        o.x += p.x; o.y += p.y; o.z += p.z; o.w += p.w;
      }
      const float4 vv = *reinterpret_cast<const float4*>(sv + t * CB + c);
      const float bt = bonus[t];
      o.x = fmaf(bt, vv.x, o.x); o.y = fmaf(bt, vv.y, o.y);
      o.z = fmaf(bt, vv.z, o.z); o.w = fmaf(bt, vv.w, o.w);
      store4(static_cast<T*>(a.out) +
                 ((size_t)(b * a.L + t0 + t) * a.H + h) * HD + c0 + c,
             o);
    }
  }
  float* s_out = a.sT + ((size_t)bh * HD + rg * KPT) * HD + c0 + CPT * cg;
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int j = 0; j < C4; ++j)
      reinterpret_cast<float4*>(s_out + (size_t)i * HD)[j] = s[i][j];
}

template <int HD, typename T>
int launch(const Args& a, int B, cudaStream_t st) {
  using S = Shape<HD, T>;
  static bool allowed = false;       // above 48 KB: once a process
  if (S::kSmem > 48 * 1024 && !allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        rwkv6_scan<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::kSmem);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  rwkv6_scan<HD, T>
      <<<B * a.H * (HD / S::CB), S::kThreads, S::kSmem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const Args& a, int B, int HD, cudaStream_t st) {
  switch (HD) {
    case 16: return launch<16, T>(a, B, st);
    case 32: return launch<32, T>(a, B, st);
    case 64: return launch<64, T>(a, B, st);
    case 128: return launch<128, T>(a, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// All pointers 16-byte aligned and contiguous; r, k, v and out fp32
// (bf16 = 0) or bf16 (1); HD one of 16, 32, 64, 128 (else returns
// cudaErrorInvalidValue); L >= 1.
extern "C" int rwkv6_forward(const void* r, const void* k, const void* v,
                             const float* logw, const float* u,
                             const float* s0, void* out, float* sT, int B,
                             int L, int H, int HD, int bf16, void* stream) {
  if (L < 1 || B < 1 || H < 1 || (bf16 != 0 && bf16 != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{r, k, v, logw, u, s0, out, sT, L, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_hd<__nv_bfloat16>(a, B, HD, st)
              : launch_hd<float>(a, B, HD, st);
}
