// Fused RSA demux exit for Hopper (sm_90a), a pipelined weight stream:
//
//   out[n, t] = LN_exit( gelu_tanh( norm(h[t]) @ W1h + kb[n] ) @ W2 + b2 )
//   kb = k @ W1k + b1
//
// Replaces the Pallas TPU kernel src/repro/kernels/demux_rsa.py
// (demux_rsa / _kernel_full) with its fused entry norm (the backbone's
// final norm: RMSNorm, or LayerNorm with a bias) and exit LayerNorm (the
// demux's own).  The reference leaves kb to XLA; here it is streamed in
// the first launch beside W1h.
//
// Layouts: h (T, D); k (N, D); W1h, W1k (D, F); b1 (F,); W2 (F, D);
// b2 (D,); out (N, T, D).  These are all fp32 (D and F multiples of 4) or
// all bf16 (multiples of 8); the entry and exit norm params are fp32.
//
// bf16 rounds where the Pallas kernel rounds (its block_f = 512): kb =
// bf16(bf16(k @ W1k) + b1), as the reference computes kb outside its
// kernel in bf16; the entry norm, both products and GELU in fp32; the
// output rounded to bf16 after + b2 with the first 512-column F tile's
// product and after each further tile's, in tile order; the exit LayerNorm
// in fp32 on that, rounded once.  A 16-byte copy of a weight chunk carries
// 8 bf16 values instead of 4 fp32 ones, halving the bytes streamed.
//
// Bound.  Bytes: the three weight matrices, 3*D*F*4 = 56.6 MB at
// qwen2-1.5b's width in fp32, 28.3 MB in bf16 (F = 2D; 403 MB at rwkv6-7b's
// D = 4096), against
// ~2*D*F*(T*(1 + N) + N) flops: ~2 flops a byte at a decode step
// (T = 4), ~16 at a 32-token chunk, near the CUDA cores' fp32 balance
// (~20) but far below that of the 3xTF32 tensor-core route (~49).  So
// bytes bound it, and the design is about streaming each weight matrix
// from HBM once, at full rate, with the products off the critical path.
//
// Design.  Three launches (two without the exit LayerNorm), one
// torch.empty of scratch and a cached zeroed counter buffer (the
// wrapper's).
//  1. demux_hidden_kernel, grid (F tiles of 64 columns, S1 depth slices,
//     row jobs).  A row job is up to 32 rows of h against W1h (job 0 also
//     carries the LN entry's two affine rows, scale and bias), or up to 32
//     rows of k against W1k.  The block stages its rows' depth slice in
//     shared memory once, then streams its W slice 16 bytes a thread
//     through a four-stage cp.async ring (three 8 KB tiles in flight while
//     one is consumed).  While T <= 32 and N <= 32 every row shares one
//     pass, so W1h and W1k are read from HBM once.  Few rows (a decode
//     step, bound by its bytes) run on the CUDA cores, the chunk's depth
//     split over the threads so that no weight is read twice from shared
//     memory; more rows (a prefill chunk, bound by fp32 products on the
//     CUDA cores) run on the tensor cores, mma.sync TF32 in the 3xTF32
//     split of flash_attention.cu (fp32 accuracy).
//     The entry norm is folded in: the RMS entry stages h * (1 + scale)
//     and its rsqrt(mean(h^2)) per row is applied after the sum; the LN
//     entry stages (h - c) * scale, c the row's mean over the slice (so no
//     large offset reaches the sum), and the affine rows give sum(scale *
//     W) and sum(bias * W) per column, from which the row's full mean and
//     variance (merged from the slices' (c, M2)) finish the norm.  Each
//     block writes its partial sums; the last block of an F tile to arrive
//     (an integer counter, no float atomics) adds the S1 partials in slice
//     order, applies the norm, + kb, GELU -> g (N, T, F), and resets the
//     counter.
//  2. demux_out_kernel, grid (D tiles of 64 columns, S2 slices of F, row
//     jobs of 64 of the N*T rows of g): the same stream over W2, with the
//     rows of g streamed through the ring beside it (so S2 is not forced
//     up by shared memory) -> S2 partials; the last block of a D tile adds
//     them in slice order + b2 (into out, or for the exit LayerNorm into
//     the first partial slice); in bf16 the slices are whole parts of the
//     512-column F tiles (the wrapper's plan), summed in fp32 within a tile
//     and rounded at each tile's end.  While N*T <= 64 W2 is read from HBM
//     once.
//  3. demux_exit_kernel (exit LayerNorm only), one block per output row.
// The split counts S1, S2 (the wrapper's plan, kernels/demux_rsa.py) give
// ~2 blocks an SM in one wave with partial sums under a quarter of the
// weight bytes; results do not depend on which block arrives last, so
// they are deterministic.
#include <cuda_bf16.h>

#include <type_traits>

#include "tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCB = 64;          // columns per block tile (16 x float4)
constexpr int kKC = 32;          // depth rows per ring stage
constexpr int kStages = 4;       // ring depth
constexpr int kMinBlocks = 2;    // blocks an SM the streams are sized for
constexpr int kRowsH = 32;       // rows of h or k per job (first product)
constexpr int kRowsG = 64;       // rows of g per job (second product)
constexpr int kMaxSplit = 32;    // S1: one warp lane per slice
constexpr int kRPT = 8;          // rows per thread in the CUDA-core stream
constexpr int kLDW = kCB + 8;    // W stage row stride: conflict-free mma loads
constexpr int kLDX = kKC + 4;    // streamed X stage row stride
constexpr int kExitThreads = 256;
constexpr int kFTile = 512;      // bf16: the output rounds every kFTile of F
// entry norm kinds (the wrapper's entry_kind None / 'rms' / 'ln')
constexpr int kEntryRms = 1, kEntryLn = 2;      // 0: no entry norm

struct Args {
  const void* h;             // h, k, the weights, b1, b2, out: float or bf16
  const void* k;
  const float* entry_scale;
  const float* entry_bias;
  const void* w1h;
  const void* w1k;
  const void* b1;
  const void* w2;
  const void* b2;
  const float* exit_scale;   // nullptr: no exit LayerNorm
  const float* exit_bias;
  float* zp;      // (S1, T + naff + N, F) partial sums of the first product
  float* st;      // (F tiles, S1, T, 2) per-slice row statistics
  float* g;       // (N, T, F)
  float* yp;      // (S2, N*T, D)
  void* out;      // (N, T, D)
  int* counter;   // (F tiles,) zero between calls
  int entry_kind, T, N, D, F, s1, len1, s2, len2;
};

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu(approximate=True)
  return x * (0.5f * (1.f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x)))));
}

// elements as fp32 (exactly): one, or four (16- or 8-byte aligned)
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// fp32 values stored as the output type (bf16: rounded to nearest even)
__device__ __forceinline__ void st1(float* p, float x) { *p = x; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<const unsigned*>(&lo),
      *reinterpret_cast<const unsigned*>(&hi));
}

// each component rounded to bf16 and back
__device__ __forceinline__ float4 round_bf16(float4 x) {
  return make_float4(__bfloat162float(__float2bfloat16_rn(x.x)),
                     __bfloat162float(__float2bfloat16_rn(x.y)),
                     __bfloat162float(__float2bfloat16_rn(x.z)),
                     __bfloat162float(__float2bfloat16_rn(x.w)));
}

template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void add4(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}


// Stage rows [0, R) of a depth slice: row r is src_r[d_lo .. d_lo + len)
// (zero past d_end), into sx with row stride len + 4.  One commit group.
template <class RowPtr>
__device__ void stage_rows(float* sx, int R, int len, int d_lo, int d_end,
                           RowPtr row_ptr) {
  const int ch = len / 4, ldx = len + 4;
  for (int i = threadIdx.x; i < R * ch; i += kThreads) {
    const int r = i / ch, c = i % ch, d = d_lo + 4 * c;
    const bool ok = d < d_end;
    cp_async16(sx + r * ldx + 4 * c, row_ptr(r) + (ok ? d : d_lo), ok);
  }
  cp_async_commit();
}

// eight bf16 values (16-byte aligned) as fp32, exactly
__device__ __forceinline__ void widen8(const __nv_bfloat16* p, float4& lo,
                                       float4& hi) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.z));
  const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.w));
  lo = make_float4(a.x, a.y, b.x, b.y);
  hi = make_float4(c.x, c.y, d.x, d.y);
}

// The same from rows of bf16 (or mixed) elements, widened to fp32 as they
// are loaded: load8(r, d, lo, hi) reads row r's 8 elements at depth d.
// Each thread issues four 16-byte loads before it stores any, so their
// latencies overlap.  One (empty) commit group, so the ring's group count
// is that of stage_rows.
template <class Load8>
__device__ void stage_rows_widened(float* sx, int R, int len, int d_lo,
                                   int d_end, Load8 load8) {
  constexpr int U = 4;
  const int ch = len / 8, ldx = len + 4, n = R * ch;
  for (int i0 = threadIdx.x; i0 < n; i0 += U * kThreads) {
    float4 v[U][2];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads, d = d_lo + 8 * (i % ch);
      v[u][0] = v[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n && d < d_end) load8(i / ch, d, v[u][0], v[u][1]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= n) break;
      float* dst = sx + (i / ch) * ldx + 8 * (i % ch);
      *reinterpret_cast<float4*>(dst) = v[u][0];
      *reinterpret_cast<float4*>(dst + 4) = v[u][1];
    }
  }
  cp_async_commit();
}

// Rows [0, R) of x[r][d0 .. d0 + kKC) (zero past d_end) into a ring
// stage's X tile, row stride kLDX.  Part of the chunk's commit group.
template <class RowPtr>
__device__ void load_x(float* sx, int R, int d0, int d_end, RowPtr row_ptr) {
  constexpr int ch = kKC / 4;
  for (int i = threadIdx.x; i < R * ch; i += kThreads) {
    const int r = i / ch, c = i % ch, d = d0 + 4 * c;
    const bool ok = d < d_end;
    cp_async16(sx + r * kLDX + 4 * c, row_ptr(r) + (ok ? d : 0), ok);
  }
}

// W[d][c0 .. c0 + kCB) for depth rows d0 .. d0 + kKC (zero past d_end or
// ncol) into a ring stage's W tile of elements as stored, row stride kLDW
// elements; 16-byte copies of 4 fp32 or 8 bf16 values.
template <typename T>
__device__ void load_w(T* sw, const T* w, int ncol, int c0, int d0,
                       int d_end) {
  constexpr int E = 16 / sizeof(T), ch = kCB / E;
  for (int i = threadIdx.x; i < kKC * ch; i += kThreads) {
    const int r = i / ch, c = i % ch, d = d0 + r, col = c0 + E * c;
    const bool ok = d < d_end && col < ncol;
    cp_async16(sw + r * kLDW + E * c,
               w + (ok ? (size_t)d * ncol + col : 0), ok);
  }
}

// The ring loop over a slice's nch depth chunks: chunk c waits in its
// stage, the copy of chunk c + kStages - 1 is issued (``issue`` commits
// one group, empty past the slice), then ``body(c)`` consumes chunk c.
template <class Issue, class Body>
__device__ void ring_loop(int nch, Issue issue, Body body) {
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();            // chunk c landed; chunk c - 1 consumed
    issue(c + kStages - 1);
    body(c);
  }
  cp_async_wait<0>();
  __syncthreads();              // the ring is free
}

// CUDA-core stream (few rows: the decode step, bound by its bytes).
// Thread tile: 4 columns (cg) x kRPT rows rg + RG * i, over the depth rows
// kk = kg (mod KG) of each chunk; RG row groups x KG depth groups x kCB / 4
// column groups = kThreads, so few rows split a chunk's depth over the
// threads instead of re-reading it from shared memory once per row group.
// The KG partial tiles are added in kg order in the freed ring.
// xs(c): row 0 of X at chunk c, row stride ldx; ws(c): chunk c's W tile.
template <int RG, class XS, class WS, class Issue, class Dst>
__device__ void stream_fma(int R, int ldx, int nch, XS xs, WS ws,
                           Issue issue, float* sring, int ncol, int c0,
                           Dst dst) {
  constexpr int CG = kCB / 4, KG = kThreads / CG / RG;
  const int tid = threadIdx.x, cg = tid % CG, rest = tid / CG;
  const int rg = rest % RG, kg = rest / RG;
  const bool active = kg < KG;
  int xoff[kRPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) xoff[i] = min(rg + RG * i, R - 1) * ldx;
  float acc[kRPT][4];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  ring_loop(nch, issue, [&](int c) {
    if (!active) return;
    const auto* sw = ws(c) + 4 * cg;
    const float* xb = xs(c);
#pragma unroll 8
    for (int kk = kg; kk < kKC; kk += KG) {
      const float4 wv = ld4(sw + kk * kLDW);
#pragma unroll
      for (int i = 0; i < kRPT; ++i) {
        const float x = xb[xoff[i] + kk];
        acc[i][0] += x * wv.x;
        acc[i][1] += x * wv.y;
        acc[i][2] += x * wv.z;
        acc[i][3] += x * wv.w;
      }
    }
  });
  float* red = sring;           // KG x R x kCB
  if (active) {
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      const int r = rg + RG * i;
      if (r < R)
        *reinterpret_cast<float4*>(red + ((size_t)kg * R + r) * kCB + 4 * cg) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < R * (kCB / 4); i += kThreads) {
    const int r = i / (kCB / 4), c4 = 4 * (i % (kCB / 4));
    if (c0 + c4 >= ncol) continue;
    float4 v = *reinterpret_cast<const float4*>(red + (size_t)r * kCB + c4);
    for (int q = 1; q < KG; ++q) {
      const float4 u =
          *reinterpret_cast<const float4*>(red + ((size_t)q * R + r) * kCB + c4);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    *reinterpret_cast<float4*>(dst(r) + c4) = v;
  }
}

// Tensor-core stream (many rows: a prefill chunk, bound by its fp32
// products on the CUDA cores): mma.sync m16n8k8 TF32 in the fp32-exact
// split (hi*hi + hi*lo + lo*hi, as the flash kernel), each operand split
// in registers as it is loaded.  Warp (wm, wn) of WM x (8 / WM) holds
// rows 16 wm .. 16 wm + 15 against kCB / (8 / WM) columns.
template <int WM, class XS, class WS, class Issue, class Dst>
__device__ void stream_mma(int R, int ldx, int nch, XS xs, WS ws,
                           Issue issue, int ncol, int c0, Dst dst) {
  constexpr int WN = 8 / WM, NTW = kCB / 8 / WN;  // n-tiles (8 columns) a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp % WM), n0 = 8 * NTW * (warp / WM);
  const bool active = m0 < R;
  const int ra = min(m0 + g, R - 1) * ldx, rb = min(m0 + g + 8, R - 1) * ldx;
  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  ring_loop(nch, issue, [&](int c) {
    if (!active) return;
    const float* x = xs(c) + t;
    const auto* w = ws(c) + t * kLDW + n0 + g;
#pragma unroll
    for (int ks = 0; ks < kKC / 8; ++ks) {
      uint32_t ah[4], al[4];
      split(x[ra + 8 * ks], ah[0], al[0]);
      split(x[rb + 8 * ks], ah[1], al[1]);
      split(x[ra + 8 * ks + 4], ah[2], al[2]);
      split(x[rb + 8 * ks + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        uint32_t bh[2], bl[2];
        split(to_f(w[8 * ks * kLDW + 8 * j]), bh[0], bl[0]);
        split(to_f(w[(8 * ks + 4) * kLDW + 8 * j]), bh[1], bl[1]);
        mma3(acc[j], ah, al, bh, bl);
      }
    }
  });
  if (!active) return;
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (c0 + col >= ncol) continue;
    if (m0 + g < R)
      *reinterpret_cast<float2*>(dst(m0 + g) + col) =
          make_float2(acc[j][0], acc[j][1]);
    if (m0 + g + 8 < R)
      *reinterpret_cast<float2*>(dst(m0 + g + 8) + col) =
          make_float2(acc[j][2], acc[j][3]);
  }
}

template <class XS, class WS, class Issue, class Dst>
__device__ void stream(int R, int ldx, int nch, XS xs, WS ws, Issue issue,
                       float* sring, int ncol, int c0, Dst dst) {
  if (R <= kRPT)
    stream_fma<1>(R, ldx, nch, xs, ws, issue, sring, ncol, c0, dst);
  else if (R <= 2 * kRPT)
    stream_fma<2>(R, ldx, nch, xs, ws, issue, sring, ncol, c0, dst);
  else if (R <= 32)
    stream_mma<2>(R, ldx, nch, xs, ws, issue, ncol, c0, dst);
  else
    stream_mma<4>(R, ldx, nch, xs, ws, issue, ncol, c0, dst);
}

// After this block's partial sums are written: true in the block that
// completes ``expected`` arrivals at ``counter`` (every thread sees it),
// with the other blocks' writes visible to it.
__device__ bool last_to_arrive(int* counter, int expected) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == expected - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) demux_hidden_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* sring = reinterpret_cast<float*>(smem4);     // kStages x kKC x kLDW
  float* sx = sring + kStages * kKC * kLDW;           // rows x (len1 + 4)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ft = blockIdx.x, f0 = ft * kCB, s = blockIdx.y, job = blockIdx.z;
  const int d_lo = s * a.len1, d_end = min(a.D, d_lo + a.len1);
  const int hjobs = (a.T + kRowsH - 1) / kRowsH;
  const int naff = a.entry_kind == kEntryLn ? 2 : 0;
  const int rv = a.T + naff + a.N;                    // rows of zp
  float* zp = a.zp + (size_t)s * rv * a.F + f0;
  const int ldx = a.len1 + 4, nch = (d_end - d_lo + kKC - 1) / kKC;
  const T* w = static_cast<const T*>(job < hjobs ? a.w1h : a.w1k);
  auto wtile = [&](int c) {       // a stage's W tile, as stored
    return reinterpret_cast<T*>(sring + (c % kStages) * kKC * kLDW);
  };
  auto issue = [&](int c) {       // W chunks; the rows are staged whole
    if (c < nch) load_w(wtile(c), w, a.F, f0, d_lo + c * kKC, d_end);
    cp_async_commit();
  };
  auto xs = [&](int c) { return sx + c * kKC; };
  auto ws = [&](int c) { return static_cast<const T*>(wtile(c)); };
  const T* hv = static_cast<const T*>(a.h);
  const T* kv = static_cast<const T*>(a.k);

  if (job < hjobs) {          // rows of h (+ the LN affine rows) x W1h
    const int t0 = job * kRowsH, rows = min(kRowsH, a.T - t0);
    const int aff = job == 0 ? naff : 0, R = rows + aff;
    if constexpr (kBf16<T>)
      stage_rows_widened(sx, R, a.len1, d_lo, d_end,
                         [&](int r, int d, float4& lo, float4& hi) {
        if (r < rows) {
          widen8(hv + (size_t)(t0 + r) * a.D + d, lo, hi);
        } else {                        // the LN entry's affine rows, fp32
          const float* p = (r == rows ? a.entry_scale : a.entry_bias) + d;
          lo = ld4(p);
          hi = ld4(p + 4);
        }
      });
    else
      stage_rows(sx, R, a.len1, d_lo, d_end, [&](int r) {
        return r < rows ? hv + (size_t)(t0 + r) * a.D
                        : (r == rows ? a.entry_scale : a.entry_bias);
      });
    for (int c = 0; c < kStages - 1; ++c) issue(c);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (a.entry_kind) {       // per-row slice statistics, then the entry
      const int n = d_end - d_lo;
      for (int r = warp; r < rows; r += kThreads / 32) {
        float* x = sx + r * ldx;
        float c = 0.f, m2 = 0.f;
        if (a.entry_kind == kEntryLn) {
          for (int i = lane; i < n; i += 32) c += x[i];
          c = warp_sum(c) / n;
          for (int i = lane; i < n; i += 32) m2 += (x[i] - c) * (x[i] - c);
          m2 = warp_sum(m2);
          for (int i = lane; i < n; i += 32)
            x[i] = (x[i] - c) * a.entry_scale[d_lo + i];
        } else {
          for (int i = lane; i < n; i += 32) c += x[i] * x[i];
          c = warp_sum(c);
          for (int i = lane; i < n; i += 32)
            x[i] *= 1.f + a.entry_scale[d_lo + i];
        }
        if (lane == 0) {
          float* st = a.st + (((size_t)ft * a.s1 + s) * a.T + t0 + r) * 2;
          st[0] = c;
          st[1] = m2;
        }
      }
    }
    stream(R, ldx, nch, xs, ws, issue, sring, a.F, f0, [&](int r) {
      return zp + (size_t)(r < rows ? t0 + r : a.T + r - rows) * a.F;
    });
  } else {                    // rows of k x W1k
    const int n0 = (job - hjobs) * kRowsH, R = min(kRowsH, a.N - n0);
    if constexpr (kBf16<T>)
      stage_rows_widened(sx, R, a.len1, d_lo, d_end,
                         [&](int r, int d, float4& lo, float4& hi) {
        widen8(kv + (size_t)(n0 + r) * a.D + d, lo, hi);
      });
    else
      stage_rows(sx, R, a.len1, d_lo, d_end,
                 [&](int r) { return kv + (size_t)(n0 + r) * a.D; });
    for (int c = 0; c < kStages - 1; ++c) issue(c);
    stream(R, ldx, nch, xs, ws, issue, sring, a.F, f0, [&](int r) {
      return zp + (size_t)(a.T + naff + n0 + r) * a.F;
    });
  }

  // the last block of this F tile to arrive finishes it
  if (!last_to_arrive(a.counter + ft, a.s1 * gridDim.z)) return;
  __shared__ float s_inv[kRowsH], s_c[kRowsH][kMaxSplit];
  const int ncol = min(kCB, a.F - f0);
  const float* zs = a.zp + f0;
  const size_t slab = (size_t)rv * a.F;              // one slice of zp
  // four columns a thread (ncol is a multiple of 4); the q loops issue
  // their slices' loads together
  constexpr int C4 = kCB / 4;
  float4* skb = reinterpret_cast<float4*>(sring);  // kb, nb streams x C4
  const int nb = kStages * kKC * kLDW / kCB;
  for (int n0 = 0; n0 < a.N; n0 += nb) {
    const int nn = min(nb, a.N - n0);
    for (int i = tid; i < nn * C4; i += kThreads) {
      const int n = n0 + i / C4, c = 4 * (i % C4);
      if (c >= ncol) continue;
      const float4 b1 = ld4(static_cast<const T*>(a.b1) + f0 + c);
      float4 v = kBf16<T> ? make_float4(0.f, 0.f, 0.f, 0.f) : b1;
#pragma unroll 8
      for (int q = 0; q < a.s1; ++q)
        add4(v, ldcg4(zs + q * slab + (size_t)(a.T + naff + n) * a.F + c));
      if constexpr (kBf16<T>) {     // kb = bf16(bf16(k @ W1k) + b1)
        v = round_bf16(v);
        add4(v, b1);
        v = round_bf16(v);
      }
      skb[i] = v;
    }
    for (int t0 = 0; t0 < a.T; t0 += kRowsH) {
      const int rows = min(kRowsH, a.T - t0);
      // rows' statistics over the whole D row, merged from the slices
      for (int r = warp; r < rows && a.entry_kind; r += kThreads / 32) {
        const int q = lane, nq = min(a.len1, a.D - q * a.len1);
        float cq = 0.f, m2 = 0.f, mu = 0.f, inv;
        if (q < a.s1) {
          const float* st = a.st + (((size_t)ft * a.s1 + q) * a.T + t0 + r) * 2;
          cq = __ldcg(st);
          m2 = __ldcg(st + 1);
        }
        if (a.entry_kind == kEntryLn) {
          mu = warp_sum(q < a.s1 ? nq * cq : 0.f) / a.D;
          const float dv = cq - mu;
          inv = rsqrtf(warp_sum(q < a.s1 ? m2 + nq * dv * dv : 0.f) / a.D +
                       1e-6f);
          s_c[r][q] = cq - mu;
        } else {
          inv = rsqrtf(warp_sum(q < a.s1 ? cq : 0.f) / a.D + 1e-6f);
        }
        if (lane == 0) s_inv[r] = inv;
      }
      __syncthreads();
#pragma unroll 2
      for (int i = tid; i < rows * C4; i += kThreads) {
        const int r = i / C4, c = 4 * (i % C4), t = t0 + r;
        if (c >= ncol) continue;
        const float* p = zs + c;
        float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
        for (int q = 0; q < a.s1; ++q) add4(z, ldcg4(p + q * slab + (size_t)t * a.F));
        const float inv = a.entry_kind ? s_inv[r] : 1.f;
        if (a.entry_kind == kEntryLn) {
          float4 zb = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
          for (int q = 0; q < a.s1; ++q) {
            const float4 u = ldcg4(p + q * slab + (size_t)a.T * a.F);
            const float cm = s_c[r][q];
            z.x += cm * u.x;
            z.y += cm * u.y;
            z.z += cm * u.z;
            z.w += cm * u.w;
            add4(zb, ldcg4(p + q * slab + (size_t)(a.T + 1) * a.F));
          }
          z = make_float4(inv * z.x + zb.x, inv * z.y + zb.y,
                          inv * z.z + zb.z, inv * z.w + zb.w);
        } else {
          z = make_float4(inv * z.x, inv * z.y, inv * z.z, inv * z.w);
        }
        for (int n = n0; n < n0 + nn; ++n) {
          const float4 k4 = skb[(n - n0) * C4 + c / 4];
          *reinterpret_cast<float4*>(a.g + ((size_t)n * a.T + t) * a.F + f0 + c) =
              make_float4(gelu_tanh(z.x + k4.x), gelu_tanh(z.y + k4.y),
                          gelu_tanh(z.z + k4.z), gelu_tanh(z.w + k4.w));
        }
      }
      __syncthreads();
    }
  }
  if (tid == 0) a.counter[ft] = 0;     // ready for the next call
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) demux_out_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* sring = reinterpret_cast<float*>(smem4);     // stages: W, then g
  const int NT = a.N * a.T, tid = threadIdx.x;
  const int dt = blockIdx.x, d0 = dt * kCB, s = blockIdx.y;
  const int r0 = blockIdx.z * kRowsG, R = min(kRowsG, NT - r0);
  const int f_lo = s * a.len2, f_end = min(a.F, f_lo + a.len2);
  const int nch = (f_end - f_lo + kKC - 1) / kKC;
  const int stage = kKC * kLDW + min(NT, kRowsG) * kLDX;
  auto issue = [&](int c) {       // a chunk of W2 and of the rows of g
    if (c < nch) {
      float* st = sring + (c % kStages) * stage;
      load_w(reinterpret_cast<T*>(st), static_cast<const T*>(a.w2), a.D, d0,
             f_lo + c * kKC, f_end);
      load_x(st + kKC * kLDW, R, f_lo + c * kKC, f_end,
             [&](int r) { return a.g + (size_t)(r0 + r) * a.F; });
    }
    cp_async_commit();
  };
  // a stage: W2's tile as stored, in the room of an fp32 tile, then g's
  auto ws = [&](int c) {
    return reinterpret_cast<const T*>(sring + (c % kStages) * stage);
  };
  auto xs = [&](int c) {
    return sring + (c % kStages) * stage + kKC * kLDW;
  };
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  float* yp = a.yp + (size_t)s * NT * a.D + d0;
  stream(R, kLDX, nch, xs, ws, issue, sring, a.D, d0,
         [&](int r) { return yp + (size_t)(r0 + r) * a.D; });

  // the last block of this D tile to arrive adds the S2 partials in slice
  // order + b2: into slice 0 of yp (each element read, then written by one
  // thread) for the exit LayerNorm, or into out.  bf16: summed in fp32
  // within each kFTile-column F tile, the running output rounded to bf16
  // at each tile's end, in tile order
  int* counter = a.counter + (a.F + kCB - 1) / kCB + dt;
  if (!last_to_arrive(counter, a.s2 * gridDim.z)) return;
  const int ncol = min(kCB, a.D - d0);
  constexpr int C4 = kCB / 4;
#pragma unroll 2
  for (int i = tid; i < NT * C4; i += kThreads) {
    const int r = i / C4, c = 4 * (i % C4);
    if (c >= ncol) continue;
    const float* p = a.yp + (size_t)r * a.D + d0 + c;
    float4 v = ld4(static_cast<const T*>(a.b2) + d0 + c);
    if constexpr (kBf16<T>) {
      float4 tile = make_float4(0.f, 0.f, 0.f, 0.f);
      int ft = 0;
      for (int q = 0; q < a.s2; ++q) {
        if (q * a.len2 / kFTile != ft) {      // tile ft ends: round
          add4(v, tile);
          v = round_bf16(v);
          tile = make_float4(0.f, 0.f, 0.f, 0.f);
          ft = q * a.len2 / kFTile;
        }
        add4(tile, ldcg4(p + (size_t)q * NT * a.D));
      }
      add4(v, tile);
      v = round_bf16(v);
    } else {
#pragma unroll 8
      for (int q = 0; q < a.s2; ++q) add4(v, ldcg4(p + (size_t)q * NT * a.D));
    }
    const size_t o = (size_t)r * a.D + d0 + c;
    if (a.exit_scale)
      st4(a.yp + o, v);
    else
      st4(static_cast<T*>(a.out) + o, v);
  }
  if (tid == 0) *counter = 0;          // ready for the next call
}

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = warp_sum(v);
  __syncthreads();             // red reusable
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < kExitThreads / 32; ++w) s += red[w];
  return s;
}

// one block per output row: the exit LayerNorm of y (slice 0 of yp)
template <typename T>
__global__ void __launch_bounds__(kExitThreads) demux_exit_kernel(Args a) {
  __shared__ float red[kExitThreads / 32];
  extern __shared__ float row[];            // D floats
  const float* y = a.yp + (size_t)blockIdx.x * a.D;
  float s = 0.f;
  for (int d = threadIdx.x; d < a.D; d += kExitThreads) {
    row[d] = y[d];
    s += row[d];
  }
  const float mu = block_sum(s, red) / a.D;
  s = 0.f;
  for (int d = threadIdx.x; d < a.D; d += kExitThreads) {
    const float c = row[d] - mu;
    s += c * c;
  }
  const float inv = rsqrtf(block_sum(s, red) / a.D + 1e-6f);
  for (int d = threadIdx.x; d < a.D; d += kExitThreads)
    st1(static_cast<T*>(a.out) + (size_t)blockIdx.x * a.D + d,
        (row[d] - mu) * inv * a.exit_scale[d] + a.exit_bias[d]);
}

// the first product: the W ring and the staged rows' slice; the second:
// a ring of W and g chunks
size_t hidden_smem(int rows, int len) {
  return sizeof(float) * ((size_t)kStages * kKC * kLDW +
                          (size_t)rows * (len + 4));
}

size_t out_smem(int rows) {
  return sizeof(float) * (size_t)kStages * (kKC * kLDW + rows * kLDX);
}

// The 48 KiB a block gets without opting in covers its static and dynamic
// shared memory together (demux_hidden_kernel's static arrays take ~4 KiB):
// opt in whenever the two exceed it.
cudaError_t set_smem(const void* fn, size_t bytes) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, fn);
  if (e != cudaSuccess) return e;
  return fa.sharedSizeBytes + bytes > 48 * 1024
             ? cudaFuncSetAttribute(
                   fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)
             : cudaSuccess;
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t sm) {
  const int hjobs = (a.T + kRowsH - 1) / kRowsH;
  const int kjobs = (a.N + kRowsH - 1) / kRowsH;
  const int rows1 = max(min(a.T, kRowsH) + (a.entry_kind == kEntryLn ? 2 : 0),
                        min(a.N, kRowsH));
  const size_t smem1 = hidden_smem(rows1, a.len1);
  cudaError_t e = set_smem((const void*)demux_hidden_kernel<T>, smem1);
  if (e != cudaSuccess) return e;
  demux_hidden_kernel<T><<<dim3((a.F + kCB - 1) / kCB, a.s1, hjobs + kjobs),
                           kThreads, smem1, sm>>>(a);
  const int NT = a.N * a.T;
  const size_t smem2 = out_smem(min(NT, kRowsG));
  if ((e = cudaGetLastError()) != cudaSuccess ||
      (e = set_smem((const void*)demux_out_kernel<T>, smem2)) != cudaSuccess)
    return e;
  demux_out_kernel<T><<<dim3((a.D + kCB - 1) / kCB, a.s2,
                             (NT + kRowsG - 1) / kRowsG),
                        kThreads, smem2, sm>>>(a);
  const size_t smem3 = sizeof(float) * (size_t)a.D;
  if ((e = cudaGetLastError()) != cudaSuccess || !a.exit_scale ||
      (e = set_smem((const void*)demux_exit_kernel<T>, smem3)) != cudaSuccess)
    return e;
  demux_exit_kernel<T><<<NT, kExitThreads, smem3, sm>>>(a);
  return cudaGetLastError();
}

}  // namespace

// entry_kind: 0 none, 1 RMSNorm (entry_scale), 2 LayerNorm (entry_scale,
// entry_bias).  exit_scale / exit_bias: demux LayerNorm, or nullptr for
// none.  bf16: 0 for fp32 h, k, weights, b1, b2 and out (D, F multiples of
// 4), 1 for bf16 (multiples of 8; len2 divides kFTile, so no slice of F
// straddles a rounding tile).  The plan (s1, len1, s2, len2) and the
// scratch sizes are the wrapper's (kernels/demux_rsa.py ``plan``): zp
// holds s1*(T+naff+N)*F floats (naff = 2 for the LN entry, else 0), st
// ceil(F/64)*s1*T*2, g N*T*F, yp s2*N*T*D; counter ceil(F/64) +
// ceil(D/64) ints, zero.
extern "C" int demux_rsa_forward(
    const void* h, const void* k, const float* entry_scale,
    const float* entry_bias, const void* w1h, const void* w1k,
    const void* b1, const void* w2, const void* b2,
    const float* exit_scale, const float* exit_bias, float* zp, float* st,
    float* g, float* yp, void* out, int* counter, int entry_kind, int T,
    int N, int D, int F, int s1, int len1, int s2, int len2, int bf16,
    void* cstream) {
  const int vec = bf16 ? 8 : 4;
  if (D % vec || F % vec || T < 1 || N < 1 || (bf16 != 0 && bf16 != 1) ||
      (bf16 && kFTile % len2) ||
      s1 < 1 || s1 > kMaxSplit || len1 % kKC || (long long)s1 * len1 < D ||
      (long long)(s1 - 1) * len1 >= D || s2 < 1 || len2 % kKC ||
      (long long)s2 * len2 < F || (long long)(s2 - 1) * len2 >= F ||
      (entry_kind && !entry_scale) ||
      (entry_kind == kEntryLn && !entry_bias))
    return (int)cudaErrorInvalidValue;
  Args a{h, k, entry_scale, entry_bias, w1h, w1k, b1, w2, b2, exit_scale,
         exit_bias, zp, st, g, yp, out, counter, entry_kind, T, N, D, F,
         s1, len1, s2, len2};
  cudaStream_t sm = static_cast<cudaStream_t>(cstream);
  return (int)(bf16 ? launch<__nv_bfloat16>(a, sm) : launch<float>(a, sm));
}
