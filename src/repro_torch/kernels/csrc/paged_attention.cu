// Paged attention over a block-table-addressed KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/paged_attention.py:
//   paged_attention          (_kernel)          -> paged_decode_kernel
//   paged_prefill_attention  (_prefill_kernel)  -> paged_prefill_kernel
//
// Layouts (as in the reference): q (B, Lq, H, Dh) fp32; pages (P, BS, Hkv,
// Dh) stored as fp32, bf16, int8 or fp8 e4m3 (the storage kind); for int8
// and fp8 pages, fp32 scales ksc / vsc (P, BS, Hkv), one per (slot, KV
// head); block tables (B, MB) int32 (-1 = unallocated); page_pos (P, BS)
// int32 (-1 = empty slot); decode q_pos (B,) (-1 = inactive row); prefill
// q_start / q_len (B,).
//
// Storage.  One body, templated on the page element type; only the shared-
// memory fill differs.  Each thread loads four elements at a time (float4,
// two bf162, char4, or four packed e4m3 bytes), converts them to fp32
// exactly, and for int8 / fp8 multiplies each by its slot's scale before
// it lands in shared memory: the Pallas body's k.astype(f32) * ks, one
// rounding, the same bits as core.quant.dequantize_kv.  Scores, softmax
// and the accumulator are fp32 for every kind.
//
// Design.  One block per (row, KV head, tile of 16 query rows).  The query
// rows of a block are the G = H / Hkv grouped heads of that KV head times
// the Lq chunk positions, so each K/V page is loaded once for all of them
// (GQA never repeats K/V).  The TPU kernel's sequential grid axis over the
// row's MB pages becomes a loop inside the block: each page's BS x Dh K and
// V tiles go to shared memory (float4 loads, neighbouring threads on
// neighbouring addresses), scores and an online softmax run in fp32, and
// the output accumulator stays in registers (one head dimension per
// thread).  Unallocated table entries are clamped to page 0 for the load
// and masked.  The mask value is the finite -2**30 of the reference, not
// -inf: a fully masked query (inactive row, bucket padding) then returns
// the uniform mean of V over the gathered slots, exactly as the Pallas
// kernel and the plain version do, instead of NaN.
//
// Bound.  Each referenced page is read once per KV head, so the kernel
// moves ~2 * slots * Dh * E bytes per KV head (E = 4, 2, 1, 1 for fp32,
// bf16, int8, fp8), plus 8 bytes of scales per (slot, KV head) for int8 and
// fp8, plus q and the output; the work is 4 * Dh flops per (query head,
// visible slot).  At decode (one query per row) that is ~3 flops per byte
// at fp32 and ~10 at int8 / fp8: bound by bytes.  A causal 32-token chunk
// has ~27 flops per byte at fp32 (~100 at int8), above the card's fp32
// balance (~20), so it is bound by operations.  In practice all are bound by
// latency: B * Hkv * ceil(G * Lq / 16) blocks (8 at decode, 24 at a
// one-row chunk) do not fill 132 SMs, and each walks its row's MB pages
// in series, -1 entries included, with four barriers per page.  Splitting
// the page loop across blocks (flash-decoding) is the known next step.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16;        // query rows per block
constexpr int kMaxDpt = 2;       // head dims per thread: Dh <= 256
constexpr float kNegInf = -1073741824.0f;   // -2**30, as the reference

struct Args {
  const float* q;
  const void* kp;       // page storage: float, bf16, int8 or e4m3
  const void* vp;
  const float* ksc;     // int8 / fp8: (P, BS, Hkv) scales; else nullptr
  const float* vsc;
  const int* bt;
  const int* ppos;
  const int* q_start;   // decode: q_pos
  const int* q_len;     // decode: nullptr (one valid query per row)
  float* out;
  int B, Lq, H, Hkv, Dh, BS, MB, causal, window;
  float scale;
};

// four consecutive page elements (16-, 8- or 4-byte aligned) -> fp32, exact
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}
__device__ __forceinline__ float4 load4(const __nv_fp8_e4m3* p) {
  return static_cast<float4>(*reinterpret_cast<const __nv_fp8x4_e4m3*>(p));
}

template <typename T>
constexpr bool kQuantized =
    std::is_same<T, int8_t>::value || std::is_same<T, __nv_fp8_e4m3>::value;

__device__ __forceinline__ float4 scaled(float4 v, float s) {
  v.x *= s; v.y *= s; v.z *= s; v.w *= s;
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int Dh, int BS) {
  const int ldk = Dh + 4;
  return sizeof(float) * (size_t)(kRows * ldk + BS * ldk + BS * Dh +
                                  kRows * BS + 3 * kRows) +
         sizeof(int) * (size_t)BS;
}

template <typename T>
__device__ void paged_attention_body(const Args& a) {
  const T* kp = static_cast<const T*>(a.kp);
  const T* vp = static_cast<const T*>(a.vp);
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.H / a.Hkv;
  const int r0 = blockIdx.z * kRows;
  const int rows = min(kRows, G * a.Lq - r0);
  const int ldk = a.Dh + 4;      // padded row stride: fewer bank conflicts
  const int d4 = a.Dh / 4;

  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // kRows x ldk, pre-scaled q
  float* sk = sq + kRows * ldk;                 // BS x ldk
  float* sv = sk + a.BS * ldk;                  // BS x Dh
  float* sp = sv + a.BS * a.Dh;                 // kRows x BS scores / probs
  float* sm = sp + kRows * a.BS;                // running max
  float* sl = sm + kRows;                       // running sum
  float* salpha = sl + kRows;                   // per-page rescale
  int* spos = reinterpret_cast<int*>(salpha + kRows);
  __shared__ int sqpos[kRows];                  // query position, -1 = masked

  const int qs = a.q_start[b];
  const int ql = a.q_len ? a.q_len[b] : 1;
  if (tid < kRows) {
    const int li = (r0 + tid) / G;
    sqpos[tid] = (tid < rows && qs >= 0 && li < ql) ? qs + li : -1;
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
  }
  // row r of the tile is query (li, g) = divmod(r0 + r, G): head kvh*G + g
  for (int i = tid; i < rows * d4; i += kThreads) {
    const int r = i / d4, c = i % d4;
    const int gr = r0 + r, li = gr / G, head = kvh * G + gr % G;
    float4 v = reinterpret_cast<const float4*>(
        a.q + ((size_t)(b * a.Lq + li) * a.H + head) * a.Dh)[c];
    v.x *= a.scale; v.y *= a.scale; v.z *= a.scale; v.w *= a.scale;
    reinterpret_cast<float4*>(sq + r * ldk)[c] = v;
  }

  float acc[kRows][kMaxDpt];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kMaxDpt; ++j) acc[r][j] = 0.f;

  for (int jb = 0; jb < a.MB; ++jb) {
    const int page = a.bt[b * a.MB + jb];
    const int pc = max(page, 0);
    __syncthreads();             // previous page's tiles fully consumed
    for (int i = tid; i < a.BS * d4; i += kThreads) {
      const int s = i / d4, c = i % d4;
      const size_t sh = (size_t)(pc * a.BS + s) * a.Hkv + kvh;  // (slot, head)
      const size_t off = sh * a.Dh + 4 * c;
      float4 kv = load4(kp + off), vv = load4(vp + off);
      if constexpr (kQuantized<T>) {   // fused dequant: payload * scale
        kv = scaled(kv, a.ksc[sh]);
        vv = scaled(vv, a.vsc[sh]);
      }
      reinterpret_cast<float4*>(sk + s * ldk)[c] = kv;
      reinterpret_cast<float4*>(sv + s * a.Dh)[c] = vv;
    }
    for (int s = tid; s < a.BS; s += kThreads) spos[s] = a.ppos[pc * a.BS + s];
    __syncthreads();

    // scores: one (query row, slot) dot product per thread
    for (int p = tid; p < rows * a.BS; p += kThreads) {
      const int r = p / a.BS, s = p % a.BS;
      const float4* qr = reinterpret_cast<const float4*>(sq + r * ldk);
      const float4* kr = reinterpret_cast<const float4*>(sk + s * ldk);
      float dot = 0.f;
      for (int c = 0; c < d4; ++c) {
        const float4 x = qr[c], y = kr[c];
        dot += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
      const int pos = spos[s], qp = sqpos[r];
      bool ok = pos >= 0 && page >= 0 && qp >= 0;
      if (a.causal) ok = ok && pos <= qp;
      if (a.window > 0) ok = ok && pos > qp - a.window;
      sp[r * a.BS + s] = ok ? dot : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per query row
    for (int r = warp; r < rows; r += kThreads / 32) {
      float mx = kNegInf;
      for (int s = lane; s < a.BS; s += 32) mx = fmaxf(mx, sp[r * a.BS + s]);
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int s = lane; s < a.BS; s += 32) {
        const float e = expf(sp[r * a.BS + s] - m_new);
        sp[r * a.BS + s] = e;
        sum += e;
      }
      sum = warp_sum(sum);
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
      for (int r = 0; r < kRows; ++r) {
        if (r >= rows) break;
        float v = acc[r][j] * salpha[r];
        for (int s = 0; s < a.BS; ++s) v += sp[r * a.BS + s] * sv[s * a.Dh + d];
        acc[r][j] = v;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxDpt; ++j) {
    const int d = tid + j * kThreads;
    if (d >= a.Dh) continue;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows) break;
      const int gr = r0 + r, li = gr / G, head = kvh * G + gr % G;
      a.out[((size_t)(b * a.Lq + li) * a.H + head) * a.Dh + d] =
          acc[r][j] / fmaxf(sl[r], 1e-30f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Args a) {
  paged_attention_body<T>(a);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(Args a) {
  paged_attention_body<T>(a);
}

int launch(void (*kernel)(Args), const Args& a, void* stream) {
  // Dh % 4 == 0 keeps every four-element load aligned for every kind
  if (a.Dh % 4 || a.Dh > kThreads * kMaxDpt || a.H % a.Hkv) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.Dh, a.BS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int G = a.H / a.Hkv;
  dim3 grid(a.B, a.Hkv, (G * a.Lq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// storage kind: 0 fp32, 1 bf16, 2 int8, 3 fp8 e4m3 (kernels/paged_attention.py
// STORAGE_KINDS); int8 and fp8 need both scale arrays, the others none
template <typename T>
int launch_kind(bool prefill, const Args& a, void* stream) {
  return launch(prefill ? paged_prefill_kernel<T> : paged_decode_kernel<T>,
                a, stream);
}

int dispatch(int kind, bool prefill, const Args& a, void* stream) {
  const bool quant = kind == 2 || kind == 3;
  if (quant != (a.ksc != nullptr) || quant != (a.vsc != nullptr))
    return (int)cudaErrorInvalidValue;
  switch (kind) {
    case 0: return launch_kind<float>(prefill, a, stream);
    case 1: return launch_kind<__nv_bfloat16>(prefill, a, stream);
    case 2: return launch_kind<int8_t>(prefill, a, stream);
    case 3: return launch_kind<__nv_fp8_e4m3>(prefill, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int paged_attention_decode(
    const float* q, const void* kp, const void* vp, const float* ksc,
    const float* vsc, const int* bt, const int* ppos, const int* q_pos,
    float* out, int kind, int B, int H, int Hkv, int Dh, int BS, int MB,
    int causal, int window, float scale, void* stream) {
  Args a{q, kp, vp, ksc, vsc, bt, ppos, q_pos, nullptr, out,
         B, 1, H, Hkv, Dh, BS, MB, causal, window, scale};
  return dispatch(kind, false, a, stream);
}

extern "C" int paged_attention_prefill(
    const float* q, const void* kp, const void* vp, const float* ksc,
    const float* vsc, const int* bt, const int* ppos, const int* q_start,
    const int* q_len, float* out, int kind, int B, int Lq, int H, int Hkv,
    int Dh, int BS, int MB, int causal, int window, float scale,
    void* stream) {
  Args a{q, kp, vp, ksc, vsc, bt, ppos, q_start, q_len, out,
         B, Lq, H, Hkv, Dh, BS, MB, causal, window, scale};
  return dispatch(kind, true, a, stream);
}
