// The Gaussian mux entry for Hopper (sm_90a): the two kernels that form a
// multiplexed backbone row,
//
//   out[t] = coef * sum_i x_i[t] ⊙ v[i]        i = 0 .. N-1
//
//  * mux_embed_kernel: x_i[t] = emb[tokens[i, t]] gathered from the table,
//    coef = scale / N (gather + embedding scale + mux in one pass).
//    Replaces the Pallas TPU kernel src/repro/kernels/mux_embed.py
//    (mux_embed_combine), which scalar-prefetches the ids and DMAs one
//    embedding row per sequential grid step into a VMEM accumulator.
//  * mux_combine_kernel: x_i = x[i] of precomputed embeddings (N, T, D),
//    coef = 1 / N, out in x's type.  Replaces the Pallas TPU kernel
//    src/repro/kernels/mux_combine.py (mux_combine), one (N, bt, bd) VMEM
//    tile a grid step.
//
// Types: x (emb) and v each fp32 or bf16, out fp32 or bf16 (mux_combine:
// x's).  The sum runs in fp32 in the order i = 0 .. N-1, is multiplied by
// coef, and rounds once to the output type (__float2bfloat16_rn), as the
// Pallas kernels' fp32 scratch accumulator does.
//
// Bound: bytes.  Each element of x is read once and takes one FMA; v is
// N x D and the output T x D.  At decode (T = 4) the gather moves ~50 KB,
// so the time is latency: the ids, then the rows they name.  At a
// prefill (whisper's encoder entry, 55 MB) it is the HBM rate.
//
// Design.  Both kernels share `combine`: a thread sums N rows of one
// 16-byte chunk of x (W = 4 fp32 or 8 bf16 columns) against the keys in
// fp32, issuing the loads of kGroup instances' rows before the first FMA,
// and stores the W outputs at once.  Each kernel is also instantiated for
// N = kStaticN, the main path's width, as a constant: its loops unroll
// whole and its registers drop (56 against 72 for mux_combine).
// Neighbouring threads take neighbouring chunks, so a warp's loads and
// stores are contiguous.  Every thread loads its own rows and keys with
// 16-byte ld.global; there is no shared memory.  mux_embed: one block a
// (token, D-slice), its threads read the N ids (int64 offsets: gemma's
// 256000 x 3072 table is past 2^31 elements).  mux_combine: one block a
// tile of rows; a thread keeps one column chunk and takes kUnroll fp32
// rows (kUnrollBf16 bf16 rows) at once.  In fp32 both instances' rows are
// loaded before the first FMA; over bf16 x one instance's at a time
// (kGroupBf16), which at two bf16 rows a thread holds 66 registers
// against 84 and reads whisper's bf16 entry ~5% faster (PERF.md).  A design that brought the rows into
// shared memory by cp.async.bulk on an mbarrier (mux_combine: a
// persistent ring) measured slower at every shape on an H100 (PERF.md).
// A row or slice whose bytes are not 16-byte aligned (D % 8 != 0, or a
// pointer off 16 bytes: `vec` = 0) takes per-thread scalar loads in the
// same kernels.  The slices, tile rows and grid come from the shape-only
// plans in kernels/mux_embed.py and kernels/mux_combine.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kGroup = 2;              // instances' rows loaded before the
                                       // first FMA (all of them at N = 2)
constexpr int kGroupBf16 = 1;          // ... in mux_combine over bf16 x
constexpr int kUnroll = 2;             // mux_combine: fp32 rows a thread
constexpr int kUnrollBf16 = 2;         // ... bf16 rows, at once
// a kernel instantiated for N = kStaticN (the main path's mux width) as a
// constant, others take N at run time; 0: always at run time
constexpr int kStaticN = 2;

// ---- W consecutive elements, moved whole ------------------------------

// W elements of T on their own size (W * sizeof(T) <= 16 is one access)
template <class T, int W>
struct alignas(sizeof(T) * W) Vec {
  T v[W];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float& o, float x) { o = x; }
__device__ __forceinline__ void from_f(bf16& o, float x) {
  o = __float2bfloat16_rn(x);
}

template <int W, class T>
__device__ __forceinline__ Vec<T, W> load(const T* p) {
  return *reinterpret_cast<const Vec<T, W>*>(p);
}

template <int W, class T>
__device__ __forceinline__ void load(const T* p, float (&f)[W]) {
  const Vec<T, W> a = load<W>(p);
#pragma unroll
  for (int j = 0; j < W; ++j) f[j] = to_f(a.v[j]);
}

template <int W, class T>
__device__ __forceinline__ void store(T* p, const float (&f)[W]) {
  Vec<T, W> o;
#pragma unroll
  for (int j = 0; j < W; ++j) from_f(o.v[j], f[j]);
  *reinterpret_cast<Vec<T, W>*>(p) = o;
}

// For each chunk u < nu (of U): out(u)[0, W) = coef * sum_{i < n}
// x(i, u)[0, W) * k(i)[0, W), in fp32, i in order, rounded once.  x and
// k return row pointers, out the output's.  The rows
// stay in their own type until the FMA, the keys are shared by the chunks.
// G instances a group; SN > 0: n == SN, a constant.
template <int W, int U, int G, int SN, class XAt, class KAt, class OAt>
__device__ __forceinline__ void combine(int n, int nu, XAt x, KAt k,
                                        float coef, OAt out) {
  using TX = std::remove_cv_t<std::remove_pointer_t<decltype(x(0, 0))>>;
  float acc[U][W];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int j = 0; j < W; ++j) acc[u][j] = 0.f;
  auto group = [&](int i0) {
    // addresses first (a gathered row's needs its token id), then every
    // row of the group, then the keys
    const TX* xp[G][U];
    Vec<TX, W> xv[G][U];
    float kv[G][W];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + g < n && u < nu) xp[g][u] = x(i0 + g, u);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (i0 + g < n && u < nu) xv[g][u] = load<W>(xp[g][u]);
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (i0 + g < n) load<W>(k(i0 + g), kv[g]);
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (i0 + g < n)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (u < nu)
#pragma unroll
            for (int j = 0; j < W; ++j)
              acc[u][j] = fmaf(to_f(xv[g][u].v[j]), kv[g][j], acc[u][j]);
  };
  if constexpr (SN > 0) {
#pragma unroll
    for (int i0 = 0; i0 < SN; i0 += G) group(i0);
  } else {
#pragma unroll 1
    for (int i0 = 0; i0 < n; i0 += G) group(i0);   // one group live
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (u < nu) {
#pragma unroll
      for (int j = 0; j < W; ++j) acc[u][j] *= coef;
      store<W>(out(u), acc[u]);
    }
}

// ---- mux_embed_combine -------------------------------------------------

struct EmbedArgs {
  const int* tok;   // (N, T)
  const void* emb;  // (V, D)
  const void* v;    // (N, D)
  void* out;        // (T, D)
  int N, T, D;
  int cols;         // columns a block: its D-slice (kernels/mux_embed.py plan)
  float coef;       // scale / N
};

// Block (s, t) forms columns [s * cols, s * cols + w) of out[t].
template <class TE, class TK, class TO, int SN>
__global__ void __launch_bounds__(256) mux_embed_kernel(EmbedArgs a, int vec) {
  constexpr int W = 16 / sizeof(TE);
  const int n = SN ? SN : a.N;
  const TE* emb = static_cast<const TE*>(a.emb);
  const TK* v = static_cast<const TK*>(a.v);
  const int t = blockIdx.y, c0 = blockIdx.x * a.cols;
  const int w = min(a.cols, a.D - c0);
  TO* out = static_cast<TO*>(a.out) + (size_t)t * a.D + c0;
  auto row = [&](int i) {
    return emb + (int64_t)a.tok[i * a.T + t] * a.D + c0;
  };
  auto key = [&](int i) { return v + (size_t)i * a.D + c0; };
  if (!vec) {
    for (int c = threadIdx.x; c < w; c += blockDim.x)
      combine<1, 1, kGroup, SN>(
          n, 1, [&](int i, int) { return row(i) + c; },
          [&](int i) { return key(i) + c; }, a.coef,
          [&](int) { return out + c; });
    return;
  }
  for (int c = W * threadIdx.x; c < w; c += W * blockDim.x)
    combine<W, 1, kGroup, SN>(
        n, 1, [&](int i, int) { return row(i) + c; },
        [&](int i) { return key(i) + c; }, a.coef,
        [&](int) { return out + c; });
}

// ---- mux_combine -------------------------------------------------------

struct CombineArgs {
  const void* x;    // (N, T, D)
  const void* v;    // (N, D)
  void* out;        // (T, D), x's type
  int N, T, D;
  // the plan (kernels/mux_combine.py): tiles of `rows` rows of T by `cols`
  // columns, `slices` = ceil(D / cols) of them across D
  int cols, rows, slices;
  float coef;       // 1 / N
};

// Per-thread scalar loads (vec = 0): grid (tiles), 1-D blocks, block b
// takes rows [b * rows, b * rows + rows) of all of D.
template <class TX, class TV, int SN>
__device__ __forceinline__ void combine_scalar(const CombineArgs& a) {
  const int n = SN ? SN : a.N;
  const TX* x = static_cast<const TX*>(a.x);
  const TV* v = static_cast<const TV*>(a.v);
  TX* out = static_cast<TX*>(a.out);
  const int t0 = blockIdx.x * a.rows, r = min(a.rows, a.T - t0);
  for (int e = threadIdx.x; e < r * a.D; e += blockDim.x) {
    const size_t t = t0 + e / a.D, c = e % a.D;
    combine<1, 1, kGroup, SN>(
        n, 1, [&](int i, int) { return x + (i * a.T + t) * a.D + c; },
        [&](int i) { return v + (size_t)i * a.D + c; }, a.coef,
        [&](int) { return out + t * a.D + c; });
  }
}

// 16-byte chunks (vec = 1): grid (tiles, slices), blocks (chunks of a
// slice row, row groups).  Thread (tx, ty) takes 16-byte chunk tx of rows
// ty, ty + groups, ... of its tile, U rows at once, one key chunk an
// instance for all of them.
template <class TX, class TV, int SN>
__device__ __forceinline__ void combine_direct(const CombineArgs& a) {
  const int n = SN ? SN : a.N;
  constexpr int W = 16 / sizeof(TX);
  constexpr int U = sizeof(TX) == 4 ? kUnroll : kUnrollBf16;
  constexpr int G = sizeof(TX) == 4 ? kGroup : kGroupBf16;
  const int c0 = blockIdx.y * a.cols, c = W * threadIdx.x;
  if (c >= min(a.cols, a.D - c0)) return;
  const int t0 = blockIdx.x * a.rows, tr = min(a.rows, a.T - t0);
  const int rg = blockDim.y;
  const size_t istride = (size_t)a.T * a.D, rs = (size_t)rg * a.D;
  const TX* x = static_cast<const TX*>(a.x) + (size_t)t0 * a.D + c0 + c;
  const TV* v = static_cast<const TV*>(a.v) + c0 + c;
  TX* out = static_cast<TX*>(a.out) + (size_t)t0 * a.D + c0 + c;
  for (int r0 = threadIdx.y; r0 < tr; r0 += rg * U) {
    const int nu = min(U, (tr - r0 + rg - 1) / rg);
    const TX* xb = x + (size_t)r0 * a.D;
    TX* ob = out + (size_t)r0 * a.D;
    combine<W, U, G, SN>(
        n, nu, [&](int i, int u) { return xb + i * istride + u * rs; },
        [&](int i) { return v + (size_t)i * a.D; }, a.coef,
        [&](int u) { return ob + u * rs; });
  }
}

template <class TX, class TV, int SN>
__global__ void __launch_bounds__(256)
    mux_combine_kernel(CombineArgs a, int vec) {
  if (vec)
    combine_direct<TX, TV, SN>(a);
  else
    combine_scalar<TX, TV, SN>(a);
}

// ---- launch ------------------------------------------------------------

template <class TE, class TK, class TO, int SN>
int launch_embed(const EmbedArgs& a, int vec, int threads, cudaStream_t st) {
  const dim3 grid((a.D + a.cols - 1) / a.cols, a.T);
  mux_embed_kernel<TE, TK, TO, SN><<<grid, threads, 0, st>>>(a, vec);
  return (int)cudaGetLastError();
}

template <class TE, class TK, class TO>
int embed_n(const EmbedArgs& a, int vec, int threads, cudaStream_t st) {
  return kStaticN && a.N == kStaticN
      ? launch_embed<TE, TK, TO, kStaticN>(a, vec, threads, st)
      : launch_embed<TE, TK, TO, 0>(a, vec, threads, st);
}

template <class TE, class TK>
int embed_out(const EmbedArgs& a, int vec, int threads, int out_bf16,
              cudaStream_t st) {
  return out_bf16 ? embed_n<TE, TK, bf16>(a, vec, threads, st)
                  : embed_n<TE, TK, float>(a, vec, threads, st);
}

template <class TX, class TV, int SN>
int launch_combine(const CombineArgs& a, int vec, int grid, int threads,
                   cudaStream_t st) {
  dim3 blocks(grid), block(threads);
  if (vec) {                           // (tiles, slices) x (chunks, groups)
    const int chunks = (a.cols * (int)sizeof(TX) + 15) / 16;
    if (threads % chunks) return (int)cudaErrorInvalidValue;
    blocks = dim3(grid / a.slices, a.slices);
    block = dim3(chunks, threads / chunks);
  }
  mux_combine_kernel<TX, TV, SN><<<blocks, block, 0, st>>>(a, vec);
  return (int)cudaGetLastError();
}

template <class TX, class TV>
int combine_n(const CombineArgs& a, int vec, int grid, int threads,
              cudaStream_t st) {
  return kStaticN && a.N == kStaticN
      ? launch_combine<TX, TV, kStaticN>(a, vec, grid, threads, st)
      : launch_combine<TX, TV, 0>(a, vec, grid, threads, st);
}

}  // namespace

// dtype codes: 0 fp32, 1 bf16.  With vec, D % 8 == 0 and every pointer
// 16-byte aligned; cols <= D, a multiple of 8 (or D); threads <= 256.
extern "C" int mux_embed_forward(const int* tok, const void* emb,
                                 const void* v, void* out, int N, int T,
                                 int D, int cols, int threads, int vec,
                                 int emb_bf16, int v_bf16, int out_bf16,
                                 float coef, void* stream) {
  if (N < 1 || T < 1 || D < 1 || cols < 1 || cols > D || threads < 1 ||
      threads > 256 || (vec && (D % 8 || cols % 8)))
    return (int)cudaErrorInvalidValue;
  const EmbedArgs a{tok, emb, v, out, N, T, D, cols, coef};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (emb_bf16)
    return v_bf16 ? embed_out<bf16, bf16>(a, vec, threads, out_bf16, st)
                  : embed_out<bf16, float>(a, vec, threads, out_bf16, st);
  return v_bf16 ? embed_out<float, bf16>(a, vec, threads, out_bf16, st)
                : embed_out<float, float>(a, vec, threads, out_bf16, st);
}

// out has x's type.  grid a multiple of slices; up to 256 threads (with
// vec, a multiple of a slice row's 16-byte chunks).  Per-thread scalar
// loads (vec = 0): grid = tiles, slices = 1.
extern "C" int mux_combine_forward(const void* x, const void* v, void* out,
                                   int N, int T, int D, int cols, int rows,
                                   int slices, int grid,
                                   int threads, int vec, int x_bf16,
                                   int v_bf16, float coef, void* stream) {
  if (N < 1 || T < 1 || D < 1 || cols < 1 || cols > D || rows < 1 ||
      slices != (D + cols - 1) / cols || grid < 1 || grid % slices ||
      threads < 1 || threads > 256 || (vec && (D % 8 || cols % 8)))
    return (int)cudaErrorInvalidValue;
  const CombineArgs a{x, v, out, N, T, D, cols, rows, slices, coef};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return v_bf16 ? combine_n<bf16, bf16>(a, vec, grid, threads, st)
                  : combine_n<bf16, float>(a, vec, grid, threads, st);
  return v_bf16 ? combine_n<float, bf16>(a, vec, grid, threads, st)
                : combine_n<float, float>(a, vec, grid, threads, st);
}
