// Paged attention over a block-table-addressed KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/paged_attention.py:
//   paged_attention          (_kernel, :54; call :162)
//       -> paged_decode_kernel on the CUDA cores
//   paged_prefill_attention  (_prefill_kernel, :172; call :297)
//       -> paged_chunk_kernel on the tensor cores (3xTF32)
// and, where a row's table is split, paged_combine_kernel for both.
//
// Layouts (as in the reference): q (B, Lq, H, Dh) and the output of the
// same shape in fp32 or bf16 (the query type); pages (P, BS, Hkv,
// Dh) stored as fp32, bf16, int8 or fp8 e4m3 (the storage kind); for int8
// and fp8 pages, fp32 scales ksc / vsc (P, BS, Hkv), one per (slot, KV
// head); block tables (B, MB) int32 (-1 = unallocated); page_pos (P, BS)
// int32 (-1 = empty slot); decode q_pos (B,) (-1 = inactive row); prefill
// q_start / q_len (B,).  As the Pallas kernels, a bf16 q is widened to fp32
// as it is loaded; scores, softmax, P V and the split partials stay fp32,
// and the output is rounded to bf16 once, where it is written.
//
// Bound.  Each page a row references is read once per KV head: ~2 * slots *
// Dh * E bytes (E = 4, 2, 1, 1 for fp32, bf16, int8, fp8; int8 / fp8 add
// 8 bytes of scales per slot and KV head), against 4 * Dh flops per (query
// head, visible slot).  At the main path's shapes (qwen2-1.5b: 12 heads
// over 2 KV heads of 128, pages of 16) that is 0.92 MB and 2.6 MFLOP at
// decode (4 rows, 426 slots) and 0.59 MB and 16 MFLOP at a 32-token chunk:
// well under a microsecond of bytes either way.  What bounds both is
// latency: the launches, two dependent loads (the table, then the pages),
// and how many pages a block walks in series.
//
// Design.
//  * Split page walk.  Block (row, KV head, [query tile,] split) walks a
//    contiguous run of split_len table entries; the split plan
//    (kernels/paged_attention.py ``decode_plan`` / ``prefill_plan``) depends
//    on shapes only (B, H, Hkv, Lq, Dh, MB, BS), never on positions or table
//    contents, and aims at ~2 blocks an SM (8 splits of one page at the main
//    path: 64 decode blocks, 48 chunk blocks).  With one split a block
//    writes the normalised output; with several it writes its unnormalised
//    (acc, m, l) and paged_combine_kernel merges them per (row, query,
//    head) by their log-sum-exp, in split order (deterministic, no
//    atomics).  All three kernels launch with programmatic dependent launch
//    (Hopper): the combine is scheduled while the split kernel runs and
//    waits for it with griddepcontrol.wait, so its launch latency hides.
//  * Pipelined page loads.  A block first copies its run of table entries to
//    shared memory, then walks the run's slots in tiles (16 slots at decode,
//    the flash kernel's key tile BK in a chunk) through a two-stage cp.async
//    ring: tile i + 1 is in flight while tile i is consumed, one barrier a
//    tile.  A tile is addressed slot by slot (table entry j / BS, slot
//    j % BS), so it may span pages: any block size works, the CLI's BS = 4
//    included, with no separate small-page body.  Pages are copied as
//    stored (raw bytes, 16-, 8- or 4-byte cp.async), so narrow pages move
//    2-4x fewer bytes.  A narrow tile is widened once, times each slot's
//    scale, into an fp32 tile between the stages (one more barrier a tile):
//    the reference's payload.float() * scale, one rounding, the same bits
//    as core.quant.dequantize_kv.  The warps that share the tile then read
//    fp32; widening at each read would convert every element once a warp.
//    The exception is bf16 in the chunk kernel: its fragments widen by a
//    shift as they read the stage, which measured faster than the extra
//    pass and barrier.
//  * Decode: one warp per query head (at most 8 a block; G > 8 splits the
//    heads over blocks).  Each lane holds Dh / 32 elements of the pre-scaled
//    q in registers; a slot's score is a shuffle-reduced dot product, and
//    the online softmax and the output accumulator live in registers.  At
//    Lq = 1 a 6-row tile cannot fill an m16 tensor-core product.
//  * Chunk: the flash kernel's tile step (attn_tile.cuh) with a block-table
//    K/V source: 64 (Dh > 64) or 128 query rows a block, the G grouped heads
//    times the Lq chunk positions, so each page is loaded once for all of
//    them; S and P in registers; the products on the tensor cores in the
//    fp32-exact 3xTF32 split.  The mask comes from page_pos, the table entry
//    and q_start + li < q_start + q_len.
//  * Masked queries.  The mask value is the finite -2**30 of the reference:
//    a query that sees no slot (an inactive row, bucket padding, a window
//    that excludes everything) returns the uniform mean of V over all MB *
//    BS gathered slots, -1 entries read as page 0, as the plain version
//    does.  No page is skipped (not trailing -1 entries, not pages past a
//    block's last query position or outside the window): each split then
//    yields m = -2**30, l = its slot count and acc = its V sum for such a
//    query, and the merge gives the mean.  Slots past a split's run (a
//    tile's ragged end) are zero-filled and weigh exactly 0 (score -inf).
#include <cuda_bf16.h>
#include <cuda_fp8.h>

#include <cstdint>
#include <type_traits>

#include "attn_tile.cuh"

namespace {

constexpr int kDecodeTile = 16;     // slots a decode stage
constexpr int kMaxHeads = 8;        // query heads (warps) a decode block
constexpr int kChunkWarps = 4;
constexpr int kChunkThreads = 32 * kChunkWarps;
constexpr int kMaxSmem = 232448;    // an H100 block's shared memory

struct Args {
  const void* q;        // query type: float or bf16
  const void* kp;       // page storage: float, bf16, int8 or e4m3
  const void* vp;
  const float* ksc;     // int8 / fp8: (P, BS, Hkv) scales; else nullptr
  const float* vsc;
  const int* bt;
  const int* ppos;
  const int* q_start;   // decode: q_pos
  const int* q_len;     // decode: nullptr (one valid query per row)
  void* out;            // query type
  float* part_o;        // (nsplit, B, Lq, H, Dh) unnormalised; nsplit == 1: unused
  float* part_ml;       // (nsplit, B, Lq, H, 2) running max (log2 units), sum
  int B, Lq, H, Hkv, Dh, BS, MB, causal, window, nsplit, split_len;
  float scale;
};

template <typename T>
constexpr bool kQuantized =
    std::is_same<T, int8_t>::value || std::is_same<T, __nv_fp8_e4m3>::value;
template <typename T>
constexpr bool kNarrow = !std::is_same<T, float>::value;

// four consecutive stored elements (8- or 4-byte aligned) -> fp32, exact
// (four bf16 values in a uint2: attn_tile.cuh)
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {
  return widen4(*reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 widen4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}
__device__ __forceinline__ float4 widen4(const __nv_fp8_e4m3* p) {
  return static_cast<float4>(*reinterpret_cast<const __nv_fp8x4_e4m3*>(p));
}
__device__ __forceinline__ float4 widen4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// four fp32 values stored as the output type (16- or 8-byte aligned; two:
// store2 in attn_tile.cuh); bf16 rounds to nearest even
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

// N bytes global -> shared (N = 4, 8, 16), zero-filled when !valid
template <int N>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(N), "r"(valid ? N : 0));
}

// programmatic dependent launch (launch_pdl): wait for the previous kernel
// in the stream to complete before reading anything, and let the next one
// (the combine) be scheduled now
__device__ __forceinline__ void pdl_enter() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One stage of the ring: K and V rows of n slots (stored type, row_bytes
// apart), then per slot its position, its flag (-1: past the split's run,
// 0: an unallocated entry, read as page 0 and masked, 1: a page) and, for
// int8 / fp8, its K and V scales.
struct Stage {
  char* k;
  char* v;
  int* pos;
  int* flag;
  float* ks;
  float* vs;
};

__host__ __device__ constexpr int stage_bytes(int n, int row_bytes) {
  return 2 * n * row_bytes + 4 * n * 4;
}

__device__ __forceinline__ Stage stage_at(char* base, int n, int row_bytes) {
  Stage s;
  s.k = base;
  s.v = base + n * row_bytes;
  s.pos = reinterpret_cast<int*>(base + 2 * n * row_bytes);
  s.flag = s.pos + n;
  s.ks = reinterpret_cast<float*>(s.flag + n);
  s.vs = s.ks + n;
  return s;
}

// Issue the copies of slots [s0, s0 + n) of the split's run (nslots slots;
// spage holds the run's table entries) into stage st.  K/V by cp.async in
// the largest of 16, 8, 4 bytes that divides a stored row; flags by plain
// stores (visible after the next barrier).
template <typename T>
__device__ void stage_tile(const Args& a, const int* spage, int kvh, int s0,
                           int n, int nslots, int ld_bytes, const Stage& st) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int rowb = a.Dh * (int)sizeof(T);
  const int cb = rowb % 16 == 0 ? 16 : rowb % 8 == 0 ? 8 : 4;
  const int nc = rowb / cb;
  for (int i = tid; i < n * nc; i += nthr) {
    const int r = i / nc, c = i % nc, j = s0 + r;
    const bool ok = j < nslots;
    const int page = ok ? max(spage[j / a.BS], 0) : 0;
    const size_t sh =
        ((size_t)page * a.BS + (ok ? j % a.BS : 0)) * a.Hkv + kvh;
    const size_t off = sh * rowb + (size_t)c * cb;
    const char* ks = static_cast<const char*>(a.kp) + off;
    const char* vs = static_cast<const char*>(a.vp) + off;
    char* dk = st.k + r * ld_bytes + c * cb;
    char* dv = st.v + r * ld_bytes + c * cb;
    if (cb == 16) {
      cp_async_ca<16>(dk, ks, ok);
      cp_async_ca<16>(dv, vs, ok);
    } else if (cb == 8) {
      cp_async_ca<8>(dk, ks, ok);
      cp_async_ca<8>(dv, vs, ok);
    } else {
      cp_async_ca<4>(dk, ks, ok);
      cp_async_ca<4>(dv, vs, ok);
    }
  }
  for (int r = tid; r < n; r += nthr) {
    const int j = s0 + r;
    const bool ok = j < nslots;
    const int e = ok ? spage[j / a.BS] : -1;
    const size_t ps = (size_t)max(e, 0) * a.BS + (ok ? j % a.BS : 0);
    cp_async_ca<4>(st.pos + r, a.ppos + ps, ok);
    st.flag[r] = ok ? (e >= 0) : -1;
    if constexpr (kQuantized<T>) {
      cp_async_ca<4>(st.ks + r, a.ksc + ps * a.Hkv + kvh, ok);
      cp_async_ca<4>(st.vs + r, a.vsc + ps * a.Hkv + kvh, ok);
    }
  }
}

// Widen a landed stage of n narrow slots (stored rows ld_in elements apart,
// cols elements each, a multiple of 4) into fp32 rows ld_out floats apart,
// times each slot's scale for int8 / fp8: the reference's payload.float()
// * scale, one rounding.  Once a tile for the whole block, so the warps that
// share the tile read fp32 and convert nothing.
template <typename T>
__device__ void widen_tile(const Stage& st, int n, int cols, int ld_in,
                           int ld_out, float* wk, float* wv) {
  const T* sk = reinterpret_cast<const T*>(st.k);
  const T* sv = reinterpret_cast<const T*>(st.v);
  const int c4 = cols / 4;
  for (int i = threadIdx.x; i < n * c4; i += blockDim.x) {
    const int r = i / c4, c = 4 * (i % c4);
    float4 k = widen4(sk + r * ld_in + c), v = widen4(sv + r * ld_in + c);
    if constexpr (kQuantized<T>) {
      const float ks = st.ks[r], vs = st.vs[r];
      k.x *= ks; k.y *= ks; k.z *= ks; k.w *= ks;
      v.x *= vs; v.y *= vs; v.z *= vs; v.w *= vs;
    }
    *reinterpret_cast<float4*>(wk + r * ld_out + c) = k;
    *reinterpret_cast<float4*>(wv + r * ld_out + c) = v;
  }
}

// the masked score in log2 units (see the note): -inf past the run, the
// finite mask value where the slot is not visible to a query at qp
__device__ __forceinline__ float masked(float s, int flag, int pos, int qp,
                                        const Args& a) {
  bool ok = flag > 0 && pos >= 0 && qp >= 0;
  if (a.causal) ok = ok && pos <= qp;
  if (a.window > 0) ok = ok && pos > qp - a.window;
  return flag < 0 ? -INFINITY : (ok ? s : kNegMask) * kLog2e;
}

// the run of table entries of split blockIdx.z into shared memory
__device__ __forceinline__ int load_run(const Args& a, int b, int* spage) {
  const int e0 = blockIdx.z * a.split_len;
  const int ne = min(a.MB - e0, a.split_len);
  for (int i = threadIdx.x; i < ne; i += blockDim.x)
    spage[i] = a.bt[(size_t)b * a.MB + e0 + i];
  return ne;
}

// -------------------------------------------------------------- decode

template <typename TQ, typename T>
__global__ void __launch_bounds__(32 * kMaxHeads) paged_decode_kernel(Args a) {
  constexpr int NT = kDecodeTile;
  const int G = a.H / a.Hkv;
  const int groups = gridDim.y / a.Hkv, hg = blockDim.x / 32;
  const int b = blockIdx.x, kvh = blockIdx.y / groups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = (blockIdx.y % groups) * hg + warp;
  const bool active = g < G;
  const int head = kvh * G + min(g, G - 1);
  const int rowb = a.Dh * (int)sizeof(T);
  const int d4 = a.Dh / 4;

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const int sb = stage_bytes(NT, rowb);
  float* wk = reinterpret_cast<float*>(base + 2 * sb);   // narrow: widened
  float* wv = wk + NT * a.Dh;
  int* spage = reinterpret_cast<int*>(
      base + 2 * sb + (kNarrow<T> ? 2 * NT * a.Dh * 4 : 0));
  pdl_enter();

  // this lane's 4-element groups c = lane, lane + 32 of the pre-scaled q
  float4 qv[2], acc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = lane + 32 * i;
    qv[i] = acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < d4) {
      qv[i] = widen4(static_cast<const TQ*>(a.q) +
                     ((size_t)b * a.H + head) * a.Dh + 4 * c);
      qv[i].x *= a.scale; qv[i].y *= a.scale;
      qv[i].z *= a.scale; qv[i].w *= a.scale;
    }
  }
  const int qp = a.q_start[b];
  float m_run = -INFINITY, l_run = 0.f;

  const int nslots = load_run(a, b, spage) * a.BS;
  const int ntiles = (nslots + NT - 1) / NT;
  __syncthreads();
  stage_tile<T>(a, spage, kvh, 0, NT, nslots, rowb, stage_at(base, NT, rowb));
  cp_async_commit();

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();     // tile it landed; tile it - 1's stage is free
    if (it + 1 < ntiles) {
      stage_tile<T>(a, spage, kvh, (it + 1) * NT, NT, nslots, rowb,
                    stage_at(base + ((it + 1) & 1) * sb, NT, rowb));
      cp_async_commit();
    }
    const Stage st = stage_at(base + (it & 1) * sb, NT, rowb);
    const float* sk = reinterpret_cast<const float*>(st.k);
    const float* sv = reinterpret_cast<const float*>(st.v);
    if constexpr (kNarrow<T>) {
      widen_tile<T>(st, NT, a.Dh, a.Dh, a.Dh, wk, wv);
      __syncthreads();
      sk = wk;
      sv = wv;
    }
    if (!active) continue;

    float s[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = lane + 32 * i;
        if (c < d4) {
          const float4 k4 =
              reinterpret_cast<const float4*>(sk + j * a.Dh)[c];
          part += qv[i].x * k4.x + qv[i].y * k4.y + qv[i].z * k4.z +
                  qv[i].w * k4.w;
        }
      }
      s[j] = part;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j] = masked(warp_sum(s[j]), st.flag[j], st.pos[j], qp, a);
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m_run, mx);
    const float alpha = exp2f(m_run - m_new);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      acc[i].x *= alpha; acc[i].y *= alpha;
      acc[i].z *= alpha; acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p = exp2f(s[j] - m_new);
      l_run += p;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = lane + 32 * i;
        if (c < d4) {
          const float4 v4 =
              reinterpret_cast<const float4*>(sv + j * a.Dh)[c];
          acc[i].x += p * v4.x; acc[i].y += p * v4.y;
          acc[i].z += p * v4.z; acc[i].w += p * v4.w;
        }
      }
    }
  }
  if (!active) return;

  const size_t nrows = (size_t)a.B * a.H, row = (size_t)b * a.H + head;
  const bool part = a.nsplit > 1;
  const float inv = part ? 1.f : 1.f / l_run;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = lane + 32 * i;
    if (c >= d4) continue;
    const float4 o = make_float4(acc[i].x * inv, acc[i].y * inv,
                                 acc[i].z * inv, acc[i].w * inv);
    if (part)
      store4(a.part_o + (blockIdx.z * nrows + row) * a.Dh + 4 * c, o);
    else
      store4(static_cast<TQ*>(a.out) + row * a.Dh + 4 * c, o);
  }
  if (part && lane == 0) {
    a.part_ml[2 * (blockIdx.z * nrows + row)] = m_run;
    a.part_ml[2 * (blockIdx.z * nrows + row) + 1] = l_run;
  }
}

// --------------------------------------------------------------- chunk

// stored K/V rows of the chunk kernel: D elements and 16 bytes of padding,
// so the fragment loads are free of bank conflicts for every element size
template <typename T, int D>
constexpr int kChunkLd = D + 16 / (int)sizeof(T);

// Q hi and lo, two stages, the widened K and V tile (int8 / fp8), the run
// of table entries
template <typename T, int D>
constexpr int chunk_smem(int split_len) {
  return 2 * 16 * kChunkWarps * Cfg<D>::MT * (D + 4) * 4 +
         2 * stage_bytes(Cfg<D>::BK, kChunkLd<T, D> * (int)sizeof(T)) +
         (kQuantized<T> ? 2 * Cfg<D>::BK * (D + 4) * 4 : 0) + 4 * split_len;
}

template <typename TQ, typename T, int D>
__global__ void __launch_bounds__(kChunkThreads, Cfg<D>::kMinBlocks)
    paged_chunk_kernel(Args a) {
  constexpr int BK = Cfg<D>::BK, MT = Cfg<D>::MT, LD = D + 4;
  constexpr int LDS = kChunkLd<T, D>, ROWB = LDS * (int)sizeof(T);
  constexpr int BQ = 16 * kChunkWarps * MT;     // query rows a block
  constexpr int NT = BK / 8, DT = D / 8;        // key groups, head-dim groups
  constexpr int SB = stage_bytes(BK, ROWB);
  extern __shared__ float4 smem4[];
  float* sqh = reinterpret_cast<float*>(smem4);   // BQ x LD, tf32 hi
  float* sql = sqh + BQ * LD;                     // BQ x LD, tf32 lo
  char* stages = reinterpret_cast<char*>(sql + BQ * LD);
  float* wk = reinterpret_cast<float*>(stages + 2 * SB);  // int8 / fp8
  float* wv = wk + BK * LD;
  int* spage = reinterpret_cast<int*>(
      stages + 2 * SB + (kQuantized<T> ? 2 * BK * LD * 4 : 0));

  const int G = a.H / a.Hkv, nq = G * a.Lq;       // query rows of a KV head
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / a.Hkv, kvh = blockIdx.y % a.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int dq = a.Dh / 4;
  pdl_enter();

  // Q: tile row r is query (li, g') = divmod(q0 + r, G), head kvh * G + g'.
  // fp32 rows by cp.async; bf16 rows by 16-byte loads of 8 values, every
  // load of a thread issued before any is widened (their latencies
  // overlap), zeros for the padded columns [Dh, D)
  if constexpr (std::is_same<TQ, float>::value) {
    for (int i = tid; i < BQ * dq; i += kChunkThreads) {
      const int r = i / dq, c = i % dq, gr = q0 + r;
      const bool ok = gr < nq;
      const int li = ok ? gr / G : 0, head = kvh * G + (ok ? gr % G : 0);
      cp_async16(sqh + r * LD + 4 * c,
                 static_cast<const float*>(a.q) +
                     (((size_t)b * a.Lq + li) * a.H + head) * a.Dh + 4 * c,
                 ok);
    }
  } else {
    constexpr int C8 = D / 8, PER = BQ * C8 / kChunkThreads;
    static_assert(BQ * C8 % kChunkThreads == 0, "whole rounds of Q loads");
    uint4 raw[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = tid + k * kChunkThreads, c = i % C8, gr = q0 + i / C8;
      const bool ok = gr < nq && 8 * c < a.Dh;
      const int li = ok ? gr / G : 0, head = kvh * G + (ok ? gr % G : 0);
      raw[k] = ok ? *reinterpret_cast<const uint4*>(
                        static_cast<const TQ*>(a.q) +
                        (((size_t)b * a.Lq + li) * a.H + head) * a.Dh + 8 * c)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = tid + k * kChunkThreads;
      float* dst = sqh + (i / C8) * LD + 8 * (i % C8);
      *reinterpret_cast<float4*>(dst) = widen4(make_uint2(raw[k].x, raw[k].y));
      *reinterpret_cast<float4*>(dst + 4) =
          widen4(make_uint2(raw[k].z, raw[k].w));
    }
  }
  cp_async_commit();
  // zero the padded head-dim columns [Dh, D) of Q and of every stored K/V
  // row (no copy writes them; Q's zeros make K's harmless, V's only reach
  // unstored columns)
  if (a.Dh < D) {
    const int pc = D - a.Dh;
    for (int i = tid; i < 2 * BQ * pc; i += kChunkThreads)
      sqh[(i / pc) * LD + a.Dh + i % pc] = 0.f;
    const int bytes = pc * (int)sizeof(T) / 4;     // 4-byte words a row
    const int lo = a.Dh * (int)sizeof(T);
    for (int i = tid; i < 2 * 2 * BK * bytes; i += kChunkThreads) {
      const int r = i / bytes, w = i % bytes;      // r: stage, K|V, row
      char* row = stages + (r / (2 * BK)) * SB + (r % (2 * BK)) * ROWB;
      reinterpret_cast<int*>(row + lo)[w] = 0;
    }
  }
  const int nslots = load_run(a, b, spage) * a.BS;
  const int ntiles = (nslots + BK - 1) / BK;
  __syncthreads();
  stage_tile<T>(a, spage, kvh, 0, BK, nslots, ROWB, stage_at(stages, BK, ROWB));
  cp_async_commit();

  // Q: scale, then split once into hi and lo (a bf16 q's scaled value is
  // not always a TF32 value, so the split stays for both query types)
  cp_async_wait<1>();
  __syncthreads();
  for (int i = tid; i < BQ * D; i += kChunkThreads) {
    const int r = i / D, c = i % D;
    uint32_t hi, lo;
    split(sqh[r * LD + c] * a.scale, hi, lo);
    sqh[r * LD + c] = __uint_as_float(hi);
    sql[r * LD + c] = __uint_as_float(lo);
  }

  // this thread's rows: m-tile m holds rows r0 + 16 m + g and + 8; a row's
  // query position, -1 for bucket padding and inactive rows
  const int r0 = warp * 16 * MT;
  const int qs = a.q_start[b], ql = a.q_len[b];
  int qpos[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int gr = q0 + r0 + 16 * m + 8 * hf + g, li = gr / G;
      qpos[m][hf] = gr < nq && qs >= 0 && li < ql ? qs + li : -1;
    }
  float o[MT][DT][4];
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int n = 0; n < DT; ++n)
      o[m][n][0] = o[m][n][1] = o[m][n][2] = o[m][n][3] = 0.f;
    m_run[m][0] = m_run[m][1] = -INFINITY;
    l_run[m][0] = l_run[m][1] = 0.f;
  }
  const float* qh = sqh + (r0 + g) * LD + t;
  const float* qlo = sql + (r0 + g) * LD + t;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();     // tile it landed; tile it - 1's stage is free
    if (it + 1 < ntiles) {
      stage_tile<T>(a, spage, kvh, (it + 1) * BK, BK, nslots, ROWB,
                    stage_at(stages + ((it + 1) & 1) * SB, BK, ROWB));
      cp_async_commit();
    }
    // fp32 and bf16 fragments read the stage (bf16 widens by a shift);
    // int8 / fp8 tiles are widened and scaled once
    const Stage st = stage_at(stages + (it & 1) * SB, BK, ROWB);
    const T* sk = reinterpret_cast<const T*>(st.k);
    const T* sv = reinterpret_cast<const T*>(st.v);
    if constexpr (kQuantized<T>) {
      widen_tile<T>(st, BK, D, LDS, LD, wk, wv);
      __syncthreads();
    }
    auto kv = [&](const T* raw, const float* wide, int r, int c) {
      if constexpr (kQuantized<T>) return wide[r * LD + c];
      else return to_float(raw[r * LDS + c]);
    };

    float s[MT][NT][4];
    tile_scores<MT, NT, DT, LD>(
        s, qh, qlo, [&](int r, int c) { return kv(sk, wk, r, c); });
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = 8 * j + 2 * t + (e & 1);
        const int flag = st.flag[kk], pos = st.pos[kk];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          s[m][j][e] = masked(s[m][j][e], flag, pos, qpos[m][e >> 1], a);
      }
    tile_softmax(s, o, m_run, l_run);
    tile_pv(o, s, [&](int r, int c) { return kv(sv, wv, r, c); });
  }

  const size_t nrows = (size_t)a.B * a.Lq * a.H;
  const bool part = a.nsplit > 1;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float l = l_run[m][hf];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int gr = q0 + r0 + 16 * m + 8 * hf + g;
      if (gr >= nq) continue;
      const size_t row = ((size_t)b * a.Lq + gr / G) * a.H + kvh * G + gr % G;
      const float inv = part ? 1.f : 1.f / l;
      float* prow = a.part_o + (blockIdx.z * nrows + row) * a.Dh;
      TQ* orow = static_cast<TQ*>(a.out) + row * a.Dh;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const int d = 8 * n + 2 * t;
        if (d >= a.Dh) break;
        const float x = o[m][n][2 * hf] * inv, y = o[m][n][2 * hf + 1] * inv;
        if (part)
          store2(prow + d, x, y);
        else
          store2(orow + d, x, y);
      }
      if (part && t == 0) {
        a.part_ml[2 * (blockIdx.z * nrows + row)] = m_run[m][hf];
        a.part_ml[2 * (blockIdx.z * nrows + row) + 1] = l;
      }
    }
  }
}

// one warp per (row, query, head): merge the splits in split order
template <typename TQ>
__global__ void __launch_bounds__(128) paged_combine_kernel(Args a) {
  pdl_enter();
  const size_t nrows = (size_t)a.B * a.Lq * a.H;
  const size_t row = (size_t)blockIdx.x * 4 + threadIdx.x / 32;
  if (row >= nrows) return;
  merge_splits(a.part_o, a.part_ml, static_cast<TQ*>(a.out), nrows, row,
               a.Dh, a.nsplit, threadIdx.x % 32);
}

// ------------------------------------------------------------- launch

// Launch with programmatic dependent launch (Hopper): the grid may be
// scheduled while the previous kernel in the stream drains; each kernel
// here waits for it (pdl_enter) before it reads anything.
cudaError_t launch_pdl(void (*kernel)(Args), dim3 grid, int threads,
                       int smem, cudaStream_t st, const Args& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

// dynamic shared memory above 48 KB is allowed once a kernel and process
template <auto Kernel>
cudaError_t allow_smem(int smem) {
  static bool done = false;
  if (smem <= 48 * 1024 || done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  done = e == cudaSuccess;
  return e;
}

template <typename TQ, typename T>
cudaError_t launch_decode(const Args& a, cudaStream_t st) {
  const int G = a.H / a.Hkv;
  const int groups = (G + kMaxHeads - 1) / kMaxHeads;
  const int hg = (G + groups - 1) / groups;
  const int smem = 2 * stage_bytes(kDecodeTile, a.Dh * (int)sizeof(T)) +
                   (kNarrow<T> ? 2 * kDecodeTile * a.Dh * 4 : 0) +
                   4 * a.split_len;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem<paged_decode_kernel<TQ, T>>(smem);
  if (e != cudaSuccess) return e;
  return launch_pdl(paged_decode_kernel<TQ, T>,
                    dim3(a.B, a.Hkv * groups, a.nsplit), 32 * hg, smem, st,
                    a);
}

template <typename TQ, typename T, int D>
cudaError_t launch_chunk(const Args& a, cudaStream_t st) {
  const int smem = chunk_smem<T, D>(a.split_len);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem<paged_chunk_kernel<TQ, T, D>>(smem);
  if (e != cudaSuccess) return e;
  constexpr int BQ = 16 * kChunkWarps * Cfg<D>::MT;
  const int nq = a.H / a.Hkv * a.Lq;
  return launch_pdl(paged_chunk_kernel<TQ, T, D>,
                    dim3((nq + BQ - 1) / BQ, a.B * a.Hkv, a.nsplit),
                    kChunkThreads, smem, st, a);
}

template <typename TQ, typename T>
cudaError_t launch_kind(bool prefill, const Args& a, cudaStream_t st) {
  if (!prefill) return launch_decode<TQ, T>(a, st);
  return a.Dh <= 32 ? launch_chunk<TQ, T, 32>(a, st)
         : a.Dh <= 64 ? launch_chunk<TQ, T, 64>(a, st)
         : a.Dh <= 128 ? launch_chunk<TQ, T, 128>(a, st)
                       : launch_chunk<TQ, T, 256>(a, st);
}

template <typename TQ>
cudaError_t launch_storage(int kind, bool prefill, const Args& a,
                           cudaStream_t st) {
  switch (kind) {
    case 0: return launch_kind<TQ, float>(prefill, a, st);
    case 1: return launch_kind<TQ, __nv_bfloat16>(prefill, a, st);
    case 2: return launch_kind<TQ, int8_t>(prefill, a, st);
    case 3: return launch_kind<TQ, __nv_fp8_e4m3>(prefill, a, st);
    default: return cudaErrorInvalidValue;
  }
}

// storage kind: 0 fp32, 1 bf16, 2 int8, 3 fp8 e4m3 (kernels/paged_attention.py
// STORAGE_KINDS); int8 and fp8 need both scale arrays, the others none.
// q_bf16: the query and output type, 0 fp32, 1 bf16.
int dispatch(int kind, int q_bf16, bool prefill, const Args& a,
             void* stream) {
  const bool quant = kind == 2 || kind == 3;
  // Dh % 4 == 0 keeps every four-element load aligned for every kind
  if (quant != (a.ksc != nullptr) || quant != (a.vsc != nullptr) ||
      a.Dh % 4 || a.Dh < 4 || a.Dh > 256 || a.H % a.Hkv || a.Lq < 1 ||
      a.BS < 1 || a.MB < 1 || a.nsplit < 1 || a.split_len < 1 ||
      (long long)a.nsplit * a.split_len < a.MB ||
      (long long)(a.nsplit - 1) * a.split_len >= a.MB ||
      (a.nsplit > 1 && (a.part_o == nullptr || a.part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  // a bf16 q loads 8 values (16 bytes) at a time
  if ((q_bf16 != 0 && q_bf16 != 1) || (q_bf16 && a.Dh % 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      q_bf16 ? launch_storage<__nv_bfloat16>(kind, prefill, a, st)
             : launch_storage<float>(kind, prefill, a, st);
  if (e != cudaSuccess || a.nsplit == 1) return (int)e;
  const size_t nrows = (size_t)a.B * a.Lq * a.H;
  return (int)launch_pdl(q_bf16 ? paged_combine_kernel<__nv_bfloat16>
                                : paged_combine_kernel<float>,
                         dim3((unsigned)((nrows + 3) / 4)), 128, 0, st, a);
}

}  // namespace

// nsplit > 1: part_o holds nsplit*B*Lq*H*Dh floats, part_ml nsplit*B*Lq*H*2;
// split s walks table entries [s * split_len, min(MB, (s + 1) * split_len)).
// q and out are fp32 (q_bf16 = 0) or bf16 (1).
extern "C" int paged_attention_decode(
    const void* q, const void* kp, const void* vp, const float* ksc,
    const float* vsc, const int* bt, const int* ppos, const int* q_pos,
    void* out, float* part_o, float* part_ml, int kind, int q_bf16, int B,
    int H, int Hkv, int Dh, int BS, int MB, int causal, int window,
    int nsplit, int split_len, float scale, void* stream) {
  Args a{q, kp, vp, ksc, vsc, bt, ppos, q_pos, nullptr, out, part_o, part_ml,
         B, 1, H, Hkv, Dh, BS, MB, causal, window, nsplit, split_len, scale};
  return dispatch(kind, q_bf16, false, a, stream);
}

extern "C" int paged_attention_prefill(
    const void* q, const void* kp, const void* vp, const float* ksc,
    const float* vsc, const int* bt, const int* ppos, const int* q_start,
    const int* q_len, void* out, float* part_o, float* part_ml, int kind,
    int q_bf16, int B, int Lq, int H, int Hkv, int Dh, int BS, int MB,
    int causal, int window, int nsplit, int split_len, float scale,
    void* stream) {
  Args a{q, kp, vp, ksc, vsc, bt, ppos, q_start, q_len, out, part_o, part_ml,
         B, Lq, H, Hkv, Dh, BS, MB, causal, window, nsplit, split_len, scale};
  return dispatch(kind, q_bf16, true, a, stream);
}
