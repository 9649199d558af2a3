// Flash-decode: one query per row against a contiguous ring KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, _kernel): decode_kernel, one launch.
//
// Layouts (as in the reference, read in place): q (B, 1, H, Dh);
// k, v (B, C, Hkv, Dh), the ring cache itself (the Pallas wrapper's
// (B, Hkv, C, Dh) transposed copy is not made: a slot's head row is
// addressed with stride Hkv * Dh); slot_pos (C,) int32, the absolute
// position each slot holds (-1 = empty; not monotone once the ring wraps).
// The query's position is an int argument or, when q_pos_ptr is given, an
// int32 in device memory read by the kernel: nothing about a position
// reaches the host, so a captured launch replays at whatever position the
// tensor holds.  q, k, v and the output are all fp32 or all bf16 (the
// compute dtype): as the Pallas kernel, bf16 elements are widened to fp32
// as they are read, everything is computed in fp32, and the output is
// rounded to bf16 once.  A 16-byte copy carries 4 fp32 or 8 bf16 values.
//
// Bound.  One query per (row, head) reads each visible slot's K and V row
// once per KV head: ~2 * Dh * E bytes (E = 4, or 2 in bf16) per (row, KV
// head, slot) against
// 4 * Dh * G flops, ~3 flops per byte at G = 6, so bytes bound it.  At the
// main path's shape (B = 4, C = 124, 2 KV heads of 128) that is ~1 MB, a
// fraction of a microsecond at 3.35 TB/s: what bounds it there is latency
// (the launch and the dependent loads of one short walk).  At whisper's
// cross-attention decode (C = 1500, 12 KV heads of 64) it is 37 MB, 11 us.
//
// Design (after paged_attention.cu's decode kernel, without the table).
//  * Split walk.  Block (row, KV head, group of at most kMaxHeads query
//    heads, split) walks a contiguous run of split_len slots; the plan
//    (kernels/decode_attention.py ``plan``) depends on shapes only and
//    trades the number of splits against the tiles each walks.
//  * One warp per query head.  K/V go to shared memory once for the group,
//    so GQA never repeats K/V.  Each lane holds Dh / 32 elements of the
//    pre-scaled q; a slot's score is a shuffle-reduced dot product, and the
//    online softmax (log2 units) and the accumulator live in registers.
//  * A cp.async ring of kStages kTile-slot tiles, the slots' positions
//    riding in the same stage: the next tiles are in flight while one is
//    consumed, one barrier a tile.
//  * One launch, merged on chip.  With several splits the nsplit blocks of
//    a (row, KV head, group) form a thread block cluster (Hopper; up to 16
//    blocks).  Each keeps its unnormalised (acc, m, l) in its shared
//    memory; after a cluster barrier the cluster's first block reads every
//    split's partial through distributed shared memory and merges them by
//    their log-sum-exp in split order, so repeats are bit-identical.  No
//    partial goes to device memory, and no counter or other state outlives
//    the launch, so a captured launch replays as it ran.
//  * Masked queries.  The mask value is the finite -2**30 of the
//    reference: a query that sees no slot returns the uniform mean of V
//    over all C slots, as the plain version does.  No slot is skipped, so
//    each split yields (m = -2**30, l = its slot count, acc = its V sum)
//    for such a query and the merge gives the mean.  Slots past a split's
//    run (a tile's ragged end) are zero-filled and weigh exactly 0.
#include <cooperative_groups.h>

#include "attn_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 16;        // cache slots a stage
constexpr int kStages = 3;       // stages of the cp.async ring
constexpr int kMaxHeads = 8;     // query heads (warps) a block
constexpr int kMaxSplits = 16;   // blocks a cluster (non-portable above 8)

struct Args {
  const void* q;         // q, k, v and out: float, or bf16
  const void* k;
  const void* v;
  const int* slot_pos;
  const int* q_pos_ptr;  // nullable: the query position in device memory
  void* out;             // (B, H, Dh)
  int B, C, H, Hkv, Dh, q_pos, causal, window, nsplit, split_len;
  float scale;
};

// 4 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// four consecutive elements (16- or 8-byte aligned) as fp32, exactly, and
// four fp32 values stored as the element type (bf16: rounded once)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
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

// bytes of one stage: K and V rows of kTile slots (elements of esize
// bytes), then their positions
__host__ __device__ constexpr int stage_bytes(int dh, int esize) {
  return 2 * kTile * dh * esize + kTile * 4;
}

// dynamic shared memory: the ring, then each warp's partial (acc of Dh
// floats, m, l, padded to a multiple of 4)
__host__ __device__ constexpr int smem_bytes(int dh, int esize, int warps) {
  return kStages * stage_bytes(dh, esize) + warps * (dh + 4) * 4;
}

// Issue the copies of tile it of the split's run (slots [s_begin, s_begin +
// nslots)) into its stage: K/V rows by 16-byte cp.async, positions by
// 4-byte ones; past the run, zeros.  One commit group a call, empty for a
// tile past the run, so the ring's group count stays uniform.
template <typename T>
__device__ __forceinline__ void stage_tile(const Args& a, char* base, int b,
                                           int kvh, int s_begin, int nslots,
                                           int ntiles, int it) {
  constexpr int E = 16 / sizeof(T);              // elements a 16-byte copy
  const int dc16 = a.Dh / E, s0 = it * kTile;
  if (it < ntiles) {
    T* sk = reinterpret_cast<T*>(base +
                                 (it % kStages) * stage_bytes(a.Dh, sizeof(T)));
    T* sv = sk + kTile * a.Dh;
    int* sp = reinterpret_cast<int*>(sv + kTile * a.Dh);
    const T* k = static_cast<const T*>(a.k);
    const T* v = static_cast<const T*>(a.v);
    // (row, 16-byte chunk) pairs, stepped without a division each
    const int dr = blockDim.x / dc16, dc = blockDim.x % dc16;
    int r = threadIdx.x / dc16, c = threadIdx.x % dc16;
    for (; r < kTile; r += dr, c += dc) {
      if (c >= dc16) {
        c -= dc16;
        if (++r >= kTile) break;
      }
      const bool ok = s0 + r < nslots;
      const size_t off =
          (((size_t)b * a.C + s_begin + (ok ? s0 + r : 0)) * a.Hkv + kvh) *
              a.Dh + E * c;
      cp_async16(sk + r * a.Dh + E * c, k + off, ok);
      cp_async16(sv + r * a.Dh + E * c, v + off, ok);
    }
    for (int j = threadIdx.x; j < kTile; j += blockDim.x) {
      const bool ok = s0 + j < nslots;
      cp_async4(sp + j, a.slot_pos + s_begin + (ok ? s0 + j : 0), ok);
    }
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(32 * kMaxHeads) decode_kernel(Args a) {
  constexpr int NT = kTile;
  const int G = a.H / a.Hkv;
  const int groups = gridDim.y / a.Hkv, hg = blockDim.x / 32;
  const int b = blockIdx.x, kvh = blockIdx.y / groups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = (blockIdx.y % groups) * hg + warp;
  const bool active = g < G;
  const int head = kvh * G + min(g, G - 1);
  const int d4 = a.Dh / 4;
  const int s_begin = blockIdx.z * a.split_len;
  const int nslots = min(a.C - s_begin, a.split_len);
  const int ntiles = (nslots + NT - 1) / NT;

  const int sb = stage_bytes(a.Dh, sizeof(T));
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  for (int it = 0; it < kStages - 1; ++it)
    stage_tile<T>(a, base, b, kvh, s_begin, nslots, ntiles, it);

  // this lane's 4-element groups c = lane, lane + 32 of the pre-scaled q
  float4 qv[2], acc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = lane + 32 * i;
    qv[i] = acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < d4) {
      qv[i] = load4(static_cast<const T*>(a.q) +
                    ((size_t)b * a.H + head) * a.Dh + 4 * c);
      qv[i].x *= a.scale; qv[i].y *= a.scale;
      qv[i].z *= a.scale; qv[i].w *= a.scale;
    }
  }
  const int qp = a.q_pos_ptr != nullptr ? *a.q_pos_ptr : a.q_pos;
  float m_run = -INFINITY, l_run = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();     // tile it landed; tile it - 1's stage is free
    stage_tile<T>(a, base, b, kvh, s_begin, nslots, ntiles, it + kStages - 1);
    if (!active) continue;
    const T* sk = reinterpret_cast<const T*>(base + (it % kStages) * sb);
    const T* sv = sk + NT * a.Dh;
    const int* sp = reinterpret_cast<const int*>(sv + NT * a.Dh);

    float s[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = lane + 32 * i;
        if (c < d4) {
          const float4 k4 = load4(sk + j * a.Dh + 4 * c);
          part += qv[i].x * k4.x + qv[i].y * k4.y + qv[i].z * k4.z +
                  qv[i].w * k4.w;
        }
      }
      s[j] = part;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int pos = sp[j];
      bool ok = pos >= 0;
      if (a.causal) ok = ok && pos <= qp;
      if (a.window > 0) ok = ok && pos > qp - a.window;
      const float sc = warp_sum(s[j]);
      s[j] = it * NT + j >= nslots ? -INFINITY : (ok ? sc : kNegMask) * kLog2e;
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
          const float4 v4 = load4(sv + j * a.Dh + 4 * c);
          acc[i].x += p * v4.x; acc[i].y += p * v4.y;
          acc[i].z += p * v4.z; acc[i].w += p * v4.w;
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out) + ((size_t)b * a.H + head) * a.Dh;
  if (a.nsplit == 1) {
    if (!active) return;
    const float inv = 1.f / l_run;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = lane + 32 * i;
      if (c < d4)
        store4(out + 4 * c, make_float4(acc[i].x * inv, acc[i].y * inv,
                                        acc[i].z * inv, acc[i].w * inv));
    }
    return;
  }

  // several splits: this block's partial to shared memory, then the
  // cluster's first block merges every split's, in split order
  float* mine =
      reinterpret_cast<float*>(base + kStages * sb) + warp * (a.Dh + 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (lane + 32 * i < d4)
      reinterpret_cast<float4*>(mine)[lane + 32 * i] = acc[i];
  if (lane == 0) {
    mine[a.Dh] = m_run;
    mine[a.Dh + 1] = l_run;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();        // every split's partial written
  if (cluster.block_rank() == 0 && active) {
    float m = -INFINITY;
    for (int s = 0; s < a.nsplit; ++s)
      m = fmaxf(m, cluster.map_shared_rank(mine, s)[a.Dh]);
    float l = 0.f;
    for (int s = 0; s < a.nsplit; ++s) {
      const float* p = cluster.map_shared_rank(mine, s);
      l += p[a.Dh + 1] * exp2f(p[a.Dh] - m);
    }
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = lane + 32 * i;
      if (c >= d4) continue;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < a.nsplit; ++s) {
        const float* p = cluster.map_shared_rank(mine, s);
        const float w = exp2f(p[a.Dh] - m);
        const float4 x = reinterpret_cast<const float4*>(p)[c];
        o.x += x.x * w; o.y += x.y * w; o.z += x.z * w; o.w += x.w * w;
      }
      store4(out + 4 * c,
             make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv));
    }
  }
  cluster.sync();        // no block leaves while its partial is read
}

// Launch decode_kernel<T> as one cluster of nsplit blocks per (row, KV
// head, head group); the attributes are set once a kernel and process.
template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  const int groups = (G + kMaxHeads - 1) / kMaxHeads;
  const int hg = (G + groups - 1) / groups;
  const int smem = smem_bytes(a.Dh, sizeof(T), hg);
  static int allowed = 48 * 1024;    // dynamic shared memory allowed so far
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  static bool wide = false;          // clusters above 8 blocks: once
  if (a.nsplit > 8 && !wide) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    wide = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B, a.Hkv * groups, a.nsplit);
  cfg.blockDim = dim3(32 * hg);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = a.nsplit;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_kernel<T>, a);
}

}  // namespace

// Split s walks slots [s * split_len, min(C, (s + 1) * split_len)); with
// nsplit > 1 (at most 16) the splits of a (row, KV head, group) run as one
// thread block cluster.  q, k, v and out fp32 (bf16 = 0; Dh a multiple of
// 4) or bf16 (bf16 = 1; Dh a multiple of 8).  Pointers 16-byte aligned;
// q_pos_ptr may be null (then q_pos is read).
extern "C" int decode_attention_forward(
    const void* q, const void* k, const void* v, const int* slot_pos,
    const int* q_pos_ptr, void* out, int B, int C, int H, int Hkv, int Dh,
    int q_pos, int causal, int window, int nsplit, int split_len, int bf16,
    float scale, void* stream) {
  if (Dh % (bf16 ? 8 : 4) || Dh < 4 || Dh > 256 || H % Hkv ||
      H / Hkv > 2 * kMaxHeads || C < 1 || nsplit < 1 ||
      nsplit > kMaxSplits || split_len < 1 ||
      (long long)nsplit * split_len < C ||
      (long long)(nsplit - 1) * split_len >= C || (bf16 != 0 && bf16 != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, slot_pos, q_pos_ptr, out, B, C, H, Hkv, Dh, q_pos,
               causal, window, nsplit, split_len, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st));
}
