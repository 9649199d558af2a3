// Flash attention (causal / sliding-window / bidirectional, GQA, logit
// softcap) over fresh K/V, for Hopper (sm_90a), on the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, _kernel): flash_attention_kernel, and
// flash_combine_kernel when the key axis is split.
//
// Layouts (as in the reference, read in place): q (B, Lq, H, Dh); k, v
// (B, Lk, Hkv, Dh); out (B, Lq, H, Dh); all fp32 or all bf16 (one
// instantiation each).  As the Pallas kernel, bf16 operands are widened to
// fp32 (exactly), the attention runs in fp32 and the output is rounded to
// bf16 once, where it is written; a split's partial stays fp32 and only
// the combine rounds.  Query i sits at
// position q_offset + i, key j at position j.  Mask, as the reference:
// key j < Lk, and j <= q (causal), j > q - window (window > 0); the
// softcap tanh(s / c) * c applies to the scaled logit before the mask.
//
// Bound.  Each (query, visible key) pair costs 4 * Dh flops.  Whisper's
// encoder (bidirectional L = 1500, 12 heads of 64, 4 rows) is 27.65
// GFLOP against 4.6 MB of q, k, v and out: operations bound it.  On the
// CUDA cores (67 TFLOP/s fp32) that is 0.41 ms; on the TF32 tensor cores
// (495 TFLOP/s dense) three products per product (below) give 165
// TFLOP/s of fp32-exact work: 0.168 ms.  Short or narrow shapes (whisper's
// cross-attention, Lq 100 over Lk 1500) are bound by their bytes.
//
// Why three TF32 products.  The port serves in fp32 and holds this kernel
// to 1e-4 of its plain version.  One TF32 product keeps 10 mantissa bits
// of each operand: at L = 1500 its error is ~1.4e-4, outside that bound.
// Each operand x is split into hi = tf32(x) and lo = tf32(x - hi) (both
// rounded with cvt.rna.tf32.f32) and the product is accumulated in fp32
// as lo*hi + hi*lo + hi*hi; the dropped lo*lo term is ~2^-22 relative, so
// the result has fp32's accuracy (~2e-7 at L = 1500).  Both products (Q
// K^T and P V) take the split on both operands.
//
// Design.  The tile step (S = Q K^T, the online softmax, O += P V) and the
// split merge are in attn_tile.cuh, shared with paged_attention.cu.
//  * mma.sync.m16n8k8 TF32 with fp32 accumulators (FA2 layout).  A block
//    is four warps over one (row, head); each warp holds MT m-tiles of 16
//    query rows: MT = 2 at Dh <= 64 (128 rows a block), 1 above (64 rows,
//    as the accumulators of Dh 128 / 256 fill the registers).  Q is scaled,
//    split once per block and kept in shared memory as hi and lo; each K/V
//    element is split in registers as its warp loads it (three ALU ops) and
//    serves the warp's MT m-tiles.  A pre-split lo copy of each K/V tile
//    would double the shared bytes the fragment loads move and cost the
//    second block an SM.
//  * Scores and probabilities stay in registers: the online softmax
//    (running max, rescale, sum, in log2 units) runs on the mma
//    accumulators with quad shuffles, and P feeds the PV product straight
//    from the accumulator layout.  The accumulator holds keys (2t, 2t+1)
//    of each 8-key group where the A fragment wants (t, t+4); the PV
//    product therefore reads V rows 2t and 2t+1 for k-slots t and t+4 (a
//    permutation of the summation order, no shuffle).
//  * K/V tiles of BK keys stream through a two-stage cp.async ring: tile
//    i+1 is in flight while tile i is consumed.  Shared rows are padded by
//    16 bytes (D + 4 floats, D + 8 bf16), so every fragment load is free of
//    bank conflicts.  bf16 tiles are stored as loaded (half the bytes) and
//    the fragment loads widen each element (a shift), as the paged chunk
//    kernel reads bf16 pages; Q, loaded once a block, is widened into the
//    fp32 tile by plain 16-byte loads.  A widened bf16 value is exact in
//    TF32 (its lo part is 0), so the split products stay exact.
//  * The head dim is padded to the mma depth: D = 32, 64, 128 or 256 (one
//    instantiation each) with zero columns in shared memory; BK = 64, 32,
//    16, 16, so that two blocks fit an SM up to D = 128 and D = 256 fits
//    one (Q 133 KB + ring 67 KB) without spills.
//  * The loop visits only the K tiles that meet the block's causal /
//    window band.  The mask value is the finite -2**30 of the reference: a
//    query that sees no key returns the mean of V over all Lk keys; a tile
//    holding such a query visits every K tile.  Keys past Lk are zero-
//    filled by the copy and weigh exactly 0.
//  * Grid fill: where (query tiles x H x B) leaves SMs idle (whisper's
//    cross-attention: 48 blocks), the wrapper splits the key tiles over
//    nsplit blocks (kernels/flash_attention.py ``splits``); each writes its
//    unnormalised (acc, m, l) and flash_combine_kernel merges them in
//    split order by their log-sum-exp (deterministic, no atomics), as
//    decode_attention.cu merges its splits.
#include <type_traits>

#include "attn_tile.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

struct Args {
  const void* q;    // q, k, v and out: float or bf16 (the kernel's T)
  const void* k;
  const void* v;
  void* out;
  float* part_o;    // (nsplit, B, Lq, H, Dh) unnormalised; nsplit == 1: unused
  float* part_ml;   // (nsplit, B, Lq, H, 2) running max (log2 units), sum
  int B, Lq, Lk, H, Hkv, Dh, causal, window, q_offset, nsplit, split_tiles;
  float scale, softcap;     // softcap <= 0: none
};

// K / V row stride in elements of T: 16 bytes of padding
template <typename T, int D>
constexpr int kLds = D + 16 / (int)sizeof(T);

template <int D, typename T>
constexpr size_t smem_bytes() {
  // Q hi + Q lo (BQ rows of fp32 each), two stages of K and V (BK rows of
  // T each)
  return sizeof(float) * (size_t)(2 * 16 * kWarps * Cfg<D>::MT) * (D + 4) +
         sizeof(T) * (size_t)(4 * Cfg<D>::BK) * kLds<T, D>;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
    flash_attention_kernel(Args a) {
  constexpr int BK = Cfg<D>::BK, MT = Cfg<D>::MT, LD = D + 4;
  constexpr int LDS = kLds<T, D>, VEC = 16 / (int)sizeof(T);
  constexpr int BQ = 16 * kWarps * MT;     // query rows a block
  constexpr int NT = BK / 8, DT = D / 8;   // key groups, head-dim groups
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ float4 smem4[];
  float* sqh = reinterpret_cast<float*>(smem4);   // BQ x LD, tf32 hi
  float* sql = sqh + BQ * LD;                     // BQ x LD, tf32 lo
  T* skv = reinterpret_cast<T*>(sql + BQ * LD);   // stages of K then V
  const T* gq = static_cast<const T*>(a.q);
  const T* gk = static_cast<const T*>(a.k);
  const T* gv = static_cast<const T*>(a.v);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const int b = blockIdx.z / a.nsplit, split_id = blockIdx.z % a.nsplit;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kvh = h / (a.H / a.Hkv);
  const int rows = min(BQ, a.Lq - q0);
  const int dq = a.Dh / VEC;                      // 16-byte chunks a row
  const size_t nrows = (size_t)a.B * a.Lq * a.H;

  // key tiles the block's queries can see: [kt_lo, kt_hi]; every tile when
  // one of them sees no key (its output is then the mean of V)
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
  const int kt_begin = max(k_lo / BK, split_id * a.split_tiles);
  const int kt_end = min(k_hi / BK + 1, (split_id + 1) * a.split_tiles);
  const int n_iter = kt_end - kt_begin;

  // this thread's rows: m-tile m holds rows r0 + 16 m + g and + 8
  const int r0 = warp * 16 * MT;
  if (n_iter <= 0) {        // a split outside the band: an empty partial
    for (int rr = 0; rr < 2 * MT; ++rr) {
      const int row = q0 + r0 + 8 * rr + g;
      if (row >= a.Lq) continue;
      const size_t i = (size_t)split_id * nrows +
                       ((size_t)b * a.Lq + row) * a.H + h;
      for (int d = 2 * t; d < a.Dh; d += 8)
        *reinterpret_cast<float2*>(a.part_o + i * a.Dh + d) =
            make_float2(0.f, 0.f);
      if (t == 0) {
        a.part_ml[2 * i] = -INFINITY;
        a.part_ml[2 * i + 1] = 0.f;
      }
    }
    return;
  }

  // zero the padded head-dim columns [Dh, D) of every row (no copy writes
  // them; Q's zeros make K's harmless, V's only reach unstored columns);
  // a bf16 Q's are written by its loads below
  if (a.Dh < D) {
    const int pc = (D - a.Dh) / 4;
    if constexpr (kF32)
      for (int i = tid; i < 2 * BQ * pc; i += kThreads)
        reinterpret_cast<float4*>(sqh + (i / pc) * LD + a.Dh)[i % pc] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    const int pk = (D - a.Dh) / VEC;
    for (int i = tid; i < 4 * BK * pk; i += kThreads)
      reinterpret_cast<uint4*>(skv + (i / pk) * LDS + a.Dh)[i % pk] =
          make_uint4(0u, 0u, 0u, 0u);
  }

  // Q: fp32 rows by cp.async; bf16 rows by 16-byte loads of 8 values, every
  // load of a thread issued before any is widened (their latencies overlap)
  if constexpr (kF32) {
    for (int i = tid; i < BQ * dq; i += kThreads) {
      const int r = i / dq, c = i % dq;
      const bool ok = q0 + r < a.Lq;
      cp_async16(sqh + r * LD + 4 * c,
                 gq + (((size_t)b * a.Lq + (ok ? q0 + r : 0)) * a.H + h) *
                          a.Dh + 4 * c, ok);
    }
    cp_async_commit();
  }

  auto load_kv = [&](int kt, int stage) {
    T* sk = skv + stage * 2 * BK * LDS;
    T* sv = sk + BK * LDS;
    const int k0 = kt * BK;
    for (int i = tid; i < BK * dq; i += kThreads) {
      const int r = i / dq, c = i % dq;
      const bool ok = k0 + r < a.Lk;
      const size_t off =
          (((size_t)b * a.Lk + (ok ? k0 + r : 0)) * a.Hkv + kvh) * a.Dh +
          VEC * c;
      cp_async16(sk + r * LDS + VEC * c, gk + off, ok);
      cp_async16(sv + r * LDS + VEC * c, gv + off, ok);
    }
    cp_async_commit();
  };
  load_kv(kt_begin, 0);

  if constexpr (!kF32) {
    constexpr int C8 = D / 8, PER = BQ * C8 / kThreads;
    static_assert(BQ * C8 % kThreads == 0, "whole rounds of Q loads");
    uint4 raw[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * kThreads, r = i / C8, c = i % C8;
      const bool ok = q0 + r < a.Lq && 8 * c < a.Dh;
      raw[j] = ok ? *reinterpret_cast<const uint4*>(
                        gq + (((size_t)b * a.Lq + q0 + r) * a.H + h) * a.Dh +
                        8 * c)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = tid + j * kThreads;
      float* dst = sqh + (i / C8) * LD + 8 * (i % C8);
      *reinterpret_cast<float4*>(dst) = widen4(make_uint2(raw[j].x, raw[j].y));
      *reinterpret_cast<float4*>(dst + 4) =
          widen4(make_uint2(raw[j].z, raw[j].w));
    }
  }

  // Q: scale, then split once into hi and lo (a bf16 q's scaled value is
  // not always a TF32 value, so the split stays for both types); bf16
  // committed one group only, so the wait returns at once
  cp_async_wait<1>();
  __syncthreads();
  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    uint32_t hi, lo;
    split(sqh[r * LD + c] * a.scale, hi, lo);
    sqh[r * LD + c] = __uint_as_float(hi);
    sql[r * LD + c] = __uint_as_float(lo);
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
  const int qp0 = a.q_offset + q0 + r0 + g;       // m-tile 0, first row
  const float* qh = sqh + (r0 + g) * LD + t;
  const float* ql = sql + (r0 + g) * LD + t;

  for (int it = 0; it < n_iter; ++it) {
    const int kt = kt_begin + it;
    if (it + 1 < n_iter) {
      load_kv(kt + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sk = skv + (it & 1) * 2 * BK * LDS;
    const T* sv = sk + BK * LDS;

    // S = Q K^T
    float s[MT][NT][4];
    tile_scores<MT, NT, DT, LD>(
        s, qh, ql, [&](int r, int c) { return to_float(sk[r * LDS + c]); });

    // softcap, mask (log2 units), online softmax, O += P V
    const int k0 = kt * BK;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          const int qp = qp0 + 16 * m + (e < 2 ? 0 : 8);
          float x = s[m][j][e];
          if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
          bool ok = true;
          if (a.causal) ok = kp <= qp;
          if (a.window > 0) ok = ok && kp > qp - a.window;
          s[m][j][e] = kp >= a.Lk ? -INFINITY : (ok ? x : kNegMask) * kLog2e;
        }
    tile_softmax(s, o, m_run, l_run);
    tile_pv(o, s, [&](int r, int c) { return to_float(sv[r * LDS + c]); });
    __syncthreads();          // the stage is free for the copy after next
  }

  const bool part = a.nsplit > 1;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float l = l_run[m][hf];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = q0 + r0 + 16 * m + 8 * hf + g;
      if (row >= a.Lq) continue;
      const float inv = part ? 1.f : 1.f / l;
      const size_t ro = (((size_t)b * a.Lq + row) * a.H + h) * a.Dh;
      float* prow = a.part_o + (size_t)split_id * nrows * a.Dh + ro;
      T* orow = static_cast<T*>(a.out) + ro;
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
        const size_t i = (size_t)split_id * nrows +
                         ((size_t)b * a.Lq + row) * a.H + h;
        a.part_ml[2 * i] = m_run[m][hf];
        a.part_ml[2 * i + 1] = l;
      }
    }
  }
}

// one warp per (row, query, head): merge the splits by their log-sum-exp,
// in split order, and round once to the output type
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_combine_kernel(Args a) {
  const size_t nrows = (size_t)a.B * a.Lq * a.H;
  const size_t row = (size_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= nrows) return;
  merge_splits(a.part_o, a.part_ml, static_cast<T*>(a.out), nrows, row,
               a.Dh, a.nsplit, threadIdx.x % 32);
}

// keys per K tile at head_dim Dh (kernels/flash_attention.py TILES)
int block_k(int Dh) {
  return Dh <= 32 ? Cfg<32>::BK : Dh <= 64 ? Cfg<64>::BK
         : Dh <= 128 ? Cfg<128>::BK : Cfg<256>::BK;
}

template <int D, typename T>
cudaError_t launch(const Args& a, cudaStream_t st) {
  constexpr size_t smem = smem_bytes<D, T>();
  static bool sized = false;      // the attribute is set once a process
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<D, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  constexpr int BQ = 16 * kWarps * Cfg<D>::MT;
  dim3 grid((a.Lq + BQ - 1) / BQ, a.H, a.B * a.nsplit);
  flash_attention_kernel<D, T><<<grid, kThreads, smem, st>>>(a);
  if (a.nsplit > 1) {
    const size_t nrows = (size_t)a.B * a.Lq * a.H;
    flash_combine_kernel<T><<<(unsigned)((nrows + kWarps - 1) / kWarps),
                              kThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const Args& a, cudaStream_t st) {
  return a.Dh <= 32 ? launch<32, T>(a, st) : a.Dh <= 64 ? launch<64, T>(a, st)
         : a.Dh <= 128 ? launch<128, T>(a, st) : launch<256, T>(a, st);
}

}  // namespace

// q, k, v and out fp32 (bf16 = 0) or bf16 (1), rows 16-byte aligned (Dh a
// multiple of 4, or of 8 in bf16); nsplit > 1: part_o holds
// nsplit*B*Lq*H*Dh floats, part_ml nsplit*B*Lq*H*2
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* out, float* part_o,
    float* part_ml, int B, int Lq, int Lk, int H, int Hkv, int Dh, int causal,
    int window, int q_offset, int nsplit, int split_tiles, int bf16,
    float softcap, float scale, void* stream) {
  const int bk = block_k(Dh);
  const int tiles = (Lk + bk - 1) / bk;
  const int vec = bf16 ? 8 : 4;
  if ((bf16 != 0 && bf16 != 1) || Dh % vec || Dh < vec || Dh > 256 ||
      H % Hkv || Lq < 1 || Lk < 1 ||
      q_offset < 0 || nsplit < 1 || split_tiles < 1 ||
      (long long)nsplit * split_tiles < tiles ||
      (long long)(nsplit - 1) * split_tiles >= tiles ||
      (nsplit > 1 && (part_o == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, part_o, part_ml, B, Lq, Lk, H, Hkv, Dh, causal,
         window, q_offset, nsplit, split_tiles, scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_dh<__nv_bfloat16>(a, st)
                    : launch_dh<float>(a, st));
}
