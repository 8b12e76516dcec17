// Fused decoder-layer blocks for one decode step (q_len == 1) on int8
// decoder weights, for Hopper (sm_90a).
//
// Replaces the TPU kernels of whisperjav_tpu/ops/pallas/fused_decode.py:
//
//   wjt_self_block_at <- self_block_stacked:  LN -> fused-QKV int8 GEMV
//                      (per-channel scale, bias) -> per-head causal
//                      attention over the (L, R, T, d) self cache (slots
//                      >= pos masked, the new key's logit joined on) ->
//                      int8 out-projection + bias -> residual; also emits
//                      the new K/V column in the cache's dtype.
//   wjt_cross_block <- cross_block_stacked: LN -> int8 q-projection ->
//                      int8 cross-attention (k_scale folded into q,
//                      v_scale on each head's output) -> int8
//                      out-projection -> residual.
//   wjt_mlp_block   <- mlp_block_stacked:   LN -> W1 int8 + bias -> exact
//                      GELU -> W2 int8, scale, bias -> residual.
//
// Every block reads the layer-stacked (L, ...) weights and caches at
// `layer` by pointer offset, so no per-layer copy is made. Arithmetic is
// f32 inside, as in the Pallas kernels: LN of x in f32, the int8 GEMVs
// accumulate in f32 with the scale applied after the sum, softmax in
// f32; only the block outputs round to bf16, the activations' dtype.
// GELU uses erff (the Pallas code approximates erf with A&S 7.1.26
// because Mosaic has none).
//
// The cross block runs under the beam fold: R = B*g query rows, row r
// reading cross-K/V row r / g (the b-major fold of
// models/whisper/model.py:cross_attention). Its attention core is Kernel
// B (decode_cross_attention.cu), which takes g rows per K/V row.
//
// What bounds it on the H100. Per layer and step the int8 weights are
// 23 MB at large-v2 (wqkv 4.9, wo 1.6, cwq 1.6, cwo 1.6, w1 6.6, w2
// 6.6), read once: ~7 us at 3.35 TB/s. The GEMVs' products, 2*R*d*(3d +
// 3d + 8d) FLOP (2.9 GFLOP per layer at R = 64), take a few us on the
// tensor cores, so the weight bytes are the bound. The self cache
// (R*pos*d*2 bf16 values per layer, up to 74 MB at R = 64, pos = 227)
// and the int8 cross K/V (2*B*d*T bytes, 123 MB at B = 32, T = 1500)
// are streamed once each.
//
// What the design does about it. The TPU grid walks the rows in order on
// one core and reuses each weight block from VMEM for every row; one
// block per row here would re-read the weights R times. So each GEMV
// block (qgemv_kernel) holds all rows of a row tile (16, 32 or 64: the
// smallest that holds R) and 128 output columns: each weight tile is read
// from memory once and used by every row. The products run on the tensor
// cores (bf16 mma.sync m16n8k16, f32 accumulate): the int8 codes are
// exact in bf16, and each f32 activation is carried as two bf16 terms,
// hi = bf16(x) and lo = bf16(x - hi) (about 16 mantissa bits of x), so
// sum_k x w = sum_k hi w + sum_k lo w with every product exact; the
// per-channel scale is applied after the sum, as in the Pallas kernels.
// Weight tiles (64 k x 128 columns of int8, 16-byte cp.async) and the
// activation terms stream through a 4-stage shared-memory ring; the
// codes become bf16 B fragments in registers (byte loads from rows
// padded against bank conflicts), the activations A fragments by
// ldmatrix; eight warps, 16 columns each. (64-column tiles, with two
// warps on each 16 columns, were slower on the H100: PERF.md.) K is
// split across blocks when the tiles alone would leave SMs idle (N = d
// at large-v2 gives 10 tiles): the blocks of one column tile form a
// thread block cluster, and each adds its share of the tile's sums from
// every block's shared memory in a fixed order (deterministic, and no
// round trip through device memory), then runs the epilogue on that
// share.
//
// The first GEMV of each block (wqkv, cwq, w1) takes the LayerNorm
// itself (LN mode): each block reads bf16 x for its own k-slice, takes
// per-row partial statistics over it (count, mean, and the sum of squares
// about that mean), combines those of the split-K cluster in rank order
// over distributed shared memory (Chan's parallel combination, which
// matches the two-pass mean and variance to f32 rounding; one split takes
// the whole row), and writes LN(x) * s + b as bf16 hi/lo terms into a
// slice of its own shared memory that the products read for the whole
// k loop; only the weights stream through the ring. The other GEMVs read
// terms their producer wrote: the self-attention kernel writes its output
// split, Kernel B writes the cross attention times v_scale as terms (its
// terms form), and W1's epilogue writes GELU(h) split for W2. Attention
// runs one block per (row, head) for the self cache, streaming the cache
// slab (never in shared memory: up to 580 KB per row).
//
// Launches per entry point, on the caller's stream: self 3 (QKV GEMV,
// attention, out-projection GEMV), cross 3 (q GEMV, Kernel B,
// out-projection GEMV), MLP 2 (W1, W2): 8 a layer-step. Intermediates
// (qkv, q, the attention output, the 4d hidden) stay in the caller's
// workspace, which stays in L2.
//
// Plain C interface, bound with ctypes; nothing is allocated here, and
// each entry returns the first CUDA error it meets (cudaGetLastError
// after each launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include "smem_guard.cuh"

// Kernel B, in decode_cross_attention.cu of the same library; form 2
// writes the hi/lo terms of out * v_scale.
extern "C" int wjt_decode_cross_attention_scaled(
    const void* q, const void* k, const void* v, const void* v_scale,
    void* o, void* o_lo, int form, int layer, int batch, int n_rows,
    int n_head, int t_len, void* stream);
constexpr int kCrossTerms = 2;

namespace {

constexpr int kHd = 64;          // head dim (all Whisper sizes)
constexpr int kThreads = 256;    // GEMV block: 8 warps
constexpr int kNt = 128;         // output columns per GEMV block
constexpr int kKc = 64;          // k per pipeline stage
constexpr int kStages = 4;       // depth of the shared-memory ring
constexpr int kWPitch = kNt + 16;    // bytes per int8 weight row in smem
constexpr int kRunCols = kNt / 4;   // 4-column runs per row of a tile
static_assert(kNt == 16 * (kThreads / 32), "one 16-column group a warp");
constexpr int kAPitch = kKc + 8;     // bf16 per activation row in smem
constexpr int kMinKSplit = 128;  // least k a split-K block takes
constexpr int kMaxSplits = 8;    // split-K blocks form one cluster (<= 8)
constexpr int kTargetBlocks = 264;   // 2 blocks on each of 132 SMs
constexpr int kLnMaxKPer = 256;  // widest k-slice an LN-mode block holds
constexpr int kResPitch = kLnMaxKPer + 8;   // bf16 per resident A row
constexpr int kAttnThreads = 128;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr float kAttnScale = 0.125f;  // hd^-0.5 at hd = 64

// Epilogues of the GEMV: f32 store (with the new K/V columns of the
// fused QKV in bf16), exact GELU written as bf16 hi/lo terms, residual
// add into bf16, and the cross block's q-fold (hd^-0.5 * k_scale). All but
// the residual one take LayerNorm(x) as their input (LN mode).
enum Epi { kEpiStore = 0, kEpiGelu = 1, kEpiResidual = 2, kEpiQFold = 3 };
__host__ __device__ constexpr bool ln_mode(int epi) {
  return epi != kEpiResidual;
}

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// two consecutive elements as f32 (the address is 2-element aligned)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo (+ under 2^-16 |x|): the two bf16 terms of an f32 value
__device__ __forceinline__ void split_store(float a, float b, bf16* hi,
                                            bf16* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo) =
      __floats2bfloat162_rn(a - hf.x, b - hf.y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// thread block clusters: rank, barrier, a shared address of another rank
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ float2 ld_cluster_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// D = A(16x16, row) * B(16x8, col) + D; bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One int8 GEMV stage: out[r][n] = epilogue(sum_k A[r][k] * W[k][n]),
// A given as its bf16 terms a_hi + a_lo, or in LN mode as LN(x) * ln_s +
// ln_b.
struct Gemv {
  const bf16* a_hi;        // (rows, k)
  const bf16* a_lo;
  const bf16* x_ln;        // LN mode: (rows, k)
  const bf16* ln_s;        // LN mode: (k)
  const bf16* ln_b;
  const int8_t* w;         // (k, n) int8 codes
  const float* w_scale;    // (n) per-output-channel scale
  const bf16* bias;        // (n)
  const bf16* x;           // kEpiResidual: (rows, n)
  float* out_f32;          // kEpiStore / kEpiQFold: (rows, n)
  bf16* out_t;             // kEpiResidual: (rows, n)
  bf16* out_hi;            // kEpiGelu: (rows, n) terms of GELU(y)
  bf16* out_lo;
  bf16* k_new;             // kEpiStore on fused QKV: columns [d, 2d) and
  bf16* v_new;             // [2d, 3d) also in bf16, (rows, d); else null
  const float* q_scale;    // kEpiQFold: (rows / group, n / 64) factors
  float q_mult;            // kEpiQFold: hd^-0.5
  int rows, k, n, k_per_split, d_model, group, n_head;
};

// Shared memory of a GEMV block: the ring of weight chunks (with the
// chunks' activation terms, unless in LN mode), then in LN mode the
// resident terms of LN(x) over the block's k-slice and the row statistics
// the cluster's ranks read from one another.
template <int MT, bool LN>
struct GemvSmem {
  static constexpr int kRows = 16 * MT;
  static constexpr int kWBytes = kKc * kWPitch;
  static constexpr int kABytes = kRows * kAPitch * 2;   // one term
  static constexpr int kStage = LN ? kWBytes : kWBytes + 2 * kABytes;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kResBytes = LN ? kRows * kResPitch * 2 : 0;
  static constexpr int kStatBytes = LN ? kRows * 4 * 4 : 0;
  static constexpr int kBytes = kRing + 2 * kResBytes + kStatBytes;
  static_assert(kRows * (kNt + 4) * 4 <= kRing, "the sums' tile fits");
};

// LN mode: the block's rows of x over its k-slice [k_begin, k_end), and
// the LayerNorm parameters of its columns, in registers: warp w holds rows
// w, w + 8, ..., its lanes pairs of columns. Loaded before the weights are
// requested, so they are not queued behind them.
template <int MT>
struct LnSlice {
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRowsPerWarp = 16 * MT / kWarps;
  static constexpr int kPairs = kLnMaxKPer / 64;   // pairs a lane holds
  __nv_bfloat162 x[kRowsPerWarp][kPairs];
  __nv_bfloat162 s[kPairs], b[kPairs];

  __device__ __forceinline__ void load(const Gemv& p, int r0, int rows,
                                       int k_begin, int k_len) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const int col = 2 * (lane + 32 * j);
      const bool ok = col < k_len;
      s[j] = ok ? *reinterpret_cast<const __nv_bfloat162*>(
                      p.ln_s + k_begin + col) : zero;
      b[j] = ok ? *reinterpret_cast<const __nv_bfloat162*>(
                      p.ln_b + k_begin + col) : zero;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = warp + kWarps * i;
        x[i][j] = (ok && r < rows)
            ? *reinterpret_cast<const __nv_bfloat162*>(
                  p.x_ln + (int64_t)(r0 + r) * p.k + k_begin + col)
            : zero;
      }
    }
  }
};

// LN mode: LayerNorm of the slice as hi/lo terms in shared memory
// (res_hi, res_lo; kResPitch a row): the rows' partial statistics (mean
// and sum of squares about it), one thread a row to combine the cluster's
// ranks, then the terms from the registers.
template <int MT>
__device__ __forceinline__ void ln_terms(const Gemv& p, const LnSlice<MT>& xs,
                                         int rows, int k_len, float* stats,
                                         bf16* res_hi, bf16* res_lo) {
  using X = LnSlice<MT>;
  constexpr int kRows = 16 * MT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // partial statistics of the slice: mean, and sum of squares about it
#pragma unroll
  for (int i = 0; i < X::kRowsPerWarp; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < X::kPairs; ++j) {
      const float2 v = __bfloat1622float2(xs.x[i][j]);
      sum += v.x + v.y;
    }
    const float mean = warp_sum(sum) / k_len;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < X::kPairs; ++j) {
      if (2 * (lane + 32 * j) < k_len) {
        const float2 v = __bfloat1622float2(xs.x[i][j]);
        const float a = v.x - mean, b = v.y - mean;
        q += a * a + b * b;
      }
    }
    const float m2 = warp_sum(q);
    if (lane == 0) {
      const int r = warp + X::kWarps * i;
      stats[2 * r] = mean;
      stats[2 * r + 1] = m2;
    }
  }
  const int n_split = gridDim.y;
  if (n_split > 1) cluster_sync(); else __syncthreads();
  // the ranks' statistics in rank order, one thread a row (Chan's
  // combination; the same result in every rank)
  float* row_norm = stats + 2 * kRows;      // mean, 1/std of each row
  if (tid < rows) {
    const uint32_t local = static_cast<uint32_t>(
        __cvta_generic_to_shared(stats + 2 * tid));
    float2 st[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      st[s] = s >= n_split ? make_float2(0.f, 0.f)
            : n_split > 1 ? ld_cluster_f2(map_rank(local, s))
                          : make_float2(stats[2 * tid], stats[2 * tid + 1]);
    float n = 0.f, mean = 0.f, m2 = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      if (s >= n_split) break;
      const float nb = (float)(min(p.k, (s + 1) * p.k_per_split)
                               - s * p.k_per_split);
      if (s == 0) {
        n = nb; mean = st[s].x; m2 = st[s].y;
      } else {
        const float nab = n + nb;
        const float delta = st[s].x - mean;
        mean += delta * (nb / nab);
        m2 += st[s].y + delta * delta * (n * nb / nab);
        n = nab;
      }
    }
    row_norm[2 * tid] = mean;
    row_norm[2 * tid + 1] = rsqrtf(m2 / n + 1e-5f);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < X::kRowsPerWarp; ++i) {
    const int r = warp + X::kWarps * i;
    const float mean = row_norm[2 * r], rstd = row_norm[2 * r + 1];
#pragma unroll
    for (int j = 0; j < X::kPairs; ++j) {
      const int col = 2 * (lane + 32 * j);
      if (col >= k_len) continue;
      bf16* hi = res_hi + r * kResPitch + col;
      bf16* lo = res_lo + r * kResPitch + col;
      if (r >= rows) {   // rows past the end: zero terms
        *reinterpret_cast<uint32_t*>(hi) = 0u;
        *reinterpret_cast<uint32_t*>(lo) = 0u;
        continue;
      }
      const float2 x = __bfloat1622float2(xs.x[i][j]);
      const float2 g = __bfloat1622float2(xs.s[j]);
      const float2 b = __bfloat1622float2(xs.b[j]);
      split_store((x.x - mean) * rstd * g.x + b.x,
                  (x.y - mean) * rstd * g.y + b.y, hi, lo);
    }
  }
}

// Block tile: 16*MT rows x kNt columns; warp w owns columns 16w .. 16w +
// 15, so its accumulators are MT x 2 n8 tiles of the mma C layout.
template <int EPI, int MT>
__global__ void __launch_bounds__(kThreads, 2) qgemv_kernel(Gemv p) {
  constexpr bool LN = ln_mode(EPI);
  using S = GemvSmem<MT, LN>;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* res_hi = reinterpret_cast<bf16*>(smem + S::kRing);
  bf16* res_lo = res_hi + S::kRows * kResPitch;
  float* stats = reinterpret_cast<float*>(smem + S::kRing + 2 * S::kResBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int n0 = blockIdx.x * kNt;
  const int r0 = blockIdx.z * S::kRows;
  const int rows = min(S::kRows, p.rows - r0);
  const int k_begin = blockIdx.y * p.k_per_split;
  const int k_end = min(p.k, k_begin + p.k_per_split);
  const int n_chunks = (k_end - k_begin) / kKc;   // k % 64 == 0

  auto load = [&](int c) {
    uint8_t* st = smem + (c % kStages) * S::kStage;
    const int kc = k_begin + c * kKc;
#pragma unroll
    for (int u = tid; u < kKc * kNt / 16; u += kThreads) {
      // weights: 64 rows of kNt bytes in 16-byte copies
      const int kk = u / (kNt / 16), cc = (u % (kNt / 16)) * 16;
      cp_async16(st + kk * kWPitch + cc,
                 p.w + (int64_t)(kc + kk) * p.n + n0 + cc, true);
    }
    if (!LN) {   // in LN mode A is resident
#pragma unroll
      for (int i = 0; i < MT; ++i) {  // hi, then lo: 16*MT rows of 128 B
        const int u = tid + i * kThreads;
        const int term = u / (S::kRows * 8);
        const int rem = u % (S::kRows * 8);
        const int r = rem >> 3, cc = (rem & 7) * 8;
        const bool ok = r < rows;
        const bf16* src = (term ? p.a_lo : p.a_hi) +
                          (ok ? (int64_t)(r0 + r) * p.k + kc + cc : 0);
        cp_async16(
            st + S::kWBytes + term * S::kABytes + (r * kAPitch + cc) * 2,
            src, ok);
      }
    }
  };

  float acc[MT][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

  // LN mode: x and the LN parameters first, then the first weight
  // chunks, which arrive while the terms of LN(x) are made
  LnSlice<MT> xs;
  if (LN) xs.load(p, r0, rows, k_begin, k_end - k_begin);
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) load(c);
    cp_async_commit();
  }
  if (LN) ln_terms<MT>(p, xs, rows, k_end - k_begin, stats, res_hi, res_lo);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk c landed; chunk c - 1's stage is free
    if (c + kStages - 1 < n_chunks) load(c + kStages - 1);
    cp_async_commit();
    const uint8_t* st = smem + (c % kStages) * S::kStage;
    const int8_t* ws = reinterpret_cast<const int8_t*>(st);
    constexpr int kPitch = LN ? kResPitch : kAPitch;
    const bf16* ah = LN ? res_hi + c * kKc
                        : reinterpret_cast<const bf16*>(st + S::kWBytes);
    const bf16* al = LN ? res_lo + c * kKc : ah + S::kRows * kAPitch;
#pragma unroll
    for (int ss = 0; ss < kKc / 16; ++ss) {
      const int k_off = ss * 16;
      // B fragments: codes W[k_off + 2tg + {0, 1, 8, 9}][column g of the
      // n8 tile], exact in bf16
      uint32_t bfr[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int8_t* wp =
            ws + (k_off + 2 * tg) * kWPitch + warp * 16 + j * 8 + g;
        bfr[j][0] = pack_bf16x2((float)wp[0], (float)wp[kWPitch]);
        bfr[j][1] =
            pack_bf16x2((float)wp[8 * kWPitch], (float)wp[9 * kWPitch]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t ahf[4], alf[4];
        const int off =
            (mt * 16 + (lane & 15)) * kPitch + k_off + (lane >> 4) * 8;
        ldmatrix_x4(ahf, ah + off);
        ldmatrix_x4(alf, al + off);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_16816(acc[mt][j], ahf, bfr[j]);
          mma_16816(acc[mt][j], alf, bfr[j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the block's sums into a shared (rows x kNt) f32 tile: element (mt, j,
  // e) of a warp sits at row mt*16 + g + 8 (e >> 1), column warp*16 + j*8
  // + 2tg + (e & 1)
  constexpr int kTP = kNt + 4;
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            &tile[(mt * 16 + g + 8 * h) * kTP + warp * 16 + j * 8 + 2 * tg]) =
            make_float2(acc[mt][j][2 * h], acc[mt][j][2 * h + 1]);
  __syncthreads();

  // from here each thread owns runs of 4 columns: run u is row u /
  // kRunCols, columns 4 (u % kRunCols) .. +3 of the tile
  constexpr int kRuns = S::kRows * kRunCols;
  constexpr int kMine = kRuns / kThreads;   // runs a thread, unsplit
  auto run_at = [&](int u) {
    return &tile[(u / kRunCols) * kTP + (u % kRunCols) * 4];
  };
  float4 y[kMine];
  int n_mine = kMine;                   // runs tid + i * kThreads, i < kMine
  if (gridDim.y > 1) {
    // split-K: the gridDim.y blocks of a column tile form one cluster;
    // each holds its k-slice's sums in shared memory, and rank r adds the
    // runs [r * per, (r + 1) * per) of every rank's tile, in rank order
    // (deterministic), through distributed shared memory
    const int n_split = gridDim.y;
    const int rank = (int)cluster_ctarank();
    const int per = (kRuns + n_split - 1) / n_split;
    cluster_sync();                     // every rank's tile is complete
    n_mine = 0;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int v = tid + i * kThreads;
      if (v < per && rank * per + v < kRuns) n_mine = i + 1;
    }
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      y[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i >= n_mine) continue;
      const int u = rank * per + tid + i * kThreads;
      const uint32_t local =
          static_cast<uint32_t>(__cvta_generic_to_shared(run_at(u)));
      for (int s = 0; s < n_split; ++s) {
        const float4 v = ld_cluster_f4(map_rank(local, s));
        y[i].x += v.x; y[i].y += v.y; y[i].z += v.z; y[i].w += v.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kMine; ++i)
      y[i] = *reinterpret_cast<const float4*>(run_at(tid + i * kThreads));
  }
  const int run0 = gridDim.y > 1
      ? (int)cluster_ctarank() * ((kRuns + gridDim.y - 1) / gridDim.y) : 0;
  auto run_of = [&](int i) { return run0 + tid + i * kThreads; };
  auto gofs = [&](int i) {   // offset of run i in a (rows, n) array
    const int u = run_of(i);
    return (int64_t)(r0 + u / kRunCols) * p.n + n0 + (u % kRunCols) * 4;
  };
  auto row_ok = [&](int i) {
    return i < n_mine && run_of(i) / kRunCols < rows;
  };

#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    if (!row_ok(i)) continue;
    const int rg = r0 + run_of(i) / kRunCols;
    const int n = n0 + (run_of(i) % kRunCols) * 4;
    const int64_t o = gofs(i);
    const float4 sc = *reinterpret_cast<const float4*>(p.w_scale + n);
    const float2 b01 = load2(p.bias + n), b23 = load2(p.bias + n + 2);
    float v[4] = {y[i].x * sc.x + b01.x, y[i].y * sc.y + b01.y,
                  y[i].z * sc.z + b23.x, y[i].w * sc.w + b23.y};
    if (EPI == kEpiStore) {
      *reinterpret_cast<float4*>(p.out_f32 + o) =
          make_float4(v[0], v[1], v[2], v[3]);
      if (p.k_new != nullptr && n >= p.d_model) {
        const int d = p.d_model;
        bf16* dst = n < 2 * d ? p.k_new + (int64_t)rg * d + n - d
                              : p.v_new + (int64_t)rg * d + n - 2 * d;
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
      }
    } else if (EPI == kEpiGelu) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = v[e] * 0.5f * (1.f + erff(v[e] * 0.70710678118654752f));
      split_store(v[0], v[1], p.out_hi + o, p.out_lo + o);
      split_store(v[2], v[3], p.out_hi + o + 2, p.out_lo + o + 2);
    } else if (EPI == kEpiResidual) {
      const float2 x01 = load2(p.x + o), x23 = load2(p.x + o + 2);
      *reinterpret_cast<uint2*>(p.out_t + o) =
          make_uint2(pack_bf16x2(x01.x + v[0], x01.y + v[1]),
                     pack_bf16x2(x23.x + v[2], x23.y + v[3]));
    } else {  // kEpiQFold
      const float f =
          p.q_mult * p.q_scale[(rg / p.group) * p.n_head + n / kHd];
      *reinterpret_cast<float4*>(p.out_f32 + o) =
          make_float4(v[0] * f, v[1] * f, v[2] * f, v[3] * f);
    }
  }
  // a rank's shared memory must outlive the other ranks' reads of it
  if (gridDim.y > 1) cluster_sync();
}

// Decode-step self-attention of one (row, head) over the cache slots
// t < pos plus the new key, whose logit and value come from the f32 qkv;
// the output goes out as bf16 hi/lo terms, the out-projection's input.
// `pos` is read from device memory, so that one launch (captured in a
// CUDA graph) serves every step; the logits' shared memory is sized by
// t_cache, the loops still run to pos.
__global__ void __launch_bounds__(kAttnThreads)
self_attention_kernel(const float* __restrict__ qkv,
                      const bf16* __restrict__ ck,
                      const bf16* __restrict__ cv, bf16* __restrict__ out_hi,
                      bf16* __restrict__ out_lo, int d, int n_head,
                      int t_cache, const int* __restrict__ pos_ptr,
                      float scale) {
  extern __shared__ float p_s[];          // [t_cache] logits, then exp
  const int pos = min(max(*pos_ptr, 0), t_cache - 1);
  __shared__ float q_s[kHd];
  __shared__ float red_s[kAttnWarps][kHd];
  __shared__ float wred_s[kAttnWarps];

  const int r = blockIdx.x / n_head;
  const int h = blockIdx.x - r * n_head;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* qrow = qkv + (int64_t)r * 3 * d;
  if (tid < kHd) q_s[tid] = qrow[h * kHd + tid] * scale;
  __syncthreads();
  const float q0 = q_s[2 * lane], q1 = q_s[2 * lane + 1];
  const bf16* kb = ck + (int64_t)r * t_cache * d + h * kHd + 2 * lane;
  const bf16* vb = cv + (int64_t)r * t_cache * d + h * kHd + 2 * lane;

  // logits of the cached keys, one warp per slot
  float m = -INFINITY;
  for (int t = warp; t < pos; t += kAttnWarps) {
    const float2 kv = load2(kb + (int64_t)t * d);
    const float s = warp_sum(q0 * kv.x + q1 * kv.y);
    if (lane == 0) p_s[t] = s;
    m = fmaxf(m, s);
  }
  const float2 kn = load2(qrow + d + h * kHd + 2 * lane);
  const float s_new = warp_sum(q0 * kn.x + q1 * kn.y);
  if (lane == 0) wred_s[warp] = m;
  __syncthreads();
  m = s_new;
#pragma unroll
  for (int w = 0; w < kAttnWarps; ++w) m = fmaxf(m, wred_s[w]);
  __syncthreads();

  float sum = 0.f;
  for (int t = tid; t < pos; t += kAttnThreads) {
    const float e = expf(p_s[t] - m);
    p_s[t] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  if (lane == 0) wred_s[warp] = sum;
  __syncthreads();
  const float e_new = expf(s_new - m);
  float denom = e_new;
#pragma unroll
  for (int w = 0; w < kAttnWarps; ++w) denom += wred_s[w];

  // weighted values, one warp per slot, two dims a lane
  float o0 = 0.f, o1 = 0.f;
  for (int t = warp; t < pos; t += kAttnWarps) {
    const float e = p_s[t];
    const float2 vv = load2(vb + (int64_t)t * d);
    o0 = fmaf(e, vv.x, o0);
    o1 = fmaf(e, vv.y, o1);
  }
  red_s[warp][2 * lane] = o0;
  red_s[warp][2 * lane + 1] = o1;
  __syncthreads();
  if (tid < kHd) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kAttnWarps; ++w) o += red_s[w][tid];
    o = fmaf(e_new, qrow[2 * d + h * kHd + tid], o) / denom;
    const int64_t i = (int64_t)r * d + h * kHd + tid;
    out_hi[i] = __float2bfloat16_rn(o);
    out_lo[i] = __float2bfloat16_rn(o - to_f32(out_hi[i]));
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Plan {
  int mt, tiles_x, tiles_z, splits, k_per;
  int tiles() const { return tiles_x * tiles_z; }
};

// Grid of one GEMV: the row tile (16, 32 or 64 rows) is the smallest that
// holds the rows; then column tiles x row tiles, and K split until there
// are at most kTargetBlocks blocks, one wave (each split keeps >=
// kMinKSplit of k; at most kMaxSplits, the blocks of one cluster). A
// fixed target, not the device's SM count, so that the grid is a function
// of the shapes alone. In LN mode each split holds at most kLnMaxKPer of
// k in shared memory, so k may be at most kMaxSplits * kLnMaxKPer there;
// splits == 0 when it is not.
Plan plan(int rows, int k, int n, bool ln) {
  Plan pl;
  pl.mt = rows <= 16 ? 1 : rows <= 32 ? 2 : 4;
  pl.tiles_x = n / kNt;
  pl.tiles_z = (rows + 16 * pl.mt - 1) / (16 * pl.mt);
  const int want = std::min(kTargetBlocks / pl.tiles(), kMaxSplits);
  int s = std::max(1, std::min(want, k / kMinKSplit));
  if (ln) s = std::max(s, (k + kLnMaxKPer - 1) / kLnMaxKPer);
  pl.k_per = ((k + s - 1) / s + kKc - 1) / kKc * kKc;
  pl.splits = (k + pl.k_per - 1) / pl.k_per;
  if (pl.splits > kMaxSplits || (ln && pl.k_per > kLnMaxKPer)) pl.splits = 0;
  return pl;
}

template <int EPI, int MT>
int launch_gemv(const Plan& pl, const Gemv& p, cudaStream_t stream) {
  using S = GemvSmem<MT, ln_mode(EPI)>;
  static SmemGuard guard;
  const int allowed = allow_smem(qgemv_kernel<EPI, MT>, guard, S::kBytes);
  if (allowed) return allowed;
  // the splits of a column tile are one cluster along y
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.tiles_x, pl.splits, pl.tiles_z);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = S::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = pl.splits;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, qgemv_kernel<EPI, MT>, p);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int EPI>
int run_gemv(Gemv p, cudaStream_t stream) {
  const Plan pl = plan(p.rows, p.k, p.n, ln_mode(EPI));
  if (pl.splits == 0) return static_cast<int>(cudaErrorInvalidValue);
  p.k_per_split = pl.k_per;
  if (pl.mt == 1) return launch_gemv<EPI, 1>(pl, p, stream);
  if (pl.mt == 2) return launch_gemv<EPI, 2>(pl, p, stream);
  return launch_gemv<EPI, 4>(pl, p, stream);
}

// Workspace of one entry, carved in this order: f32 intermediates, the
// bf16 hi/lo terms of the second GEMV's input: s0 (rows x d) for the self
// and cross blocks, s1 (rows x hidden) for the MLP.
struct Work {
  float* f;
  bf16 *s0_hi, *s0_lo, *s1_hi, *s1_lo;
};

enum Kind { kSelf = 0, kCross = 1, kMlp = 2 };

// f32 intermediates of an entry, and the elements of each s1 term
struct Shapes {
  int64_t inter_floats;
  int64_t s1_elems;
};

Shapes shapes(int kind, int rows, int d, int hidden) {
  Shapes s;
  s.s1_elems = 0;
  if (kind == kSelf) {
    s.inter_floats = (int64_t)rows * 3 * d;          // qkv
  } else if (kind == kCross) {
    s.inter_floats = (int64_t)rows * d;              // q
  } else {
    s.inter_floats = 0;
    s.s1_elems = (int64_t)rows * hidden;             // GELU(h W1) terms
  }
  return s;
}

int64_t workspace_bytes(int kind, int rows, int d, int hidden, Work* w,
                        void* base) {
  const Shapes s = shapes(kind, rows, d, hidden);
  const int64_t s0 = kind == kMlp ? 0 : (int64_t)rows * d;
  // every piece is a multiple of 16 bytes (d, hidden % 128 == 0)
  const int64_t bytes_f = s.inter_floats * 4;
  if (w != nullptr) {
    uint8_t* b = static_cast<uint8_t*>(base);
    w->f = reinterpret_cast<float*>(b);
    w->s0_hi = reinterpret_cast<bf16*>(b + bytes_f);
    w->s0_lo = w->s0_hi + s0;
    w->s1_hi = w->s0_lo + s0;
    w->s1_lo = w->s1_hi + s.s1_elems;
  }
  return bytes_f + (2 * s0 + 2 * s.s1_elems) * 2;
}

Gemv gemv_base(int rows, int k, int n, int d, const bf16* a_hi,
               const bf16* a_lo, const int8_t* w, const float* ws,
               const void* bias) {
  Gemv p = {};
  p.rows = rows; p.k = k; p.n = n; p.d_model = d;
  p.a_hi = a_hi; p.a_lo = a_lo;
  p.w = w; p.w_scale = ws; p.bias = static_cast<const bf16*>(bias);
  p.group = 1;
  p.n_head = 1;
  return p;
}

// an LN-mode GEMV of x (rows, k) with layer L's LayerNorm parameters
Gemv gemv_ln(int rows, int k, int n, int d, const void* x, const void* ln_s,
             const void* ln_b, int64_t L, const int8_t* w, const float* ws,
             const void* bias) {
  Gemv p = gemv_base(rows, k, n, d, nullptr, nullptr, w, ws, bias);
  p.x_ln = static_cast<const bf16*>(x);
  p.ln_s = static_cast<const bf16*>(ln_s) + L * k;
  p.ln_b = static_cast<const bf16*>(ln_b) + L * k;
  return p;
}

#define WJT_TRY(expr)                  \
  do {                                 \
    const int err_ = (expr);           \
    if (err_ != 0) return err_;        \
  } while (0)

int self_block(const void* x, const void* ln_s, const void* ln_b,
               const void* wqkv, const void* wqkv_s, const void* bqkv,
               const void* wo, const void* wo_s, const void* bo,
               const void* cache_k, const void* cache_v, void* x_out,
               void* k_new, void* v_new, void* work, const int* pos,
               int layer, int rows, int d, int n_head, int t_cache,
               cudaStream_t stream) {
  Work wk;
  workspace_bytes(kSelf, rows, d, 0, &wk, work);
  float* qkv = wk.f;
  const int64_t L = layer;
  const bf16* xt = static_cast<const bf16*>(x);

  Gemv g1 = gemv_ln(
      rows, d, 3 * d, d, x, ln_s, ln_b, L,
      static_cast<const int8_t*>(wqkv) + L * d * 3 * d,
      static_cast<const float*>(wqkv_s) + L * 3 * d,
      static_cast<const bf16*>(bqkv) + L * 3 * d);
  g1.out_f32 = qkv;
  g1.k_new = static_cast<bf16*>(k_new);
  g1.v_new = static_cast<bf16*>(v_new);
  WJT_TRY(run_gemv<kEpiStore>(g1, stream));

  // the attention output, as terms in s0
  const int64_t slab = L * rows * t_cache * d;
  self_attention_kernel<<<rows * n_head, kAttnThreads,
                          (size_t)t_cache * sizeof(float), stream>>>(
      qkv, static_cast<const bf16*>(cache_k) + slab,
      static_cast<const bf16*>(cache_v) + slab, wk.s0_hi, wk.s0_lo, d,
      n_head, t_cache, pos, kAttnScale);
  WJT_TRY(static_cast<int>(cudaGetLastError()));

  Gemv g2 = gemv_base(
      rows, d, d, d, wk.s0_hi, wk.s0_lo,
      static_cast<const int8_t*>(wo) + L * d * d,
      static_cast<const float*>(wo_s) + L * d,
      static_cast<const bf16*>(bo) + L * d);
  g2.x = xt;
  g2.out_t = static_cast<bf16*>(x_out);
  return run_gemv<kEpiResidual>(g2, stream);
}

int cross_block(const void* x, const void* ln_s, const void* ln_b,
                const void* cwq, const void* cwq_s, const void* cbq,
                const void* cwo, const void* cwo_s, const void* cbo,
                const void* ck, const void* cv, const void* k_scale,
                const void* v_scale, void* x_out, void* work, int layer,
                int rows, int batch, int d, int n_head, int t_cross,
                cudaStream_t stream) {
  Work wk;
  workspace_bytes(kCross, rows, d, 0, &wk, work);
  float* q = wk.f;
  const int64_t L = layer;
  const int group = rows / batch;
  const bf16* xt = static_cast<const bf16*>(x);

  Gemv g1 = gemv_ln(
      rows, d, d, d, x, ln_s, ln_b, L,
      static_cast<const int8_t*>(cwq) + L * d * d,
      static_cast<const float*>(cwq_s) + L * d,
      static_cast<const bf16*>(cbq) + L * d);
  g1.out_f32 = q;
  g1.q_scale = static_cast<const float*>(k_scale) + L * batch * n_head;
  g1.q_mult = kAttnScale;
  g1.group = group;
  g1.n_head = n_head;
  WJT_TRY(run_gemv<kEpiQFold>(g1, stream));

  // q (B, g, H, 64) = (rows, d): g query rows per cross-K/V row; the
  // attention output times v_scale, as terms in s0
  WJT_TRY(wjt_decode_cross_attention_scaled(
      q, ck, cv, v_scale, wk.s0_hi, wk.s0_lo, kCrossTerms, layer, batch,
      group, n_head, t_cross, stream));

  Gemv g2 = gemv_base(
      rows, d, d, d, wk.s0_hi, wk.s0_lo,
      static_cast<const int8_t*>(cwo) + L * d * d,
      static_cast<const float*>(cwo_s) + L * d,
      static_cast<const bf16*>(cbo) + L * d);
  g2.x = xt;
  g2.out_t = static_cast<bf16*>(x_out);
  return run_gemv<kEpiResidual>(g2, stream);
}

int mlp_block(const void* x, const void* ln_s, const void* ln_b,
              const void* w1, const void* w1_s, const void* b1,
              const void* w2, const void* w2_s, const void* b2, void* x_out,
              void* work, int layer, int rows, int d, int hidden,
              cudaStream_t stream) {
  Work wk;
  workspace_bytes(kMlp, rows, d, hidden, &wk, work);
  const int64_t L = layer;
  const bf16* xt = static_cast<const bf16*>(x);

  Gemv g1 = gemv_ln(
      rows, d, hidden, d, x, ln_s, ln_b, L,
      static_cast<const int8_t*>(w1) + L * d * hidden,
      static_cast<const float*>(w1_s) + L * hidden,
      static_cast<const bf16*>(b1) + L * hidden);
  g1.out_hi = wk.s1_hi;
  g1.out_lo = wk.s1_lo;
  WJT_TRY(run_gemv<kEpiGelu>(g1, stream));

  Gemv g2 = gemv_base(
      rows, hidden, d, d, wk.s1_hi, wk.s1_lo,
      static_cast<const int8_t*>(w2) + L * hidden * d,
      static_cast<const float*>(w2_s) + L * d,
      static_cast<const bf16*>(b2) + L * d);
  g2.x = xt;
  g2.out_t = static_cast<bf16*>(x_out);
  return run_gemv<kEpiResidual>(g2, stream);
}

}  // namespace
// x, the LayerNorm parameters, the biases, the self cache and the
// outputs are bf16; weights are int8 with f32 scales; stacked pointers
// are offset to `layer` here.

extern "C" long long wjt_fused_workspace_bytes(int kind, int rows, int d,
                                               int hidden) {
  return workspace_bytes(kind, rows, d, hidden, nullptr, nullptr);
}

// `pos` points to one int32 on the device (the step's position), read by
// the attention kernel when it runs; an older build's wjt_self_block took
// it by value.
extern "C" int wjt_self_block_at(const void* x, const void* ln_s,
                                 const void* ln_b, const void* wqkv,
                                 const void* wqkv_s, const void* bqkv,
                                 const void* wo, const void* wo_s,
                                 const void* bo, const void* cache_k,
                                 const void* cache_v, void* x_out,
                                 void* k_new, void* v_new, void* work,
                                 const void* pos, int layer, int rows, int d,
                                 int n_head, int t_cache, void* stream) {
  return self_block(x, ln_s, ln_b, wqkv, wqkv_s, bqkv, wo, wo_s, bo, cache_k,
                    cache_v, x_out, k_new, v_new, work,
                    static_cast<const int*>(pos), layer, rows, d, n_head,
                    t_cache, static_cast<cudaStream_t>(stream));
}

extern "C" int wjt_cross_block(const void* x, const void* ln_s,
                               const void* ln_b, const void* cwq,
                               const void* cwq_s, const void* cbq,
                               const void* cwo, const void* cwo_s,
                               const void* cbo, const void* ck,
                               const void* cv, const void* k_scale,
                               const void* v_scale, void* x_out, void* work,
                               int layer, int rows, int batch, int d,
                               int n_head, int t_cross, void* stream) {
  return cross_block(x, ln_s, ln_b, cwq, cwq_s, cbq, cwo, cwo_s, cbo, ck, cv,
                     k_scale, v_scale, x_out, work, layer, rows, batch, d,
                     n_head, t_cross, static_cast<cudaStream_t>(stream));
}

extern "C" int wjt_mlp_block(const void* x, const void* ln_s,
                             const void* ln_b, const void* w1,
                             const void* w1_s, const void* b1,
                             const void* w2, const void* w2_s,
                             const void* b2, void* x_out, void* work,
                             int layer, int rows, int d, int hidden,
                             void* stream) {
  return mlp_block(x, ln_s, ln_b, w1, w1_s, b1, w2, w2_s, b2, x_out, work,
                   layer, rows, d, hidden, static_cast<cudaStream_t>(stream));
}
