// Decode-step cross-attention over int8 K/V for Hopper (sm_90a).
//
// Replaces the TPU kernels whisperjav_tpu/ops/pallas/decode_attention.py
// (_kernel behind decode_cross_attention, and
// decode_cross_attention_stacked, which picks the layer of the stacked
// K/V by scalar prefetch).
//
//   q (B, R, H, 64) f32, attention scale and k_scale folded in
//   K, V (L, B, H, 64, T) int8, layer chosen by a pointer offset
//   out (B, R, H, 64), in one of three forms:
//     f32    the attention output before v_scale;
//     bf16   bf16(out * v_scale[b, h]), the order of
//            models/whisper/model.py:cross_attention (multiply in f32,
//            then round);
//     terms  hi = bf16(y), lo = bf16(y - hi) of y = out * v_scale[b, h]:
//            the fused cross block's out-projection input
//            (fused_decode.cu).
//
// R is the number of query rows that read one K/V row: g*q_len, where
// beam search folds its g beams onto one cross-K/V row.
//
// What bounds it on the H100: bytes. Every decode step streams the whole
// int8 cross K/V, 2*B*H*64*T bytes per layer (123 MB at B=32, T=1500:
// 37 us at 3.35 TB/s), against ~4 FLOP per byte per query row.
//
// What the design does about it (flash-decoding inside a cluster).
// - Split over T. A thread block cluster of C ranks (C = ceil(T / 768),
//   at most 8: 2 at T=1500 and 960, 1 at 448) owns one (b, h); rank c
//   takes a contiguous range of keys for all 64 d-rows (~96 KB of K and V
//   at T=1500, two blocks of 256 threads an SM). Every rank's partial
//   result is small (its row max m, its sum of exponentials l and its
//   unnormalised R x 64 output), so the ranks combine over distributed
//   shared memory in rank order (deterministic). Development runs on the
//   H100 timed 96 to 384 keys a rank and 128 to 512 threads a block; this
//   size was the fastest at the main shapes (PERF.md).
// - Alignment. A d-row of K/V is T bytes, only 4-byte aligned at T=1500,
//   and a key range of it is no better, so neither 16-byte copies nor a
//   tensor map can take it; 4-byte cp.async can (each warp's request is
//   128 contiguous bytes). Every K and V copy of the block is issued at
//   the start, K and V in two commit groups: all the block's bytes are in
//   flight at once, and V arrives while the logits and the softmax run.
// - Dequantisation. An int8 code becomes f32 by a byte permute into a
//   float's mantissa and one subtract (PRMT + FADD), not the conversion
//   unit, whose rate (16 a clock per SM) would take as long as the bytes.
// - Lengths with T % 4 != 0 (none on the paths) copy with byte loads.
//
// Plain C interface, bound with ctypes; the kernel launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_guard.cuh"

namespace {

constexpr int kHd = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDPerWarp = kHd / kWarps;  // d-rows a warp reduces in P.V
constexpr int kMaxRows = 8;          // query rows a block; more take grid.y
constexpr int kMaxT = 7168;          // longest T taken
constexpr int kMaxRanks = 8;         // the largest portable cluster
constexpr int kWordsPerRank = 192;   // at most this many 4-key words a rank
constexpr int kSmemMax = 226 * 1024;  // of 227 KB; the rest is static

enum Form { kF32 = 0, kBf16 = 1, kTerms = 2 };

using bf16 = __nv_bfloat16;

struct Args {
  const float* q;        // (B, R, H, 64)
  const int8_t* k;       // (B, H, 64, T) of the layer
  const int8_t* v;
  const float* v_scale;  // (B, H) of the layer; kBf16 / kTerms
  void* out;             // f32 or bf16 (hi)
  bf16* out_lo;          // kTerms
  int form, n_rows, n_head, t_len, ranks, rank_words;
};

// byte offsets in dynamic shared memory; cw = words a rank holds
struct Layout {
  int v, p, q, o, total;
};

__host__ __device__ inline Layout layout(int rows, int cw) {
  Layout l;
  l.v = kHd * 4 * cw;                 // K [64][4cw] bytes at 0
  l.p = 2 * l.v;                      // logits, then exp [rows][4cw] f32
  l.q = l.p + rows * 4 * cw * 4;      // q [rows][64]
  l.o = l.q + rows * kHd * 4;         // unnormalised output [rows][64]
  l.total = l.o + rows * kHd * 4;
  return l;
}

// P.V accumulators a lane holds: ROWS x DC of its warp's kDPerWarp d-rows
template <int ROWS>
struct PvTile {
  static constexpr int kDc = 32 / ROWS < kDPerWarp ? 32 / ROWS : kDPerWarp;
  static constexpr int kAcc = ROWS * kDc;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// four int8 codes (one little-endian word) as exact f32: each biased byte
// becomes the low mantissa byte of 2^23, then 2^23 + 128 is taken off
__device__ __forceinline__ void dequant4(uint32_t w, float out[4]) {
  const uint32_t u = w ^ 0x80808080u;
  out[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  out[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  out[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  out[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sums each of N (a power of two <= 32) values over the warp, halving the
// values a lane holds at each step (HALF values kept, partners at lane ^
// off); lane l ends with the total of value l / (32 / N) in v[0]. Fixed
// order: deterministic. Unrolled by the template, so v stays in registers.
template <int HALF, int N>
__device__ __forceinline__ void warp_reduce_scatter(float (&v)[N],
                                                    int lane) {
  if constexpr (HALF >= 1) {
    constexpr int off = 32 * HALF / N;
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = up ? v[i] : v[i + HALF];
      const float keep = up ? v[i + HALF] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
    warp_reduce_scatter<HALF / 2>(v, lane);
  } else {
#pragma unroll
    for (int off = 16 / N; off >= 1; off >>= 1)
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  }
}

template <int ROWS, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, 512 / kThreads)
decode_cross_attention_kernel(Args a) {
  using Pv = PvTile<ROWS>;
  constexpr int DC = Pv::kDc;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red[kWarps][ROWS];
  __shared__ float ml[2][ROWS];         // this rank's row max and sum

  const int t_len = a.t_len, cw = a.rank_words, pitch = 4 * cw;
  const Layout lay = layout(ROWS, cw);
  int8_t* ks = reinterpret_cast<int8_t*>(smem);
  int8_t* vs = reinterpret_cast<int8_t*>(smem + lay.v);
  float* p = reinterpret_cast<float*>(smem + lay.p);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* o_s = reinterpret_cast<float*>(smem + lay.o);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_ranks = a.ranks;
  const int rank = (int)cluster_ctarank();   // == blockIdx.x % n_ranks
  const int bh = blockIdx.x / n_ranks;       // b * n_head + h
  const int b = bh / a.n_head;
  const int h = bh - b * a.n_head;
  const int row0 = blockIdx.y * ROWS;
  const int rows = min(ROWS, a.n_rows - row0);
  const int words = (t_len + 3) / 4;
  const int w0 = rank * cw;                  // this rank's first word
  const int nw = max(0, min(cw, words - w0));
  const int t0 = 4 * w0;
  const int8_t* kg = a.k + (int64_t)bh * kHd * t_len + t0;
  const int8_t* vg = a.v + (int64_t)bh * kHd * t_len + t0;

  // every copy of the block in flight at once: K, then V
  if (ALIGNED) {   // warp w copies d-rows w, w + 4, ...; lanes the words
    for (int d = warp; d < kHd; d += kWarps)
      for (int w = lane; w < nw; w += 32)
        cp_async4(ks + d * pitch + 4 * w, kg + (int64_t)d * t_len + 4 * w);
    cp_async_commit();
    for (int d = warp; d < kHd; d += kWarps)
      for (int w = lane; w < nw; w += 32)
        cp_async4(vs + d * pitch + 4 * w, vg + (int64_t)d * t_len + 4 * w);
    cp_async_commit();
  } else {   // byte loads, zeros past T
    for (int i = tid; i < kHd * 4 * nw; i += kThreads) {
      const int d = i / (4 * nw), t = i - d * 4 * nw;
      const bool ok = t0 + t < t_len;
      ks[d * pitch + t] = ok ? kg[(int64_t)d * t_len + t] : 0;
      vs[d * pitch + t] = ok ? vg[(int64_t)d * t_len + t] : 0;
    }
  }
  for (int i = tid; i < ROWS * kHd; i += kThreads) {
    const int r = i / kHd;
    q_s[i] = r < rows ? a.q[(((int64_t)b * a.n_rows + row0 + r) * a.n_head
                             + h) * kHd + i - r * kHd]
                      : 0.f;
  }
  if (ALIGNED) cp_async_wait<1>();   // K has landed (this thread's part)
  __syncthreads();

  // logits of this rank's keys, 4 a thread; keys past T masked
  float mx[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) mx[r] = -INFINITY;
  for (int w = tid; w < nw; w += kThreads) {
    float acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kHd; ++d) {
      float kv[4];
      dequant4(*reinterpret_cast<const uint32_t*>(ks + d * pitch + 4 * w),
               kv);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float qv = q_s[r * kHd + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(qv, kv[j], acc[r][j]);
      }
    }
    const int t = t0 + 4 * w;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int j = 1; j < 4; ++j)
        if (t + j >= t_len) acc[r][j] = -INFINITY;
      *reinterpret_cast<float4*>(p + r * pitch + 4 * w) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      mx[r] = fmaxf(mx[r], fmaxf(fmaxf(acc[r][0], acc[r][1]),
                                 fmaxf(acc[r][2], acc[r][3])));
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float m = warp_max(mx[r]);
    if (lane == 0) red[warp][r] = m;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    mx[r] = red[0][r];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) mx[r] = fmaxf(mx[r], red[i][r]);
  }
  __syncthreads();   // red is read; the sums reuse it

  float sum[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) sum[r] = 0.f;
  for (int w = tid; w < nw; w += kThreads) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float4* pp = reinterpret_cast<float4*>(p + r * pitch + 4 * w);
      float4 e = *pp;
      e.x = expf(e.x - mx[r]);
      e.y = expf(e.y - mx[r]);
      e.z = expf(e.z - mx[r]);
      e.w = expf(e.w - mx[r]);
      *pp = e;
      sum[r] += (e.x + e.y) + (e.z + e.w);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float s = warp_sum(sum[r]);
    if (lane == 0) red[warp][r] = s;
  }
  if (ALIGNED) cp_async_wait<0>();   // V has landed (this thread's part)
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (tid == r) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) s += red[i][r];
      ml[0][r] = mx[r];
      ml[1][r] = s;
    }
  }

  // unnormalised P.V of this rank's keys: warp w reduces d-rows [16w,
  // 16w + 16), DC of them a pass; lanes walk the words
#pragma unroll 1
  for (int d0 = warp * kDPerWarp; d0 < (warp + 1) * kDPerWarp; d0 += DC) {
    float acc[Pv::kAcc];
#pragma unroll
    for (int i = 0; i < Pv::kAcc; ++i) acc[i] = 0.f;
    for (int w = lane; w < nw; w += 32) {
      float4 pr[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        pr[r] = *reinterpret_cast<const float4*>(p + r * pitch + 4 * w);
#pragma unroll
      for (int dd = 0; dd < DC; ++dd) {
        float vv[4];
        dequant4(*reinterpret_cast<const uint32_t*>(
                     vs + (d0 + dd) * pitch + 4 * w), vv);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          float& o = acc[r * DC + dd];
          o = fmaf(pr[r].x, vv[0], o);
          o = fmaf(pr[r].y, vv[1], o);
          o = fmaf(pr[r].z, vv[2], o);
          o = fmaf(pr[r].w, vv[3], o);
        }
      }
    }
    warp_reduce_scatter<Pv::kAcc / 2>(acc, lane);
    constexpr int kLanesPer = 32 / Pv::kAcc;
    if ((lane & (kLanesPer - 1)) == 0) {
      const int i = lane / kLanesPer, r = i / DC;
      o_s[r * kHd + d0 + i - r * DC] = acc[0];
    }
  }
  cluster_arrive();
  cluster_wait();   // every rank's m, l and output are complete

  // combine the ranks in rank order: rank c writes every n_ranks-th
  // element of the rows x 64 output
  float vsc = 1.f;
  if (a.form != kF32) vsc = a.v_scale[bh];
  const uint32_t ml_local = smem_u32(&ml[0][0]);
  const uint32_t o_local = smem_u32(o_s);
  for (int e = rank * kThreads + tid; e < rows * kHd;
       e += n_ranks * kThreads) {
    const int r = e / kHd;
    float m[kMaxRanks];
    float mmax = -INFINITY;
#pragma unroll
    for (int c = 0; c < kMaxRanks; ++c) {
      m[c] = c < n_ranks ? ld_cluster(map_rank(ml_local + 4 * r, c))
                         : -INFINITY;
      mmax = fmaxf(mmax, m[c]);
    }
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxRanks; ++c) {
      if (c >= n_ranks) break;
      const float f = m[c] == -INFINITY ? 0.f : expf(m[c] - mmax);
      l = fmaf(ld_cluster(map_rank(ml_local + 4 * (ROWS + r), c)), f, l);
      o = fmaf(ld_cluster(map_rank(o_local + 4 * e, c)), f, o);
    }
    const int64_t oi =
        (((int64_t)b * a.n_rows + row0 + r) * a.n_head + h) * kHd
        + e - r * kHd;
    const float val = o / l;
    if (a.form == kF32) {
      static_cast<float*>(a.out)[oi] = val;
    } else {
      const float y = val * vsc;
      const bf16 hi = __float2bfloat16_rn(y);
      static_cast<bf16*>(a.out)[oi] = hi;
      if (a.form == kTerms)
        a.out_lo[oi] = __float2bfloat16_rn(y - __bfloat162float(hi));
    }
  }
  cluster_arrive();
  cluster_wait();   // no rank leaves while another may read its memory
}

template <int ROWS, bool ALIGNED>
int launch_one(const Args& a, int batch, int smem, cudaStream_t stream) {
  auto kernel = decode_cross_attention_kernel<ROWS, ALIGNED>;
  static SmemGuard guard;
  const int allowed = allow_smem(kernel, guard, smem);
  if (allowed) return allowed;
  cudaError_t err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ranks * batch * a.n_head,
                     (a.n_rows + ROWS - 1) / ROWS);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.ranks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int ROWS>
int launch_rows(const Args& a, int batch, cudaStream_t stream) {
  const int smem = layout(ROWS, a.rank_words).total;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  if ((a.t_len & 3) == 0)
    return launch_one<ROWS, true>(a, batch, smem, stream);
  return launch_one<ROWS, false>(a, batch, smem, stream);
}

int launch(Args a, int layer, int batch, cudaStream_t stream) {
  if (a.t_len <= 0 || a.t_len > kMaxT || a.n_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t layer_off = (int64_t)layer * batch * a.n_head * kHd * a.t_len;
  a.k += layer_off;
  a.v += layer_off;
  if (a.v_scale != nullptr) a.v_scale += (int64_t)layer * batch * a.n_head;
  const int words = (a.t_len + 3) / 4;
  a.ranks = (words + kWordsPerRank - 1) / kWordsPerRank;
  if (a.ranks > kMaxRanks) a.ranks = kMaxRanks;
  a.rank_words = (words + a.ranks - 1) / a.ranks;
  if (a.n_rows <= 1) return launch_rows<1>(a, batch, stream);
  if (a.n_rows <= 2) return launch_rows<2>(a, batch, stream);
  if (a.n_rows <= 4) return launch_rows<4>(a, batch, stream);
  return launch_rows<kMaxRows>(a, batch, stream);
}

}  // namespace

// k and v point at the whole (L, B, H, 64, T) stack; `layer` selects one.
// f32 output before v_scale.
extern "C" int wjt_decode_cross_attention(const void* q, const void* k,
                                          const void* v, void* o, int layer,
                                          int batch, int n_rows, int n_head,
                                          int t_len, void* stream) {
  Args a = {static_cast<const float*>(q), static_cast<const int8_t*>(k),
            static_cast<const int8_t*>(v), nullptr, o, nullptr, kF32,
            n_rows, n_head, t_len, 0, 0};
  return launch(a, layer, batch, static_cast<cudaStream_t>(stream));
}

// The scaled forms: v_scale (L, B, H) f32 of the whole stack; form 1
// writes bf16(out * v_scale) to o, form 2 its hi/lo terms to o, o_lo.
extern "C" int wjt_decode_cross_attention_scaled(
    const void* q, const void* k, const void* v, const void* v_scale,
    void* o, void* o_lo, int form, int layer, int batch, int n_rows,
    int n_head, int t_len, void* stream) {
  if (form != kBf16 && form != kTerms)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {static_cast<const float*>(q), static_cast<const int8_t*>(k),
            static_cast<const int8_t*>(v),
            static_cast<const float*>(v_scale), o, static_cast<bf16*>(o_lo),
            form, n_rows, n_head, t_len, 0, 0};
  return launch(a, layer, batch, static_cast<cudaStream_t>(stream));
}

// largest T the kernel takes
extern "C" int wjt_decode_cross_attention_max_t(void) { return kMaxT; }
