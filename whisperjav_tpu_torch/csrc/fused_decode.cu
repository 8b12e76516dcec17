// Fused decoder-layer blocks for one decode step (q_len == 1) on int8
// decoder weights, for Hopper (sm_90a).
//
// Replaces the TPU kernels of whisperjav_tpu/ops/pallas/fused_decode.py:
//
//   wjt_self_block  <- self_block_stacked:  LN -> fused-QKV int8 GEMV
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
// 6.6), read once: ~7 us at 3.35 TB/s. The GEMVs are f32 products on the
// CUDA cores: 2*R*d*(3d + 3d + 8d) FLOP, 2.9 GFLOP per layer at R = 64,
// ~44 us at the card's 67 TFLOP/s f32 rate, so at R = 32-64 this design
// is bound by f32 FMA throughput, not by bytes (the tensor cores, with
// activations split into bf16 pairs, are the next step). The self cache
// (R*pos*d*2 bf16 values per layer, up to 74 MB at R = 64, pos = 227)
// and the int8 cross K/V (2*B*d*T bytes, 123 MB at B = 32, T = 1500)
// are streamed once each.
//
// What the design does about it. The TPU grid walks the rows in order on
// one core and reuses each weight block from VMEM for every row; one
// block per row here would re-read the weights R times. So each GEMV
// block holds all rows of a row tile (16, 32 or 64: the smallest that
// holds R) and 256, 128 or 64 output columns (2048 outputs a block): each
// weight tile is read from memory once, converted to f32 once into
// shared memory, and used by every row. Each thread computes 4 rows x 4
// columns, so a k step costs it two 16-byte shared-memory loads for 16
// FMAs and the FMA units, not shared memory, set the pace. K is split
// across blocks when the tiles alone would leave SMs idle (N = d at
// large-v2 and R = 64 gives 20 tiles); partial sums go to a workspace
// and the last block of a tile adds them in a fixed order
// (deterministic) and runs the epilogue. LN is computed inside the first
// GEMV of each block (each block takes the row statistics itself).
// Attention runs one block per (row, head) for the self cache, streaming
// the cache slab (never in shared memory: up to 580 KB per row).
//
// Launches per entry point, on the caller's stream: self 3 (QKV GEMV,
// attention, out-projection), cross 3 (q GEMV, Kernel B, out-projection),
// MLP 2 (W1, W2); each entry also clears its split-K counters with one
// cudaMemsetAsync. Intermediates (qkv, attention output, the 4d hidden)
// stay in f32 in the caller's workspace, which stays in L2.
//
// Plain C interface, bound with ctypes; nothing is allocated here, and
// each entry returns the first CUDA error it meets (cudaGetLastError
// after each launch).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

// Kernel B, in decode_cross_attention.cu of the same library.
extern "C" int wjt_decode_cross_attention(const void* q, const void* k,
                                          const void* v, void* o, int layer,
                                          int batch, int n_rows, int n_head,
                                          int t_len, void* stream);

namespace {

constexpr int kHd = 64;          // head dim (all Whisper sizes)
constexpr int kThreads = 256;    // GEMV block: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKc = 32;          // k per shared-memory chunk
constexpr int kMaxTr = 64;       // rows per GEMV block
constexpr int kMinKSplit = 64;   // least k a split-K block takes
constexpr int kTargetBlocks = 264;   // 2 blocks on each of 132 SMs
constexpr int kAttnThreads = 128;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr float kAttnScale = 0.125f;  // hd^-0.5 at hd = 64

enum Src { kSrcLn = 0, kSrcF32 = 1, kSrcF32VScale = 2 };
enum Epi { kEpiStore = 0, kEpiGelu = 1, kEpiResidual = 2, kEpiQFold = 3 };

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

// One int8 GEMV stage: out[r][n] = epilogue(sum_k A[r][k] * W[k][n]).
struct Gemv {
  const bf16* x;           // kSrcLn: (rows, k) input; kEpiResidual: (rows, n)
  const bf16* ln_s;        // kSrcLn: (k) LayerNorm scale and bias
  const bf16* ln_b;
  const float* a;          // kSrcF32*: (rows, k) f32 input
  const float* a_scale;    // kSrcF32VScale: (rows / group, k / 64) factors
  const int8_t* w;         // (k, n) int8 codes
  const float* w_scale;    // (n) per-output-channel scale
  const bf16* bias;        // (n)
  float* out_f32;          // kEpiStore / kEpiGelu / kEpiQFold: (rows, n)
  bf16* out_t;             // kEpiResidual: (rows, n)
  bf16* k_new;             // kEpiStore on fused QKV: columns [d, 2d) and
  bf16* v_new;             // [2d, 3d) also in bf16, (rows, d); else null
  const float* q_scale;    // kEpiQFold: (rows / group, n / 64) factors
  float q_mult;            // kEpiQFold: hd^-0.5
  float* partial;          // (splits, rows, n) split-K sums
  int* counters;           // one per (column tile, row tile), zero on entry
  int rows, k, n, k_per_split, d_model, group, n_head;
};

// four consecutive elements as f32 (the address is 4-element aligned)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Block tile: WR x 16 rows by (8 / WR) x 32 columns; each warp owns 16
// rows x 32 columns and each thread 4 rows x 4 columns, so a k step
// costs a thread two 16-byte shared-memory loads (one wavefront each
// per warp) for 16 FMAs.
template <int SRC, int EPI, int WR>
__global__ void __launch_bounds__(kThreads) qgemv_kernel(Gemv p) {
  constexpr int kTr = 16 * WR;                 // rows of the tile
  constexpr int kNt = 32 * (kWarps / WR);      // columns of the tile
  constexpr int kAPitch = kTr + 4;             // [k][r], 16-byte rows
  __shared__ __align__(16) float a_s[kKc * kAPitch];
  __shared__ __align__(16) float w_s[kKc * kNt];
  __shared__ float stat_s[2 * kMaxTr];         // LN mean, rstd per row
  __shared__ int last_s;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int rb = (warp % WR) * 16 + (lane >> 3) * 4;   // thread's rows
  const int cb = (warp / WR) * 32 + (lane & 7) * 4;    // thread's columns
  const int n0 = blockIdx.x * kNt;
  const int r0 = blockIdx.z * kTr;
  const int rows = min(kTr, p.rows - r0);
  const int k_begin = blockIdx.y * p.k_per_split;
  const int k_end = min(p.k, k_begin + p.k_per_split);

  if (SRC == kSrcLn) {
    // two-pass f32 statistics of each row over the whole of k
    for (int r = warp; r < rows; r += kWarps) {
      const bf16* xr = p.x + (int64_t)(r0 + r) * p.k;
      float s = 0.f;
      for (int i = lane; i < p.k; i += 32) s += to_f32(xr[i]);
      const float mean = warp_sum(s) / p.k;
      float v = 0.f;
      for (int i = lane; i < p.k; i += 32) {
        const float c = to_f32(xr[i]) - mean;
        v += c * c;
      }
      v = warp_sum(v) / p.k;
      if (lane == 0) {
        stat_s[2 * r] = mean;
        stat_s[2 * r + 1] = rsqrtf(v + 1e-5f);
      }
    }
    __syncthreads();
  }
  // A staging: each thread keeps one row and walks k in groups of 4
  const int ar = tid % kTr;
  float mean = 0.f, rstd = 0.f;
  if (SRC == kSrcLn && ar < rows) {
    mean = stat_s[2 * ar];
    rstd = stat_s[2 * ar + 1];
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += kKc) {
    const int kn = min(kKc, k_end - kc);
    __syncthreads();  // the previous chunk is consumed
    // A chunk, f32, transposed to [k][r]; zeros outside the tile
    for (int q = tid / kTr; q < kKc / 4; q += kThreads / kTr) {
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * q < kn && ar < rows) {
        const int kg = kc + 4 * q;
        const int64_t idx = (int64_t)(r0 + ar) * p.k + kg;
        if (SRC == kSrcLn) {
          const float4 xv = load4(p.x + idx);
          const float4 g = load4(p.ln_s + kg);
          const float4 b = load4(p.ln_b + kg);
          val.x = (xv.x - mean) * rstd * g.x + b.x;
          val.y = (xv.y - mean) * rstd * g.y + b.y;
          val.z = (xv.z - mean) * rstd * g.z + b.z;
          val.w = (xv.w - mean) * rstd * g.w + b.w;
        } else {
          val = load4(p.a + idx);
          if (SRC == kSrcF32VScale) {
            const float f =
                p.a_scale[((r0 + ar) / p.group) * p.n_head + kg / kHd];
            val.x *= f; val.y *= f; val.z *= f; val.w *= f;
          }
        }
      }
      a_s[(4 * q + 0) * kAPitch + ar] = val.x;
      a_s[(4 * q + 1) * kAPitch + ar] = val.y;
      a_s[(4 * q + 2) * kAPitch + ar] = val.z;
      a_s[(4 * q + 3) * kAPitch + ar] = val.w;
    }
    // W chunk: kKc rows of k x kNt int8 columns -> f32, 8 bytes a step
    for (int u = tid; u < kKc * kNt / 8; u += kThreads) {
      const int kk = u / (kNt / 8);
      const int c = (u % (kNt / 8)) * 8;
      float4 lo4 = make_float4(0.f, 0.f, 0.f, 0.f), hi4 = lo4;
      if (kk < kn && n0 + c < p.n) {
        const char4* src = reinterpret_cast<const char4*>(
            p.w + (int64_t)(kc + kk) * p.n + n0 + c);
        const char4 lo = src[0], hi = src[1];
        lo4 = make_float4(lo.x, lo.y, lo.z, lo.w);
        hi4 = make_float4(hi.x, hi.y, hi.z, hi.w);
      }
      float4* dst = reinterpret_cast<float4*>(&w_s[kk * kNt + c]);
      dst[0] = lo4;
      dst[1] = hi4;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kKc; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[kk * kAPitch + rb]);
      const float4 wv = *reinterpret_cast<const float4*>(&w_s[kk * kNt + cb]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(a4[i], wv.x, acc[i][0]);
        acc[i][1] = fmaf(a4[i], wv.y, acc[i][1]);
        acc[i][2] = fmaf(a4[i], wv.z, acc[i][2]);
        acc[i][3] = fmaf(a4[i], wv.w, acc[i][3]);
      }
    }
  }

  const bool col_ok = n0 + cb < p.n;   // n % 32 == 0: all 4 or none
  if (gridDim.y > 1) {
    // split-K: publish this split's sums; the tile's last block adds all
    // splits in order 0..S-1 and finishes
    float* part = p.partial + (int64_t)blockIdx.y * p.rows * p.n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (rb + i < rows && col_ok)
        *reinterpret_cast<float4*>(
            &part[(int64_t)(r0 + rb + i) * p.n + n0 + cb]) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int tile = blockIdx.z * gridDim.x + blockIdx.x;
      last_s = atomicAdd(&p.counters[tile], 1) == (int)gridDim.y - 1;
    }
    __syncthreads();
    if (!last_s) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    for (int s = 0; s < (int)gridDim.y; ++s) {
      const float* ps = p.partial + (int64_t)s * p.rows * p.n;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (rb + i < rows && col_ok) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(
              &ps[(int64_t)(r0 + rb + i) * p.n + n0 + cb]));
          acc[i][0] += v.x; acc[i][1] += v.y; acc[i][2] += v.z; acc[i][3] += v.w;
        }
      }
    }
  }
  if (!col_ok) return;

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (rb + i >= rows) continue;
    const int rg = r0 + rb + i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + cb + c;
      const int64_t o = (int64_t)rg * p.n + n;
      const float y = acc[i][c] * p.w_scale[n] + to_f32(p.bias[n]);
      if (EPI == kEpiStore) {
        p.out_f32[o] = y;
        if (p.k_new != nullptr && n >= p.d_model) {
          const int d = p.d_model;
          const bf16 yb = __float2bfloat16_rn(y);
          if (n < 2 * d) p.k_new[(int64_t)rg * d + n - d] = yb;
          else p.v_new[(int64_t)rg * d + n - 2 * d] = yb;
        }
      } else if (EPI == kEpiGelu) {
        p.out_f32[o] = y * 0.5f * (1.f + erff(y * 0.70710678118654752f));
      } else if (EPI == kEpiResidual) {
        p.out_t[o] = __float2bfloat16_rn(to_f32(p.x[o]) + y);
      } else {  // kEpiQFold
        p.out_f32[o] =
            y * (p.q_mult * p.q_scale[(rg / p.group) * p.n_head + n / kHd]);
      }
    }
  }
}

// Decode-step self-attention of one (row, head) over the cache slots
// t < pos plus the new key, whose logit and value come from the f32 qkv.
__global__ void __launch_bounds__(kAttnThreads)
self_attention_kernel(const float* __restrict__ qkv,
                      const bf16* __restrict__ ck,
                      const bf16* __restrict__ cv, float* __restrict__ out,
                      int d, int n_head, int t_cache, int pos, float scale) {
  extern __shared__ float p_s[];          // [pos] logits, then exp
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
    o = fmaf(e_new, qrow[2 * d + h * kHd + tid], o);
    out[(int64_t)r * d + h * kHd + tid] = o / denom;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Plan {
  int wr, tiles_x, tiles_z, splits, k_per;
  int tiles() const { return tiles_x * tiles_z; }
};

// Grid of one GEMV: the row tile (16, 32 or 64 rows: WR warps down, the
// other warps across columns) is the smallest that holds the rows; then
// column tiles x row tiles, and K split until there are about
// kTargetBlocks blocks (each split keeps >= kMinKSplit of k). A fixed
// target, not the device's SM count, so that the workspace size is a
// function of the shapes alone.
Plan plan(int rows, int k, int n) {
  Plan pl;
  pl.wr = rows <= 16 ? 1 : rows <= 32 ? 2 : 4;
  const int nt = 32 * (kWarps / pl.wr);
  pl.tiles_x = (n + nt - 1) / nt;
  pl.tiles_z = (rows + 16 * pl.wr - 1) / (16 * pl.wr);
  const int want = (kTargetBlocks + pl.tiles() - 1) / pl.tiles();
  const int s = std::max(1, std::min(want, k / kMinKSplit));
  pl.k_per = ((k + s - 1) / s + kKc - 1) / kKc * kKc;
  pl.splits = (k + pl.k_per - 1) / pl.k_per;
  return pl;
}

int64_t partial_floats(int rows, int k, int n) {
  const Plan pl = plan(rows, k, n);
  return pl.splits > 1 ? (int64_t)pl.splits * rows * n : 0;
}

template <int SRC, int EPI>
int run_gemv(Gemv p, cudaStream_t stream) {
  const Plan pl = plan(p.rows, p.k, p.n);
  p.k_per_split = pl.k_per;
  dim3 grid(pl.tiles_x, pl.splits, pl.tiles_z);
  if (pl.wr == 1)
    qgemv_kernel<SRC, EPI, 1><<<grid, kThreads, 0, stream>>>(p);
  else if (pl.wr == 2)
    qgemv_kernel<SRC, EPI, 2><<<grid, kThreads, 0, stream>>>(p);
  else
    qgemv_kernel<SRC, EPI, 4><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Workspace of one entry, carved in this order: f32 intermediates, the
// split-K partial sums (shared by the entry's GEMVs, which run in stream
// order), then the int32 counters.
struct Work {
  float* f;
  float* partial;
  int* counters;
  int n_counters;
};

enum Kind { kSelf = 0, kCross = 1, kMlp = 2 };

struct Shapes {
  int n_gemv;
  int k[2], n[2];
  int64_t inter_floats;
};

Shapes shapes(int kind, int rows, int d, int hidden) {
  Shapes s;
  s.n_gemv = 2;
  if (kind == kSelf) {
    s.k[0] = d; s.n[0] = 3 * d; s.k[1] = d; s.n[1] = d;
    s.inter_floats = (int64_t)rows * 4 * d;          // qkv, attention out
  } else if (kind == kCross) {
    s.k[0] = d; s.n[0] = d; s.k[1] = d; s.n[1] = d;
    s.inter_floats = (int64_t)rows * 2 * d;          // q, attention out
  } else {
    s.k[0] = d; s.n[0] = hidden; s.k[1] = hidden; s.n[1] = d;
    s.inter_floats = (int64_t)rows * hidden;         // GELU(h W1)
  }
  return s;
}

int64_t workspace_bytes(int kind, int rows, int d, int hidden, Work* w,
                        void* base) {
  const Shapes s = shapes(kind, rows, d, hidden);
  int64_t part = 0;
  int counters = 0;
  for (int i = 0; i < s.n_gemv; ++i) {
    part = std::max(part, partial_floats(rows, s.k[i], s.n[i]));
    counters += plan(rows, s.k[i], s.n[i]).tiles();
  }
  const int64_t floats = s.inter_floats + part;
  if (w != nullptr) {
    w->f = static_cast<float*>(base);
    w->partial = w->f + s.inter_floats;
    w->counters = reinterpret_cast<int*>(w->f + floats);
    w->n_counters = counters;
  }
  return floats * (int64_t)sizeof(float) + (int64_t)counters * sizeof(int);
}

Gemv gemv_base(int rows, int k, int n, int d, const int8_t* w,
               const float* ws, const void* bias, const Work& work,
               int* counters) {
  Gemv p = {};
  p.rows = rows; p.k = k; p.n = n; p.d_model = d;
  p.w = w; p.w_scale = ws; p.bias = static_cast<const bf16*>(bias);
  p.partial = work.partial;
  p.counters = counters;
  p.group = 1;
  p.n_head = 1;
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
               void* k_new, void* v_new, void* work, int layer, int pos,
               int rows, int d, int n_head, int t_cache,
               cudaStream_t stream) {
  Work wk;
  workspace_bytes(kSelf, rows, d, 0, &wk, work);
  WJT_TRY(static_cast<int>(cudaMemsetAsync(
      wk.counters, 0, wk.n_counters * sizeof(int), stream)));
  float* qkv = wk.f;
  float* attn = wk.f + (int64_t)rows * 3 * d;
  const int64_t L = layer;
  const bf16* xt = static_cast<const bf16*>(x);

  Gemv g1 = gemv_base(
      rows, d, 3 * d, d, static_cast<const int8_t*>(wqkv) + L * d * 3 * d,
      static_cast<const float*>(wqkv_s) + L * 3 * d,
      static_cast<const bf16*>(bqkv) + L * 3 * d, wk, wk.counters);
  g1.x = xt;
  g1.ln_s = static_cast<const bf16*>(ln_s) + L * d;
  g1.ln_b = static_cast<const bf16*>(ln_b) + L * d;
  g1.out_f32 = qkv;
  g1.k_new = static_cast<bf16*>(k_new);
  g1.v_new = static_cast<bf16*>(v_new);
  WJT_TRY((run_gemv<kSrcLn, kEpiStore>(g1, stream)));

  const int64_t slab = L * rows * t_cache * d;
  self_attention_kernel<<<rows * n_head, kAttnThreads,
                          (size_t)(pos > 0 ? pos : 1) * sizeof(float),
                          stream>>>(
      qkv, static_cast<const bf16*>(cache_k) + slab,
      static_cast<const bf16*>(cache_v) + slab, attn, d, n_head, t_cache, pos,
      kAttnScale);
  WJT_TRY(static_cast<int>(cudaGetLastError()));

  Gemv g2 = gemv_base(
      rows, d, d, d, static_cast<const int8_t*>(wo) + L * d * d,
      static_cast<const float*>(wo_s) + L * d,
      static_cast<const bf16*>(bo) + L * d, wk,
      wk.counters + plan(rows, d, 3 * d).tiles());
  g2.a = attn;
  g2.x = xt;
  g2.out_t = static_cast<bf16*>(x_out);
  return run_gemv<kSrcF32, kEpiResidual>(g2, stream);
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
  WJT_TRY(static_cast<int>(cudaMemsetAsync(
      wk.counters, 0, wk.n_counters * sizeof(int), stream)));
  float* q = wk.f;
  float* attn = wk.f + (int64_t)rows * d;
  const int64_t L = layer;
  const int group = rows / batch;
  const bf16* xt = static_cast<const bf16*>(x);

  Gemv g1 = gemv_base(
      rows, d, d, d, static_cast<const int8_t*>(cwq) + L * d * d,
      static_cast<const float*>(cwq_s) + L * d,
      static_cast<const bf16*>(cbq) + L * d, wk, wk.counters);
  g1.x = xt;
  g1.ln_s = static_cast<const bf16*>(ln_s) + L * d;
  g1.ln_b = static_cast<const bf16*>(ln_b) + L * d;
  g1.out_f32 = q;
  g1.q_scale = static_cast<const float*>(k_scale) + L * batch * n_head;
  g1.q_mult = kAttnScale;
  g1.group = group;
  g1.n_head = n_head;
  WJT_TRY((run_gemv<kSrcLn, kEpiQFold>(g1, stream)));

  // q (B, g, H, 64) = (rows, d): g query rows per cross-K/V row
  WJT_TRY(wjt_decode_cross_attention(q, ck, cv, attn, layer, batch, group,
                                     n_head, t_cross, stream));

  Gemv g2 = gemv_base(
      rows, d, d, d, static_cast<const int8_t*>(cwo) + L * d * d,
      static_cast<const float*>(cwo_s) + L * d,
      static_cast<const bf16*>(cbo) + L * d, wk,
      wk.counters + plan(rows, d, d).tiles());
  g2.a = attn;
  g2.a_scale = static_cast<const float*>(v_scale) + L * batch * n_head;
  g2.group = group;
  g2.n_head = n_head;
  g2.x = xt;
  g2.out_t = static_cast<bf16*>(x_out);
  return run_gemv<kSrcF32VScale, kEpiResidual>(g2, stream);
}

int mlp_block(const void* x, const void* ln_s, const void* ln_b,
              const void* w1, const void* w1_s, const void* b1,
              const void* w2, const void* w2_s, const void* b2, void* x_out,
              void* work, int layer, int rows, int d, int hidden,
              cudaStream_t stream) {
  Work wk;
  workspace_bytes(kMlp, rows, d, hidden, &wk, work);
  WJT_TRY(static_cast<int>(cudaMemsetAsync(
      wk.counters, 0, wk.n_counters * sizeof(int), stream)));
  const int64_t L = layer;
  const bf16* xt = static_cast<const bf16*>(x);

  Gemv g1 = gemv_base(
      rows, d, hidden, d, static_cast<const int8_t*>(w1) + L * d * hidden,
      static_cast<const float*>(w1_s) + L * hidden,
      static_cast<const bf16*>(b1) + L * hidden, wk, wk.counters);
  g1.x = xt;
  g1.ln_s = static_cast<const bf16*>(ln_s) + L * d;
  g1.ln_b = static_cast<const bf16*>(ln_b) + L * d;
  g1.out_f32 = wk.f;
  WJT_TRY((run_gemv<kSrcLn, kEpiGelu>(g1, stream)));

  Gemv g2 = gemv_base(
      rows, hidden, d, d, static_cast<const int8_t*>(w2) + L * hidden * d,
      static_cast<const float*>(w2_s) + L * d,
      static_cast<const bf16*>(b2) + L * d, wk,
      wk.counters + plan(rows, d, hidden).tiles());
  g2.a = wk.f;
  g2.x = xt;
  g2.out_t = static_cast<bf16*>(x_out);
  return run_gemv<kSrcF32, kEpiResidual>(g2, stream);
}

}  // namespace

// x, the LayerNorm parameters, the biases, the self cache and the
// outputs are bf16; weights are int8 with f32 scales; stacked pointers
// are offset to `layer` here.

extern "C" long long wjt_fused_workspace_bytes(int kind, int rows, int d,
                                               int hidden) {
  return workspace_bytes(kind, rows, d, hidden, nullptr, nullptr);
}

extern "C" int wjt_self_block(const void* x, const void* ln_s,
                              const void* ln_b, const void* wqkv,
                              const void* wqkv_s, const void* bqkv,
                              const void* wo, const void* wo_s,
                              const void* bo, const void* cache_k,
                              const void* cache_v, void* x_out, void* k_new,
                              void* v_new, void* work, int layer, int pos,
                              int rows, int d, int n_head, int t_cache,
                              void* stream) {
  return self_block(x, ln_s, ln_b, wqkv, wqkv_s, bqkv, wo, wo_s, bo, cache_k,
                    cache_v, x_out, k_new, v_new, work, layer, pos, rows, d,
                    n_head, t_cache, static_cast<cudaStream_t>(stream));
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
