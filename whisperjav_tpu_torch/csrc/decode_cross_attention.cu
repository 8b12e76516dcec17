// Decode-step cross-attention over int8 K/V for Hopper (sm_90a).
//
// Replaces the TPU kernels whisperjav_tpu/ops/pallas/decode_attention.py
// (_kernel behind decode_cross_attention, and
// decode_cross_attention_stacked, which picks the layer of the stacked
// K/V by scalar prefetch).
//
//   q (B, R, H, 64) f32, attention scale and k_scale folded in
//   K, V (L, B, H, 64, T) int8, layer chosen by a pointer offset
//   out (B, R, H, 64) f32, before v_scale
//
// R is the number of query rows that read one K/V row: g*q_len, where
// beam search folds its g beams onto one cross-K/V row
// (models/whisper/model.py:cross_attention).
//
// What bounds it on the H100: bytes. Every decode step streams the whole
// int8 cross K/V, 2*B*H*64*T bytes per layer (123 MB at B=32, T=1500 for
// the 4 turbo layers together: 491 MB), against ~4 FLOP per byte per
// query row. The plain PyTorch version also writes and re-reads a
// dequantised f32 copy of K and V.
//
// What the design does about it: K and V are read once, as int8, and
// dequantised in registers. One block owns one (batch, head) and up to
// kMaxRows query rows (more rows take more blocks along grid.y). Pass 1
// reads K along T in 4-byte words (consecutive threads, consecutive
// words) and writes the f32 logits to shared memory; pass 2 takes the
// f32 softmax of each row there; pass 3 reads V the same way and reduces
// each output element across a warp. Nothing but the output is written
// to device memory. Rows of K/V are 4-byte aligned only when T % 4 == 0
// (the 448/960/1500 buckets); other lengths take byte loads.
//
// Plain C interface, bound with ctypes; the kernel launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;

__device__ __forceinline__ void load4(const int8_t* row, int t, int t_len,
                                      bool aligned, float out[4]) {
  if (aligned) {
    const char4 c = *reinterpret_cast<const char4*>(row + t);
    out[0] = c.x; out[1] = c.y; out[2] = c.z; out[3] = c.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = (t + j < t_len) ? row[t + j] : 0.f;
  }
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
decode_cross_attention_kernel(const float* __restrict__ q,
                              const int8_t* __restrict__ k,
                              const int8_t* __restrict__ v,
                              float* __restrict__ o, int n_rows, int n_head,
                              int t_len) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [ROWS][64]
  float* p_s = smem + ROWS * kHd;    // [ROWS][t_len] logits, then probs
  __shared__ float inv_sum[ROWS];

  const int bh = blockIdx.x;         // b * n_head + h
  const int b = bh / n_head;
  const int h = bh - b * n_head;
  const int row0 = blockIdx.y * ROWS;
  const int rows = min(ROWS, n_rows - row0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool aligned = (t_len & 3) == 0;

  const int8_t* kb = k + (int64_t)bh * kHd * t_len;
  const int8_t* vb = v + (int64_t)bh * kHd * t_len;

  for (int i = tid; i < ROWS * kHd; i += kThreads) {
    const int r = i / kHd;
    const int d = i - r * kHd;
    q_s[i] = (r < rows)
        ? q[(((int64_t)b * n_rows + row0 + r) * n_head + h) * kHd + d]
        : 0.f;
  }
  __syncthreads();

  // pass 1: logits[r][t] = sum_d q[r][d] * K[d][t]
  for (int t = tid * 4; t < t_len; t += kThreads * 4) {
    float acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kHd; ++d) {
      float kv[4];
      load4(kb + (int64_t)d * t_len, t, t_len, aligned, kv);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float qv = q_s[r * kHd + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(qv, kv[j], acc[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (t + j < t_len) p_s[r * t_len + t + j] = acc[r][j];
    }
  }
  __syncthreads();

  // pass 2: f32 softmax of each row, one warp per row
  for (int r = warp; r < rows; r += kWarps) {
    float* row = p_s + r * t_len;
    float m = -INFINITY;
    for (int t = lane; t < t_len; t += 32) m = fmaxf(m, row[t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int t = lane; t < t_len; t += 32) {
      const float e = expf(row[t] - m);
      row[t] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) inv_sum[r] = 1.f / sum;
  }
  __syncthreads();

  // pass 3: out[r][d] = sum_t p[r][t] * V[d][t] / sum_r, one warp per d
  for (int d = warp; d < kHd; d += kWarps) {
    const int8_t* vrow = vb + (int64_t)d * t_len;
    float part[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) part[r] = 0.f;
    for (int t = lane * 4; t < t_len; t += 32 * 4) {
      float vv[4];
      load4(vrow, t, t_len, aligned, vv);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < rows) {
          const float* pr = p_s + r * t_len + t;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (t + j < t_len) part[r] = fmaf(pr[j], vv[j], part[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
    }
    if (lane == 0) {
      for (int r = 0; r < rows; ++r)
        o[(((int64_t)b * n_rows + row0 + r) * n_head + h) * kHd + d] =
            part[r] * inv_sum[r];
    }
  }
}

template <int ROWS>
int launch(const float* q, const int8_t* k, const int8_t* v, float* o,
           int batch, int n_rows, int n_head, int t_len, cudaStream_t stream) {
  const size_t smem = (size_t)ROWS * (kHd + t_len) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_cross_attention_kernel<ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(batch * n_head, (n_rows + ROWS - 1) / ROWS);
  decode_cross_attention_kernel<ROWS><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, n_rows, n_head, t_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k and v point at the whole (L, B, H, 64, T) stack; `layer` selects one.
extern "C" int wjt_decode_cross_attention(const void* q, const void* k,
                                          const void* v, void* o, int layer,
                                          int batch, int n_rows, int n_head,
                                          int t_len, void* stream) {
  const int64_t layer_off = (int64_t)layer * batch * n_head * kHd * t_len;
  const float* qf = static_cast<const float*>(q);
  const int8_t* kl = static_cast<const int8_t*>(k) + layer_off;
  const int8_t* vl = static_cast<const int8_t*>(v) + layer_off;
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 1) return launch<1>(qf, kl, vl, of, batch, n_rows, n_head, t_len, s);
  if (n_rows <= 2) return launch<2>(qf, kl, vl, of, batch, n_rows, n_head, t_len, s);
  if (n_rows <= 4) return launch<4>(qf, kl, vl, of, batch, n_rows, n_head, t_len, s);
  return launch<kMaxRows>(qf, kl, vl, of, batch, n_rows, n_head, t_len, s);
}

// largest T the kernel takes: its logit rows live in shared memory, which
// holds 227 KB per block on sm_90 (1 KB kept back for the static part)
extern "C" int wjt_decode_cross_attention_max_t(void) {
  return (226 * 1024) / (kMaxRows * (int)sizeof(float)) - kHd;
}
