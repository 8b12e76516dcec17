// Encoder self-attention for Hopper (sm_90a): bidirectional multi-head
// attention over the (B, T, H, 64) bf16 layout, flash-style.
//
// Replaces the TPU kernel whisperjav_tpu/ops/pallas/attention.py
// (_flash / _attn_kernel, wrapped by encoder_attention).
//
// What bounds it on the H100: arithmetic. One turbo encoder batch
// (B=32, T=1500, H=20, hd=64, 32 layers) needs 4*B*H*T^2*hd*L ~ 1.2e13
// FLOP, against ~70 MB of q/k/v per layer. The plain PyTorch version
// also writes and re-reads a (B, H, T, T) f32 logit tensor (5.8 GB per
// layer at B=32), which makes it memory-bound instead.
//
// What the design does about it: the logits never leave the SM. One
// block of 4 warps owns 64 query rows of one (batch, head); it walks the
// keys in tiles of 64, staging K and V^T in shared memory (9 KB each,
// rows padded by 8 bf16 so the fragment loads hit 32 distinct banks).
// Q.K^T and P.V run on the tensor cores as bf16 mma.sync.m16n8k16 with
// f32 accumulation; the softmax is online, in f32, in registers. The
// ragged edge (T=1500 is not a multiple of 64) is masked in the kernel,
// and q/k/v are read straight from their strides, so the wrapper makes
// no transposed or padded copies.
//
// Numerics follow models/whisper/model.py:attention: q and k are each
// scaled by hd^-0.25 and rounded to bf16, logits and softmax are f32,
// probabilities are rounded to bf16 before the product with V, and that
// product accumulates in f32. (The probabilities are rounded before the
// final division by the row sum rather than after it.)
//
// Plain C interface, bound with ctypes; the kernel launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 64;       // head dim (all Whisper sizes)
constexpr int kBq = 64;       // query rows per block, 16 per warp
constexpr int kBk = 64;       // keys per shared-memory tile
constexpr int kThreads = 128; // 4 warps
constexpr int kPad = 8;       // bf16 padding per shared-memory row
constexpr int kRow = kHd + kPad;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A(16x16, row) * B(16x8, col) + D; bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_16816(float d[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two consecutive bf16 of global row `row` at column `col`, each scaled
// by `scale` and rounded back to bf16; zeros past the ragged edge.
__device__ __forceinline__ uint32_t load_scaled_pair(
    const __nv_bfloat16* base, int64_t s_t, int row, int t, int col,
    float scale) {
  if (row >= t) return 0u;
  __nv_bfloat162 v =
      *reinterpret_cast<const __nv_bfloat162*>(base + row * s_t + col);
  float2 f = __bfloat1622float2(v);
  return pack_bf16x2(f.x * scale, f.y * scale);
}

__global__ void __launch_bounds__(kThreads)
encoder_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, int t_len, int n_head,
                         int64_t qs_b, int64_t qs_t, int64_t qs_h,
                         int64_t ks_b, int64_t ks_t, int64_t ks_h,
                         int64_t vs_b, int64_t vs_t, int64_t vs_h) {
  __shared__ __align__(16) __nv_bfloat16 k_tile[kBk][kRow];   // [key][hd]
  __shared__ __align__(16) __nv_bfloat16 vt_tile[kHd][kRow];  // [hd][key]

  const int q0 = blockIdx.x * kBq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread within the group
  const float scale = 0.35355339059327373f;  // 64^-0.25

  const __nv_bfloat16* qb = q + b * qs_b + h * qs_h;
  const __nv_bfloat16* kb = k + b * ks_b + h * ks_h;
  const __nv_bfloat16* vb = v + b * vs_b + h * vs_h;

  // this thread's two query rows
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;

  // Q as A fragments, one per 16-wide slice of hd
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + 2 * tg;
    qa[kk][0] = load_scaled_pair(qb, qs_t, r0, t_len, c, scale);
    qa[kk][1] = load_scaled_pair(qb, qs_t, r1, t_len, c, scale);
    qa[kk][2] = load_scaled_pair(qb, qs_t, r0, t_len, c + 8, scale);
    qa[kk][3] = load_scaled_pair(qb, qs_t, r1, t_len, c + 8, scale);
  }

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row maxima
  float l0 = 0.f, l1 = 0.f;              // this thread's share of row sums

  for (int k0 = 0; k0 < t_len; k0 += kBk) {
    __syncthreads();  // previous tile fully consumed
    // stage K (scaled) and V^T: 64 rows x 8 chunks of 8 bf16 each
#pragma unroll
    for (int i = 0; i < (kBk * kHd / 8) / kThreads; ++i) {
      const int chunk = tid + i * kThreads;
      const int row = chunk >> 3;
      const int col = (chunk & 7) * 8;
      const int key = k0 + row;
      uint4 kraw = make_uint4(0u, 0u, 0u, 0u);
      uint4 vraw = make_uint4(0u, 0u, 0u, 0u);
      if (key < t_len) {
        kraw = *reinterpret_cast<const uint4*>(kb + key * ks_t + col);
        vraw = *reinterpret_cast<const uint4*>(vb + key * vs_t + col);
      }
      const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(&kraw);
      uint4 kscaled;
      uint32_t* ko = reinterpret_cast<uint32_t*>(&kscaled);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float2 f = __bfloat1622float2(kp[e]);
        ko[e] = pack_bf16x2(f.x * scale, f.y * scale);
      }
      *reinterpret_cast<uint4*>(&k_tile[row][col]) = kscaled;
      const __nv_bfloat16* vp = reinterpret_cast<const __nv_bfloat16*>(&vraw);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_tile[col + e][row] = vp[e];
    }
    __syncthreads();

    // S = (q s)(k s)^T for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* kr = &k_tile[j * 8 + g][kk * 16 + 2 * tg];
        mma_16816(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // mask keys past the end, then the online-softmax update
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = k0 + j * 8 + 2 * tg;
      if (key >= t_len) { s[j][0] = -INFINITY; s[j][2] = -INFINITY; }
      if (key + 1 >= t_len) { s[j][1] = -INFINITY; s[j][3] = -INFINITY; }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // every tile holds at least one real key, so the new maxima are finite
    const float n0 = fmaxf(m0, mx0);
    const float n1 = fmaxf(m1, mx1);
    const float a0 = __expf(m0 - n0);
    const float a1 = __expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= a0; acc[j][1] *= a0;
      acc[j][2] *= a1; acc[j][3] *= a1;
      s[j][0] = __expf(s[j][0] - n0);
      s[j][1] = __expf(s[j][1] - n0);
      s[j][2] = __expf(s[j][2] - n1);
      s[j][3] = __expf(s[j][3] - n1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // acc += P V: the S accumulator layout is the A fragment layout
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* vr = &vt_tile[j * 8 + g][kk * 16 + 2 * tg];
        mma_16816(acc[j], pa, *reinterpret_cast<const uint32_t*>(vr),
                  *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0;
  const float inv1 = 1.f / l1;
  // output is contiguous (B, T, H, 64)
  const int64_t os_t = (int64_t)n_head * kHd;
  __nv_bfloat16* ob = o + ((int64_t)b * t_len * n_head + h) * kHd;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + 2 * tg;
    if (r0 < t_len)
      *reinterpret_cast<uint32_t*>(ob + r0 * os_t + c) =
          pack_bf16x2(acc[j][0] * inv0, acc[j][1] * inv0);
    if (r1 < t_len)
      *reinterpret_cast<uint32_t*>(ob + r1 * os_t + c) =
          pack_bf16x2(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

}  // namespace

extern "C" int wjt_encoder_attention(
    const void* q, const void* k, const void* v, void* o, int batch, int t_len,
    int n_head, int64_t qs_b, int64_t qs_t, int64_t qs_h, int64_t ks_b,
    int64_t ks_t, int64_t ks_h, int64_t vs_b, int64_t vs_t, int64_t vs_h,
    void* stream) {
  dim3 grid((t_len + kBq - 1) / kBq, n_head, batch);
  encoder_attention_kernel<<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      t_len, n_head, qs_b, qs_t, qs_h, ks_b, ks_t, ks_h, vs_b, vs_t, vs_h);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wjt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
