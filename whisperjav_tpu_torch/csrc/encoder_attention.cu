// Encoder self-attention for Hopper (sm_90a): bidirectional multi-head
// attention over the (B, T, H, 64) bf16 layout, in the FlashAttention-3
// shape (TMA loads, wgmma on the tensor cores, warp specialisation).
//
// Replaces the TPU kernel whisperjav_tpu/ops/pallas/attention.py
// (_flash / _attn_kernel, wrapped by encoder_attention).
//
// What bounds it on the H100: arithmetic. One layer of the turbo or
// large-v2 encoder at B=32 (T=1500, H=20, hd=64) needs 4*B*H*T^2*hd =
// 368.6 GFLOP, 0.373 ms at the card's 989 TFLOP/s bf16 rate, against
// 492 MB of q/k/v/out (0.147 ms at 3.35 TB/s). The plain PyTorch version
// also writes and re-reads a (B, H, T, T) f32 logit tensor (5.8 GB per
// layer at B=32), which makes it memory-bound instead. The exponentials
// of the softmax come next: T^2 per (b, h) through the SFUs, which run
// at a small fraction of the tensor-core rate.
//
// What the design does about it: the logits never leave the SM, and only
// wgmma (the warpgroup MMA, the one way to the tensor cores' full rate)
// does the products. One CTA owns 128 query rows of one (batch, head):
// two consumer warpgroups of 64 rows each and one producer warpgroup.
//   * Thread 0 of the producer walks the keys in tiles of 64 and asks the
//     TMA for the K and V tiles (64 keys x 64 bf16, 128-byte rows,
//     128-byte swizzle) straight from the (B, T, H, hd) strides through
//     two tensor maps; rows past T arrive as zeros. The tiles land in a
//     ring of kStages stages, each signalled by an mbarrier (full). Then
//     the producer's 128 threads scale the K tile in place by hd^-0.25
//     and round it to bf16 (the numerics below) and release the stage to
//     the consumers (kready). Consumers hand a stage back through a third
//     barrier (empty), and the producer refills it.
//   * Each consumer warpgroup writes its 64 rows of q (scaled and
//     rounded) once into shared memory in the same swizzled layout. Per
//     tile: S = Q K^T with four wgmma m64n64k16 (Q and K from shared
//     memory, K-major), the ragged edge masked to -inf, the online
//     softmax in f32 in registers, P rounded to bf16 in registers (the S
//     accumulator layout is the A fragment layout), and O += P V with
//     four wgmma m64n64k16 whose B operand is V in shared memory read
//     through the transposed (MN-major) descriptor.
//   * Two CTAs share an SM (80 KB of shared memory each); setmaxnreg
//     moves registers from the producer warpgroup (24 a thread) to the
//     consumers (104). The four consumer warpgroups of an SM are not in
//     lockstep, so one's softmax overlaps another's products.
//   Measured on an H100 (PERF.md), this beat a software-pipelined loop
//   (S_i and P_{i-1} V_{i-1} in flight together), 128-key tiles, three
//   consumer warpgroups and a persistent grid.
//
// Numerics follow models/whisper/model.py:attention: q and k are each
// scaled by hd^-0.25 and rounded to bf16, logits and softmax are f32,
// probabilities are rounded to bf16 before the product with V, and that
// product accumulates in f32. (The probabilities are rounded before the
// final division by the row sum rather than after it.)
//
// Plain C interface, bound with ctypes; the kernel launches on the
// caller's stream, allocates nothing, and returns a cudaError_t.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem_guard.cuh"

namespace {

constexpr int kHd = 64;          // head dim (all Whisper sizes)
constexpr int kWgs = 2;          // consumer warpgroups, 64 query rows each
constexpr int kBq = 64 * kWgs;   // query rows per CTA
constexpr int kBk = 64;          // keys per tile
constexpr int kStages = 4;       // K/V ring depth
constexpr int kMinBlocks = 2;    // CTAs per SM
constexpr int kConsumerThreads = 128 * kWgs;
// + the producer warpgroup: one thread issues the TMA loads, all 128
// scale K; a whole warpgroup, so that setmaxnreg can hand its registers
// to the consumers
constexpr int kThreads = kConsumerThreads + 128;
// registers a thread after setmaxnreg; a CTA keeps the 384 x 80 it was
// launched with (the bound at 2 CTAs/SM): 128 x 24 + 256 x 104 <= 384 x 80
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 104;
constexpr int kTileBytes = kBk * kHd * 2;         // one K or V tile
constexpr float kScale = 0.35355339059327373f;    // 64^-0.25

struct Smem {
  __nv_bfloat16 q[kWgs][64 * kHd];       // each warpgroup's scaled q
  __nv_bfloat16 k[kStages][kBk * kHd];   // each 1024-byte aligned
  __nv_bfloat16 v[kStages][kBk * kHd];
  uint64_t full[kStages];    // TMA bytes of K and V arrived
  uint64_t kready[kStages];  // K scaled; the stage is the consumers'
  uint64_t empty[kStages];   // the consumers are done with the stage
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;   // + alignment slack

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the barrier's phase `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// One 4-D TMA load of a (1, 64 keys, 1, 64 hd) box of a (B, T, H, hd)
// tensor map at (b, key0, h) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h, int key0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(0), "r"(h), "r"(key0), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a tile with 128-byte rows in the
// 128-byte swizzle (layout type 1), 8-row groups 1024 bytes apart (SBO).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFFull) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d(64x64, f32) (+)= A(64x16 from `desc_a`, K-major) * B(16x64 from
// `desc_b`, K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
// d(64x64, f32) (+)= a(64x16, bf16 registers) * B(16x64 from `desc_b`,
// stored as K rows of N: MN-major, the transposed descriptor).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may not move their other uses across this point (it cannot see that a
// wgmma in flight still holds them).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// 2^x on the SFU (the instruction behind __expf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Eight bf16 scaled by kScale and rounded back to bf16.
__device__ __forceinline__ uint4 scale8(uint4 raw) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[e]));
    w[e] = pack_bf16x2(f.x * kScale, f.y * kScale);
  }
  return raw;
}

// One CTA per (block of kBq query rows, head, batch); the query blocks of
// one (b, h) are neighbours in the grid, so they read K/V from L2.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
encoder_attention_kernel(const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __nv_bfloat16* __restrict__ q,
                         __nv_bfloat16* __restrict__ o, int t_len, int n_head,
                         int64_t qs_b, int64_t qs_t, int64_t qs_h) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (t_len + kBk - 1) / kBk;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.kready[s], 4);   // the producer warpgroup's warps
      mbar_init(&sm.empty[s], kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    const int ptid = tid - kConsumerThreads;    // 0..127
    const int lane = tid & 31;
    auto issue = [&](int j) {
      const int s = j % kStages;
      if (j >= kStages) mbar_wait(&sm.empty[s], ((j / kStages) - 1) & 1);
      if (ptid == 0) {
        mbar_expect_tx(&sm.full[s], 2 * kTileBytes);
        tma_load(sm.k[s], &k_map, &sm.full[s], h, j * kBk, b);
        tma_load(sm.v[s], &v_map, &sm.full[s], h, j * kBk, b);
      }
    };
    for (int j = 0; j < kStages - 1 && j < n_tiles; ++j) issue(j);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(&sm.full[s], (i / kStages) & 1);
      // k <- bf16(k * hd^-0.25), 16 bytes a step (the swizzle moves
      // whole 16-byte chunks, so this is elementwise)
      uint4* kp = reinterpret_cast<uint4*>(sm.k[s]);
#pragma unroll 2
      for (int c = ptid; c < kTileBytes / 16; c += 128) kp[c] = scale8(kp[c]);
      // make the generic-proxy writes visible to wgmma's async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.kready[s]);
      if (i + kStages - 1 < n_tiles) issue(i + kStages - 1);
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int wg = tid >> 7;           // 64 query rows each
    const int warp = (tid >> 5) & 3;   // warp within the warpgroup
    const int lane = tid & 31;
    const int g = lane >> 2;           // fragment row group
    const int tg = lane & 3;           // thread within the group
    constexpr float kLog2e = 1.4426950408889634f;
    auto wg_sync = [&]() {             // named barrier 1 + wg, 128 threads
      static_assert(kWgs == 2, "one named barrier per warpgroup");
      if (wg == 0) asm volatile("bar.sync 1, 128;\n" ::: "memory");
      else asm volatile("bar.sync 2, 128;\n" ::: "memory");
    };

    // S accumulator layout: n8 tile j holds keys 8j + 2tg + {0, 1} of rows
    // g (regs 4j, 4j+1) and g + 8 (regs 4j+2, 4j+3) of this warp's 16
    float acc[32], sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    uint32_t pa[4][4];                 // P as bf16 A fragments of P V
    {
      const int q0 = blockIdx.x * kBq + wg * 64;
      const int r0 = q0 + warp * 16 + g;   // this thread's rows
      const int r1 = r0 + 8;

      // this warpgroup's 64 rows of q, scaled and rounded, into shared
      // memory in the 128-byte swizzle (16-byte chunk c of row r at chunk
      // c ^ (r % 8)), the layout of the K tiles
      {
        const __nv_bfloat16* qb = q + b * qs_b + h * qs_h;
        uint4* qs = reinterpret_cast<uint4*>(sm.q[wg]);
#pragma unroll
        for (int u0 = 0; u0 < 4; ++u0) {
          const int u = (tid & 127) + u0 * 128;
          const int r = u >> 3, c = u & 7;
          uint4 raw = make_uint4(0u, 0u, 0u, 0u);
          if (q0 + r < t_len)
            raw = scale8(*reinterpret_cast<const uint4*>(
                qb + (q0 + r) * qs_t + c * 8));
          qs[r * 8 + (c ^ (r & 7))] = raw;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wg_sync();
      }

#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY;  // running row maxima
      float l0 = 0.f, l1 = 0.f;              // this thread's row-sum shares
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(&sm.full[s], (i / kStages) & 1);
        mbar_wait(&sm.kready[s], (i / kStages) & 1);

        // S = (q s)(k s)^T, 64 x 64
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHd / 16; ++kk)
          wgmma_ss(sc, desc_sw128(sm.q[wg] + kk * 16),
                   desc_sw128(sm.k[s] + kk * 16), kk > 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);

        const int k0 = i * kBk;
        if (k0 + kBk > t_len) {            // the ragged edge: keys >= T
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int key = k0 + j * 8 + 2 * tg;
            if (key >= t_len) sc[4 * j] = sc[4 * j + 2] = -INFINITY;
            if (key + 1 >= t_len) sc[4 * j + 1] = sc[4 * j + 3] = -INFINITY;
          }
        }
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        // every tile holds at least one real key, so the new maxima are
        // finite; exp(s - m) = 2^(s log2e - m log2e), one FMA and one SFU op
        const float n0 = fmaxf(m0, mx0);
        const float n1 = fmaxf(m1, mx1);
        const float a0 = ex2((m0 - n0) * kLog2e);
        const float a1 = ex2((m1 - n1) * kLog2e);
        l0 *= a0;
        l1 *= a1;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[4 * j] *= a0; acc[4 * j + 1] *= a0;
          acc[4 * j + 2] *= a1; acc[4 * j + 3] *= a1;
        }
        m0 = n0;
        m1 = n1;
        const float b0 = n0 * kLog2e, b1 = n1 * kLog2e;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[4 * j] = ex2(fmaf(sc[4 * j], kLog2e, -b0));
          sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], kLog2e, -b0));
          sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], kLog2e, -b1));
          sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], kLog2e, -b1));
          s0 += sc[4 * j] + sc[4 * j + 1];
          s1 += sc[4 * j + 2] + sc[4 * j + 3];
        }
        l0 += s0;
        l1 += s1;

        // O += P V, P = bf16(exp(s - m)) as A fragments (the S
        // accumulator layout is the A fragment layout); keys 16kk..16kk+15
        // are V's rows
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          pa[kk][0] = pack_bf16x2(sc[8 * kk], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(acc, pa[kk], desc_sw128(sm.v[s] + kk * 16 * kHd), 1);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.empty[s]);
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
              pack_bf16x2(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        if (r1 < t_len)
          *reinterpret_cast<uint32_t*>(ob + r1 * os_t + c) =
              pack_bf16x2(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (so the
// library needs no link against libcuda); looked up once, by the first
// caller, whichever thread that is.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      return reinterpret_cast<EncodeTiledFn>(p);
    return nullptr;
  }();
  return fn;
}

// Tensor map of a (B, T, H, 64) bf16 tensor with element strides (s_b,
// s_t, s_h, 1): boxes of 64 keys x 64 hd of one (b, h), 128-byte swizzle,
// zeros past T.
bool make_map(CUtensorMap* map, const void* base, int batch, int t_len,
              int n_head, int64_t s_b, int64_t s_t, int64_t s_h) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)kHd, (cuuint64_t)n_head,
                              (cuuint64_t)t_len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_h * 2, (cuuint64_t)s_t * 2,
                                 (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {kHd, 1, kBk, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" int wjt_encoder_attention(
    const void* q, const void* k, const void* v, void* o, int batch, int t_len,
    int n_head, int64_t qs_b, int64_t qs_t, int64_t qs_h, int64_t ks_b,
    int64_t ks_t, int64_t ks_h, int64_t vs_b, int64_t vs_t, int64_t vs_h,
    void* stream) {
  static SmemGuard guard;
  const int err = allow_smem(encoder_attention_kernel, guard,
                             static_cast<int>(kSmemBytes));
  if (err) return err;
  CUtensorMap k_map, v_map;
  if (!make_map(&k_map, k, batch, t_len, n_head, ks_b, ks_t, ks_h) ||
      !make_map(&v_map, v, batch, t_len, n_head, vs_b, vs_t, vs_h))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((t_len + kBq - 1) / kBq, n_head, batch);
  encoder_attention_kernel<<<grid, kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), t_len, n_head, qs_b, qs_t, qs_h);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wjt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
