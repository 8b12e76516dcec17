// Qwen3 decode-step grouped-query column attention for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's Qwen path runs this step as
// plain einsums that XLA fuses (whisperjav_tpu/models/qwen/model.py,
// column mode), and no Pallas kernel lies on it. It was added because
// the same einsums in eager PyTorch turn each layer's (B, T_max,
// n_kv * hd) cache into a (B * n_kv, ...) batch for bmm; the cache's b
// and group strides do not merge, so every layer of every step copied
// the layer's whole cache, K and again V (8.8 GB a step at B=32,
// T_max=1201, f32), before the products read all T_max slots, the
// masked ones included.
//
//   q (B, n_kv * rep, hd), the step's queries after q_norm and rope, any
//     rep (query heads a KV group)
//   K, V (L, B, T_max, n_kv * hd), the layer chosen by a pointer offset;
//     positions [0, pos) are read in place, none at or after pos
//   k_new, v_new (B, n_kv * hd) rows at any row stride: the step's own
//     column, attended as position pos and written into K, V at pos
//   pos: one int32 in device memory, read when the kernel runs (so one
//     launch captured in a CUDA graph serves every step), clamped to
//     [0, T_max)
//   out (B, n_kv * rep, hd): softmax(q k^T hd^-0.5) v over the pos + 1
//     positions, query head h reading KV group h / rep
// f32 or bf16 (q, K, V, the column and out share one type); the scale,
// logits, softmax and sums in f32 either way, on CUDA-core FMAs.
//
// What bounds it on the H100: bytes. Each (row, group) reads pos keys and
// values of hd elements once, for 2 * rep FMAs an element: at f32 half
// an FMA a byte, where the card needs ~20 before the FMAs bound it. At
// B=32, 8 groups of 128, pos 913, f32: 239 MB a layer, 71 us at
// 3.35 TB/s.
//
// What the design does about it (flash-decoding, split over positions
// inside a thread block cluster, as Kernel B splits over T):
// - Grid: a block per (row, group, head chunk, rank); a cluster of R
//   ranks (at most 8) owns one (row, group, chunk) and splits [0, pos]
//   into R ranges. A chunk is the RB query heads of the group that a block
//   serves from one read of K and V: RB = 4 where 4 divides rep (Qwen3-4B
//   and 8B: rep 4, one chunk; 32B: rep 8, two), else 2 (the 0.6B and
//   1.7B: rep 2), else 1 (14B: rep 5, five chunks, each reading the
//   group's K and V). R is the most that keeps the whole grid resident at
//   once (B * n_kv * chunks * R within the card's resident blocks, from
//   the occupancy API) and no more than T_max's sweeps of a block's
//   warps: the rows share pos, so the blocks' work is equal and one wave
//   ends together (B=32, rep 2: R=2; B=1, the translator: R=8). Nothing
//   to set: it follows B, n_kv, rep and T_max, never pos, which the
//   launch does not know. Each rank reads pos and takes its share of
//   [0, pos], ceil((pos + 1) / R) keys; at small pos the last ranks'
//   shares are empty (B=1, the first steps): such a rank's max stays
//   -inf and its sum 0, and the merges weigh it 0.
// - Streaming: a warp takes whole keys; its lanes split the head
//   dimension in 16-byte pieces (hd 128: 32 lanes a key at f32, 16 at
//   bf16, so two keys a load). A lane issues the 16-byte loads of
//   kUnroll keys of K and of V before it uses any (8 KB a warp in flight
//   at f32, ~100 KB an SM), so no shared-memory ring is needed: each byte
//   is read once, by one lane, into registers, and serves every query
//   head of its chunk there.
// - Softmax: online in f32, a running max and sum per head, rescaled once
//   per kUnroll loads; the warps' partials combine in shared memory, the
//   ranks' over distributed shared memory in rank order (deterministic).
// - The new column joins the rank whose range holds pos, read from
//   k_new, v_new; that rank of chunk 0 also writes it into K, V at pos.
//
// Plain C interface, bound with ctypes; the kernel launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;     // 16-byte loads of K, and of V, in flight
constexpr int kMaxRanks = 8;   // the largest portable cluster
constexpr int kMaxDevices = 64;

enum Dtype { kF32 = 0, kBf16 = 1 };

using bf16 = __nv_bfloat16;

struct Args {
  const void* q;        // (B, n_kv * rep, hd)
  const void* k_new;    // (B, n_kv * hd) rows, k_new_stride apart
  const void* v_new;
  void* k;              // (B, T_max, n_kv * hd) of the layer
  void* v;
  void* out;            // (B, n_kv * rep, hd)
  const int* pos;       // one int32 on the device
  int64_t k_new_stride, v_new_stride;   // elements
  int n_kv, rep, chunks, t_max, ranks;
  float scale;
};

// 16 bytes of T as floats, and one float stored as T
template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;
  __device__ static void unpack(const uint4& w, float (&o)[4]) {
    o[0] = __uint_as_float(w.x);
    o[1] = __uint_as_float(w.y);
    o[2] = __uint_as_float(w.z);
    o[3] = __uint_as_float(w.w);
  }
  __device__ static void put(float* p, float x) { *p = x; }
};

template <>
struct Io<bf16> {
  static constexpr int kVec = 8;
  // a bf16 is the high half of its float; the first element is the low
  // half of a little-endian word
  __device__ static void unpack(const uint4& w, float (&o)[8]) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(u[i] << 16);
      o[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ static void put(bf16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// kVec elements at p, which need not be 16-byte aligned
__device__ __forceinline__ uint4 load_elems(const float* p) {
  return make_uint4(__float_as_uint(p[0]), __float_as_uint(p[1]),
                    __float_as_uint(p[2]), __float_as_uint(p[3]));
}
__device__ __forceinline__ uint4 load_elems(const bf16* p) {
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = h[2 * i] | (static_cast<uint32_t>(h[2 * i + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// The online softmax over U loads of keys (a load is KPL keys, one a
// group of TPK lanes; ok[u] says whether this lane's key of load u
// exists): the logits, one rescale of the running max m, sum l and
// unnormalised output acc of each head, then the weighted values. m is
// the same in every lane; l and acc hold this lane's group's keys.
template <typename T, int U, int TPK, int REP>
__device__ __forceinline__ void attend(
    const uint4 (&kr)[U], const uint4 (&vr)[U], const bool (&ok)[U],
    const float (&q)[REP][Io<T>::kVec], float (&m)[REP], float (&l)[REP],
    float (&acc)[REP][Io<T>::kVec]) {
  constexpr int VEC = Io<T>::kVec;
  float s[U][REP];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float kf[VEC];
    Io<T>::unpack(kr[u], kf);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) dot = fmaf(q[r][j], kf[j], dot);
#pragma unroll
      for (int off = TPK / 2; off >= 1; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      s[u][r] = ok[u] ? dot : -INFINITY;
    }
  }
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float cm = s[0][r];
#pragma unroll
    for (int u = 1; u < U; ++u) cm = fmaxf(cm, s[u][r]);
#pragma unroll
    for (int off = TPK; off < 32; off <<= 1)
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, off));
    // some key of the loads exists, so mn is finite; m starts at -inf
    const float mn = fmaxf(m[r], cm);
    const float alpha = expf(m[r] - mn);
    m[r] = mn;
    l[r] *= alpha;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[r][j] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u][r] = expf(s[u][r] - mn);
      l[r] += s[u][r];
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    float vf[VEC];
    Io<T>::unpack(vr[u], vf);
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[r][j] = fmaf(s[u][r], vf[j], acc[r][j]);
  }
}

// REP: the query heads a block serves (the chunk), of the group's a.rep
template <typename T, int HD, int REP>
__global__ void __launch_bounds__(kThreads, REP > 2 ? 2 : 4)
qwen_column_attention_kernel(Args a) {
  constexpr int VEC = Io<T>::kVec;
  constexpr int TPK = HD / VEC;        // lanes a key
  constexpr int KPL = 32 / TPK;        // keys a warp-wide load
  constexpr int KPS = kUnroll * KPL;   // keys a warp takes a sweep
  static_assert(HD % VEC == 0 && TPK <= 32 && 32 % TPK == 0,
                "a key must fill a power-of-two group of lanes");

  __shared__ float w_ml[2][kWarps][REP];         // each warp's max, sum
  __shared__ float w_acc[kWarps][REP][HD];       // and output
  __shared__ float r_ml[2][REP];                 // this rank's
  __shared__ float r_acc[REP][HD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane / TPK, d0 = (lane % TPK) * VEC;
  const int n_ranks = a.ranks;
  const int rank = (int)cluster_ctarank();   // == blockIdx.x % n_ranks
  const int unit = blockIdx.x / n_ranks;     // (b * n_kv + g) * chunks + c
  const int pair = unit / a.chunks, chunk = unit - pair * a.chunks;
  const int b = pair / a.n_kv, g = pair - b * a.n_kv;
  const int kvd = a.n_kv * HD, nh = a.n_kv * a.rep;
  const int h0 = g * a.rep + chunk * REP;   // the chunk's first head
  const int pos = min(max(__ldg(a.pos), 0), a.t_max - 1);
  const int rank_keys = (pos + n_ranks) / n_ranks;   // ceil((pos + 1) / R)
  const int t0 = rank * rank_keys;
  const int t1 = min(t0 + rank_keys, pos + 1);   // key pos: the column
  const int cached = min(t1, pos);                 // keys from the cache
  const bool has_new = t0 <= pos && pos < t1;

  const T* kc = static_cast<const T*>(a.k) + (int64_t)b * a.t_max * kvd
                + g * HD + d0;
  const T* vc = static_cast<const T*>(a.v) + (int64_t)b * a.t_max * kvd
                + g * HD + d0;
  const T* kn = static_cast<const T*>(a.k_new) + b * a.k_new_stride + g * HD;
  const T* vn = static_cast<const T*>(a.v_new) + b * a.v_new_stride + g * HD;

  if (has_new && chunk == 0) {   // the column into the cache; no block
                                 // reads slot pos
    const int64_t at = ((int64_t)b * a.t_max + pos) * kvd + g * HD;
    for (int i = tid; i < HD; i += kThreads) {
      static_cast<T*>(a.k)[at + i] = kn[i];
      static_cast<T*>(a.v)[at + i] = vn[i];
    }
  }

  float q[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    Io<T>::unpack(load16(static_cast<const T*>(a.q)
                         + ((int64_t)b * nh + h0 + r) * HD + d0),
                  q[r]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) q[r][j] *= a.scale;
  }
  float m[REP], l[REP], acc[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[r][j] = 0.f;
  }

  for (int base = t0 + warp * KPS; base < cached; base += kWarps * KPS) {
    uint4 kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * KPL + grp;
      ok[u] = t < cached;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (ok[u]) {
        kr[u] = load16(kc + (int64_t)t * kvd);
        vr[u] = load16(vc + (int64_t)t * kvd);
      }
    }
    attend<T, kUnroll, TPK, REP>(kr, vr, ok, q, m, l, acc);
  }
  if (has_new && warp == kWarps - 1) {   // the last warp sweeps least
    uint4 kr[1] = {make_uint4(0u, 0u, 0u, 0u)};
    uint4 vr[1] = {make_uint4(0u, 0u, 0u, 0u)};
    const bool ok[1] = {grp == 0};
    if (ok[0]) {
      kr[0] = load_elems(kn + d0);
      vr[0] = load_elems(vn + d0);
    }
    attend<T, 1, TPK, REP>(kr, vr, ok, q, m, l, acc);
  }

  // the warp's groups of lanes, summed (m is the warp's already)
#pragma unroll
  for (int r = 0; r < REP; ++r) {
#pragma unroll
    for (int off = TPK; off < 32; off <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], off);
    }
    if (grp == 0) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) w_acc[warp][r][d0 + j] = acc[r][j];
    }
    if (lane == 0) {
      w_ml[0][warp][r] = m[r];
      w_ml[1][warp][r] = l[r];
    }
  }
  __syncthreads();

  // the rank's partial: the warps in order (a warp that took no key
  // holds m = -inf, l = 0 and adds nothing)
  for (int e = tid; e < REP * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, w_ml[0][w][r]);
    float o = 0.f, sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = w_ml[0][w][r] == -INFINITY ? 0.f
                                                 : expf(w_ml[0][w][r] - mx);
      o = fmaf(w_acc[w][r][d], f, o);
      sum = fmaf(w_ml[1][w][r], f, sum);
    }
    r_acc[r][d] = o;
    if (d == 0) {
      r_ml[0][r] = mx;
      r_ml[1][r] = sum;
    }
  }
  cluster_arrive();
  cluster_wait();   // every rank's partial is complete

  // the ranks in order: rank c writes every n_ranks-th output element
  const uint32_t ml_local = smem_u32(&r_ml[0][0]);
  const uint32_t acc_local = smem_u32(&r_acc[0][0]);
  for (int e = rank * kThreads + tid; e < REP * HD;
       e += n_ranks * kThreads) {
    const int r = e / HD, d = e - r * HD;
    float mc[kMaxRanks];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < kMaxRanks; ++c) {
      mc[c] = c < n_ranks ? ld_cluster(map_rank(ml_local + 4 * r, c))
                          : -INFINITY;
      mx = fmaxf(mx, mc[c]);
    }
    float o = 0.f, sum = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxRanks; ++c) {
      if (c >= n_ranks) break;
      const float f = mc[c] == -INFINITY ? 0.f : expf(mc[c] - mx);
      sum = fmaf(ld_cluster(map_rank(ml_local + 4 * (REP + r), c)), f, sum);
      o = fmaf(ld_cluster(map_rank(acc_local + 4 * e, c)), f, o);
    }
    Io<T>::put(static_cast<T*>(a.out)
                   + ((int64_t)b * nh + h0 + r) * HD + d,
               o / sum);
  }
  cluster_arrive();
  cluster_wait();   // no rank leaves while another may read its memory
}

// blocks of `kernel` the current card holds at once, found once a card
template <typename Kernel>
int resident_blocks(Kernel kernel, std::atomic<int> (&known)[kMaxDevices],
                    int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  int n = known[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    n = per_sm * sms;
    known[dev].store(n, std::memory_order_relaxed);
  }
  *out = n;
  return 0;
}

template <typename T, int HD, int REP>
int launch(Args a, int batch, cudaStream_t stream) {
  auto kernel = qwen_column_attention_kernel<T, HD, REP>;
  constexpr int kSweep = kWarps * kUnroll * 32 / (HD / Io<T>::kVec);
  static std::atomic<int> known[kMaxDevices];
  int resident = 0;
  const int err0 = resident_blocks(kernel, known, &resident);
  if (err0) return err0;
  const int units = batch * a.n_kv * a.chunks;
  int ranks = resident / units;
  ranks = min(ranks, (a.t_max + kSweep - 1) / kSweep);
  ranks = max(1, min(ranks, kMaxRanks));
  a.ranks = ranks;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks * units);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ranks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T, int HD>
int launch_chunk(Args a, int batch, cudaStream_t stream) {
  const int rb = a.rep % 4 == 0 ? 4 : a.rep % 2 == 0 ? 2 : 1;
  a.chunks = a.rep / rb;
  if (rb == 4) return launch<T, HD, 4>(a, batch, stream);
  if (rb == 2) return launch<T, HD, 2>(a, batch, stream);
  return launch<T, HD, 1>(a, batch, stream);
}

template <typename T>
int launch_width(const Args& a, int batch, int head_dim,
                 cudaStream_t stream) {
  if (head_dim == 128) return launch_chunk<T, 128>(a, batch, stream);
  if (head_dim == 32) return launch_chunk<T, 32>(a, batch, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// k and v point at the whole (L, B, T_max, n_kv * hd) cache; `layer`
// selects one. `pos` points to the step's position, one int32 on the
// device. Writes the column at pos; attends over [0, pos] with the
// column as pos. dtype 0: f32, 1: bf16. Any rep; hd 128 or 32 only.
extern "C" int wjt_qwen_column_attention(
    const void* q, const void* k_new, const void* v_new, void* k, void* v,
    void* out, long long k_new_stride, long long v_new_stride, int dtype,
    int layer, int batch, int n_kv, int rep, int head_dim, int t_max,
    const void* pos, float scale, void* stream) {
  if (batch <= 0 || n_kv <= 0 || rep <= 0 || layer < 0 || t_max <= 0 ||
      pos == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t itemsize = dtype == kBf16 ? 2 : 4;
  const int64_t layer_off =
      (int64_t)layer * batch * t_max * n_kv * head_dim * itemsize;
  Args a = {q, k_new, v_new,
            static_cast<char*>(k) + layer_off,
            static_cast<char*>(v) + layer_off,
            out, static_cast<const int*>(pos), k_new_stride, v_new_stride,
            n_kv, rep, 1, t_max, 0, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_width<float>(a, batch, head_dim, s);
  if (dtype == kBf16) return launch_width<bf16>(a, batch, head_dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
