// K1: GroupNorm (+ optional SiLU) over NCHW activations, f32 or bf16 I/O,
// forward and backward (K1-bwd), for Hopper (sm_90a).
//
// Replaces: the JAX functions `models/common.py` `group_norm` /
// `group_norm_1d` and `models/ddpmpp.py` `_gn_silu`, and the gradient XLA
// derives for them (formerly the Pallas kernel `ops/groupnorm.py`
// `_gn_silu_kernel` and its `jax.custom_vjp`, deleted in 4b63bc3).
//
// Forward math (same as the reference): per (sample, group of C/G channels)
// the mean and the population variance over H*W*C/G elements in f32,
// two-pass (centred squares, never E[x^2] - E[x]^2), then
// xhat = (x - mean) * rstd with rstd = 1 / sqrt(var + eps), the per-channel
// affine z = xhat * w + b, optional SiLU z / (1 + exp(-z)), and one cast
// back. With `mean_out` / `rstd_out` set, the forward also writes each
// group's mean and rstd (f32) for the backward. Two optional serving
// epilogues, each step rounded to the I/O dtype where the separate torch
// ops round it:
//   pre_add [B, C]:      x <- round(x + pre_add[b, c]) before the statistics
//                        (DDPM++ `h + temb_proj(...)`, then the norm);
//   scale_shift [B, 2C]: z <- round(round(round(z) * round(1 + scale)) + shift),
//                        then the optional SiLU (the OpenAI FiLM epilogue).
//
// Backward math, per group, in f32 from the saved mean and rstd:
//   dz = dy * s * (1 + z * (1 - s)), s = sigmoid(z)   (with SiLU; else dy)
//   g  = dz * w
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat))
//   dw = sum over (B, HW) of dz * xhat;  db = sum over (B, HW) of dz
//
// Bound: device-memory bytes. Each element of x (and dy) must cross device
// memory once and each output once; the FLOPs are negligible. In NCHW a
// (sample, group) is one contiguous run of C/G * H*W elements.
//
// Design: one launch per call. A group is one thread block cluster of S
// blocks (S = 1, 2, 4, 8 or 16; 16 with the non-portable cluster size):
// block r holds slice r of the group in shared memory. Pass 1 brings the
// slice on chip once: by bulk copies (TMA, up to 8 chunks on their own
// mbarriers, so the sum starts on the first chunk while the rest are in
// flight) where several blocks share an SM, by 16-byte loads (4 f32 or 8
// bf16 each, several in flight per thread) where a 512-thread block has an
// SM to itself (the backward: there the loads interleave with its math).
// It sums the slice; the cluster adds its S partial sums through
// distributed shared memory in rank order (so every block, and every run,
// gets the same bits: no atomics); pass 2 sums the centred squares from
// shared memory and exchanges them the same way; pass 3 normalizes from
// shared memory and writes y with 16-byte stores. So x crosses device
// memory once and y once. A group's channels are contiguous runs of H*W
// elements: a vector's channel is its index shifted right (H*W/vec a power
// of two) or divided once per vector, and w, b and the epilogue's
// per-channel terms sit in a shared-memory table.
//
// The plan (host, per call): S grows until a slice fits 48 KB (four
// blocks per SM) or 16 blocks, and, while the card has fewer than 528
// blocks (four per SM), as long as slices stay at 16 KB or more; a group
// under 32 KB is one block, no cluster (a cluster exchange costs about as
// much as such a group's whole pass). Blocks are 256 threads, or 512
// where a block's slice passes 64 KB.
//
// Capacity: a block holds at most kMaxSliceBytes (200 KB of the 227 KB);
// a cluster of 16 about 3.2 MB. The largest group on the UNets' paths, the
// decoder's 256-channel concat at 256^2, is 8 x 65,536 elements: 2 MiB in
// f32, so 16 blocks of 128 KB, one per SM. A larger group (off the paths)
// keeps what fits and streams the rest of its slice from device memory in
// each pass (read three times: the sum, the centred squares, the
// normalize). The backward holds x first and then as much of dy as fits:
// the 2 MiB f32 group (4 MiB of x and dy) re-reads the last 56 KB of each
// block's dy in its dx pass.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

// threads per block: 512 where a block holds a large slice (at most two
// blocks per SM), 256 where several blocks share an SM
constexpr int kBigSliceBytes = 64 * 1024;
constexpr int kUnroll = 4;      // forward: streamed vectors in flight per thread
constexpr int kUnrollBwd = 2;   // backward: streamed x and dy vectors in flight per thread
constexpr int kMaxCluster = 16;
constexpr int kMaxChunks = 8;   // bulk copies (and mbarriers) per block
// the plan (host): a block's slice of the group
constexpr int64_t kSoftSliceBytes = 48 * 1024;   // four blocks share an SM below this
constexpr int64_t kMaxSliceBytes = 200 * 1024;   // resident at most; the rest streams
constexpr int64_t kMinSliceBytes = 16 * 1024;    // no smaller slices to fill the card
constexpr int64_t kTargetBlocks = 528;           // four blocks per SM on 132 SMs
constexpr int64_t kChunkBytes = 16 * 1024;       // a bulk copy, at the least
constexpr int kMaxSmem = 227 * 1024;

// ---------------------------------------------------------------------------
// element types and 16-byte vectors
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// the value rounded to T, back in f32
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// VEC elements of T: one 16-byte uint4, or one T when VEC == 1
template <typename T, int VEC>
using Raw = typename std::conditional<VEC == 1, T, uint4>::type;

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> ld_vec(const T* __restrict__ p, int j) {
  if constexpr (VEC == 1) {
    return p[j];
  } else {
    return __ldg(reinterpret_cast<const uint4*>(p) + j);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void st_vec(T* __restrict__ p, int j, Raw<T, VEC> r) {
  if constexpr (VEC == 1) {
    p[j] = r;
  } else {
    reinterpret_cast<uint4*>(p)[j] = r;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack(Raw<T, VEC> r, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = to_f(r);
  } else if constexpr (std::is_same<T, float>::value) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  } else {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> pack(const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    return from_f<T>(f[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1])) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ---------------------------------------------------------------------------
// reductions: fixed order everywhere, so every block of a cluster and every
// run gets the same bits
// ---------------------------------------------------------------------------

// butterfly: every lane ends with the same sum
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block (NW warps) of two values; every thread gets the results.
template <int NW>
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();  // `red` may still be read from a previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = make_float2(a, b);
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    s.x += red[i].x;
    s.y += red[i].y;
  }
  return s;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The cluster's sum of each block's `mine` (two floats in shared memory,
// written before the cluster barrier this follows), in rank order; every
// thread of every block gets the same bits. `out` is a shared float2.
__device__ __forceinline__ float2 cluster_sum2(const float2* mine, int nblocks, float2* out) {
  if (threadIdx.x < 32) {
    float2 v = make_float2(0.f, 0.f);
    if ((int)threadIdx.x < nblocks) v = *cg::this_cluster().map_shared_rank(mine, threadIdx.x);
    v.x = warp_sum(v.x);
    v.y = warp_sum(v.y);
    if (threadIdx.x == 0) *out = v;
  }
  __syncthreads();
  return *out;
}

// the vector's channel within its group
__device__ __forceinline__ int chan(int j, int hwv, int hwv_shift) {
  return hwv_shift >= 0 ? (j >> hwv_shift) : (int)((unsigned)j / (unsigned)hwv);
}

// The upstream gradient of the affine output z: dy, times SiLU's derivative.
__device__ __forceinline__ float dz_of(float dy, float xhat, float w, float b, int silu) {
  if (!silu) return dy;
  const float z = xhat * w + b;
  const float s = 1.0f / (1.0f + expf(-z));
  return dy * s * (1.0f + z * (1.0f - s));
}

// ---------------------------------------------------------------------------
// the slice's resident part arrives by bulk copies (TMA), in chunks that
// each complete on their own mbarrier, so pass 1 starts on the first chunk
// while the rest are in flight; threads spend no registers on the copy
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// `bytes` (a multiple of 16) from device memory into shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Thread 0: start the copies of `n` resident vectors of each array into
// shared memory, chunk k (vectors [k * chunk_v, (k + 1) * chunk_v)) on
// bars[k]; array 1 holds only its first n1 <= n vectors. Every chunk with
// bytes gets its mbarrier initialized and armed.
template <typename R>
__device__ __forceinline__ void start_copies(uint64_t* bars, int nchunks, int chunk_v, int n,
                                             R* dst0, const R* src0, int n1, R* dst1,
                                             const R* src1) {
  for (int k = 0; k < nchunks; ++k) mbar_init(bars + k, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  for (int k = 0; k < nchunks; ++k) {
    const int a = k * chunk_v, e = min(a + chunk_v, n);
    if (e <= a) break;
    const int e1 = min(e, n1);
    const uint32_t b0 = (uint32_t)(e - a) * sizeof(R);
    const uint32_t b1 = e1 > a ? (uint32_t)(e1 - a) * sizeof(R) : 0u;
    mbar_expect_tx(bars + k, b0 + b1);
    bulk_load(dst0 + a, src0 + a, b0, bars + k);
    if (b1) bulk_load(dst1 + a, src1 + a, b1, bars + k);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdParams {
  const void* x;
  void* y;
  const float* w;
  const float* b;
  const void* pre_add;      // [B, C] in the I/O dtype, or null
  const void* scale_shift;  // [B, 2C] in the I/O dtype, or null
  float* mean_out;          // [B * G], or null
  float* rstd_out;
  int channels, groups, cpg, cluster;
  int hwv, hwv_shift;  // vectors per channel, and its log2 (or -1)
  int group_v;         // vectors per group
  int slice_v;         // vectors per block
  int res_v;           // of a slice, held in shared memory
  int nchunks, chunk_v;
  float eps;
  int silu;
};

template <typename T, int VEC, int NT>
__global__ void __launch_bounds__(NT, 1024 / NT) gn_fwd(const FwdParams p) {
  using R = Raw<T, VEC>;
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 red[NW];
  __shared__ float2 part[2], total;  // this block's partials of the two exchanges
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  R* xs = reinterpret_cast<R*>(smem);
  float* tab = reinterpret_cast<float*>(smem + (((int64_t)p.res_v * sizeof(R) + 15) / 16) * 16);
  const int cpg = p.cpg;
  float *tw = tab, *tb = tab + cpg, *tpa = tab + 2 * cpg, *ts1 = tab + 3 * cpg,
        *tsh = tab + 4 * cpg;

  const int rank = blockIdx.x;
  const int bg = blockIdx.y;
  const int bi = bg / p.groups, c0 = (bg % p.groups) * cpg;
  const int lo = rank * p.slice_v;
  const int n_s = max(min(p.slice_v, p.group_v - lo), 0);  // this block's vectors
  const int res_v = min(p.res_v, n_s), hwv = p.hwv, hwv_shift = p.hwv_shift;
  const int tma_v = VEC > 1 ? res_v : 0;  // resident vectors that arrive by bulk copy
  const int64_t base = (int64_t)bg * p.group_v * VEC;
  const R* xg = reinterpret_cast<const R*>(static_cast<const T*>(p.x) + base) + lo;
  R* yg = reinterpret_cast<R*>(static_cast<T*>(p.y) + base) + lo;
  if (threadIdx.x == 0 && tma_v > 0)
    start_copies<R>(bars, p.nchunks, p.chunk_v, tma_v, xs, xg, 0, nullptr, nullptr);

  for (int i = threadIdx.x; i < cpg; i += NT) {
    tw[i] = p.w[c0 + i];
    tb[i] = p.b[c0 + i];
    if (p.pre_add) tpa[i] = to_f(static_cast<const T*>(p.pre_add)[(int64_t)bi * p.channels + c0 + i]);
    if (p.scale_shift) {
      const T* ss = static_cast<const T*>(p.scale_shift) + (int64_t)bi * 2 * p.channels;
      ts1[i] = round_to<T>(1.0f + to_f(ss[c0 + i]));
      tsh[i] = to_f(ss[p.channels + c0 + i]);
    }
  }
  __syncthreads();
  const bool pre = p.pre_add != nullptr;
  // the pre-add, rounded to T as `x + pre_add` rounds; v: the slice's vector
  auto add_pre = [=](int v, float (&f)[VEC]) {
    const float a = tpa[chan(lo + v, hwv, hwv_shift)];
#pragma unroll
    for (int k = 0; k < VEC; ++k) f[k] = round_to<T>(f[k] + a);
  };
  // vector v, from shared memory if resident, else from device memory
  auto fetch = [=](int v, float (&f)[VEC]) {
    if (v < res_v) {
      unpack<T, VEC>(xs[v], f);
    } else {
      unpack<T, VEC>(ld_vec<T, VEC>(reinterpret_cast<const T*>(xg), v), f);
      if (pre) add_pre(v, f);
    }
  };

  // pass 1: the sum, chunk by chunk as the copies land (with the pre-add,
  // written back), then the rest of the slice from device memory
  float sum = 0.f;
  for (int k = 0; k < p.nchunks; ++k) {
    const int a = k * p.chunk_v, e = min(a + p.chunk_v, tma_v);
    if (e <= a) break;
    mbar_wait(bars + k, 0);
    for (int v = a + threadIdx.x; v < e; v += NT) {
      float f[VEC];
      unpack<T, VEC>(xs[v], f);
      if (pre) {
        add_pre(v, f);
        xs[v] = pack<T, VEC>(f);
      }
#pragma unroll
      for (int k2 = 0; k2 < VEC; ++k2) sum += f[k2];
    }
  }
  for (int v0 = tma_v + threadIdx.x; v0 < n_s; v0 += NT * kUnroll) {
    R r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * NT;
      if (v < n_s) r[u] = ld_vec<T, VEC>(reinterpret_cast<const T*>(xg), v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * NT;
      if (v < n_s) {
        float f[VEC];
        unpack<T, VEC>(r[u], f);
        if (pre) {
          add_pre(v, f);
          r[u] = pack<T, VEC>(f);
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) sum += f[k];
        if (v < res_v) xs[v] = r[u];
      }
    }
  }
  const float n = (float)p.group_v * (float)VEC;
  float2 s = block_sum2<NW>(sum, 0.f, red);
  if (p.cluster > 1) {
    if (threadIdx.x == 0) part[0] = s;
    cluster_arrive();
    cluster_wait();
    s = cluster_sum2(&part[0], p.cluster, &total);
  }
  const float mean = s.x / n;

  // pass 2: the centred squares, from shared memory
  float m2 = 0.f;
  for (int v = threadIdx.x; v < n_s; v += NT) {
    float f[VEC];
    fetch(v, f);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float d = f[k] - mean;
      m2 += d * d;
    }
  }
  s = block_sum2<NW>(m2, 0.f, red);
  if (p.cluster > 1) {
    // a second slot: a peer may still be reading this block's first one
    if (threadIdx.x == 0) part[1] = s;
    cluster_arrive();
    cluster_wait();
    s = cluster_sum2(&part[1], p.cluster, &total);
    cluster_arrive();  // this block's reads of the others are done; wait before leaving
  }
  const float rstd = 1.0f / sqrtf(s.x / n + p.eps);
  if (rank == 0 && threadIdx.x == 0 && p.mean_out != nullptr) {
    p.mean_out[bg] = mean;
    p.rstd_out[bg] = rstd;
  }

  // pass 3: normalize, the affine and the epilogue, from shared memory
  const bool film = p.scale_shift != nullptr;
  const int silu = p.silu;
  for (int v = threadIdx.x; v < n_s; v += NT) {
    float f[VEC];
    fetch(v, f);
    const int c = chan(lo + v, hwv, hwv_shift);
    const float w = tw[c], b = tb[c];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float z = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[k], mean), rstd), w), b);
      if (film) {
        z = round_to<T>(__fmul_rn(round_to<T>(z), ts1[c]));
        z = round_to<T>(__fadd_rn(z, tsh[c]));
      }
      if (silu) z = z / (1.0f + expf(-z));
      f[k] = z;
    }
    st_vec<T, VEC>(reinterpret_cast<T*>(yg), v, pack<T, VEC>(f));
  }
  if (p.cluster > 1) cluster_wait();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdParams {
  const void* x;
  const void* dy;
  void* dx;
  const float* w;
  const float* b;
  const float* mean;  // [B * G]
  const float* rstd;
  float* wsum;        // [B, 2, C]: per-sample sums of dz * xhat and dz, or null
  int channels, groups, cpg, cluster;
  int hwv, hwv_shift, group_v, slice_v;
  int res_x, res_dy;  // of a slice, held in shared memory (res_dy <= res_x)
  int nchunks, chunk_v;
  int silu;
};

template <typename T, int VEC, int NT>
__global__ void __launch_bounds__(NT, 1024 / NT) gn_bwd(const BwdParams p) {
  using R = Raw<T, VEC>;
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 red[NW];
  __shared__ float2 part, total;
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  R* xs = reinterpret_cast<R*>(smem);
  R* dys = xs + p.res_x;
  float* tab = reinterpret_cast<float*>(
      smem + (((int64_t)(p.res_x + p.res_dy) * sizeof(R) + 15) / 16) * 16);
  const int cpg = p.cpg;
  float *tw = tab, *tb = tab + cpg;
  float2* wpart = reinterpret_cast<float2*>(tab + 2 * cpg);  // [cpg]

  const int rank = blockIdx.x;
  const int bg = blockIdx.y;
  const int bi = bg / p.groups, c0 = (bg % p.groups) * cpg;
  const int lo = rank * p.slice_v;
  const int n_s = max(min(p.slice_v, p.group_v - lo), 0);
  const int res_x = min(p.res_x, n_s), res_dy = min(p.res_dy, n_s);
  const int hwv = p.hwv, hwv_shift = p.hwv_shift, silu = p.silu;
  // bulk copies where several blocks share an SM; a block alone on its SM
  // (512 threads) keeps its loads in flight itself, interleaved with the math
  const int tma_v = (VEC > 1 && NT == 256) ? res_x : 0;
  const int64_t base = (int64_t)bg * p.group_v * VEC;
  const R* xg = reinterpret_cast<const R*>(static_cast<const T*>(p.x) + base) + lo;
  const R* dyg = reinterpret_cast<const R*>(static_cast<const T*>(p.dy) + base) + lo;
  R* dxg = reinterpret_cast<R*>(static_cast<T*>(p.dx) + base) + lo;
  if (threadIdx.x == 0 && tma_v > 0)
    start_copies<R>(bars, p.nchunks, p.chunk_v, tma_v, xs, xg, res_dy, dys, dyg);

  for (int i = threadIdx.x; i < cpg; i += NT) {
    tw[i] = p.w[c0 + i];
    tb[i] = p.b[c0 + i];
    if (p.wsum != nullptr) wpart[i] = make_float2(0.f, 0.f);
  }
  __syncthreads();
  const float m = p.mean[bg], r = p.rstd[bg];
  const T* xgt = reinterpret_cast<const T*>(xg);
  const T* dygt = reinterpret_cast<const T*>(dyg);

  // vector v of x and of dy, each from shared memory if resident
  auto fetch = [=](int v, float (&fx)[VEC], float (&fd)[VEC]) {
    unpack<T, VEC>(v < res_x ? xs[v] : ld_vec<T, VEC>(xgt, v), fx);
    unpack<T, VEC>(v < res_dy ? dys[v] : ld_vec<T, VEC>(dygt, v), fd);
  };
  // the sums of g and g * xhat over one vector
  auto accumulate = [=](int v, const float (&fx)[VEC], const float (&fd)[VEC], float& sg,
                        float& sgx) {
    const int c = chan(lo + v, hwv, hwv_shift);
    const float w = tw[c], b = tb[c];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float xh = (fx[k] - m) * r;
      const float g = dz_of(fd[k], xh, w, b, silu) * w;
      sg += g;
      sgx += g * xh;
    }
  };

  // pass 1: the sums of g and g * xhat, chunk by chunk as the copies land
  // (dy past its resident part from device memory), then the rest of the
  // slice from device memory
  float sg = 0.f, sgx = 0.f;
  for (int k = 0; k < p.nchunks; ++k) {
    const int a = k * p.chunk_v, e = min(a + p.chunk_v, tma_v);
    if (e <= a) break;
    mbar_wait(bars + k, 0);
    for (int v0 = a + threadIdx.x; v0 < e; v0 += NT * kUnrollBwd) {
      R rd[kUnrollBwd];
#pragma unroll
      for (int u = 0; u < kUnrollBwd; ++u) {
        const int v = v0 + u * NT;
        if (v < e) rd[u] = v < res_dy ? dys[v] : ld_vec<T, VEC>(dygt, v);
      }
#pragma unroll
      for (int u = 0; u < kUnrollBwd; ++u) {
        const int v = v0 + u * NT;
        if (v < e) {
          float fx[VEC], fd[VEC];
          unpack<T, VEC>(xs[v], fx);
          unpack<T, VEC>(rd[u], fd);
          accumulate(v, fx, fd, sg, sgx);
        }
      }
    }
  }
  for (int v0 = tma_v + threadIdx.x; v0 < n_s; v0 += NT * kUnrollBwd) {
    R rx[kUnrollBwd], rd[kUnrollBwd];
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      const int v = v0 + u * NT;
      if (v < n_s) {
        rx[u] = ld_vec<T, VEC>(xgt, v);
        rd[u] = ld_vec<T, VEC>(dygt, v);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      const int v = v0 + u * NT;
      if (v < n_s) {
        if (v < res_x) xs[v] = rx[u];
        if (v < res_dy) dys[v] = rd[u];
        float fx[VEC], fd[VEC];
        unpack<T, VEC>(rx[u], fx);
        unpack<T, VEC>(rd[u], fd);
        accumulate(v, fx, fd, sg, sgx);
      }
    }
  }
  float2 s = block_sum2<NW>(sg, sgx, red);

  // dw, db: each warp takes whole channels of the slice (a channel's
  // vectors strided over its lanes), in a fixed order
  if (p.wsum != nullptr) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int cl_lo = n_s > 0 ? chan(lo, hwv, hwv_shift) : 0;
    const int cl_hi = n_s > 0 ? chan(lo + n_s - 1, hwv, hwv_shift) : -1;
    for (int cl = cl_lo + warp; cl <= cl_hi; cl += NW) {
      const int a = max(0, cl * hwv - lo), e = min(n_s, (cl + 1) * hwv - lo);
      const float w = tw[cl], b = tb[cl];
      float sw = 0.f, sb = 0.f;
      for (int v = a + lane; v < e; v += 32) {
        float fx[VEC], fd[VEC];
        fetch(v, fx, fd);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xh = (fx[k] - m) * r;
          const float dz = dz_of(fd[k], xh, w, b, silu);
          sw += dz * xh;
          sb += dz;
        }
      }
      sw = warp_sum(sw);
      sb = warp_sum(sb);
      if (lane == 0) wpart[cl] = make_float2(sw, sb);
    }
  }

  if (p.cluster > 1) {
    if (threadIdx.x == 0) part = s;
    cluster_arrive();  // publishes `part` and `wpart`
    cluster_wait();
    s = cluster_sum2(&part, p.cluster, &total);
  } else {
    __syncthreads();  // `wpart` is complete
  }
  if (p.wsum != nullptr && rank == 0) {
    float* out = p.wsum + (int64_t)bi * 2 * p.channels + c0;
    for (int cl = threadIdx.x; cl < cpg; cl += NT) {
      float2 t = wpart[cl];
      for (int q = 1; q < p.cluster; ++q) {
        const float2 v = *cg::this_cluster().map_shared_rank(wpart + cl, q);
        t.x += v.x;
        t.y += v.y;
      }
      out[cl] = t.x;
      out[p.channels + cl] = t.y;
    }
  }
  if (p.cluster > 1) cluster_arrive();  // this block's reads of the others are done

  // pass 2: dx, from shared memory
  const float n = (float)p.group_v * (float)VEC;
  const float mg = s.x / n, mgx = s.y / n;
  for (int v = threadIdx.x; v < n_s; v += NT) {
    float fx[VEC], fd[VEC];
    fetch(v, fx, fd);
    const int c = chan(lo + v, hwv, hwv_shift);
    const float w = tw[c], b = tb[c];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float xh = (fx[k] - m) * r;
      const float g = dz_of(fd[k], xh, w, b, silu) * w;
      fx[k] = r * (g - mg - xh * mgx);
    }
    st_vec<T, VEC>(reinterpret_cast<T*>(dxg), v, pack<T, VEC>(fx));
  }
  if (p.cluster > 1) cluster_wait();  // no block leaves while another reads it
}

// ---------------------------------------------------------------------------
// the plan and the launch (host)
// ---------------------------------------------------------------------------

struct Plan {
  int vec, cluster, hwv, hwv_shift, group_v, slice_v, res0, res1, nchunks, chunk_v, threads;
  int64_t smem;
};

// `arrays`: 1 for the forward (x), 2 for the backward (x, dy);
// `aligned`: every tensor the kernel reads by vectors starts on 16 bytes.
bool make_plan(int batch, int channels, int64_t hw, int groups, int es, int arrays, bool wgrad,
               bool aligned, Plan* pl) {
  if (batch < 1 || groups < 1 || channels % groups != 0 || hw < 1) return false;
  if ((int64_t)batch * groups > 65535) return false;
  const int cpg = channels / groups;
  const int vmax = 16 / es;
  pl->vec = (aligned && hw % vmax == 0) ? vmax : 1;
  const int64_t group_len = (int64_t)cpg * hw;
  if (group_len / pl->vec >= (int64_t)1 << 30) return false;
  pl->hwv = (int)(hw / pl->vec);
  pl->hwv_shift = -1;
  if ((pl->hwv & (pl->hwv - 1)) == 0) {
    pl->hwv_shift = 0;
    while ((1 << pl->hwv_shift) < pl->hwv) ++pl->hwv_shift;
  }
  pl->group_v = (int)(group_len / pl->vec);
  const int64_t vbytes = (int64_t)pl->vec * es;  // bytes of one vector of one array
  const int64_t gbytes = group_len * es * arrays;
  int s = 1;
  while (s < kMaxCluster &&
         (gbytes > s * kSoftSliceBytes ||
          ((int64_t)batch * groups * s < kTargetBlocks && gbytes >= 2 * s * kMinSliceBytes)))
    s *= 2;
  // no empty slice
  while (s > 1 && (int64_t)(s - 1) * ((pl->group_v + s - 1) / s) >= pl->group_v) s /= 2;
  pl->cluster = s;
  pl->slice_v = (pl->group_v + s - 1) / s;
  const int64_t table = (int64_t)cpg * 4 * (arrays == 1 ? 5 : 2) + (wgrad ? (int64_t)cpg * 8 : 0);
  const int64_t room = (int64_t)kMaxSmem - 1024 - table;
  if (room < 16) return false;
  int64_t cap_v = (room < kMaxSliceBytes ? room : kMaxSliceBytes) / vbytes;
  pl->res0 = (int)(pl->slice_v < cap_v ? pl->slice_v : cap_v);
  cap_v -= pl->res0;
  pl->res1 = arrays == 2 ? (int)(pl->slice_v < cap_v ? pl->slice_v : cap_v) : 0;
  pl->smem = (((int64_t)(pl->res0 + pl->res1) * vbytes + 15) / 16) * 16 + table;
  pl->threads = (int64_t)(pl->res0 + pl->res1) * vbytes > kBigSliceBytes ? 512 : 256;
  int64_t nch = ((int64_t)(pl->res0 + pl->res1) * vbytes + kChunkBytes - 1) / kChunkBytes;
  pl->nchunks = (int)(nch < 1 ? 1 : nch > kMaxChunks ? kMaxChunks : nch);
  pl->chunk_v = pl->res0 > 0 ? (pl->res0 + pl->nchunks - 1) / pl->nchunks : 1;
  return true;
}

bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; }

template <typename K>
cudaError_t configure(K kernel) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem - 1024);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename K, typename P>
int launch_planned(K kernel, const P& params, const Plan& pl, int nbg, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.cluster, nbg);
  cfg.blockDim = dim3(pl.threads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, params);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int VEC, int NT>
int launch_fwd(const FwdParams& prm, const Plan& pl, int nbg, cudaStream_t stream) {
  static const cudaError_t ready = configure(gn_fwd<T, VEC, NT>);  // once per entry
  if (ready != cudaSuccess) return (int)ready;
  return launch_planned(gn_fwd<T, VEC, NT>, prm, pl, nbg, stream);
}

template <typename T, int VEC, int NT>
int launch_bwd(const BwdParams& prm, const Plan& pl, int nbg, cudaStream_t stream) {
  static const cudaError_t ready = configure(gn_bwd<T, VEC, NT>);
  if (ready != cudaSuccess) return (int)ready;
  return launch_planned(gn_bwd<T, VEC, NT>, prm, pl, nbg, stream);
}

// the entry for the plan's dtype, vector width and block size
template <bool BWD, typename P>
int dispatch(const P& prm, const Plan& pl, int dtype, int nbg, cudaStream_t s) {
  using B = __nv_bfloat16;
  const int key = dtype * 4 + (pl.vec == 1 ? 0 : 2) + (pl.threads == 512 ? 1 : 0);
  if constexpr (BWD) {
    switch (key) {
      case 0: return launch_bwd<float, 1, 256>(prm, pl, nbg, s);
      case 1: return launch_bwd<float, 1, 512>(prm, pl, nbg, s);
      case 2: return launch_bwd<float, 4, 256>(prm, pl, nbg, s);
      case 3: return launch_bwd<float, 4, 512>(prm, pl, nbg, s);
      case 4: return launch_bwd<B, 1, 256>(prm, pl, nbg, s);
      case 5: return launch_bwd<B, 1, 512>(prm, pl, nbg, s);
      case 6: return launch_bwd<B, 8, 256>(prm, pl, nbg, s);
      default: return launch_bwd<B, 8, 512>(prm, pl, nbg, s);
    }
  } else {
    switch (key) {
      case 0: return launch_fwd<float, 1, 256>(prm, pl, nbg, s);
      case 1: return launch_fwd<float, 1, 512>(prm, pl, nbg, s);
      case 2: return launch_fwd<float, 4, 256>(prm, pl, nbg, s);
      case 3: return launch_fwd<float, 4, 512>(prm, pl, nbg, s);
      case 4: return launch_fwd<B, 1, 256>(prm, pl, nbg, s);
      case 5: return launch_fwd<B, 1, 512>(prm, pl, nbg, s);
      case 6: return launch_fwd<B, 8, 256>(prm, pl, nbg, s);
      default: return launch_fwd<B, 8, 512>(prm, pl, nbg, s);
    }
  }
}

// ---------------------------------------------------------------------------
// across ranks: each rank of a spatial group holds a block of rows of every
// (sample, group). The statistics of the whole group come in three steps:
// gn_part gives each part of the local run its count, mean and centred sum
// of squares (two passes in f32, as the one-rank kernel); the caller
// gathers the parts of every rank and combines them by Chan's formula
// (mean = sum n_i m_i / N, M2 = sum M2_i + sum n_i (m_i - mean)^2: the
// centred squares throughout, never E[x^2] - E[x]^2); gn_apply then
// normalizes the local rows from the combined mean and rstd with the
// affine, the FiLM epilogue and SiLU, as pass 3 of gn_fwd. The pre-add is
// applied (and rounded to T) in both kernels.
//
// Bound: device-memory bytes. gn_part reads x twice (the second pass
// mostly from the L2), gn_apply reads x once and writes y once; the
// statistics are a few floats per group. The design is the simple one:
// parts of 8192 elements per block so that a batch-1 call still fills the
// card, and a grid-stride elementwise pass.
// ---------------------------------------------------------------------------

constexpr int kPartThreads = 256;
constexpr int kApplyThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kPartThreads) gn_part(const T* __restrict__ x,
                                                        const T* __restrict__ pre_add,
                                                        float* __restrict__ parts, int channels,
                                                        int groups, int64_t hw,
                                                        int64_t part_len) {
  constexpr int NW = kPartThreads / 32;
  __shared__ float2 red[NW];
  const int p = blockIdx.x, nparts = gridDim.x, bg = blockIdx.y;
  const int cpg = channels / groups;
  const int bi = bg / groups, c0 = (bg % groups) * cpg;
  const int64_t glen = (int64_t)cpg * hw;
  const int64_t lo = (int64_t)p * part_len;
  const int64_t hi = lo + part_len < glen ? lo + part_len : glen;
  const T* xg = x + (int64_t)bg * glen;
  const T* pa = pre_add != nullptr ? pre_add + (int64_t)bi * channels + c0 : nullptr;
  auto val = [&](int64_t e) {
    float f = to_f(xg[e]);
    if (pa != nullptr) f = round_to<T>(f + to_f(pa[e / hw]));
    return f;
  };
  float s = 0.f;
  for (int64_t e = lo + threadIdx.x; e < hi; e += kPartThreads) s += val(e);
  const float n = hi > lo ? (float)(hi - lo) : 0.f;
  const float2 tot = block_sum2<NW>(s, 0.f, red);
  const float mean = n > 0.f ? tot.x / n : 0.f;
  float m2 = 0.f;
  for (int64_t e = lo + threadIdx.x; e < hi; e += kPartThreads) {
    const float d = val(e) - mean;
    m2 += d * d;
  }
  const float2 t2 = block_sum2<NW>(m2, 0.f, red);
  if (threadIdx.x == 0) {
    float* o = parts + ((int64_t)bg * nparts + p) * 3;
    o[0] = n;
    o[1] = mean;
    o[2] = t2.x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kApplyThreads) gn_apply(
    const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
    const T* __restrict__ pre_add, const T* __restrict__ scale_shift,
    const float* __restrict__ mean, const float* __restrict__ rstd, T* __restrict__ y,
    int channels, int groups, int64_t hw, int64_t total, int silu) {
  const int cpg = channels / groups;
  for (int64_t i = blockIdx.x * (int64_t)kApplyThreads + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * kApplyThreads) {
    const int64_t bc = i / hw;
    const int c = (int)(bc % channels);
    const int64_t bi = bc / channels;
    const int64_t bg = bi * groups + c / cpg;
    float f = to_f(x[i]);
    if (pre_add != nullptr) f = round_to<T>(f + to_f(pre_add[bi * channels + c]));
    float z = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f, mean[bg]), rstd[bg]), w[c]), b[c]);
    if (scale_shift != nullptr) {
      const T* ss = scale_shift + bi * 2 * channels;
      z = round_to<T>(__fmul_rn(round_to<T>(z), round_to<T>(1.0f + to_f(ss[c]))));
      z = round_to<T>(__fadd_rn(z, to_f(ss[channels + c])));
    }
    if (silu) z = z / (1.0f + expf(-z));
    y[i] = from_f<T>(z);
  }
}

// ---------------------------------------------------------------------------
// the backward across ranks: the forward's mean and rstd are the combined
// ones, so dx = rstd * (g - mean(g) - xhat * mean(g * xhat)), g = dz * w,
// needs only each (sample, group)'s two sums over the whole image. gn_bwd_part
// gives this rank's: one block per (sample, channel) sums dz and dz * xhat
// over the channel's local H*W (fixed order: strided per thread, then the
// block's tree), writes them to wsum [B, 2, C] (this rank's partials of dw
// and db), and the last block of a group to finish (a counter per group,
// left at zero again) forms the group's sums of w * those, channel by
// channel in order. The caller all-reduces the sums over the ranks and
// divides by the group's count; gn_bwd_apply then forms dx elementwise.
//
// Bound: device-memory bytes. gn_bwd_part reads x and dy once; gn_bwd_apply
// reads them again and writes dx. The design is the simple one: a block
// per channel (16-byte loads where the channel's run is whole vectors), and
// a grid-stride elementwise pass.
// ---------------------------------------------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(kPartThreads) gn_bwd_part(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ mean, const float* __restrict__ rstd,
    float* __restrict__ sums, float* wsum, int* done, int channels, int groups, int64_t hw,
    int silu) {
  constexpr int NW = kPartThreads / 32;
  __shared__ float2 red[NW];
  const int64_t bc = blockIdx.x;
  const int c = (int)(bc % channels);
  const int64_t bi = bc / channels;
  const int cpg = channels / groups;
  const int64_t bg = bi * groups + c / cpg;
  const float m = mean[bg], r = rstd[bg], wc = w[c], bc_ = b[c];
  const T* xc = x + bc * hw;
  const T* dc = dy + bc * hw;
  float sdz = 0.f, sdzx = 0.f;
  auto add = [&](float xv, float dv) {
    const float xhat = (xv - m) * r;
    const float dz = dz_of(dv, xhat, wc, bc_, silu);
    sdz += dz;
    sdzx += dz * xhat;
  };
  const int nv = (int)(hw / VEC);
#pragma unroll 4
  for (int j = threadIdx.x; j < nv; j += kPartThreads) {
    float fx[VEC], fd[VEC];
    unpack<T, VEC>(ld_vec<T, VEC>(xc, j), fx);
    unpack<T, VEC>(ld_vec<T, VEC>(dc, j), fd);
#pragma unroll
    for (int e = 0; e < VEC; ++e) add(fx[e], fd[e]);
  }
  const float2 t = block_sum2<NW>(sdzx, sdz, red);
  if (threadIdx.x == 0) {
    wsum[(bi * 2) * channels + c] = t.x;
    wsum[(bi * 2 + 1) * channels + c] = t.y;
    __threadfence();  // this channel's sums, visible before the count says so
    if (atomicAdd(done + bg, 1) == cpg - 1) {  // the group's last channel
      __threadfence();
      const int c0 = c / cpg * cpg;
      float sg = 0.f, sgx = 0.f;
      for (int k = 0; k < cpg; ++k) {
        const float wk = w[c0 + k];
        sg += wk * __ldcg(wsum + (bi * 2 + 1) * channels + c0 + k);
        sgx += wk * __ldcg(wsum + (bi * 2) * channels + c0 + k);
      }
      sums[bg * 2] = sg;
      sums[bg * 2 + 1] = sgx;
      done[bg] = 0;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kApplyThreads) gn_bwd_apply(
    const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ mean, const float* __restrict__ rstd,
    const float* __restrict__ means, T* __restrict__ dx, int channels, int groups, int64_t hw,
    int64_t total, int silu) {
  const int cpg = channels / groups;
  for (int64_t i = blockIdx.x * (int64_t)kApplyThreads + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * kApplyThreads) {
    const int64_t bc = i / hw;
    const int c = (int)(bc % channels);
    const int64_t bg = (bc / channels) * groups + c / cpg;
    const float r = rstd[bg];
    const float xhat = (to_f(x[i]) - mean[bg]) * r;
    const float g = dz_of(to_f(dy[i]), xhat, w[c], b[c], silu) * w[c];
    dx[i] = from_f<T>(r * ((g - means[bg * 2]) - xhat * means[bg * 2 + 1]));
  }
}

template <typename T>
int launch_bwd_part(const void* x, const void* dy, const float* w, const float* b,
                    const float* mean, const float* rstd, float* sums, float* wsum, int* done,
                    int batch, int channels, int64_t hw, int groups, int silu,
                    cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const unsigned blocks = (unsigned)((int64_t)batch * channels);
  const T *xt = static_cast<const T*>(x), *dt = static_cast<const T*>(dy);
  if (hw % VEC == 0 && aligned16(x) && aligned16(dy))
    gn_bwd_part<T, VEC><<<blocks, kPartThreads, 0, stream>>>(xt, dt, w, b, mean, rstd, sums,
                                                               wsum, done, channels, groups, hw,
                                                               silu);
  else
    gn_bwd_part<T, 1><<<blocks, kPartThreads, 0, stream>>>(xt, dt, w, b, mean, rstd, sums, wsum,
                                                           done, channels, groups, hw, silu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_apply(const void* x, const void* dy, const float* w, const float* b,
                     const float* mean, const float* rstd, const float* means, void* dx,
                     int batch, int channels, int64_t hw, int groups, int silu,
                     cudaStream_t stream) {
  const int64_t total = (int64_t)batch * channels * hw;
  int64_t blocks = (total + kApplyThreads - 1) / kApplyThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, then the grid strides
  gn_bwd_apply<T><<<(unsigned)blocks, kApplyThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), w, b, mean, rstd, means,
      static_cast<T*>(dx), channels, groups, hw, total, silu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_part(const void* x, const void* pre_add, float* parts, int batch, int channels,
                int64_t hw, int groups, int nparts, cudaStream_t stream) {
  const int64_t glen = (int64_t)(channels / groups) * hw;
  const int64_t part_len = (glen + nparts - 1) / nparts;
  gn_part<T><<<dim3(nparts, batch * groups), kPartThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(pre_add), parts, channels, groups, hw,
      part_len);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_apply(const void* x, const float* w, const float* b, const void* pre_add,
                 const void* scale_shift, const float* mean, const float* rstd, void* y,
                 int batch, int channels, int64_t hw, int groups, int silu,
                 cudaStream_t stream) {
  const int64_t total = (int64_t)batch * channels * hw;
  int64_t blocks = (total + kApplyThreads - 1) / kApplyThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, then the grid strides
  gn_apply<T><<<(unsigned)blocks, kApplyThreads, 0, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<const T*>(pre_add),
      static_cast<const T*>(scale_shift), mean, rstd, static_cast<T*>(y), channels, groups, hw,
      total, silu);
  return (int)cudaGetLastError();
}

}  // namespace

// Across ranks, step 1: parts float32 [B * G, nparts, 3] output, per part of
// each (sample, group)'s local run its (count, mean, M2) of x (+ pre_add
// [B, C], optional). x and pre_add in the I/O dtype (0 = float32, 1 =
// bfloat16). One kernel launch.
extern "C" int asyrp_group_norm_part_stats(const void* x, const void* pre_add, void* parts,
                                           int batch, int channels, int64_t hw, int groups,
                                           int nparts, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch < 1 || groups < 1 || channels % groups != 0 ||
      hw < 1 || nparts < 1 || (int64_t)batch * groups > 65535 || nparts > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(parts);
  return dtype == 0
             ? launch_part<float>(x, pre_add, out, batch, channels, hw, groups, nparts, s)
             : launch_part<__nv_bfloat16>(x, pre_add, out, batch, channels, hw, groups, nparts,
                                          s);
}

// Across ranks, step 3: y from x (+ pre_add) with the combined mean and rstd
// (float32 [B * G]), the affine (w, b float32 [C]), the FiLM epilogue
// (scale_shift [B, 2C], optional) and SiLU. One kernel launch.
extern "C" int asyrp_group_norm_apply(const void* x, const void* w, const void* b,
                                      const void* pre_add, const void* scale_shift,
                                      const void* mean, const void* rstd, void* y, int batch,
                                      int channels, int64_t hw, int groups, int silu, int dtype,
                                      void* stream) {
  if ((dtype != 0 && dtype != 1) || batch < 1 || groups < 1 || channels % groups != 0 || hw < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *wf = static_cast<const float*>(w), *bf = static_cast<const float*>(b);
  const float *mf = static_cast<const float*>(mean), *rf = static_cast<const float*>(rstd);
  return dtype == 0 ? launch_apply<float>(x, wf, bf, pre_add, scale_shift, mf, rf, y, batch,
                                          channels, hw, groups, silu, s)
                    : launch_apply<__nv_bfloat16>(x, wf, bf, pre_add, scale_shift, mf, rf, y,
                                                  batch, channels, hw, groups, silu, s);
}

// The plan a call takes (for reports): out = {cluster size, vector width,
// vectors per slice, resident vectors of x, of dy, dynamic shared bytes,
// vectors per group, threads per block}. dtype: 0 = float32, 1 = bfloat16; bwd: 0 forward,
// 1 backward, 2 backward with dw/db. Returns 0, or cudaErrorInvalidValue.
extern "C" int asyrp_group_norm_plan(int batch, int channels, int64_t hw, int groups, int dtype,
                                     int bwd, int64_t* out) {
  Plan pl;
  if ((dtype != 0 && dtype != 1) ||
      !make_plan(batch, channels, hw, groups, dtype == 0 ? 4 : 2, bwd ? 2 : 1, bwd == 2, true,
                 &pl))
    return (int)cudaErrorInvalidValue;
  const int64_t v[8] = {pl.cluster, pl.vec, pl.slice_v, pl.res0, pl.res1, pl.smem, pl.group_v,
                        pl.threads};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// x, y (and pre_add [B, C], scale_shift [B, 2C], each optional) in the I/O
// dtype (0 = float32, 1 = bfloat16); w, b float32 [C]; mean, rstd float32
// [B * G] outputs, or both null. One kernel launch.
extern "C" int asyrp_group_norm(const void* x, const void* w, const void* b, void* y,
                                const void* pre_add, const void* scale_shift, void* mean,
                                void* rstd, int batch, int channels, int64_t hw, int groups,
                                float eps, int silu, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Plan pl;
  if (!make_plan(batch, channels, hw, groups, dtype == 0 ? 4 : 2, 1, false,
                 aligned16(x) && aligned16(y), &pl))
    return (int)cudaErrorInvalidValue;
  FwdParams prm;
  prm.x = x;
  prm.y = y;
  prm.w = static_cast<const float*>(w);
  prm.b = static_cast<const float*>(b);
  prm.pre_add = pre_add;
  prm.scale_shift = scale_shift;
  prm.mean_out = static_cast<float*>(mean);
  prm.rstd_out = static_cast<float*>(rstd);
  prm.channels = channels;
  prm.groups = groups;
  prm.cpg = channels / groups;
  prm.cluster = pl.cluster;
  prm.hwv = pl.hwv;
  prm.hwv_shift = pl.hwv_shift;
  prm.group_v = pl.group_v;
  prm.slice_v = pl.slice_v;
  prm.res_v = pl.res0;
  prm.nchunks = pl.nchunks;
  prm.chunk_v = pl.chunk_v;
  prm.eps = eps;
  prm.silu = silu;
  return dispatch<false>(prm, pl, dtype, batch * groups, static_cast<cudaStream_t>(stream));
}

// The backward: x, dy, dx in the I/O dtype; w, b, mean, rstd as the
// forward's; wsum float32 [B, 2, C] output (per sample: the sums of
// dz * xhat and of dz over H*W; dw and db are their sums over B), or null
// (weight not trained). One kernel launch.
extern "C" int asyrp_group_norm_bwd(const void* x, const void* dy, const void* w, const void* b,
                                    const void* mean, const void* rstd, void* dx, void* wsum,
                                    int batch, int channels, int64_t hw, int groups, int silu,
                                    int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Plan pl;
  if (!make_plan(batch, channels, hw, groups, dtype == 0 ? 4 : 2, 2, wsum != nullptr,
                 aligned16(x) && aligned16(dy) && aligned16(dx), &pl))
    return (int)cudaErrorInvalidValue;
  BwdParams prm;
  prm.x = x;
  prm.dy = dy;
  prm.dx = dx;
  prm.w = static_cast<const float*>(w);
  prm.b = static_cast<const float*>(b);
  prm.mean = static_cast<const float*>(mean);
  prm.rstd = static_cast<const float*>(rstd);
  prm.wsum = static_cast<float*>(wsum);
  prm.channels = channels;
  prm.groups = groups;
  prm.cpg = channels / groups;
  prm.cluster = pl.cluster;
  prm.hwv = pl.hwv;
  prm.hwv_shift = pl.hwv_shift;
  prm.group_v = pl.group_v;
  prm.slice_v = pl.slice_v;
  prm.res_x = pl.res0;
  prm.res_dy = pl.res1;
  prm.nchunks = pl.nchunks;
  prm.chunk_v = pl.chunk_v;
  prm.silu = silu;
  return dispatch<true>(prm, pl, dtype, batch * groups, static_cast<cudaStream_t>(stream));
}

// Across ranks, backward step 1: x, dy in the I/O dtype (0 = float32, 1 =
// bfloat16); w, b float32 [C]; mean, rstd the combined float32 [B * G];
// outputs sums float32 [B * G, 2] (this rank's sums of g = dz * w and of
// g * xhat per group) and wsum float32 [B, 2, C] (per sample and channel
// the sums of dz * xhat and of dz); done int32 [B * G], zero on entry and
// on exit. One kernel launch.
extern "C" int asyrp_group_norm_bwd_part(const void* x, const void* dy, const void* w,
                                         const void* b, const void* mean, const void* rstd,
                                         void* sums, void* wsum, void* done, int batch,
                                         int channels, int64_t hw, int groups, int silu,
                                         int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || batch < 1 || groups < 1 || channels % groups != 0 ||
      hw < 1 || hw > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *wf = static_cast<const float*>(w), *bf = static_cast<const float*>(b);
  const float *mf = static_cast<const float*>(mean), *rf = static_cast<const float*>(rstd);
  float *sf = static_cast<float*>(sums), *ws = static_cast<float*>(wsum);
  int* dn = static_cast<int*>(done);
  return dtype == 0 ? launch_bwd_part<float>(x, dy, wf, bf, mf, rf, sf, ws, dn, batch, channels,
                                             hw, groups, silu, s)
                    : launch_bwd_part<__nv_bfloat16>(x, dy, wf, bf, mf, rf, sf, ws, dn, batch,
                                                     channels, hw, groups, silu, s);
}

// Across ranks, backward step 2: dx (the I/O dtype) of the local rows from
// the whole group's means float32 [B * G, 2] (the ranks' sums over the
// group's count); the rest as step 1. One kernel launch.
extern "C" int asyrp_group_norm_bwd_apply(const void* x, const void* dy, const void* w,
                                          const void* b, const void* mean, const void* rstd,
                                          const void* means, void* dx, int batch, int channels,
                                          int64_t hw, int groups, int silu, int dtype,
                                          void* stream) {
  if ((dtype != 0 && dtype != 1) || batch < 1 || groups < 1 || channels % groups != 0 || hw < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *wf = static_cast<const float*>(w), *bf = static_cast<const float*>(b);
  const float *mf = static_cast<const float*>(mean), *rf = static_cast<const float*>(rstd);
  const float* mm = static_cast<const float*>(means);
  return dtype == 0 ? launch_bwd_apply<float>(x, dy, wf, bf, mf, rf, mm, dx, batch, channels, hw,
                                              groups, silu, s)
                    : launch_bwd_apply<__nv_bfloat16>(x, dy, wf, bf, mf, rf, mm, dx, batch,
                                                      channels, hw, groups, silu, s);
}
