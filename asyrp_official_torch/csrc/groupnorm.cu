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
  float* part_out;          // [B * G, 3]: (count, mean, M2) only, no y (across ranks), or null
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
    if (p.part_out == nullptr) {
      tw[i] = p.w[c0 + i];
      tb[i] = p.b[c0 + i];
    }
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
  if (p.part_out != nullptr) {  // across ranks: the local group's statistics, no pass 3
    if (rank == 0 && threadIdx.x == 0) {
      p.part_out[3 * bg] = n;
      p.part_out[3 * bg + 1] = mean;
      p.part_out[3 * bg + 2] = s.x;
    }
    if (p.cluster > 1) cluster_wait();
    return;
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
  float* sums_out;    // [B * G, 2]: the sums of g and g * xhat only, no dx (across ranks), or null
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
  // dw, db where the slice holds at most two channels (a long H*W): their
  // sums of dz * xhat and dz accumulate in pass 1 (`pc`: the first
  // channel's, then the second's); else a pass over the slice's channels
  const int cl_lo = n_s > 0 ? chan(lo, hwv, hwv_shift) : 0;
  const int nch = n_s > 0 ? chan(lo + n_s - 1, hwv, hwv_shift) - cl_lo + 1 : 0;
  const bool in_pass = p.wsum != nullptr && nch <= 2;
  // the sums of g and g * xhat over one vector, and with `in_pass` its
  // channel's sums of dz * xhat and dz
  auto accumulate = [=](int v, const float (&fx)[VEC], const float (&fd)[VEC], float& sg,
                        float& sgx, float4& pc) {
    const int c = chan(lo + v, hwv, hwv_shift);
    const float w = tw[c], b = tb[c];
    float sw = 0.f, sb = 0.f;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float xh = (fx[k] - m) * r;
      const float dz = dz_of(fd[k], xh, w, b, silu);
      const float g = dz * w;
      sg += g;
      sgx += g * xh;
      sw += dz * xh;
      sb += dz;
    }
    if (in_pass) {
      if (c == cl_lo) {
        pc.x += sw;
        pc.y += sb;
      } else {
        pc.z += sw;
        pc.w += sb;
      }
    }
  };

  // pass 1: the sums of g and g * xhat, chunk by chunk as the copies land
  // (dy past its resident part from device memory), then the rest of the
  // slice from device memory
  float sg = 0.f, sgx = 0.f;
  float4 pc = make_float4(0.f, 0.f, 0.f, 0.f);
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
          accumulate(v, fx, fd, sg, sgx, pc);
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
        accumulate(v, fx, fd, sg, sgx, pc);
      }
    }
  }
  float2 s = block_sum2<NW>(sg, sgx, red);

  if (in_pass) {
    const float2 c0s = block_sum2<NW>(pc.x, pc.y, red);
    const float2 c1s = block_sum2<NW>(pc.z, pc.w, red);
    if (threadIdx.x == 0 && nch > 0) {
      wpart[cl_lo] = c0s;
      if (nch == 2) wpart[cl_lo + 1] = c1s;
    }
  } else if (p.wsum != nullptr) {
    // dw, db: the slice's channels in rounds, each channel over `wpc`
    // warps (its vectors strided over their lanes; one warp each where the
    // slice has as many channels as warps), the warps' sums added in warp
    // order: a fixed order
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wpc = nch >= NW ? 1 : NW / max(nch, 1);  // warps per channel
    const int cpr = NW / wpc;                          // channels per round
    const int slot = warp / wpc, sub = warp % wpc;
    for (int k0 = 0; k0 < nch; k0 += cpr) {
      const int cl = cl_lo + k0 + slot;
      const bool mine = slot < cpr && k0 + slot < nch;
      float sw = 0.f, sb = 0.f;
      if (mine) {
        const int a = max(0, cl * hwv - lo), e = min(n_s, (cl + 1) * hwv - lo);
        const float w = tw[cl], b = tb[cl];
        for (int v = a + sub * 32 + lane; v < e; v += wpc * 32) {
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
      }
      sw = warp_sum(sw);
      sb = warp_sum(sb);
      if (wpc == 1) {
        if (mine && lane == 0) wpart[cl] = make_float2(sw, sb);
        continue;
      }
      __syncthreads();  // `red` may still be read
      if (lane == 0) red[warp] = make_float2(sw, sb);
      __syncthreads();
      if (mine && sub == 0 && lane == 0) {
        float2 t = make_float2(0.f, 0.f);
        for (int q = 0; q < wpc; ++q) {
          t.x += red[warp + q].x;
          t.y += red[warp + q].y;
        }
        wpart[cl] = t;
      }
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
  if (p.sums_out != nullptr) {  // across ranks: the local group's sums, no pass 2
    if (rank == 0 && threadIdx.x == 0) {
      p.sums_out[2 * bg] = s.x;
      p.sums_out[2 * bg + 1] = s.y;
    }
    if (p.cluster > 1) cluster_wait();
    return;
  }

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
// gn_part gives the local run's count, mean and centred sum of squares (M2)
// per (sample, group): passes 1-2 of gn_fwd on its cluster plan (the
// `part_out` mode), so x crosses device memory once, the pre-add fused and
// rounded to T; the caller gathers every rank's [B * G, 3] (one part per
// rank); gn_apply combines the S parts of its groups by Chan's formula in
// its prologue (mean = sum n_i m_i / N, M2 = sum M2_i + sum n_i (m_i -
// mean)^2: the centred squares throughout, never E[x^2] - E[x]^2), in rank
// order in f32, so every rank gets the same bits, then normalizes the
// local rows with the affine, the FiLM epilogue and SiLU as pass 3 of
// gn_fwd.
//
// The backward: the forward's mean and rstd are the combined ones, so
// dx = rstd * (g - mean(g) - xhat * mean(g * xhat)), g = dz * w, needs
// only each (sample, group)'s two sums over the whole image. gn_bwd_part is
// gn_bwd's sums pass on its cluster plan (the `sums_out` mode): x and dy
// on chip once, the sums of g and g * xhat across the cluster through
// DSMEM in rank order, and wsum [B, 2, C] (this rank's partials of dw and
// db, per channel in a fixed order). The caller all-reduces the sums over
// the ranks; gn_bwd_apply divides them by the group's count in its
// prologue and forms dx.
//
// Bound: device-memory bytes. The function moves 2n in the forward (x
// read, y written) and 3n in the backward (x, dy read, dx written); this
// design moves 3n and 5n (each part kernel reads its inputs once more), so
// 1.5x and 1.67x of the bound are the best it can do per call.
//
// The apply kernels: a block of kApplyThreads threads takes up to
// kApplyVecs 16-byte vectors per thread (fewer for a small tensor) of one
// group's local run (grid (slices, B * G)), or, where a group holds fewer
// vectors than a block does, several whole groups (grid (1, B * G / groups
// per block)). So a block
// knows its groups and channel rows from its index; a vector's row within
// them is a shift (or one 32-bit divide) of its index. Its loads are in
// flight while the prologue combines the statistics and fills the
// shared-memory table of its rows' w, b and epilogue terms.
// ---------------------------------------------------------------------------

constexpr int kApplyThreads = 256;
constexpr int kApplyVecs = 4;  // vectors per thread at most: one block takes up to 1024
constexpr int kSMs = 132;
constexpr int kMaxRanks = 64;

struct ApplyPlan {
  int vec, hwv, hwv_shift, group_v, gpb, slice_v, slices, blocks_y;
  int64_t smem;
};

// `arrays` the kernel reads by vectors; `aligned`: each starts on 16 bytes
bool make_apply_plan(int batch, int channels, int64_t hw, int groups, int es, bool aligned,
                     ApplyPlan* pl) {
  if (batch < 1 || groups < 1 || channels % groups != 0 || hw < 1) return false;
  const int cpg = channels / groups;
  const int nbg = batch * groups;
  const int vmax = 16 / es;
  pl->vec = (aligned && hw % vmax == 0) ? vmax : 1;
  const int64_t group_len = (int64_t)cpg * hw;
  if ((int64_t)nbg * group_len / pl->vec >= (int64_t)1 << 31) return false;
  pl->hwv = (int)(hw / pl->vec);
  pl->hwv_shift = -1;
  if ((pl->hwv & (pl->hwv - 1)) == 0) {
    pl->hwv_shift = 0;
    while ((1 << pl->hwv_shift) < pl->hwv) ++pl->hwv_shift;
  }
  pl->group_v = (int)(group_len / pl->vec);
  // vectors per thread: kApplyVecs where that still leaves two blocks per
  // SM, fewer for a small tensor, whose latency and not its bytes sets the
  // time (more blocks then share the work)
  const int64_t total_v = (int64_t)nbg * pl->group_v;
  int vpt = kApplyVecs;
  while (vpt > 1 && total_v < (int64_t)kApplyThreads * vpt * 2 * kSMs) vpt /= 2;
  const int block_v = kApplyThreads * vpt;
  if (pl->group_v >= block_v) {  // slices of one group
    pl->gpb = 1;
    pl->slice_v = block_v;
    pl->slices = (pl->group_v + block_v - 1) / block_v;
  } else {  // whole groups
    pl->gpb = block_v / pl->group_v;
    if (pl->gpb > nbg) pl->gpb = nbg;
    pl->slice_v = pl->gpb * pl->group_v;
    pl->slices = 1;
  }
  pl->blocks_y = (nbg + pl->gpb - 1) / pl->gpb;
  if (pl->slices > 65535 || pl->blocks_y > 65535) return false;
  // mean, rstd (or the two means) per group; five terms per channel row
  pl->smem = ((int64_t)pl->gpb * 4 + (int64_t)pl->gpb * cpg * 5) * 4;
  return pl->smem <= 48 * 1024;
}

// Chan's combination of a group's S gathered parts (count, mean, M2), in
// rank order, in f32: (mean, rstd), on every lane of the calling warp. Lane
// l loads rank l's part (and rank 32 + l's), so the loads are in flight
// together; the sums then take the ranks in order through the shuffles.
__device__ __forceinline__ float2 combine_parts(const float* __restrict__ parts, int ranks,
                                                int nbg, int bg, float eps) {
  const int lane = threadIdx.x % 32;
  float qn[2], qm[2], qv[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int r = c * 32 + lane;
    qn[c] = qm[c] = qv[c] = 0.f;
    if (r < ranks) {
      const float* q = parts + ((int64_t)r * nbg + bg) * 3;
      qn[c] = q[0];
      qm[c] = q[1];
      qv[c] = q[2];
    }
  }
  float n = 0.f, nm = 0.f;
  for (int r = 0; r < ranks; ++r) {
    const float a = __shfl_sync(0xffffffffu, r < 32 ? qn[0] : qn[1], r % 32);
    const float m = __shfl_sync(0xffffffffu, r < 32 ? qm[0] : qm[1], r % 32);
    n += a;
    nm += a * m;
  }
  const float mean = nm / n;
  float m2 = 0.f, d2 = 0.f;
  for (int r = 0; r < ranks; ++r) {
    const float a = __shfl_sync(0xffffffffu, r < 32 ? qn[0] : qn[1], r % 32);
    const float m = __shfl_sync(0xffffffffu, r < 32 ? qm[0] : qm[1], r % 32);
    const float v = __shfl_sync(0xffffffffu, r < 32 ? qv[0] : qv[1], r % 32);
    const float d = m - mean;
    m2 += v;
    d2 += a * (d * d);
  }
  return make_float2(mean, 1.0f / sqrtf((m2 + d2) / n + eps));
}

struct ApplyParams {
  const void* x;
  void* y;
  const float* w;
  const float* b;
  const void* pre_add;      // [B, C] in the I/O dtype, or null
  const void* scale_shift;  // [B, 2C] in the I/O dtype, or null
  const float* parts;       // [S, B * G, 3] gathered, in rank order
  float* mean_out;          // [B * G] each, or null
  float* rstd_out;
  int ranks, nbg, channels, cpg;
  int hwv, hwv_shift, group_v, gpb, slice_v;
  float eps;
  int silu;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kApplyThreads) gn_apply(const ApplyParams p) {
  using R = Raw<T, VEC>;
  extern __shared__ __align__(16) float tab[];
  const int cpg = p.cpg, gpb = p.gpb;
  const int g0 = blockIdx.y * gpb;
  const int ng = min(gpb, p.nbg - g0);
  const int rows = ng * cpg;
  float *sm = tab, *sr = tab + gpb;
  float *tw = tab + 2 * gpb, *tb = tw + gpb * cpg, *tpa = tb + gpb * cpg, *ts1 = tpa + gpb * cpg,
        *tsh = ts1 + gpb * cpg;
  // this block's vectors, from its first group's start
  const int lo = blockIdx.x * p.slice_v;
  const int hi = min(lo + p.slice_v, ng * p.group_v);
  const int64_t base = (int64_t)g0 * p.group_v;
  const R* xg = reinterpret_cast<const R*>(p.x) + base;
  R* yg = reinterpret_cast<R*>(p.y) + base;
  R r[kApplyVecs] = {};
#pragma unroll
  for (int u = 0; u < kApplyVecs; ++u) {
    const int j = lo + u * kApplyThreads + threadIdx.x;
    if (j < hi) r[u] = ld_vec<T, VEC>(reinterpret_cast<const T*>(xg), j);
  }

  // a row's w, b and epilogue terms (row: b * C + c of this block's rows)
  auto terms = [&](int i, float (&t)[5]) {
    const int row = g0 * cpg + i;
    const int c = row % p.channels, bi = row / p.channels;
    t[0] = p.w[c];
    t[1] = p.b[c];
    t[2] = p.pre_add ? to_f(static_cast<const T*>(p.pre_add)[row]) : 0.f;
    if (p.scale_shift) {
      const T* ss = static_cast<const T*>(p.scale_shift) + (int64_t)bi * 2 * p.channels;
      t[3] = round_to<T>(1.0f + to_f(ss[c]));
      t[4] = to_f(ss[p.channels + c]);
    }
  };
  auto keep = [&](int i, const float (&t)[5]) {
    tw[i] = t[0];
    tb[i] = t[1];
    tpa[i] = t[2];
    ts1[i] = t[3];
    tsh[i] = t[4];
  };
  // the first row's terms in flight while a warp per group combines its parts
  float t0[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if ((int)threadIdx.x < rows) terms(threadIdx.x, t0);
  for (int i = threadIdx.x / 32; i < ng; i += kApplyThreads / 32) {
    const float2 ms = combine_parts(p.parts, p.ranks, p.nbg, g0 + i, p.eps);
    if (threadIdx.x % 32 == 0) {
      sm[i] = ms.x;
      sr[i] = ms.y;
      if (p.mean_out != nullptr && blockIdx.x == 0) {
        p.mean_out[g0 + i] = ms.x;
        p.rstd_out[g0 + i] = ms.y;
      }
    }
  }
  if ((int)threadIdx.x < rows) keep(threadIdx.x, t0);
  for (int i = threadIdx.x + kApplyThreads; i < rows; i += kApplyThreads) {
    float t[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    terms(i, t);
    keep(i, t);
  }
  __syncthreads();

  const bool pre = p.pre_add != nullptr, film = p.scale_shift != nullptr;
  const int silu = p.silu;
#pragma unroll
  for (int u = 0; u < kApplyVecs; ++u) {
    const int j = lo + u * kApplyThreads + threadIdx.x;
    if (j >= hi) continue;
    const int row = chan(j, p.hwv, p.hwv_shift);
    const int gi = gpb == 1 ? 0 : row / cpg;
    const float mean = sm[gi], rstd = sr[gi], w = tw[row], b = tb[row];
    float f[VEC];
    unpack<T, VEC>(r[u], f);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float v = f[k];
      if (pre) v = round_to<T>(v + tpa[row]);
      float z = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mean), rstd), w), b);
      if (film) {
        z = round_to<T>(__fmul_rn(round_to<T>(z), ts1[row]));
        z = round_to<T>(__fadd_rn(z, tsh[row]));
      }
      if (silu) z = z / (1.0f + expf(-z));
      f[k] = z;
    }
    st_vec<T, VEC>(reinterpret_cast<T*>(yg), j, pack<T, VEC>(f));
  }
}

struct BwdApplyParams {
  const void* x;
  const void* dy;
  void* dx;
  const float* w;
  const float* b;
  const float* mean;  // [B * G] the combined statistics
  const float* rstd;
  const float* sums;  // [B * G, 2] the ranks' sums of g and g * xhat
  float count;        // the whole group's elements
  int nbg, channels, cpg;
  int hwv, hwv_shift, group_v, gpb, slice_v;
  int silu;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kApplyThreads) gn_bwd_apply(const BwdApplyParams p) {
  using R = Raw<T, VEC>;
  extern __shared__ __align__(16) float tab[];
  const int cpg = p.cpg, gpb = p.gpb;
  const int g0 = blockIdx.y * gpb;
  const int ng = min(gpb, p.nbg - g0);
  const int rows = ng * cpg;
  float *sm = tab, *sr = tab + gpb, *smg = tab + 2 * gpb, *smgx = tab + 3 * gpb;
  float *tw = tab + 4 * gpb, *tb = tw + gpb * cpg;
  const int lo = blockIdx.x * p.slice_v;
  const int hi = min(lo + p.slice_v, ng * p.group_v);
  const int64_t base = (int64_t)g0 * p.group_v;
  const T* xg = reinterpret_cast<const T*>(reinterpret_cast<const R*>(p.x) + base);
  const T* dyg = reinterpret_cast<const T*>(reinterpret_cast<const R*>(p.dy) + base);
  R* dxg = reinterpret_cast<R*>(p.dx) + base;
  R rx[kApplyVecs] = {}, rd[kApplyVecs] = {};
#pragma unroll
  for (int u = 0; u < kApplyVecs; ++u) {
    const int j = lo + u * kApplyThreads + threadIdx.x;
    if (j < hi) {
      rx[u] = ld_vec<T, VEC>(xg, j);
      rd[u] = ld_vec<T, VEC>(dyg, j);
    }
  }

  // each thread's first row and group loaded together, then kept
  for (int i = threadIdx.x; i < max(rows, ng); i += kApplyThreads) {
    float w = 0.f, b = 0.f, g[4] = {0.f, 0.f, 0.f, 0.f};
    if (i < rows) {
      const int c = (g0 * cpg + i) % p.channels;
      w = p.w[c];
      b = p.b[c];
    }
    if (i < ng) {
      const int bg = g0 + i;
      g[0] = p.mean[bg];
      g[1] = p.rstd[bg];
      g[2] = p.sums[2 * bg];
      g[3] = p.sums[2 * bg + 1];
    }
    if (i < rows) {
      tw[i] = w;
      tb[i] = b;
    }
    if (i < ng) {
      sm[i] = g[0];
      sr[i] = g[1];
      smg[i] = g[2] / p.count;
      smgx[i] = g[3] / p.count;
    }
  }
  __syncthreads();

  const int silu = p.silu;
#pragma unroll
  for (int u = 0; u < kApplyVecs; ++u) {
    const int j = lo + u * kApplyThreads + threadIdx.x;
    if (j >= hi) continue;
    const int row = chan(j, p.hwv, p.hwv_shift);
    const int gi = gpb == 1 ? 0 : row / cpg;
    const float m = sm[gi], r = sr[gi], mg = smg[gi], mgx = smgx[gi];
    const float w = tw[row], b = tb[row];
    float fx[VEC], fd[VEC];
    unpack<T, VEC>(rx[u], fx);
    unpack<T, VEC>(rd[u], fd);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float xh = (fx[k] - m) * r;
      const float g = dz_of(fd[k], xh, w, b, silu) * w;
      fx[k] = r * ((g - mg) - xh * mgx);
    }
    st_vec<T, VEC>(reinterpret_cast<T*>(dxg), j, pack<T, VEC>(fx));
  }
}

template <typename K, typename P>
int launch_apply_planned(K kernel, const P& prm, const ApplyPlan& pl, cudaStream_t stream) {
  kernel<<<dim3(pl.slices, pl.blocks_y), kApplyThreads, pl.smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// Across ranks, step 1: parts float32 [B * G, 3] output, per (sample,
// group) of the local x (+ pre_add [B, C], optional) its (count, mean, M2).
// x and pre_add in the I/O dtype (0 = float32, 1 = bfloat16). One kernel
// launch (gn_fwd's passes 1-2).
extern "C" int asyrp_group_norm_part_stats(const void* x, const void* pre_add, void* parts,
                                           int batch, int channels, int64_t hw, int groups,
                                           int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Plan pl;
  if (!make_plan(batch, channels, hw, groups, dtype == 0 ? 4 : 2, 1, false, aligned16(x), &pl))
    return (int)cudaErrorInvalidValue;
  FwdParams prm = {};
  prm.x = x;
  prm.w = nullptr;
  prm.b = nullptr;
  prm.pre_add = pre_add;
  prm.part_out = static_cast<float*>(parts);
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
  return dispatch<false>(prm, pl, dtype, batch * groups, static_cast<cudaStream_t>(stream));
}

// Across ranks, step 3: y from x (+ pre_add) with the statistics combined
// from `parts`, float32 [ranks, B * G, 3] (every rank's step 1, in rank
// order), the affine (w, b float32 [C]), the FiLM epilogue (scale_shift
// [B, 2C], optional) and SiLU; mean, rstd float32 [B * G] outputs (the
// combined statistics, for the backward), or both null. One kernel launch.
extern "C" int asyrp_group_norm_apply(const void* x, const void* w, const void* b,
                                      const void* pre_add, const void* scale_shift,
                                      const void* parts, void* mean, void* rstd, void* y,
                                      int ranks, int batch, int channels, int64_t hw, int groups,
                                      float eps, int silu, int dtype, void* stream) {
  ApplyPlan pl;
  if ((dtype != 0 && dtype != 1) || ranks < 1 || ranks > kMaxRanks ||
      !make_apply_plan(batch, channels, hw, groups, dtype == 0 ? 4 : 2,
                       aligned16(x) && aligned16(y), &pl))
    return (int)cudaErrorInvalidValue;
  ApplyParams prm;
  prm.x = x;
  prm.y = y;
  prm.w = static_cast<const float*>(w);
  prm.b = static_cast<const float*>(b);
  prm.pre_add = pre_add;
  prm.scale_shift = scale_shift;
  prm.parts = static_cast<const float*>(parts);
  prm.mean_out = static_cast<float*>(mean);
  prm.rstd_out = static_cast<float*>(rstd);
  prm.ranks = ranks;
  prm.nbg = batch * groups;
  prm.channels = channels;
  prm.cpg = channels / groups;
  prm.hwv = pl.hwv;
  prm.hwv_shift = pl.hwv_shift;
  prm.group_v = pl.group_v;
  prm.gpb = pl.gpb;
  prm.slice_v = pl.slice_v;
  prm.eps = eps;
  prm.silu = silu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using B16 = __nv_bfloat16;
  if (dtype == 0)
    return pl.vec == 1 ? launch_apply_planned(gn_apply<float, 1>, prm, pl, s)
                       : launch_apply_planned(gn_apply<float, 4>, prm, pl, s);
  return pl.vec == 1 ? launch_apply_planned(gn_apply<B16, 1>, prm, pl, s)
                     : launch_apply_planned(gn_apply<B16, 8>, prm, pl, s);
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
  FwdParams prm = {};
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
  BwdParams prm = {};
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
// the sums of dz * xhat and of dz). One kernel launch (gn_bwd's sums pass).
extern "C" int asyrp_group_norm_bwd_part(const void* x, const void* dy, const void* w,
                                         const void* b, const void* mean, const void* rstd,
                                         void* sums, void* wsum, int batch, int channels,
                                         int64_t hw, int groups, int silu, int dtype,
                                         void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Plan pl;
  if (!make_plan(batch, channels, hw, groups, dtype == 0 ? 4 : 2, 2, true,
                 aligned16(x) && aligned16(dy), &pl))
    return (int)cudaErrorInvalidValue;
  // nothing held for a second pass: a slice of at most two channels sums
  // dw and db in pass 1, and the channel pass of a slice of more (a short
  // H*W) reads its few vectors again from the L2. So the slice streams, and
  // four or more 256-thread blocks share an SM, their loads in flight.
  pl.res0 = pl.res1 = 0;
  pl.threads = 256;
  pl.smem = (int64_t)(channels / groups) * (4 * 2 + 8);
  BwdParams prm = {};
  prm.x = x;
  prm.dy = dy;
  prm.w = static_cast<const float*>(w);
  prm.b = static_cast<const float*>(b);
  prm.mean = static_cast<const float*>(mean);
  prm.rstd = static_cast<const float*>(rstd);
  prm.wsum = static_cast<float*>(wsum);
  prm.sums_out = static_cast<float*>(sums);
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

// Across ranks, backward step 2: dx (the I/O dtype) of the local rows from
// the ranks' summed `sums` float32 [B * G, 2] over the whole group's
// `count` elements; the rest as step 1. One kernel launch.
extern "C" int asyrp_group_norm_bwd_apply(const void* x, const void* dy, const void* w,
                                          const void* b, const void* mean, const void* rstd,
                                          const void* sums, void* dx, float count, int batch,
                                          int channels, int64_t hw, int groups, int silu,
                                          int dtype, void* stream) {
  ApplyPlan pl;
  if ((dtype != 0 && dtype != 1) || !(count > 0.f) ||
      !make_apply_plan(batch, channels, hw, groups, dtype == 0 ? 4 : 2,
                       aligned16(x) && aligned16(dy) && aligned16(dx), &pl))
    return (int)cudaErrorInvalidValue;
  BwdApplyParams prm;
  prm.x = x;
  prm.dy = dy;
  prm.dx = dx;
  prm.w = static_cast<const float*>(w);
  prm.b = static_cast<const float*>(b);
  prm.mean = static_cast<const float*>(mean);
  prm.rstd = static_cast<const float*>(rstd);
  prm.sums = static_cast<const float*>(sums);
  prm.count = count;
  prm.nbg = batch * groups;
  prm.channels = channels;
  prm.cpg = channels / groups;
  prm.hwv = pl.hwv;
  prm.hwv_shift = pl.hwv_shift;
  prm.group_v = pl.group_v;
  prm.gpb = pl.gpb;
  prm.slice_v = pl.slice_v;
  prm.silu = silu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using B16 = __nv_bfloat16;
  if (dtype == 0)
    return pl.vec == 1 ? launch_apply_planned(gn_bwd_apply<float, 1>, prm, pl, s)
                       : launch_apply_planned(gn_bwd_apply<float, 4>, prm, pl, s);
  return pl.vec == 1 ? launch_apply_planned(gn_bwd_apply<B16, 1>, prm, pl, s)
                     : launch_apply_planned(gn_bwd_apply<B16, 8>, prm, pl, s);
}
