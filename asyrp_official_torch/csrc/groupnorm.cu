// K1: GroupNorm (+ optional SiLU) over NCHW activations, f32 or bf16 I/O.
//
// Replaces: the JAX functions `models/common.py` `group_norm` and
// `models/ddpmpp.py` `_gn_silu` (formerly the Pallas kernel
// `ops/groupnorm.py` `_gn_silu_kernel`, deleted in 4b63bc3).
//
// Math (same as the reference): per (sample, group of C/G channels) the
// mean and the population variance over H*W*C/G elements in f32, two-pass
// (centred squares, never E[x^2] - E[x]^2), then (x - mean) / sqrt(var + eps),
// the per-channel affine, optional SiLU y * sigmoid(y), and one cast back.
//
// Layout: in NCHW a (sample, group) is one contiguous run of C/G * H*W
// elements, so a group needs no gather.
//
// Bound: device-memory bytes. Each element is read twice (statistics, then
// normalize) and written once; the FLOPs are negligible. At batch 1 there are
// only 32 groups for 132 SMs, each up to 262,144 elements (256^2 x 128), so
// every group is split into `splits` slices:
//   pass 1 (`gn_stats`): one block per (group, slice) computes the slice's
//     (count, mean, M2), reading its slice twice (the second read hits L2);
//   pass 2 (`gn_apply`): one block per (group, slice) merges its group's
//     partials with Chan's parallel formula and normalizes its slice.
// The slice reads of pass 2 mostly hit the 50 MB L2 as well.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// Sum over the block; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // `red` may still be read from a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < 32) {
    s = lane < kThreads / 32 ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) red[0] = s;
  }
  __syncthreads();
  return red[0];
}

// grid = (splits, B*G); partials[(bg * splits + s) * 3 + {0,1,2}] = count, mean, M2
template <typename T>
__global__ void gn_stats(const T* __restrict__ x, float* __restrict__ partials,
                         int64_t group_len, int64_t slice_len, int splits) {
  __shared__ float red[32];
  const int s = blockIdx.x;
  const int64_t bg = blockIdx.y;
  const int64_t lo = (int64_t)s * slice_len;
  const int64_t hi = (lo + slice_len < group_len ? lo + slice_len : group_len);
  const T* xg = x + bg * group_len;

  float sum = 0.f;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) sum += load_f(xg, i);
  const float cnt = (float)(hi - lo);
  const float mean = block_sum(sum, red) / cnt;

  float m2 = 0.f;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float d = load_f(xg, i) - mean;
    m2 += d * d;
  }
  m2 = block_sum(m2, red);
  if (threadIdx.x == 0) {
    float* p = partials + (bg * splits + s) * 3;
    p[0] = cnt;
    p[1] = mean;
    p[2] = m2;
  }
}

template <typename T>
__global__ void gn_apply(const T* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ b, const float* __restrict__ partials,
                         T* __restrict__ y, int64_t group_len, int64_t slice_len,
                         int splits, int groups, int64_t hw, float eps, int silu) {
  __shared__ float stat[2];
  const int s = blockIdx.x;
  const int64_t bg = blockIdx.y;
  if (threadIdx.x == 0) {
    // Chan et al.: merge (n_a, mean_a, M2_a) with (n_b, mean_b, M2_b)
    const float* p = partials + bg * splits * 3;
    float n = p[0], mean = p[1], m2 = p[2];
    for (int k = 1; k < splits; ++k) {
      const float nb = p[3 * k], mb = p[3 * k + 1], m2b = p[3 * k + 2];
      const float nab = n + nb;
      const float d = mb - mean;
      mean += d * (nb / nab);
      m2 += m2b + d * d * (n * nb / nab);
      n = nab;
    }
    stat[0] = mean;
    stat[1] = 1.0f / sqrtf(m2 / n + eps);
  }
  __syncthreads();
  const float mean = stat[0], rstd = stat[1];
  const int64_t c0 = (bg % groups) * (group_len / hw);  // first channel of the group
  const int64_t lo = (int64_t)s * slice_len;
  const int64_t hi = (lo + slice_len < group_len ? lo + slice_len : group_len);
  const T* xg = x + bg * group_len;
  T* yg = y + bg * group_len;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    const int64_t c = c0 + i / hw;
    float v = (load_f(xg, i) - mean) * rstd * w[c] + b[c];
    if (silu) v = v * (1.0f / (1.0f + expf(-v)));
    store_f(yg, i, v);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, void* partials, int batch,
           int channels, int64_t hw, int groups, float eps, int silu, int splits,
           cudaStream_t stream) {
  const int64_t group_len = (int64_t)(channels / groups) * hw;
  const int64_t slice_len = (group_len + splits - 1) / splits;
  const dim3 grid(splits, batch * groups);
  gn_stats<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                             static_cast<float*>(partials), group_len,
                                             slice_len, splits);
  gn_apply<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const float*>(partials), static_cast<T*>(y), group_len, slice_len, splits,
      groups, hw, eps, silu);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. w, b are float32 [C]; partials is float32
// [batch * groups * splits * 3] scratch. Every slice must be non-empty:
// splits <= C/G * hw, and ceil(C/G * hw / splits) * (splits - 1) < C/G * hw.
extern "C" int asyrp_group_norm(const void* x, const void* w, const void* b, void* y,
                                void* partials, int batch, int channels, int64_t hw,
                                int groups, float eps, int silu, int splits, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, b, y, partials, batch, channels, hw, groups, eps, silu, splits, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, b, y, partials, batch, channels, hw, groups, eps, silu,
                                 splits, s);
  return (int)cudaErrorInvalidValue;
}
