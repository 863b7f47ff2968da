// K1: GroupNorm (+ optional SiLU) over NCHW activations, f32 or bf16 I/O,
// forward and backward (K1-bwd).
//
// Replaces: the JAX functions `models/common.py` `group_norm` and
// `models/ddpmpp.py` `_gn_silu`, and the gradient XLA derives for them
// (formerly the Pallas kernel `ops/groupnorm.py` `_gn_silu_kernel` and its
// `jax.custom_vjp`, deleted in 4b63bc3).
//
// Forward math (same as the reference): per (sample, group of C/G channels)
// the mean and the population variance over H*W*C/G elements in f32,
// two-pass (centred squares, never E[x^2] - E[x]^2), then
// xhat = (x - mean) * rstd with rstd = 1 / sqrt(var + eps), the per-channel
// affine z = xhat * w + b, optional SiLU z * sigmoid(z), and one cast back.
// With `mean_out` / `rstd_out` set, the forward also writes each group's
// mean and rstd (f32) for the backward.
//
// Backward math, per group, in f32 from the saved mean and rstd:
//   dz = dy * s * (1 + z * (1 - s)), s = sigmoid(z)   (with SiLU; else dy)
//   g  = dz * w
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat))
//   dw = sum over (B, HW) of dz * xhat;  db = sum over (B, HW) of dz
//
// Layout: in NCHW a (sample, group) is one contiguous run of C/G * H*W
// elements, so a group needs no gather.
//
// Bound: device-memory bytes, both ways. The forward reads each element
// twice (statistics, then normalize) and writes it once; the backward
// reads x and dy twice (the two sums, then dx) and writes dx once; the
// FLOPs are negligible. At batch 1 there are only 32 groups for 132 SMs,
// each up to 262,144 elements (256^2 x 128), so every group is split into
// `splits` slices, in both directions:
//   forward pass 1 (`gn_stats`): one block per (group, slice) computes the
//     slice's (count, mean, M2), reading its slice twice (the second read
//     hits L2);
//   forward pass 2 (`gn_apply`): one block per (group, slice) merges its
//     group's partials with Chan's parallel formula and normalizes its slice;
//   backward pass 1 (`gn_bwd_reduce`): one block per (group, slice) writes
//     the slice's sums of g and g * xhat;
//   backward pass 2 (`gn_bwd_apply`): one block per (group, slice) adds its
//     group's partial sums and writes dx for its slice;
//   `gn_bwd_wgrad` (only when the weight is trained): one block per channel
//     sums dz * xhat and dz over the batch and the channel's H*W elements.
// The second reads mostly hit the 50 MB L2. Every sum runs in a fixed
// order (no atomics), so results do not change from run to run.
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

// The upstream gradient of the affine output z: dy, times SiLU's derivative.
__device__ __forceinline__ float dz_of(float dy, float xhat, float w, float b, int silu) {
  if (!silu) return dy;
  const float z = xhat * w + b;
  const float s = 1.0f / (1.0f + expf(-z));
  return dy * s * (1.0f + z * (1.0f - s));
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
                         T* __restrict__ y, float* __restrict__ mean_out,
                         float* __restrict__ rstd_out, int64_t group_len, int64_t slice_len,
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
    if (s == 0 && mean_out != nullptr) {
      mean_out[bg] = stat[0];
      rstd_out[bg] = stat[1];
    }
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

// grid = (splits, B*G); partials[(bg * splits + s) * 2 + {0,1}] = sum g, sum g*xhat
template <typename T>
__global__ void gn_bwd_reduce(const T* __restrict__ x, const T* __restrict__ dy,
                              const float* __restrict__ w, const float* __restrict__ b,
                              const float* __restrict__ mean, const float* __restrict__ rstd,
                              float* __restrict__ partials, int64_t group_len,
                              int64_t slice_len, int splits, int groups, int64_t hw, int silu) {
  __shared__ float red[32];
  const int s = blockIdx.x;
  const int64_t bg = blockIdx.y;
  const float m = mean[bg], r = rstd[bg];
  const int64_t c0 = (bg % groups) * (group_len / hw);
  const int64_t lo = (int64_t)s * slice_len;
  const int64_t hi = (lo + slice_len < group_len ? lo + slice_len : group_len);
  const T* xg = x + bg * group_len;
  const T* dyg = dy + bg * group_len;
  float sg = 0.f, sgx = 0.f;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    const int64_t c = c0 + i / hw;
    const float xh = (load_f(xg, i) - m) * r;
    const float g = dz_of(load_f(dyg, i), xh, w[c], b[c], silu) * w[c];
    sg += g;
    sgx += g * xh;
  }
  sg = block_sum(sg, red);
  sgx = block_sum(sgx, red);
  if (threadIdx.x == 0) {
    partials[(bg * splits + s) * 2] = sg;
    partials[(bg * splits + s) * 2 + 1] = sgx;
  }
}

template <typename T>
__global__ void gn_bwd_apply(const T* __restrict__ x, const T* __restrict__ dy,
                             const float* __restrict__ w, const float* __restrict__ b,
                             const float* __restrict__ mean, const float* __restrict__ rstd,
                             const float* __restrict__ partials, T* __restrict__ dx,
                             int64_t group_len, int64_t slice_len, int splits, int groups,
                             int64_t hw, int silu) {
  __shared__ float stat[2];
  const int s = blockIdx.x;
  const int64_t bg = blockIdx.y;
  if (threadIdx.x == 0) {
    const float* p = partials + bg * splits * 2;
    float sg = 0.f, sgx = 0.f;
    for (int k = 0; k < splits; ++k) {
      sg += p[2 * k];
      sgx += p[2 * k + 1];
    }
    stat[0] = sg / (float)group_len;
    stat[1] = sgx / (float)group_len;
  }
  __syncthreads();
  const float mg = stat[0], mgx = stat[1];
  const float m = mean[bg], r = rstd[bg];
  const int64_t c0 = (bg % groups) * (group_len / hw);
  const int64_t lo = (int64_t)s * slice_len;
  const int64_t hi = (lo + slice_len < group_len ? lo + slice_len : group_len);
  const T* xg = x + bg * group_len;
  const T* dyg = dy + bg * group_len;
  T* dxg = dx + bg * group_len;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    const int64_t c = c0 + i / hw;
    const float xh = (load_f(xg, i) - m) * r;
    const float g = dz_of(load_f(dyg, i), xh, w[c], b[c], silu) * w[c];
    store_f(dxg, i, r * (g - mg - xh * mgx));
  }
}

// grid = C; dw[c], db[c] over the batch and the channel's hw elements
template <typename T>
__global__ void gn_bwd_wgrad(const T* __restrict__ x, const T* __restrict__ dy,
                             const float* __restrict__ w, const float* __restrict__ b,
                             const float* __restrict__ mean, const float* __restrict__ rstd,
                             float* __restrict__ dw, float* __restrict__ db, int batch,
                             int channels, int64_t hw, int groups, int silu) {
  __shared__ float red[32];
  const int c = blockIdx.x;
  const int g = c / (channels / groups);
  const float wc = w[c], bc = b[c];
  float sw = 0.f, sb = 0.f;
  for (int n = 0; n < batch; ++n) {
    const float m = mean[n * groups + g], r = rstd[n * groups + g];
    const int64_t base = ((int64_t)n * channels + c) * hw;
    for (int64_t i = threadIdx.x; i < hw; i += kThreads) {
      const float xh = (load_f(x, base + i) - m) * r;
      const float dz = dz_of(load_f(dy, base + i), xh, wc, bc, silu);
      sw += dz * xh;
      sb += dz;
    }
  }
  sw = block_sum(sw, red);
  sb = block_sum(sb, red);
  if (threadIdx.x == 0) {
    dw[c] = sw;
    db[c] = sb;
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, void* partials, void* mean,
           void* rstd, int batch, int channels, int64_t hw, int groups, float eps, int silu,
           int splits, cudaStream_t stream) {
  const int64_t group_len = (int64_t)(channels / groups) * hw;
  const int64_t slice_len = (group_len + splits - 1) / splits;
  const dim3 grid(splits, batch * groups);
  gn_stats<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                             static_cast<float*>(partials), group_len,
                                             slice_len, splits);
  gn_apply<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const float*>(partials), static_cast<T*>(y), static_cast<float*>(mean),
      static_cast<float*>(rstd), group_len, slice_len, splits, groups, hw, eps, silu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* w, const void* b, const void* mean,
               const void* rstd, void* dx, void* dw, void* db, void* partials, int batch,
               int channels, int64_t hw, int groups, int silu, int splits,
               cudaStream_t stream) {
  const int64_t group_len = (int64_t)(channels / groups) * hw;
  const int64_t slice_len = (group_len + splits - 1) / splits;
  const dim3 grid(splits, batch * groups);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const float* mf = static_cast<const float*>(mean);
  const float* rf = static_cast<const float*>(rstd);
  float* pf = static_cast<float*>(partials);
  gn_bwd_reduce<T><<<grid, kThreads, 0, stream>>>(xt, dyt, wf, bf, mf, rf, pf, group_len,
                                                  slice_len, splits, groups, hw, silu);
  gn_bwd_apply<T><<<grid, kThreads, 0, stream>>>(xt, dyt, wf, bf, mf, rf, pf,
                                                 static_cast<T*>(dx), group_len, slice_len,
                                                 splits, groups, hw, silu);
  if (dw != nullptr) {
    gn_bwd_wgrad<T><<<channels, kThreads, 0, stream>>>(
        xt, dyt, wf, bf, mf, rf, static_cast<float*>(dw), static_cast<float*>(db), batch,
        channels, hw, groups, silu);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. w, b are float32 [C]; partials is float32
// [batch * groups * splits * 3] scratch; mean, rstd are float32 [batch * groups]
// outputs, or both null. Every slice must be non-empty:
// splits <= C/G * hw, and ceil(C/G * hw / splits) * (splits - 1) < C/G * hw.
extern "C" int asyrp_group_norm(const void* x, const void* w, const void* b, void* y,
                                void* partials, void* mean, void* rstd, int batch, int channels,
                                int64_t hw, int groups, float eps, int silu, int splits,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, b, y, partials, mean, rstd, batch, channels, hw, groups, eps,
                         silu, splits, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, b, y, partials, mean, rstd, batch, channels, hw, groups,
                                 eps, silu, splits, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: x, dy, dx in the I/O dtype; w, b, mean, rstd as the forward's;
// dw, db float32 [C] outputs, or both null (weight not trained); partials is
// float32 [batch * groups * splits * 2] scratch. Slices as in the forward.
extern "C" int asyrp_group_norm_bwd(const void* x, const void* dy, const void* w,
                                    const void* b, const void* mean, const void* rstd,
                                    void* dx, void* dw, void* db, void* partials, int batch,
                                    int channels, int64_t hw, int groups, int silu, int splits,
                                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, dy, w, b, mean, rstd, dx, dw, db, partials, batch, channels,
                             hw, groups, silu, splits, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, dy, w, b, mean, rstd, dx, dw, db, partials, batch,
                                     channels, hw, groups, silu, splits, s);
  return (int)cudaErrorInvalidValue;
}
