// K2: single-head spatial self-attention, softmax(q k^T * scale) v, over
// row-major [B, T, C] maps, f32 or bf16 I/O.
//
// Replaces: the JAX function `models/common.py` `spatial_attention`
// (num_heads=1, scale C^-0.5 on the logits; formerly the Pallas kernel
// `ops/attention.py` `_attn_kernel`, deleted in 4b63bc3).
//
// Math (same as the reference): logits in f32 (products of the I/O type,
// f32 sums), times `scale`, softmax in f32 (exp(s - max) / sum), the weights
// cast to the I/O type, then weights x v with f32 sums and one cast back.
//
// Shapes on the DDPM++ path: T = 256 (16^2 levels) or 64 (mid block), C = 512.
// One block owns BM = 16 query rows of one sample, 256 threads:
//   1. the [BM, C] query tile goes to shared memory as f32;
//   2. for each tile of BN = 64 keys, the key tile is staged through shared
//      memory in BK = 64-channel chunks; each thread keeps 4 logits in
//      registers, and the tile's logits land in a [BM, T] f32 row buffer;
//   3. one warp per row takes the exact softmax over the whole row (T is at
//      most a few thousand, so the row fits in shared memory and no online
//      rescaling is needed);
//   4. weights x v: each thread owns one column per 256-column pass and BM
//      f32 accumulators; v is read straight from device memory, coalesced.
// Bound: at T = 256, C = 512 a block does 2 * 16 * 256 * 512 FMAs from shared
// memory and reads all of k and v (through L2): this simple version is bound
// by shared-memory and L2 bandwidth, not by the tensor cores, which it does
// not use. Dynamic shared memory: (BM*C + BN*(BK+1) + BM*T) * 4 bytes,
// 65.8 KB at T = 256, C = 512.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 16;
constexpr int BN = 64;
constexpr int BK = 64;

__device__ __forceinline__ float load_f(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__global__ void attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o, int t_len, int ch,
                            float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [BM][ch]
  float* ks = qs + BM * ch;          // [BN][BK + 1]
  float* ss = ks + BN * (BK + 1);    // [BM][t_len]

  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.y * t_len * ch;
  const int r0 = blockIdx.x * BM;
  const int rows = min(BM, t_len - r0);

  for (int i = tid; i < BM * ch; i += kThreads) {
    const int r = i / ch, c = i % ch;
    qs[i] = r < rows ? load_f(q, base + (int64_t)(r0 + r) * ch + c) : 0.f;
  }

  // 2. logits
  const int my_r = tid / 16;  // 0..15
  const int my_j = tid % 16;  // keys my_j + 16*m
  for (int j0 = 0; j0 < t_len; j0 += BN) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < ch; c0 += BK) {
      __syncthreads();
      for (int i = tid; i < BN * BK; i += kThreads) {
        const int jj = i / BK, cc = i % BK;
        const int j = j0 + jj, c = c0 + cc;
        ks[jj * (BK + 1) + cc] = (j < t_len && c < ch) ? load_f(k, base + (int64_t)j * ch + c) : 0.f;
      }
      __syncthreads();
      const int cmax = min(BK, ch - c0);
      const float* qrow = qs + my_r * ch + c0;
      for (int cc = 0; cc < cmax; ++cc) {
        const float qv = qrow[cc];
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[m] += qv * ks[(my_j + 16 * m) * (BK + 1) + cc];
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = j0 + my_j + 16 * m;
      if (j < t_len) ss[my_r * t_len + j] = acc[m] * scale;
    }
  }
  __syncthreads();

  // 3. softmax, one warp per row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BM; r += kThreads / 32) {
    float* row = ss + r * t_len;
    if (r >= rows) {
      for (int j = lane; j < t_len; j += 32) row[j] = 0.f;
      continue;
    }
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < t_len; j += 32) mx = fmaxf(mx, row[j]);
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < t_len; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < t_len; j += 32) row[j] = round_to(row[j] / sum, q);
  }
  __syncthreads();

  // 4. weights x v
  for (int c = tid; c < ch; c += kThreads) {
    float acc[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[r] = 0.f;
    for (int j = 0; j < t_len; ++j) {
      const float vv = load_f(v, base + (int64_t)j * ch + c);
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] += ss[r * t_len + j] * vv;
    }
    for (int r = 0; r < rows; ++r) store_f(o, base + (int64_t)(r0 + r) * ch + c, acc[r]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int t_len, int ch,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BM * ch + (size_t)BN * (BK + 1) + (size_t)BM * t_len);
  cudaError_t err = cudaFuncSetAttribute(attn_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + BM - 1) / BM, batch);
  attn_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), t_len, ch, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o are contiguous [batch, t_len, ch].
extern "C" int asyrp_attention(const void* q, const void* k, const void* v, void* o, int batch,
                               int t_len, int ch, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, batch, t_len, ch, scale, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, o, batch, t_len, ch, scale, s);
  return (int)cudaErrorInvalidValue;
}
