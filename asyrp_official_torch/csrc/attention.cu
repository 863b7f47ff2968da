// K2: single-head spatial self-attention, softmax(q k^T * scale) v, over
// row-major [B, T, C] maps, f32 or bf16 I/O, forward and backward (K2-bwd).
//
// Replaces: the JAX function `models/common.py` `spatial_attention`
// (num_heads=1, scale C^-0.5 on the logits) and the gradient XLA derives for
// it (formerly the Pallas kernel `ops/attention.py` `_attn_kernel` and its
// `jax.custom_vjp`, deleted in 4b63bc3).
//
// Forward math (same as the reference): logits in f32 (products of the I/O
// type, f32 sums), times `scale`, softmax in f32 (exp(s - max) / sum), the
// weights cast to the I/O type, then weights x v with f32 sums and one cast
// back. With `lse` set, the forward also writes each row's log-sum-exp
// max + log(sum) (f32, [B, T]) for the backward.
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
//
// Backward (FlashAttention-2 style, from the saved lse; S = q k^T * scale,
// P = exp(S - lse), D = rowsum(dO o O)):
//   `attn_bwd_d`:  D, one warp per query row;
//   `attn_bwd_dq`: one block per BM query rows recomputes S and dP = dO v^T
//     for all keys (the same tile loop as the forward, two products at
//     once), forms dS = P o (dP - D), and writes dQ = scale * dS k;
//   `attn_bwd_dkv`: one block per BM key rows recomputes S^T and dP^T for
//     all queries, and writes dV = P^T dO and dK = scale * dS^T q.
// As in the reference's rounding, dP is rounded to the I/O type (the
// gradient of the weights' cast) and, in bf16, P is cast to v's type before
// the dV product, as the forward casts the weights before weights x v.
// The backward recomputes S twice and does five [T, T, C] products, all with
// FMAs from shared memory; it is bound like the forward. Dynamic shared
// memory: (2*BM*C + 2*BN*(BK+1) + 2*BM*T) * 4 bytes, 131.6 KB at T = 256,
// C = 512.
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

// rows [r0, r0 + BM) of the [t_len, ch] matrix at `src` → f32 smem tile
// [BM][ch], zero past the last row
template <typename T>
__device__ void load_tile(float* dst, const T* src, int r0, int rows, int ch) {
  for (int i = threadIdx.x; i < BM * ch; i += kThreads) {
    const int r = i / ch, c = i % ch;
    dst[i] = r < rows ? load_f(src, (int64_t)(r0 + r) * ch + c) : 0.f;
  }
}

// For the BN rows j0.. of the [t_len, ch] matrices X and Y: each thread
// (row my_r = tid / 16 of the smem tiles A and B, rows j0 + my_j + 16 m of X
// and Y) accumulates acc_a[m] = A[my_r] . X[j] and acc_b[m] = B[my_r] . Y[j],
// staging X and Y through shared memory in BK-channel chunks. B and Y may be
// null (one product only).
template <typename T>
__device__ void tile_dots(const float* a_s, const float* b_s, const T* X, const T* Y, int j0,
                          int t_len, int ch, float* xs, float* ys, float acc_a[4],
                          float acc_b[4]) {
  const int tid = threadIdx.x;
  const int my_r = tid / 16, my_j = tid % 16;
#pragma unroll
  for (int m = 0; m < 4; ++m) acc_a[m] = acc_b[m] = 0.f;
  for (int c0 = 0; c0 < ch; c0 += BK) {
    __syncthreads();
    for (int i = tid; i < BN * BK; i += kThreads) {
      const int jj = i / BK, cc = i % BK;
      const int j = j0 + jj, c = c0 + cc;
      const bool in = j < t_len && c < ch;
      xs[jj * (BK + 1) + cc] = in ? load_f(X, (int64_t)j * ch + c) : 0.f;
      if (Y != nullptr) ys[jj * (BK + 1) + cc] = in ? load_f(Y, (int64_t)j * ch + c) : 0.f;
    }
    __syncthreads();
    const int cmax = min(BK, ch - c0);
    const float* arow = a_s + my_r * ch + c0;
    if (Y == nullptr) {
      for (int cc = 0; cc < cmax; ++cc) {
        const float av = arow[cc];
#pragma unroll
        for (int m = 0; m < 4; ++m) acc_a[m] += av * xs[(my_j + 16 * m) * (BK + 1) + cc];
      }
    } else {
      const float* brow = b_s + my_r * ch + c0;
      for (int cc = 0; cc < cmax; ++cc) {
        const float av = arow[cc], bv = brow[cc];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          acc_a[m] += av * xs[(my_j + 16 * m) * (BK + 1) + cc];
          acc_b[m] += bv * ys[(my_j + 16 * m) * (BK + 1) + cc];
        }
      }
    }
  }
}

template <typename T>
__global__ void attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                            int t_len, int ch, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [BM][ch]
  float* ks = qs + BM * ch;          // [BN][BK + 1]
  float* ss = ks + BN * (BK + 1);    // [BM][t_len]

  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.y * t_len * ch;
  const int r0 = blockIdx.x * BM;
  const int rows = min(BM, t_len - r0);
  load_tile(qs, q + base, r0, rows, ch);

  // 2. logits
  const int my_r = tid / 16, my_j = tid % 16;
  for (int j0 = 0; j0 < t_len; j0 += BN) {
    float acc[4], unused[4];
    tile_dots<T>(qs, nullptr, k + base, nullptr, j0, t_len, ch, ks, nullptr, acc, unused);
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
    if (lse != nullptr && lane == 0) lse[(int64_t)blockIdx.y * t_len + r0 + r] = mx + logf(sum);
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

// D[row] = sum_c dO[row, c] * O[row, c]; one warp per row, grid = B*T / 8
template <typename T>
__global__ void attn_bwd_d(const T* __restrict__ o, const T* __restrict__ d_o,
                           float* __restrict__ d, int64_t n_rows, int ch) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  float s = 0.f;
  for (int c = lane; c < ch; c += 32) s += load_f(d_o, row * ch + c) * load_f(o, row * ch + c);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) d[row] = s;
}

// dQ for BM query rows: grid = (ceil(T / BM), B)
template <typename T>
__global__ void attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ d_o,
                            const float* __restrict__ lse, const float* __restrict__ dd,
                            T* __restrict__ dq, int t_len, int ch, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [BM][ch]
  float* dos = qs + BM * ch;          // [BM][ch]
  float* ks = dos + BM * ch;          // [BN][BK + 1]
  float* vs = ks + BN * (BK + 1);     // [BN][BK + 1]
  float* ds = vs + BN * (BK + 1);     // [BM][t_len]: dS

  const int tid = threadIdx.x;
  const int64_t bt = (int64_t)blockIdx.y * t_len;
  const int64_t base = bt * ch;
  const int r0 = blockIdx.x * BM;
  const int rows = min(BM, t_len - r0);
  load_tile(qs, q + base, r0, rows, ch);
  load_tile(dos, d_o + base, r0, rows, ch);

  const int my_r = tid / 16, my_j = tid % 16;
  const bool live = my_r < rows;
  const float l_i = live ? lse[bt + r0 + my_r] : 0.f;
  const float d_i = live ? dd[bt + r0 + my_r] : 0.f;
  for (int j0 = 0; j0 < t_len; j0 += BN) {
    float acc_s[4], acc_dp[4];
    tile_dots<T>(qs, dos, k + base, v + base, j0, t_len, ch, ks, vs, acc_s, acc_dp);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = j0 + my_j + 16 * m;
      if (j >= t_len) continue;
      const float p = live ? expf(acc_s[m] * scale - l_i) : 0.f;
      ds[my_r * t_len + j] = p * (round_to(acc_dp[m], q) - d_i);
    }
  }
  __syncthreads();

  for (int c = tid; c < ch; c += kThreads) {
    float acc[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[r] = 0.f;
    for (int j = 0; j < t_len; ++j) {
      const float kv = load_f(k, base + (int64_t)j * ch + c);
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] += ds[r * t_len + j] * kv;
    }
    for (int r = 0; r < rows; ++r) store_f(dq, base + (int64_t)(r0 + r) * ch + c, acc[r] * scale);
  }
}

// dK, dV for BM key rows: grid = (ceil(T / BM), B)
template <typename T>
__global__ void attn_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ d_o,
                             const float* __restrict__ lse, const float* __restrict__ dd,
                             T* __restrict__ dk, T* __restrict__ dv, int t_len, int ch,
                             float scale) {
  extern __shared__ float smem[];
  float* kts = smem;                  // [BM][ch]: this block's key rows
  float* vts = kts + BM * ch;         // [BM][ch]: its value rows
  float* qs = vts + BM * ch;          // [BN][BK + 1]
  float* dos = qs + BN * (BK + 1);    // [BN][BK + 1]
  float* ps = dos + BN * (BK + 1);    // [BM][t_len]: P^T (I/O-rounded)
  float* ds = ps + BM * t_len;        // [BM][t_len]: dS^T

  const int tid = threadIdx.x;
  const int64_t bt = (int64_t)blockIdx.y * t_len;
  const int64_t base = bt * ch;
  const int r0 = blockIdx.x * BM;
  const int rows = min(BM, t_len - r0);
  load_tile(kts, k + base, r0, rows, ch);
  load_tile(vts, v + base, r0, rows, ch);

  const int my_r = tid / 16, my_j = tid % 16;
  const bool live = my_r < rows;
  for (int i0 = 0; i0 < t_len; i0 += BN) {
    float acc_s[4], acc_dp[4];  // S[i, key] and dP[i, key] for queries i = i0 + my_j + 16 m
    tile_dots<T>(kts, vts, q + base, d_o + base, i0, t_len, ch, qs, dos, acc_s, acc_dp);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = i0 + my_j + 16 * m;
      if (i >= t_len) continue;
      const float p = live ? expf(acc_s[m] * scale - lse[bt + i]) : 0.f;
      ps[my_r * t_len + i] = round_to(p, q);
      ds[my_r * t_len + i] = p * (round_to(acc_dp[m], q) - dd[bt + i]);
    }
  }
  __syncthreads();

  for (int c = tid; c < ch; c += kThreads) {
    float acc_v[BM], acc_k[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) acc_v[r] = acc_k[r] = 0.f;
    for (int i = 0; i < t_len; ++i) {
      const float dov = load_f(d_o, base + (int64_t)i * ch + c);
      const float qv = load_f(q, base + (int64_t)i * ch + c);
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        acc_v[r] += ps[r * t_len + i] * dov;
        acc_k[r] += ds[r * t_len + i] * qv;
      }
    }
    for (int r = 0; r < rows; ++r) {
      store_f(dv, base + (int64_t)(r0 + r) * ch + c, acc_v[r]);
      store_f(dk, base + (int64_t)(r0 + r) * ch + c, acc_k[r] * scale);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int t_len,
           int ch, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BM * ch + (size_t)BN * (BK + 1) + (size_t)BM * t_len);
  cudaError_t err = cudaFuncSetAttribute(attn_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + BM - 1) / BM, batch);
  attn_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), t_len, ch, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* d_o,
               const void* lse, void* d, void* dq, void* dk, void* dv, int batch, int t_len,
               int ch, float scale, cudaStream_t stream) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k);
  const T *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(d_o);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(d);
  const int64_t n_rows = (int64_t)batch * t_len;
  const int rows_per_block = kThreads / 32;
  attn_bwd_d<T><<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block), kThreads, 0,
                  stream>>>(static_cast<const T*>(o), dot, df, n_rows, ch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem =
      sizeof(float) * (2 * (size_t)BM * ch + 2 * (size_t)BN * (BK + 1) + 2 * (size_t)BM * t_len);
  const dim3 grid((t_len + BM - 1) / BM, batch);
  err = cudaFuncSetAttribute(attn_bwd_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq<T><<<grid, kThreads, smem, stream>>>(qt, kt, vt, dot, lf, df, static_cast<T*>(dq),
                                                   t_len, ch, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv<T><<<grid, kThreads, smem, stream>>>(qt, kt, vt, dot, lf, df, static_cast<T*>(dk),
                                                    static_cast<T*>(dv), t_len, ch, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o are contiguous [batch, t_len, ch];
// lse is a float32 [batch, t_len] output, or null.
extern "C" int asyrp_attention(const void* q, const void* k, const void* v, void* o, void* lse,
                               int batch, int t_len, int ch, float scale, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, lse, batch, t_len, ch, scale, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, o, lse, batch, t_len, ch, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: q, k, v, o (the forward's output), d_o and the outputs dq,
// dk, dv are contiguous [batch, t_len, ch] in the I/O dtype; lse is the
// forward's float32 [batch, t_len]; d is float32 [batch, t_len] scratch.
extern "C" int asyrp_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* d_o, const void* lse, void* d, void* dq, void* dk,
                                   void* dv, int batch, int t_len, int ch, float scale,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, o, d_o, lse, d, dq, dk, dv, batch, t_len, ch, scale, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, o, d_o, lse, d, dq, dk, dv, batch, t_len, ch,
                                     scale, s);
  return (int)cudaErrorInvalidValue;
}
