// K2: spatial self-attention, softmax(q k^T * scale) v per head, over
// row-major [B, T, C] maps, f32 or bf16 I/O; forward (K2) and backward
// (K2-bwd), both with H heads.
//
// Replaces: the JAX function `models/common.py` `spatial_attention` (formerly
// the Pallas kernel `ops/attention.py` `_attn_kernel` and its
// `jax.custom_vjp`, deleted in 4b63bc3): the DDPM++ flavor (num_heads=1,
// scale C^-0.5 on the logits) and its gradient, and the OpenAI flavor
// (num_heads=H, `legacy_scale`: d^-0.25 on q and on k, d = C / H).
//
// Heads: head h owns channels [h*d, (h+1)*d) of every row (the JAX layout),
// and the output keeps that layout. A block reads its head's d columns with
// row stride C (`ld`).
//
// Forward math (same as the reference): with `pre` != 1 (legacy_scale) q*pre
// and k*pre are formed in f32 and rounded to the I/O type before the
// product, as the JAX `q * scale` on a bf16 q rounds; logits in f32
// (products of the I/O type, f32 sums), times `scale` (1 with legacy_scale),
// softmax in f32 (exp(s - max) / sum), the weights cast to the I/O type,
// then weights x v with f32 sums and one cast back. With `lse` set, the
// forward also writes each row's log-sum-exp max + log(sum) (f32,
// [B, H, T]) for the backward.
//
// Shapes: DDPM++ T = 256 (16^2 levels) or 64 (mid block), C = 512, one head;
// the OpenAI UNets (AFHQ/FFHQ) the same T with C = 512 as 8 heads of d = 64,
// and T = 1024 for IMAGENET's 32^2 level.
// One block owns BM = 16 query rows of one (sample, head), 256 threads:
//   1. the [BM, d] query tile goes to shared memory as f32;
//   2. for each tile of BN = 64 keys, the key tile is staged through shared
//      memory in BK = 64-channel chunks; each thread keeps 4 logits in
//      registers, and the tile's logits land in a [BM, T] f32 row buffer;
//   3. one warp per row takes the exact softmax over the whole row (T is at
//      most a few thousand, so the row fits in shared memory and no online
//      rescaling is needed);
//   4. weights x v: each thread owns one column per 256-column pass and BM
//      f32 accumulators; v is read straight from device memory, coalesced
//      (at d = 64 a quarter of the threads do this pass).
// Bound: at T = 256, C = 512 the call does 2 * T * T * C FMAs from shared
// memory and reads k and v once per query tile (through L2): this simple
// version is bound by shared-memory and L2 bandwidth, not by the tensor
// cores, which it does not use. Dynamic shared memory: (BM*d + BN*(BK+1) +
// BM*T) * 4 bytes, 65.8 KB at T = 256, d = 512; 36.9 KB at T = 256, d = 64;
// 86.3 KB at T = 1024, d = 64.
//
// Backward (FlashAttention-2 style, from the saved lse; per (sample, head),
// q' = q*pre and k' = k*pre rounded to the I/O type as in the forward,
// S = q' k'^T * scale, P = exp(S - lse), D = rowsum(dO o O) over the head's
// d columns only):
//   `attn_bwd_d`:  D, one warp per (sample, head, query row);
//   `attn_bwd_dq`: one block per BM query rows of one (sample, head)
//     recomputes S and dP = dO v^T for all keys (the same tile loop as the
//     forward, two products at once), forms dS = P o (dP - D), and writes
//     dQ = pre * rnd(scale * dS k');
//   `attn_bwd_dkv`: one block per BM key rows recomputes S^T and dP^T for
//     all queries, and writes dV = P^T dO and dK = pre * rnd(scale * dS^T q').
// rnd() rounds to the I/O type. As in the reference's rounding (the
// gradient XLA derives for `spatial_attention`): dP is rounded to the I/O
// type (the gradient of the weights' cast); P is cast to v's type before
// the dV product, as the forward casts the weights before weights x v; and
// with `legacy_scale` the cotangent of q' (k') is rounded to the I/O type
// before it is multiplied by pre, as the product q * pre in the I/O type
// differentiates. Every output element is written by one thread of one
// block, with no atomics, so the backward is deterministic run to run.
// It recomputes S twice and does five [T, T, d] products per head, all with
// FMAs from shared memory; it is bound like the forward. Dynamic shared
// memory: (2*BM*d + 2*BN*(BK+1) + 2*BM*T) * 4 bytes, 131.6 KB at T = 256,
// d = 512 (DDPM++); 74.2 KB at T = 256, d = 64 (8 heads); 172.5 KB at
// T = 1024, d = 64.
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

// rows [r0, r0 + BM) of the [t_len, ch] matrix at `src` (row stride ld),
// times `pre` rounded to the I/O type → f32 smem tile [BM][ch], zero past the
// last row
template <typename T>
__device__ void load_tile(float* dst, const T* src, int r0, int rows, int ch, int ld,
                          float pre) {
  for (int i = threadIdx.x; i < BM * ch; i += kThreads) {
    const int r = i / ch, c = i % ch;
    dst[i] = r < rows ? round_to(load_f(src, (int64_t)(r0 + r) * ld + c) * pre, src) : 0.f;
  }
}

// For the BN rows j0.. of the [t_len, ch] matrices X and Y (row stride ld):
// each thread (row my_r = tid / 16 of the smem tiles A and B, rows
// j0 + my_j + 16 m of X and Y) accumulates acc_a[m] = A[my_r] . X[j] and
// acc_b[m] = B[my_r] . Y[j], staging X (times `pre_x`, rounded to the I/O
// type) and Y through shared memory in BK-channel chunks. B and Y may be
// null (one product only).
template <typename T>
__device__ void tile_dots(const float* a_s, const float* b_s, const T* X, const T* Y, int j0,
                          int t_len, int ch, int ld, float pre_x, float* xs, float* ys,
                          float acc_a[4], float acc_b[4]) {
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
      xs[jj * (BK + 1) + cc] = in ? round_to(load_f(X, (int64_t)j * ld + c) * pre_x, X) : 0.f;
      if (Y != nullptr) ys[jj * (BK + 1) + cc] = in ? load_f(Y, (int64_t)j * ld + c) : 0.f;
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

// grid = (ceil(T / BM), B * H); blockIdx.y = b * H + h; d = ch, ld = H * d
template <typename T>
__global__ void attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                            int t_len, int ch, int heads, float scale, float pre) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [BM][ch]
  float* ks = qs + BM * ch;          // [BN][BK + 1]
  float* ss = ks + BN * (BK + 1);    // [BM][t_len]

  const int tid = threadIdx.x;
  const int ld = heads * ch;
  const int64_t b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int64_t base = b * t_len * ld + h * ch;
  const int r0 = blockIdx.x * BM;
  const int rows = min(BM, t_len - r0);
  load_tile(qs, q + base, r0, rows, ch, ld, pre);

  // 2. logits
  const int my_r = tid / 16, my_j = tid % 16;
  for (int j0 = 0; j0 < t_len; j0 += BN) {
    float acc[4], unused[4];
    tile_dots<T>(qs, nullptr, k + base, nullptr, j0, t_len, ch, ld, pre, ks, nullptr, acc,
                 unused);
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
      const float vv = load_f(v, base + (int64_t)j * ld + c);
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] += ss[r * t_len + j] * vv;
    }
    for (int r = 0; r < rows; ++r) store_f(o, base + (int64_t)(r0 + r) * ld + c, acc[r]);
  }
}

// D[b, h, i] = sum over the head's d columns of dO[b, i, .] * O[b, i, .];
// one warp per (sample, head, query row), grid = B*H*T / 8
template <typename T>
__global__ void attn_bwd_d(const T* __restrict__ o, const T* __restrict__ d_o,
                           float* __restrict__ d, int64_t n_rows, int t_len, int ch, int heads) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const int64_t bh = row / t_len, i = row % t_len;
  const int64_t at = ((bh / heads) * t_len + i) * heads * ch + (bh % heads) * ch;
  float s = 0.f;
  for (int c = lane; c < ch; c += 32) s += load_f(d_o, at + c) * load_f(o, at + c);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) d[row] = s;
}

// dQ for BM query rows of one (sample, head): grid = (ceil(T / BM), B * H),
// blockIdx.y = b * H + h; d = ch, ld = H * d
template <typename T>
__global__ void attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ d_o,
                            const float* __restrict__ lse, const float* __restrict__ dd,
                            T* __restrict__ dq, int t_len, int ch, int heads, float scale,
                            float pre) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [BM][ch]: q' = q * pre, I/O-rounded
  float* dos = qs + BM * ch;          // [BM][ch]
  float* ks = dos + BM * ch;          // [BN][BK + 1]
  float* vs = ks + BN * (BK + 1);     // [BN][BK + 1]
  float* ds = vs + BN * (BK + 1);     // [BM][t_len]: dS

  const int tid = threadIdx.x;
  const int ld = heads * ch;
  const int64_t bt = (int64_t)blockIdx.y * t_len;  // row of (b, h) in lse and D
  const int64_t base = (int64_t)(blockIdx.y / heads) * t_len * ld + (blockIdx.y % heads) * ch;
  const int r0 = blockIdx.x * BM;
  const int rows = min(BM, t_len - r0);
  load_tile(qs, q + base, r0, rows, ch, ld, pre);
  load_tile(dos, d_o + base, r0, rows, ch, ld, 1.f);

  const int my_r = tid / 16, my_j = tid % 16;
  const bool live = my_r < rows;
  const float l_i = live ? lse[bt + r0 + my_r] : 0.f;
  const float d_i = live ? dd[bt + r0 + my_r] : 0.f;
  for (int j0 = 0; j0 < t_len; j0 += BN) {
    float acc_s[4], acc_dp[4];
    tile_dots<T>(qs, dos, k + base, v + base, j0, t_len, ch, ld, pre, ks, vs, acc_s, acc_dp);
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
      const float kv = round_to(load_f(k, base + (int64_t)j * ld + c) * pre, k);
#pragma unroll
      for (int r = 0; r < BM; ++r) acc[r] += ds[r * t_len + j] * kv;
    }
    // the cotangent of q' is rounded to the I/O type before the pre-scale
    for (int r = 0; r < rows; ++r)
      store_f(dq, base + (int64_t)(r0 + r) * ld + c, round_to(acc[r] * scale, q) * pre);
  }
}

// dK, dV for BM key rows of one (sample, head): grid = (ceil(T / BM), B * H)
template <typename T>
__global__ void attn_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ d_o,
                             const float* __restrict__ lse, const float* __restrict__ dd,
                             T* __restrict__ dk, T* __restrict__ dv, int t_len, int ch, int heads,
                             float scale, float pre) {
  extern __shared__ float smem[];
  float* kts = smem;                  // [BM][ch]: this block's key rows k' = k * pre
  float* vts = kts + BM * ch;         // [BM][ch]: its value rows
  float* qs = vts + BM * ch;          // [BN][BK + 1]
  float* dos = qs + BN * (BK + 1);    // [BN][BK + 1]
  float* ps = dos + BN * (BK + 1);    // [BM][t_len]: P^T (I/O-rounded)
  float* ds = ps + BM * t_len;        // [BM][t_len]: dS^T

  const int tid = threadIdx.x;
  const int ld = heads * ch;
  const int64_t bt = (int64_t)blockIdx.y * t_len;
  const int64_t base = (int64_t)(blockIdx.y / heads) * t_len * ld + (blockIdx.y % heads) * ch;
  const int r0 = blockIdx.x * BM;
  const int rows = min(BM, t_len - r0);
  load_tile(kts, k + base, r0, rows, ch, ld, pre);
  load_tile(vts, v + base, r0, rows, ch, ld, 1.f);

  const int my_r = tid / 16, my_j = tid % 16;
  const bool live = my_r < rows;
  for (int i0 = 0; i0 < t_len; i0 += BN) {
    float acc_s[4], acc_dp[4];  // S[i, key] and dP[i, key] for queries i = i0 + my_j + 16 m
    tile_dots<T>(kts, vts, q + base, d_o + base, i0, t_len, ch, ld, pre, qs, dos, acc_s,
                 acc_dp);
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
      const float dov = load_f(d_o, base + (int64_t)i * ld + c);
      const float qv = round_to(load_f(q, base + (int64_t)i * ld + c) * pre, q);
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        acc_v[r] += ps[r * t_len + i] * dov;
        acc_k[r] += ds[r * t_len + i] * qv;
      }
    }
    for (int r = 0; r < rows; ++r) {
      store_f(dv, base + (int64_t)(r0 + r) * ld + c, acc_v[r]);
      store_f(dk, base + (int64_t)(r0 + r) * ld + c, round_to(acc_k[r] * scale, q) * pre);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int t_len,
           int ch, int heads, float scale, float pre, cudaStream_t stream) {
  if (heads < 1 || ch % heads != 0) return (int)cudaErrorInvalidValue;
  const int d = ch / heads;
  const size_t smem = sizeof(float) * ((size_t)BM * d + (size_t)BN * (BK + 1) + (size_t)BM * t_len);
  cudaError_t err = cudaFuncSetAttribute(attn_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + BM - 1) / BM, batch * heads);
  attn_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), t_len, d, heads, scale, pre);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* d_o,
               const void* lse, void* d, void* dq, void* dk, void* dv, int batch, int t_len,
               int ch, int heads, float scale, float pre, cudaStream_t stream) {
  if (heads < 1 || ch % heads != 0) return (int)cudaErrorInvalidValue;
  const int hd = ch / heads;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k);
  const T *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(d_o);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(d);
  const int64_t n_rows = (int64_t)batch * heads * t_len;
  const int rows_per_block = kThreads / 32;
  attn_bwd_d<T><<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block), kThreads, 0,
                  stream>>>(static_cast<const T*>(o), dot, df, n_rows, t_len, hd, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem =
      sizeof(float) * (2 * (size_t)BM * hd + 2 * (size_t)BN * (BK + 1) + 2 * (size_t)BM * t_len);
  const dim3 grid((t_len + BM - 1) / BM, batch * heads);
  err = cudaFuncSetAttribute(attn_bwd_dq<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkv<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq<T><<<grid, kThreads, smem, stream>>>(qt, kt, vt, dot, lf, df, static_cast<T*>(dq),
                                                   t_len, hd, heads, scale, pre);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv<T><<<grid, kThreads, smem, stream>>>(qt, kt, vt, dot, lf, df, static_cast<T*>(dk),
                                                    static_cast<T*>(dv), t_len, hd, heads, scale,
                                                    pre);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o are contiguous [batch, t_len, ch],
// ch = heads * d with head h in channels [h*d, (h+1)*d); lse is a float32
// [batch, heads, t_len] output, or null. `scale` multiplies the logits and
// `pre` q and k (rounded to the I/O type): scale = d^-0.5, pre = 1 for the
// DDPM++ flavor; scale = 1, pre = d^-0.25 for `legacy_scale`.
extern "C" int asyrp_attention(const void* q, const void* k, const void* v, void* o, void* lse,
                               int batch, int t_len, int ch, int heads, float scale, float pre,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, lse, batch, t_len, ch, heads, scale, pre, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, lse, batch, t_len, ch, heads, scale, pre, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: q, k, v, o (the forward's output), d_o and the outputs dq,
// dk, dv are contiguous [batch, t_len, ch] in the I/O dtype, ch = heads * d
// with head h in channels [h*d, (h+1)*d); lse is the forward's float32
// [batch, heads, t_len]; d is float32 [batch, heads, t_len] scratch.
// `scale` and `pre` as for the forward.
extern "C" int asyrp_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* d_o, const void* lse, void* d, void* dq, void* dk,
                                   void* dv, int batch, int t_len, int ch, int heads, float scale,
                                   float pre, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(q, k, v, o, d_o, lse, d, dq, dk, dv, batch, t_len, ch, heads, scale,
                             pre, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(q, k, v, o, d_o, lse, d, dq, dk, dv, batch, t_len, ch,
                                     heads, scale, pre, s);
  return (int)cudaErrorInvalidValue;
}
