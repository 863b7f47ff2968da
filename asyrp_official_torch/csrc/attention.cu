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
// Forward math (the reference's): with `pre` != 1 (legacy_scale) q' =
// rnd(q*pre) and k' = rnd(k*pre), rnd() rounding to the I/O type, as the
// JAX `q * scale` on a bf16 q rounds (pre = d^-0.25 is not a power of two
// for d = 64, so this is not the same as scaling the logits); logits
// q'k'^T with f32 sums, times `scale` (1 with legacy_scale); softmax in
// f32; the normalized weights cast to the I/O type; weights x v with f32
// sums and one cast back. With `lse` set, the forward also writes each
// row's log-sum-exp (f32, [B, H, T]) for the backward.
//
// Forward kernel `fwd::attn_fwd` (one design for one head of 512 and for 8
// heads of 64):
//   - Grid (ceil(T/64), nc, B*H), nc = ceil(d/64). One warpgroup (128
//     threads) owns 64 query rows (wgmma's M) of one (sample, head) and 64
//     of its channels: its chunk of q' (resident in shared memory in the I/O
//     type), of k and of the output. The nc blocks of a row tile form a
//     thread block cluster: each computes its partial q'k'^T over its 64
//     channels, and the cluster sums the partials through distributed
//     shared memory (a reduce-scatter, then an all-gather; fixed order, so
//     every block holds the same logits). So no block recomputes another's
//     channels: at d = 512 a block reads 1 chunk of q and 3 per key tile.
//   - k and v chunks of 64 keys x 64 channels stream through a ring of
//     stages (8 in bf16, 4 in f32), kStages - 1 ahead of the one in use.
//     bf16: TMA over a [B, T, H, d] tensor map (128-byte swizzle, zero past
//     T and past d), completing on an mbarrier per stage. f32: cp.async
//     16-byte copies into padded rows (zero-filled by the source size). The
//     legacy pre-scale rounds q' and k' in shared memory after they land (a
//     TMA copy cannot multiply), then a proxy fence hands them to wgmma.
//   - Pass 1: S = q'k'^T per 64-key tile; a running row max and sum (f32,
//     base 2, per thread, combined across the 4 threads of a row with
//     shuffles) give lse. Keys past T are -inf.
//   - Pass 2: S again; P = exp(S*scale - lse) is the reference's normalized
//     weights, rounded to the I/O type; O += P v over the block's 64
//     columns. The epilogue rounds O once. Two passes and not
//     FlashAttention's online rescaling: that rounds the unnormalized
//     exp(s - m) and divides at the end, which rounds otherwise than the
//     reference; two passes keep its function and give the lse directly.
//     Shared memory does not grow with T.
//   - bf16: both products on the tensor cores with `wgmma.mma_async`
//     m64n64k16 (f32 accumulators). q' and k chunks are K-major and v chunks
//     MN-major operands in 128-byte-swizzled shared memory; P is fed from
//     registers (the accumulator layout repacked as the A fragment).
//   - f32: 3xTF32 with `mma.sync` m16n8k8 (each operand split into tf32 hi +
//     lo, hi*hi + hi*lo + lo*hi), from padded shared memory (row stride 68
//     floats, no bank conflicts). Not wgmma: its tf32 form takes both
//     operands K-major from shared memory (v is MN-major) and hi/lo copies
//     of every chunk would double the ring; mma.sync splits in registers.
//     Each warp owns 16 of the 64 rows; the accumulators have wgmma's
//     layout, so the softmax and the epilogue are shared with bf16.
// Bound: one head at [1, 256, 512] moves 1.05 MB in bf16 (q, k, v read
// once, o written once) and does 4*T*T*C = 134 MFLOP: bound by bytes at
// 0.31 us on an H100, so launch latency and the serial chain of a block
// (3 chunk waits and 2 cluster exchanges per key tile) dominate. The design
// spreads the work over 32 blocks at batch 1 and T = 256, for one head of
// 512 (4 row tiles x 8 channel blocks) as for 8 heads of 64 (4 x 8 heads),
// does the products on the tensor cores and computes the logits twice (two
// passes), not once per output slice.
// Dynamic shared memory, whatever T and d: (1 + kStages) chunks of 8 KB
// (bf16) or 17 KB (f32), 32 KB of partial and summed logits, the
// mbarriers and 1 KB of alignment: 105 KB in bf16, 118 KB in f32.
//
// Backward (FlashAttention-2 style, from the saved lse; per (sample, head),
// q' = q*pre and k' = k*pre rounded to the I/O type as in the forward,
// S = q' k'^T * scale, P = exp(S - lse), D = rowsum(dO o O) over the head's
// d columns only):
//   `attn_bwd_d`:  D, one warp per (sample, head, query row);
//   `attn_bwd_dq`: one block per BM = 16 query rows of one (sample, head),
//     256 threads, recomputes S and dP = dO v^T for all keys (`tile_dots`:
//     BN = 64-key tiles staged through shared memory in BK = 64-channel
//     chunks as f32, two products at once, 4 of each per thread), forms
//     dS = P o (dP - D) in a [BM, T] f32 row buffer, and writes
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
// FMAs that read an operand from shared memory, and no tensor cores: it is
// bound by shared-memory and L2 bandwidth. Dynamic shared
// memory: (2*BM*d + 2*BN*(BK+1) + 2*BM*T) * 4 bytes, 131.6 KB at T = 256,
// d = 512 (DDPM++); 74.2 KB at T = 256, d = 64 (8 heads); 172.5 KB at
// T = 1024, d = 64.
#include <cooperative_groups.h>
#include <cuda.h>
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

namespace fwd {

constexpr int kRows = 64;     // query rows per block: wgmma's M
constexpr int kKeys = 64;     // keys per tile
constexpr int kChunk = 64;    // channels per staged chunk
constexpr int kThreads = 128;  // one warpgroup

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

// A chunk is 64 rows (keys or query rows) x 64 channels in shared memory,
// copied in 16-byte granules. bf16: rows of 128 bytes with the 128-byte
// swizzle wgmma's descriptors expect (granule g of row r at g ^ (r % 8));
// f32: rows of 256 bytes padded to 272.
template <typename T>
struct Layout;
template <>
struct Layout<__nv_bfloat16> {
  static constexpr int kGranules = 8, kChunkBytes = kRows * 128, kStages = 8;
  __device__ static uint32_t at(int r, int g) { return r * 128 + ((g ^ (r & 7)) << 4); }
};
template <>
struct Layout<float> {
  static constexpr int kRowFloats = 68;
  static constexpr int kGranules = 16, kChunkBytes = kRows * kRowFloats * 4, kStages = 4;
  __device__ static uint32_t at(int r, int g) { return r * kRowFloats * 4 + (g << 4); }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with `valid` false the granule is zero-filled
// and nothing is read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers in shared memory, and TMA loads that complete on them
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
// the 64 x 64 box at (channel c0 of head c1, row c2 of sample c3) of a map
// over [B, T, H, d], 128-byte swizzled, zero past T and past d
__device__ __forceinline__ void tma_load(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// rows [row0, row0 + 64) x channels [col0, col0 + 64) of the head's
// [t_len, d] matrix at `src` (row stride ld) into the chunk at `dst`; this
// thread's granules are idx = threadIdx.x + 128 u
template <typename T>
__device__ __forceinline__ void load_chunk(uint32_t dst, const T* src, int row0, int col0,
                                           int t_len, int d, int ld) {
  constexpr int G = Layout<T>::kGranules, E = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < kRows * G / kThreads; ++u) {
    const int idx = threadIdx.x + kThreads * u, r = idx / G, g = idx % G;
    const int row = row0 + r, ch = col0 + g * E;
    const bool valid = row < t_len && ch < d;
    cp_async16(dst + Layout<T>::at(r, g), valid ? src + (int64_t)row * ld + ch : src, valid);
  }
}

// the legacy pre-scale, x -> rnd(x * pre), on the granules this thread
// copied into the chunk at `base`
__device__ __forceinline__ void scale16(float* p, float pre) {
  float4 x = *reinterpret_cast<float4*>(p);
  x.x *= pre, x.y *= pre, x.z *= pre, x.w *= pre;
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void scale16(__nv_bfloat16* p, float pre) {
  uint4 x = *reinterpret_cast<uint4*>(p);
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    h[i] = __floats2bfloat162_rn(f.x * pre, f.y * pre);
  }
  *reinterpret_cast<uint4*>(p) = x;
}
template <typename T>
__device__ __forceinline__ void scale_chunk(uint8_t* base, float pre) {
  constexpr int G = Layout<T>::kGranules;
#pragma unroll
  for (int u = 0; u < kRows * G / kThreads; ++u) {
    const int idx = threadIdx.x + kThreads * u;
    scale16(reinterpret_cast<T*>(base + Layout<T>::at(idx / G, idx % G)), pre);
  }
}

// ---- bf16: wgmma ----

// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset (K-major: unused; MN-major: between 64-column atoms), stride
// byte offset 1024 (between groups of 8 rows)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(a[i])::"memory");
}

#define ACC32(d)                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),       \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define REGS32                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] += A[64 x 16] B[16 x 64]: A and B from shared memory, both
// K-major (S = q' k'^T: q' rows and k rows, channels contiguous)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (P), B MN-major
// from shared memory (v rows: keys, channels contiguous)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S += q' chunk x k chunk^T, 64 channels as 4 steps of 16 (32 bytes along
// the swizzled row)
__device__ __forceinline__ void qk_chunk(float (&s)[32], const uint8_t* q_chunk,
                                         const uint8_t* k_chunk, const __nv_bfloat16*) {
  const uint32_t qa = smem_u32(q_chunk), ka = smem_u32(k_chunk);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(s, gmma_desc(qa + 32 * kk, 16), gmma_desc(ka + 32 * kk, 16));
  wgmma_commit();
  wgmma_wait();
  reg_fence(s);
}

// O += P v chunk: 64 keys as 4 steps of 16 (16 rows of 128 bytes each)
__device__ __forceinline__ void pv_chunk(float (&o)[32], const uint32_t (&p)[4][4],
                                         const uint8_t* v_chunk) {
  const uint32_t va = smem_u32(v_chunk);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(o, p[kk], gmma_desc(va + 2048 * kk, kRows * 128));
  wgmma_commit();
  wgmma_wait();
  reg_fence(o);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---- f32: 3xTF32 mma.sync ----

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a b as hi*hi + hi*lo + lo*hi, small terms first. The tensor core
// truncates where it adds into its accumulator, so a long chain of mma.sync
// into one running sum drifts (by 1e-5 of scale at T = 256, d = 512): each
// 8-deep step sums into a fresh accumulator, which is added to c with
// round-to-nearest.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, bh0, bh1);
  mma_tf32(t, ah, bl0, bl1);
  mma_tf32(t, ah, bh0, bh1);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// S += q' chunk x k chunk^T: warp w owns rows 16w..16w+15, 8 steps of 8
// channels, 8 tiles of 8 keys
__device__ __forceinline__ void qk_chunk(float (&s)[32], const uint8_t* q_chunk,
                                         const uint8_t* k_chunk, const float*) {
  constexpr int RS = Layout<float>::kRowFloats;
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const float* qc = reinterpret_cast<const float*>(q_chunk) + (16 * (threadIdx.x / 32) + gid) * RS;
  const float* kc = reinterpret_cast<const float*>(k_chunk) + gid * RS;
#pragma unroll 1  // the registers go to the accumulators
  for (int ks = 0; ks < kChunk / 8; ++ks) {
    const int c = 8 * ks + tig;
    uint32_t ah[4], al[4];
    split_tf32(qc[c], ah[0], al[0]);
    split_tf32(qc[8 * RS + c], ah[1], al[1]);
    split_tf32(qc[c + 4], ah[2], al[2]);
    split_tf32(qc[8 * RS + c + 4], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      mma_3xtf32(s + 4 * nt, ah, al, kc[8 * nt * RS + c], kc[8 * nt * RS + c + 4]);
  }
}

// O += P v chunk. The A fragment's k = tig holds key 2 tig of each 8-key
// step and k = tig + 4 key 2 tig + 1, which is where the S accumulators
// already hold them; the v rows are read in the same order.
__device__ __forceinline__ void pv_chunk(float (&o)[32], const float (&p)[32],
                                         const uint8_t* v_chunk) {
  constexpr int RS = Layout<float>::kRowFloats;
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const float* vc = reinterpret_cast<const float*>(v_chunk) + 2 * tig * RS + gid;
#pragma unroll
  for (int g = 0; g < kKeys / 8; ++g) {
    uint32_t ah[4], al[4];
    split_tf32(p[4 * g + 0], ah[0], al[0]);
    split_tf32(p[4 * g + 2], ah[1], al[1]);
    split_tf32(p[4 * g + 1], ah[2], al[2]);
    split_tf32(p[4 * g + 3], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      mma_3xtf32(o + 4 * nt, ah, al, vc[8 * g * RS + 8 * nt], vc[(8 * g + 1) * RS + 8 * nt]);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The accumulator layout of both routes (wgmma m64nN and mma.sync m16n8,
// per warp): s[4 i + e] is row 16 w + lane / 4 (+ 8 for e >= 2) and column
// 8 i + 2 (lane % 4) + (e & 1).
//
// The blocks of one (sample, head, 64-row tile) form a cluster of nc =
// ceil(d / 64) blocks along y; block c owns channels [64 c, 64 c + 64) of
// the head: its q' and k chunks (a partial q'k'^T) and its 64 output
// columns. Per key tile the cluster sums the nc partial logit tiles through
// distributed shared memory, as a reduce-scatter and an all-gather: each
// thread keeps its 32 accumulators as 8 float4 groups; block c sums groups
// g = c, c + nc, ... of every thread over all nc partials in the order 0,
// 1, ..., and every block then gathers the 8 sums, so each holds the same
// S. A block reads one chunk of q and 3 chunks per key tile (k twice, v
// once).
//
// Loads: bf16 chunks come by TMA (one thread issues them; they complete on
// the stage's mbarrier, through the async proxy that wgmma reads by, so
// only the legacy pre-scale's stores need a proxy fence); f32 chunks by
// cp.async (mma.sync reads through the generic proxy).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, const T* __restrict__ q,
             const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int t_len, int d, int heads, float scale, float pre) {
  using L = Layout<T>;
  constexpr int S = L::kStages, CB = L::kChunkBytes;
  constexpr bool kTma = sizeof(T) == 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nc = gridDim.y, c = blockIdx.y;
  const int nj = (t_len + kKeys - 1) / kKeys;
  const int ld = heads * d;
  const int64_t bh = blockIdx.z;
  const int b = bh / heads, h = bh % heads;
  const int64_t base = (int64_t)b * t_len * ld + (int64_t)h * d;
  const int r0 = blockIdx.x * kRows, col0 = c * kChunk;
  uint8_t* qs = smem;                                             // q' chunk c
  uint8_t* ring = smem + CB;                                      // S stages
  float4* part = reinterpret_cast<float4*>(ring + S * CB);        // [8][128] partial S
  float4* sums = part + kThreads * 8;                             // [8][128] summed groups
  uint64_t* full = reinterpret_cast<uint64_t*>(sums + kThreads * 8);  // S stages + q
  const bool scaled = pre != 1.f;
  const int n_items = 3 * nj;
  const bool leader = threadIdx.x == 0;
  if constexpr (kTma) {
    if (leader) {
      for (int i = 0; i <= S; ++i) mbar_init(full + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // the chunk stream: pass 1 reads k of every key tile, pass 2 k and v
  auto is_key = [&](int it) { return it < nj || ((it - nj) & 1) == 0; };
  auto issue = [&](int it) {
    if (it < n_items) {
      const int j = it < nj ? it : (it - nj) >> 1;
      uint8_t* dst = ring + (it % S) * CB;
      if constexpr (kTma) {
        if (leader) {
          mbar_expect_tx(full + it % S, CB);
          tma_load(dst, is_key(it) ? &map_k : &map_v, full + it % S, col0, h, j * kKeys, b);
        }
      } else {
        load_chunk<T>(smem_u32(dst), (is_key(it) ? k : v) + base, j * kKeys, col0, t_len, d, ld);
      }
    }
    if constexpr (!kTma) cp_async_commit();
  };
  // the q rows: with the first chunk (cp.async group 0), or on their own
  // mbarrier
  if constexpr (kTma) {
    if (leader) {
      mbar_expect_tx(full + S, CB);
      tma_load(qs, &map_q, full + S, col0, h, r0, b);
    }
  } else {
    load_chunk<T>(smem_u32(qs), q + base, r0, col0, t_len, d, ld);
  }
  for (int it = 0; it < S - 1; ++it) issue(it);
  int it = 0;
  // wait for chunk `it`, pre-scale it if it is k', then refill the stage
  // every thread finished with in the previous step
  auto acquire = [&]() -> const uint8_t* {
    if constexpr (kTma) {
      if (it == 0) mbar_wait(full + S, 0);
      mbar_wait(full + it % S, (it / S) & 1);
    } else {
      cp_async_wait<S - 2>();
    }
    if (scaled) {
      if (it == 0) scale_chunk<T>(qs, pre);
      if (is_key(it)) scale_chunk<T>(ring + (it % S) * CB, pre);
      // the pre-scale's stores, visible to wgmma
      if constexpr (kTma) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    issue(it + S - 1);
    return ring + (it % S) * CB;
  };

  const int lane = threadIdx.x % 32, tig = lane % 4;
  const float kNegInf = neg_inf();
  // logits in base 2: x = s * scale * log2(e), so exp(s * scale - m) =
  // exp2(x - m * log2(e))
  const float scale2 = scale * 1.4426950408889634f;
  float s[32];

  // S of the next key tile, times scale2: this block's partial, then the
  // cluster's sum. `part` is rewritten only after the second barrier of
  // the previous exchange, which every block passes after its last read of
  // it; `sums` only after the first, passed after the last gather.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float4* my_part = part + threadIdx.x;  // group g at [g * 128]: no bank conflicts
  float4* my_sums = sums + threadIdx.x;
  auto logits = [&]() {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    qk_chunk(s, qs, acquire(), q);
    ++it;
    if (nc > 1) {
#pragma unroll
      for (int g = 0; g < 8; ++g)
        my_part[g * kThreads] = make_float4(s[4 * g], s[4 * g + 1], s[4 * g + 2], s[4 * g + 3]);
      cluster.sync();
      for (int g = c; g < 8; g += nc) {
        float4 x[8];  // all loads in flight before the first add
#pragma unroll
        for (int r = 0; r < 8; ++r)
          if (r < nc) x[r] = cluster.map_shared_rank(my_part, r)[g * kThreads];
        float4 acc = x[0];
#pragma unroll
        for (int r = 1; r < 8; ++r)
          if (r < nc) acc.x += x[r].x, acc.y += x[r].y, acc.z += x[r].z, acc.w += x[r].w;
        my_sums[g * kThreads] = acc;
      }
      cluster.sync();
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const float4 x = cluster.map_shared_rank(my_sums, g % nc)[g * kThreads];
        s[4 * g] = x.x, s[4 * g + 1] = x.y, s[4 * g + 2] = x.z, s[4 * g + 3] = x.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale2;
  };

  // pass 1: row max and sum per thread (base 2), then across the row's 4
  // threads
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int j = 0; j < nj; ++j) {
    logits();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = kNegInf;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * i + 2 * r + e];
          if (j * kKeys + 8 * i + 2 * tig + e >= t_len) x = kNegInf;
          mt = fmaxf(mt, x);
        }
      const float mn = fmaxf(m[r], mt);
      if (mn == kNegInf) continue;  // no key of this thread's yet
      float acc = m[r] == kNegInf ? 0.f : l[r] * exp2f(m[r] - mn);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) acc += exp2f(s[4 * i + 2 * r + e] - mn);
      l[r] = acc, m[r] = mn;
    }
  }
  float lse2[2];  // log2 of each row's sum of exp2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mn = fmaxf(m[r], mo);
      l[r] = (m[r] == kNegInf ? 0.f : l[r] * exp2f(m[r] - mn)) +
             (mo == kNegInf ? 0.f : lo * exp2f(mo - mn));
      m[r] = mn;
    }
    lse2[r] = m[r] + log2f(l[r]);
  }
  const int row_a = r0 + 16 * (threadIdx.x / 32) + lane / 4;
  if (lse != nullptr && c == 0 && tig == 0) {  // natural log
    if (row_a < t_len) lse[bh * t_len + row_a] = lse2[0] * 0.6931471805599453f;
    if (row_a + 8 < t_len) lse[bh * t_len + row_a + 8] = lse2[1] * 0.6931471805599453f;
  }

  // pass 2: the weights, rounded to the I/O type, times the v chunk
  float acc_o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_o[i] = 0.f;
  for (int j = 0; j < nj; ++j) {
    logits();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * i + e] = j * kKeys + 8 * i + 2 * tig + (e & 1) < t_len
                           ? exp2f(s[4 * i + e] - lse2[e >> 1]) : 0.f;
    if constexpr (sizeof(T) == 2) {
      uint32_t p[4][4];  // the A fragments of 4 steps of 16 keys
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      pv_chunk(acc_o, p, acquire());
    } else {
      pv_chunk(acc_o, s, acquire());
    }
    ++it;
  }
  if constexpr (!kTma) cp_async_wait<0>();  // the trailing empty groups

  T* oh = o + base;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = col0 + 8 * i + 2 * tig;
    if (col >= d) continue;
    if (row_a < t_len) store2(oh + (int64_t)row_a * ld + col, acc_o[4 * i], acc_o[4 * i + 1]);
    if (row_a + 8 < t_len)
      store2(oh + (int64_t)(row_a + 8) * ld + col, acc_o[4 * i + 2], acc_o[4 * i + 3]);
  }
  if (nc > 1) cluster.sync();  // no block leaves while another reads its sums
}

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 [batch, t_len, heads, d] map (row stride heads * d) with 64 x 64
// boxes of one head's channels, 128-byte swizzled, zero-filled out of bounds
bool bf16_map(CUtensorMap* map, const void* ptr, int batch, int t_len, int heads, int d) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)t_len,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)t_len * heads * d * 2};
  const cuuint32_t box[4] = {kChunk, 1, kKeys, 1}, elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int t_len,
           int ch, int heads, float scale, float pre, cudaStream_t stream) {
  if (heads < 1 || ch % heads != 0 || t_len < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  const int d = ch / heads;
  if (d % 16 != 0 || d > 512 || batch * heads > 65535) return (int)cudaErrorInvalidValue;
  const int nc = (d + kChunk - 1) / kChunk;  // the cluster: at most 8 blocks
  const int smem = (1 + Layout<T>::kStages) * Layout<T>::kChunkBytes + 2 * kThreads * 8 * 16 +
                   8 * (Layout<T>::kStages + 1) + 1024;
  CUtensorMap maps[3] = {};  // unused by the f32 route
  if (sizeof(T) == 2)
    for (int i = 0; i < 3; ++i)
      if (!bf16_map(maps + i, i == 0 ? q : i == 1 ? k : v, batch, t_len, heads, d))
        return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(attn_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((t_len + kRows - 1) / kRows, nc, batch * heads);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = nc;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attn_fwd<T>, maps[0], maps[1], maps[2], static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o),
                           static_cast<float*>(lse), t_len, d, heads, scale, pre);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace fwd


// dtype: 0 = float32, 1 = bfloat16. q, k, v, o are contiguous [batch, t_len, ch],
// 16-byte aligned, ch = heads * d with head h in channels [h*d, (h+1)*d), d a
// multiple of 16 up to 512; lse is a float32 [batch, heads, t_len] output, or
// null. `scale` multiplies the logits and `pre` q and k (rounded to the I/O
// type): scale = d^-0.5, pre = 1 for the DDPM++ flavor; scale = 1, pre =
// d^-0.25 for `legacy_scale`.
extern "C" int asyrp_attention(const void* q, const void* k, const void* v, void* o, void* lse,
                               int batch, int t_len, int ch, int heads, float scale, float pre,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd::launch<float>(q, k, v, o, lse, batch, t_len, ch, heads, scale, pre, s);
  if (dtype == 1)
    return fwd::launch<__nv_bfloat16>(q, k, v, o, lse, batch, t_len, ch, heads, scale, pre, s);
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
