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
//   - Grid (ceil(Tq/64), nc, B*H), nc = ceil(d/64). One warpgroup (128
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
//     shuffles) give lse. Keys past Tk are -inf.
//   - Tq may differ from Tk (`asyrp_attention_kv`): under spatial sharding a
//     rank's queries are its rows of the image (Tq = T / S), its keys and
//     values those of the whole image (Tk = T, gathered along the token
//     axis). q and o have their own length and tensor map, k and v theirs;
//     the row tiles cover Tq, the key tiles (the cluster exchange and the
//     softmax) Tk.
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
// Backward (K2-bwd; replaces the gradient XLA derives for `models/common.py`
// `spatial_attention`, formerly the Pallas kernel's `jax.custom_vjp`
// backward, `ops/attention.py:98-125` at 4b63bc3^), from the forward's lse
// and output, per (sample, head): q' = rnd(q*pre) and k' = rnd(k*pre) as in
// the forward, S = q'k'^T * scale, P = exp(S - lse), D = rowsum(dO o O) over
// the head's d columns only, dP = rnd(dO v^T), dS = P o (dP - D), and
//   dV = rnd(P)^T dO,  dQ = pre * rnd(scale * dS k'),  dK = pre * rnd(scale * dS^T q').
// rnd() rounds to the I/O type, as in the reference's rounding: dP is the
// gradient of the weights' cast, P is cast to v's type before weights x v,
// and with `legacy_scale` the cotangent of q' (k') is rounded before the
// multiply by pre, as the product q * pre in the I/O type differentiates.
// dS stays f32, as XLA multiplies the f32 cotangent of its f32-accumulated
// product by the bf16 k' and q'.
//
// Kernels: `attn_bwd_d` (D, one warp per query row) and `attn_bwd`, which
// is FlashAttention-2's split in one launch: grid (2 * ceil(T/64), nc, B*H),
// nc = ceil(d/64), one warpgroup (128 threads) per block. The first
// ceil(T/64) blocks along x own 64 keys (wgmma's M) of dK and dV, the rest 64
// queries of dQ; blockIdx.y picks the block's 64 output channels (chunk c).
// A block walks the other side's 64-row tiles; per tile it sums two 64 x 64
// products over all nc channel chunks of the head, X = A1 B1^T and Y =
// A2 B2^T (dK/dV blocks: X = S^T from k' and q', Y = dP^T from v and dO; dQ
// blocks: X = S, Y = dP), forms P and dS in registers (lse and D by column
// or by row), then accumulates in registers dV += rnd(P)^T dO and
// dK += dS^T q' (dQ: dQ += dS k') over its 64 channels, reading the tile's
// chunk c. Each output element is written by one thread of one block, with
// no atomics: the backward is deterministic run to run. S and dP are
// computed twice (by the dK/dV and the dQ blocks), and at d = 512 by each of
// the 8 channel blocks: no exchange between blocks (the forward's cluster
// exchange took 57% of a one-head block's cycles, and the backward would
// need two per tile). `attn_bwd` is a programmatic dependent launch: its
// blocks start while `attn_bwd_d` runs and wait for it before they read D.
//   - Tq may differ from Tk (`asyrp_attention_bwd_kv`, the gradient of
//     `asyrp_attention_kv`): the grid is (ceil(Tk/64) + ceil(Tq/64), nc,
//     B*H); the dK/dV blocks walk ceil(Tq/64) query tiles, the dQ blocks
//     ceil(Tk/64) key tiles; D, lse and the q, o, dO and dq rows run over
//     Tq, the k, v, dk and dv rows over Tk, each side with its own tensor
//     maps (zero past its length) and row bounds. dK and dV are then what
//     this call's Tq queries give to every key: under spatial sharding the
//     adjoint of the K/V gather sums the ranks' parts (not folded in here).
//   - Loads: A1 and A2 (the block's own rows) and B1 and B2 (the tile's).
//     bf16: the block's A1, A2 chunks (all nc of each) stay resident, and a
//     ring of 4 stages, 3 ahead, holds the tile's B1, B2 chunks of one
//     channel chunk each, by TMA over [B, T, H, d] tensor maps (zero past T
//     and d). f32 (2 * nc chunks of 17 KB would not fit): 3 stages, 2
//     ahead, each the A1, B1, A2, B2 chunks, by cp.async into padded rows.
//     A tile's chunks come in the order c + 1, ..., c, so the chunk the
//     output products read is the tile's last stage, still in place. The
//     legacy pre-scale rounds A1 and B1 (q' and k') in shared memory after
//     they land.
//   - bf16: wgmma m64n64k16 for all four products (f32 accumulators). X and
//     Y read K-major chunks; the output products take P, dS from registers
//     (the accumulator layout repacked as the A fragment, as the forward
//     feeds P) and an MN-major chunk. dS goes in as two bf16 halves, hi =
//     rnd(dS) and lo = rnd(dS - hi), two wgmmas into one accumulator: about
//     16 bits of dS, where one bf16 operand would add a rounding the
//     reference does not have.
//   - f32: 3xTF32 on mma.sync from padded rows, a fresh accumulator per
//     8-deep step (the forward's helpers).
// Bound: one head at [1, 256, 512] moves 8*T*C elements plus lse and D (2.1
// MB in bf16: 0.63 us at 3.35 TB/s) and does 10*T*T*C = 335 MFLOP (0.34 us
// on the bf16 tensor cores; 5.0 us on the f32 CUDA cores): bytes bound in
// bf16, operations bound in f32. The design puts every product on the
// tensor cores and keeps P, dP and dS in registers; what it spends is the
// recomputed S and dP (per tile a d = 512 dK/dV block does 16 chunk
// products for S^T and dP^T against 2 for its outputs), and the serial
// chain of one warpgroup per tile (wait, products, P and dS, products: no
// overlap between them), which leaves it slower than SDPA's backward at 8
// heads and T >= 1024.
// Dynamic shared memory, whatever T: bf16 2 * nc resident chunks and 4
// stages of 2 (8 KB each), f32 3 stages of 4 (17 KB each), the mbarriers,
// 512 bytes of lse and D, 1 KB of alignment: 82 KB at d = 64 and 194 KB at
// d = 512 in bf16, 206 KB in f32.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
// bf16: pre is a bf16 value (the wrapper rounds it), so the product of two
// bf16 values is exact in f32 and mul.rn.bf16x2 rounds it as rnd(x * pre)
__device__ __forceinline__ void scale16(__nv_bfloat16* p, float pre) {
  uint4 x = *reinterpret_cast<uint4*>(p);
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
  const __nv_bfloat162 s = __float2bfloat162_rn(pre);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __hmul2(h[i], s);
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
             float* __restrict__ lse, int tq, int tk, int d, int heads, float scale, float pre) {
  using L = Layout<T>;
  constexpr int S = L::kStages, CB = L::kChunkBytes;
  constexpr bool kTma = sizeof(T) == 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nc = gridDim.y, c = blockIdx.y;
  const int nj = (tk + kKeys - 1) / kKeys;
  const int ld = heads * d;
  const int64_t bh = blockIdx.z;
  const int b = bh / heads, h = bh % heads;
  // the head's columns of this sample: of q and o (tq rows), of k and v (tk)
  const int64_t base = (int64_t)b * tq * ld + (int64_t)h * d;
  const int64_t kv_base = (int64_t)b * tk * ld + (int64_t)h * d;
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
        load_chunk<T>(smem_u32(dst), (is_key(it) ? k : v) + kv_base, j * kKeys, col0, tk, d, ld);
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
    load_chunk<T>(smem_u32(qs), q + base, r0, col0, tq, d, ld);
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
          if (j * kKeys + 8 * i + 2 * tig + e >= tk) x = kNegInf;
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
    if (row_a < tq) lse[bh * tq + row_a] = lse2[0] * 0.6931471805599453f;
    if (row_a + 8 < tq) lse[bh * tq + row_a + 8] = lse2[1] * 0.6931471805599453f;
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
        s[4 * i + e] = j * kKeys + 8 * i + 2 * tig + (e & 1) < tk
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
    if (row_a < tq) store2(oh + (int64_t)row_a * ld + col, acc_o[4 * i], acc_o[4 * i + 1]);
    if (row_a + 8 < tq)
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
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int tq,
           int tk, int ch, int heads, float scale, float pre, cudaStream_t stream) {
  if (heads < 1 || ch % heads != 0 || tq < 1 || tk < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  const int d = ch / heads;
  if (d % 16 != 0 || d > 512 || batch * heads > 65535) return (int)cudaErrorInvalidValue;
  const int nc = (d + kChunk - 1) / kChunk;  // the cluster: at most 8 blocks
  const int smem = (1 + Layout<T>::kStages) * Layout<T>::kChunkBytes + 2 * kThreads * 8 * 16 +
                   8 * (Layout<T>::kStages + 1) + 1024;
  CUtensorMap maps[3] = {};  // unused by the f32 route
  if (sizeof(T) == 2)
    for (int i = 0; i < 3; ++i)
      if (!bf16_map(maps + i, i == 0 ? q : i == 1 ? k : v, batch, i == 0 ? tq : tk, heads, d))
        return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(attn_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tq + kRows - 1) / kRows, nc, batch * heads);
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
                           static_cast<float*>(lse), tq, tk, d, heads, scale, pre);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace fwd

namespace bwd {

using fwd::kChunk;
using fwd::kRows;
using fwd::kThreads;
using fwd::Layout;
using fwd::smem_u32;

constexpr int kDThreads = 256;  // attn_bwd_d: one warp per query row

// bf16: the block's own rows (A1, A2: all nc chunks of each) stay resident
// and a stage holds the tile's B1, B2 chunks; f32 (17 KB chunks, 2 * 8 of
// them would not fit) streams all four per stage
template <typename T>
struct Ring;
template <>
struct Ring<__nv_bfloat16> {
  static constexpr bool kResident = true;
  static constexpr int kChunks = 2, kStages = 4;
};
template <>
struct Ring<float> {
  static constexpr bool kResident = false;
  static constexpr int kChunks = 4, kStages = 3;
};

// dynamic shared memory: the ring, the resident chunks, one mbarrier per
// stage and one for the resident chunks, the tile's lse and D (2 x 64 f32),
// and 1 KB of alignment
template <typename T>
__host__ __device__ constexpr int smem_bytes(int nc) {
  return ((Ring<T>::kResident ? 2 * nc : 0) + Ring<T>::kStages * Ring<T>::kChunks) *
             Layout<T>::kChunkBytes +
         8 * (Ring<T>::kStages + 1) + 2 * kRows * 4 + 1024;
}

__device__ __forceinline__ float load_f(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
// 2^x, one MUFU instruction (results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D[b, h, i] = sum over the head's d columns of dO[b, i, .] * O[b, i, .];
// one warp per (sample, head, query row)
template <typename T>
__global__ void attn_bwd_d(const T* __restrict__ o, const T* __restrict__ d_o,
                           float* __restrict__ d, int64_t n_rows, int t_len, int ch, int heads) {
  // the backward kernel may start now; it waits for D where it reads it
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int64_t row = (int64_t)blockIdx.x * (kDThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const int64_t bh = row / t_len, i = row % t_len;
  const int64_t at = ((bh / heads) * t_len + i) * heads * ch + (bh % heads) * ch;
  float s = 0.f;
  for (int c = lane; c < ch; c += 32) s += load_f(d_o, at + c) * load_f(o, at + c);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) d[row] = s;
}

// X += A1 B1^T and Y += A2 B2^T over one 64-channel chunk. bf16: one
// group of wgmmas, all operands K-major.
__device__ __forceinline__ void xy_chunk(float (&x)[32], float (&y)[32], const uint8_t* a1,
                                         const uint8_t* b1, const uint8_t* a2, const uint8_t* b2,
                                         const __nv_bfloat16*) {
  const uint32_t sa1 = smem_u32(a1), sb1 = smem_u32(b1), sa2 = smem_u32(a2), sb2 = smem_u32(b2);
  fwd::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    fwd::wgmma_ss(x, fwd::gmma_desc(sa1 + 32 * kk, 16), fwd::gmma_desc(sb1 + 32 * kk, 16));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    fwd::wgmma_ss(y, fwd::gmma_desc(sa2 + 32 * kk, 16), fwd::gmma_desc(sb2 + 32 * kk, 16));
  fwd::wgmma_commit();
  fwd::wgmma_wait();
  fwd::reg_fence(x);
  fwd::reg_fence(y);
}
// f32: 3xTF32 mma.sync
__device__ __forceinline__ void xy_chunk(float (&x)[32], float (&y)[32], const uint8_t* a1,
                                         const uint8_t* b1, const uint8_t* a2, const uint8_t* b2,
                                         const float*) {
  const float* tag = nullptr;
  fwd::qk_chunk(x, a1, b1, tag);
  fwd::qk_chunk(y, a2, b2, tag);
}

// the accumulator layout repacked as wgmma's A fragments (4 steps of 16
// columns), rounded to bf16; `lo` gets what that rounding dropped, rounded
// again
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = fwd::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}
__device__ __forceinline__ void pack_hi_lo(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                           const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = s[8 * kk + 2 * r], b = s[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 f = __bfloat1622float2(h);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = fwd::pack_bf16(a - f.x, b - f.y);
    }
}
// d += A B: A from registers (64 rows x 64 tile rows), B the MN-major chunk
// at shared address `b` (tile rows x 64 channels); issued, not waited for
__device__ __forceinline__ void rs_issue(float (&d)[32], const uint32_t (&a)[4][4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    fwd::wgmma_rs(d, a[kk], fwd::gmma_desc(b + 2048 * kk, kRows * 128));
}

// P and dS in place of X and Y, for one tile. dK/dV blocks (KV): lse (base
// 2) and D by column, from `vals` (64 of each); dQ blocks: by row, this
// thread's two rows. kMask: the tile is ragged, columns from `cols` on have
// P = 0.
template <bool KV, bool kMask, typename T>
__device__ __forceinline__ void p_and_ds(float (&x)[32], float (&y)[32], const float* vals,
                                         const float (&lse_r)[2], const float (&d_r)[2],
                                         float scale2, int cols, const T* tag) {
  const int tig = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 8 * i + 2 * tig + e;
      const bool valid = !kMask || j < cols;
      const float l_col = KV ? vals[j] : 0.f, d_col = KV ? vals[kRows + j] : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& xs = x[4 * i + 2 * r + e];
        float& ys = y[4 * i + 2 * r + e];
        const float p = valid ? ex2(fmaf(xs, scale2, -(KV ? l_col : lse_r[r]))) : 0.f;
        ys = p * (round_to(ys, tag) - (KV ? d_col : d_r[r]));
        xs = p;
      }
    }
}

// The output products of one tile, from X = P (or P^T), Y = dS (or dS^T)
// and the tile's chunks B1, B2 of the block's channels: dK/dV blocks acc1
// (dV) += rnd(P) B2 and acc2 (dK) += dS B1; dQ blocks acc1 (dQ) += dS B1.
__device__ __forceinline__ void out_products(bool kv, float (&acc1)[32], float (&acc2)[32],
                                             const float (&x)[32], const float (&y)[32],
                                             const uint8_t* b1, const uint8_t* b2,
                                             const __nv_bfloat16*) {
  uint32_t hi[4][4], lo[4][4];
  pack_hi_lo(hi, lo, y);
  if (kv) {
    uint32_t p[4][4];
    pack_a(p, x);
    fwd::wgmma_fence();
    rs_issue(acc1, p, smem_u32(b2));
    rs_issue(acc2, hi, smem_u32(b1));
    rs_issue(acc2, lo, smem_u32(b1));
  } else {
    fwd::wgmma_fence();
    rs_issue(acc1, hi, smem_u32(b1));
    rs_issue(acc1, lo, smem_u32(b1));
  }
  fwd::wgmma_commit();
  fwd::wgmma_wait();
  fwd::reg_fence(acc1);
  fwd::reg_fence(acc2);
}
__device__ __forceinline__ void out_products(bool kv, float (&acc1)[32], float (&acc2)[32],
                                             const float (&x)[32], const float (&y)[32],
                                             const uint8_t* b1, const uint8_t* b2, const float*) {
  if (kv) {
    fwd::pv_chunk(acc1, x, b2);
    fwd::pv_chunk(acc2, y, b1);
  } else {
    fwd::pv_chunk(acc1, y, b1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    attn_bwd(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
             const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ d_o, const float* __restrict__ lse,
             const float* __restrict__ dd, T* __restrict__ dq, T* __restrict__ dk,
             T* __restrict__ dv, int tq, int tk, int d, int heads, float scale, float pre) {
  using L = Layout<T>;
  constexpr bool kRes = Ring<T>::kResident;
  constexpr int S = Ring<T>::kStages, CB = L::kChunkBytes, SB = Ring<T>::kChunks * CB;
  constexpr bool kTma = sizeof(T) == 2;
  static_assert(!kRes || kTma, "resident chunks come by TMA");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nc = gridDim.y, c = blockIdx.y, col0 = c * kChunk;
  uint8_t* res = smem + S * SB;  // resident: A1 chunks 0..nc-1, then A2 chunks
  uint64_t* full = reinterpret_cast<uint64_t*>(res + (kRes ? 2 * nc * CB : 0));  // S + 1
  float* tile_vals = reinterpret_cast<float*>(full + S + 1);  // the tile's lse (base 2), D
  // the first ceil(tk/64) blocks own 64 keys each, the rest 64 queries; a
  // block walks the other side's tiles (queries for keys, keys for queries)
  const int nt_k = (tk + kRows - 1) / kRows;
  const bool kv = blockIdx.x < nt_k;  // dK/dV block (rows: keys), else dQ (rows: queries)
  const int r0 = (kv ? blockIdx.x : blockIdx.x - nt_k) * kRows;
  const int own_len = kv ? tk : tq, tile_len = kv ? tq : tk;
  const int nt = (tile_len + kRows - 1) / kRows;
  const int ld = heads * d;
  const int64_t bh = blockIdx.z;
  const int b = bh / heads, h = bh % heads;
  // the head's columns of this sample: of q, o, dO (tq rows), of k, v (tk)
  const int64_t base_q = (int64_t)b * tq * ld + (int64_t)h * d;
  const int64_t base_k = (int64_t)b * tk * ld + (int64_t)h * d;
  const float* lse_bh = lse + bh * tq;
  const float* d_bh = dd + bh * tq;
  const bool scaled = pre != 1.f;
  const bool leader = threadIdx.x == 0;
  const int n_items = nt * nc;
  if constexpr (kTma) {
    if (leader) {
      for (int i = 0; i <= S; ++i) fwd::mbar_init(full + i, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // the operands: A1 (this block's rows, pre-scaled), B1 (the tile's rows,
  // pre-scaled), A2 (this block's rows), B2 (the tile's rows); the even
  // ones are of the block's own side, the odd ones of the tile's
  auto keys_of = [&](int s) { return kv == ((s & 1) == 0); };  // k or v, not q or dO
  auto map_of = [&](int s) -> const CUtensorMap* {
    if (s == 0) return kv ? &map_k : &map_q;
    if (s == 1) return kv ? &map_q : &map_k;
    if (s == 2) return kv ? &map_v : &map_do;
    return kv ? &map_do : &map_v;
  };
  auto src_of = [&](int s) -> const T* {
    if (s == 0) return kv ? k : q;
    if (s == 1) return kv ? q : k;
    if (s == 2) return kv ? v : d_o;
    return kv ? d_o : v;
  };
  if constexpr (kTma) {
    if (leader)
      for (int s = 0; s < 4; ++s)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map_of(s)))
                     : "memory");
  }
  // the resident chunks (bf16), on their own mbarrier
  if constexpr (kRes) {
    if (leader) {
      fwd::mbar_expect_tx(full + S, 2 * nc * CB);
      for (int cc = 0; cc < nc; ++cc) {
        fwd::tma_load(res + cc * CB, map_of(0), full + S, cc * kChunk, h, r0, b);
        fwd::tma_load(res + (nc + cc) * CB, map_of(2), full + S, cc * kChunk, h, r0, b);
      }
    }
  }
  // item `it`: tile it / nc, channel chunk (c + 1 + it % nc) % nc; its
  // stage holds B1, B2 (resident) or A1, B1, A2, B2 (streamed)
  auto chunk_of = [&](int i) { return (c + 1 + i % nc) % nc; };
  auto issue = [&](int i) {
    if (i < n_items) {
      const int t0 = i / nc * kRows, cc = chunk_of(i);
      uint8_t* dst = smem + (i % S) * SB;
      if constexpr (kTma) {
        if (leader) {
          fwd::mbar_expect_tx(full + i % S, SB);
#pragma unroll
          for (int s = kRes ? 1 : 0, slot = 0; s < 4; s += kRes ? 2 : 1, ++slot)
            fwd::tma_load(dst + slot * CB, map_of(s), full + i % S, cc * kChunk, h,
                          (s & 1) ? t0 : r0, b);
        }
      } else {
#pragma unroll
        for (int s = 0; s < 4; ++s)
          fwd::load_chunk<T>(smem_u32(dst + s * CB), src_of(s) + (keys_of(s) ? base_k : base_q),
                             (s & 1) ? t0 : r0, cc * kChunk, keys_of(s) ? tk : tq, d, ld);
      }
    }
    if constexpr (!kTma) fwd::cp_async_commit();
  };
  for (int i = 0; i < S - 1; ++i) issue(i);
  int it = 0;
  struct Ops {
    const uint8_t *a1, *b1, *a2, *b2;
  };
  // wait for item `it`, pre-scale its q' and k' chunks (and, first, the
  // resident A1), then refill the stage every thread finished with in the
  // previous step
  auto acquire = [&]() -> Ops {
    uint8_t* st = smem + (it % S) * SB;
    const int cc = chunk_of(it);
    if constexpr (kTma) {
      if (kRes && it == 0) fwd::mbar_wait(full + S, 0);
      fwd::mbar_wait(full + it % S, (it / S) & 1);
    } else {
      fwd::cp_async_wait<S - 2>();
    }
    if (scaled) {
      if (kRes && it == 0)
        for (int i = 0; i < nc; ++i) fwd::scale_chunk<T>(res + i * CB, pre);
      fwd::scale_chunk<T>(st + (kRes ? 0 : CB), pre);  // B1
      if (!kRes) fwd::scale_chunk<T>(st, pre);          // A1
      // the pre-scale's stores, visible to wgmma
      if constexpr (kTma) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    issue(it + S - 1);
    ++it;
    if constexpr (kRes) return {res + cc * CB, st, res + (nc + cc) * CB, st + CB};
    return {st, st + CB, st + 2 * CB, st + 3 * CB};
  };

  const int lane = threadIdx.x % 32, tig = lane % 4;
  const int row_a = r0 + 16 * (threadIdx.x / 32) + lane / 4;
  // exp(s * scale - lse) = exp2(s * scale2 - lse * log2(e))
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = scale * kLog2e;
  // dQ blocks: lse (base 2) and D of this thread's two rows (D once the
  // grid that writes it is done, below)
  float lse_r[2] = {0.f, 0.f}, d_r[2] = {0.f, 0.f};
  if (!kv) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row_a + 8 * r < tq) lse_r[r] = lse_bh[row_a + 8 * r] * kLog2e;
  }
  float acc1[32], acc2[32], x[32], y[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc1[i] = acc2[i] = 0.f;
  for (int t = 0; t < nt; ++t) {
    const int t0 = t * kRows;
    // dK/dV blocks: the tile's lse and D by column, loaded now, read after
    // the products below (thread i < 64: lse of query t0 + i; else its D)
    const int vi = t0 + (threadIdx.x & 63);
    const bool v_ok = kv && vi < tq;
    float col_val = 0.f;
    if (v_ok && (threadIdx.x < 64 || t > 0)) col_val = (threadIdx.x < 64 ? lse_bh : d_bh)[vi];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = y[i] = 0.f;
    Ops ops;
    for (int s = 0; s < nc; ++s) {
      ops = acquire();
      xy_chunk(x, y, ops.a1, ops.b1, ops.a2, ops.b2, q);
    }
    if (t == 0) {
      // D comes from attn_bwd_d, which this grid's start overlaps
      // (programmatic dependent launch): wait for it before the first read
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      if (v_ok && threadIdx.x >= 64) col_val = d_bh[vi];
      if (!kv) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row_a + 8 * r < tq) d_r[r] = d_bh[row_a + 8 * r];
      }
    }
    // every thread has passed this tile's first acquire, so the last tile's
    // reads of tile_vals are done
    if (kv) {
      tile_vals[threadIdx.x] = threadIdx.x < 64 ? col_val * kLog2e : col_val;
      __syncthreads();
    }
    // P and dS in place of X and Y; columns past the tile side's length have P = 0
    const int cols = tile_len - t0;
    if (kv) {
      if (cols < kRows) p_and_ds<true, true>(x, y, tile_vals, lse_r, d_r, scale2, cols, q);
      else p_and_ds<true, false>(x, y, tile_vals, lse_r, d_r, scale2, cols, q);
    } else {
      if (cols < kRows) p_and_ds<false, true>(x, y, tile_vals, lse_r, d_r, scale2, cols, q);
      else p_and_ds<false, false>(x, y, tile_vals, lse_r, d_r, scale2, cols, q);
    }
    out_products(kv, acc1, acc2, x, y, ops.b1, ops.b2, q);
  }
  if constexpr (!kTma) fwd::cp_async_wait<0>();  // the trailing empty groups

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = col0 + 8 * i + 2 * tig;
    if (col >= d) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row >= own_len) continue;
      const int64_t at = (kv ? base_k : base_q) + (int64_t)row * ld + col;
      const float a0 = acc1[4 * i + 2 * r], a1 = acc1[4 * i + 2 * r + 1];
      // the cotangent of q' (k') is rounded to the I/O type before the pre-scale
      if (kv) {
        fwd::store2(dv + at, a0, a1);
        fwd::store2(dk + at, round_to(acc2[4 * i + 2 * r] * scale, q) * pre,
                    round_to(acc2[4 * i + 2 * r + 1] * scale, q) * pre);
      } else {
        fwd::store2(dq + at, round_to(a0 * scale, q) * pre, round_to(a1 * scale, q) * pre);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* d_o,
           const void* lse, void* dd, void* dq, void* dk, void* dv, int batch, int tq, int tk,
           int ch, int heads, float scale, float pre, cudaStream_t stream) {
  if (heads < 1 || ch % heads != 0 || tq < 1 || tk < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  const int d = ch / heads;
  if (d % 16 != 0 || d > 512 || batch * heads > 65535) return (int)cudaErrorInvalidValue;
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k);
  const T *vt = static_cast<const T*>(v), *dot = static_cast<const T*>(d_o);
  float* df = static_cast<float*>(dd);
  // D over the tq query rows
  const int64_t n_rows = (int64_t)batch * heads * tq;
  constexpr int rows_per_block = kDThreads / 32;
  attn_bwd_d<T><<<(unsigned)((n_rows + rows_per_block - 1) / rows_per_block), kDThreads, 0,
                  stream>>>(static_cast<const T*>(o), dot, df, n_rows, tq, d, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int nc = (d + kChunk - 1) / kChunk;
  const int smem = smem_bytes<T>(nc);
  CUtensorMap maps[4] = {};  // q, k, v, dO; unused by the f32 route
  if (sizeof(T) == 2) {
    // q and dO over their tq rows, k and v over their tk
    const void* ptrs[4] = {q, k, v, d_o};
    for (int i = 0; i < 4; ++i)
      if (!fwd::bf16_map(maps + i, ptrs[i], batch, (i == 1 || i == 2) ? tk : tq, heads, d))
        return (int)cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(attn_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nt_q = (tq + kRows - 1) / kRows, nt_k = (tk + kRows - 1) / kRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nt_k + nt_q, nc, batch * heads);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  // programmatic dependent launch: the blocks start while attn_bwd_d runs
  // and wait for it (griddepcontrol.wait) before they read D
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attn_bwd<T>, maps[0], maps[1], maps[2], maps[3], qt, kt, vt, dot,
                           static_cast<const float*>(lse), static_cast<const float*>(df),
                           static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), tq,
                           tk, d, heads, scale, pre);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace bwd

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
    return fwd::launch<float>(q, k, v, o, lse, batch, t_len, t_len, ch, heads, scale, pre, s);
  if (dtype == 1)
    return fwd::launch<__nv_bfloat16>(q, k, v, o, lse, batch, t_len, t_len, ch, heads, scale,
                                      pre, s);
  return (int)cudaErrorInvalidValue;
}

// The forward with queries of another length than the keys (a rank's rows
// of a spatially sharded image against the whole image's keys and values):
// q and o are [batch, tq, ch], k and v [batch, tk, ch], lse [batch, heads,
// tq]; otherwise as `asyrp_attention`.
extern "C" int asyrp_attention_kv(const void* q, const void* k, const void* v, void* o,
                                  void* lse, int batch, int tq, int tk, int ch, int heads,
                                  float scale, float pre, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd::launch<float>(q, k, v, o, lse, batch, tq, tk, ch, heads, scale, pre, s);
  if (dtype == 1)
    return fwd::launch<__nv_bfloat16>(q, k, v, o, lse, batch, tq, tk, ch, heads, scale, pre, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: q, k, v, o (the forward's output), d_o and the outputs dq,
// dk, dv are contiguous in the I/O dtype, q, o, d_o and dq [batch, tq, ch],
// k, v, dk and dv [batch, tk, ch], ch = heads * d with head h in channels
// [h*d, (h+1)*d); lse is the forward's float32 [batch, heads, tq]; d is
// float32 [batch, heads, tq] scratch. With tq != tk (a rank's rows of a
// spatially sharded image, the gradient of `asyrp_attention_kv`) dk and dv
// are what these tq queries give to the tk keys. `scale` and `pre` as for
// the forward.
extern "C" int asyrp_attention_bwd_kv(const void* q, const void* k, const void* v,
                                      const void* o, const void* d_o, const void* lse, void* d,
                                      void* dq, void* dk, void* dv, int batch, int tq, int tk,
                                      int ch, int heads, float scale, float pre, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd::launch<float>(q, k, v, o, d_o, lse, d, dq, dk, dv, batch, tq, tk, ch, heads,
                              scale, pre, s);
  if (dtype == 1)
    return bwd::launch<__nv_bfloat16>(q, k, v, o, d_o, lse, d, dq, dk, dv, batch, tq, tk, ch,
                                      heads, scale, pre, s);
  return (int)cudaErrorInvalidValue;
}
