// K3, the asymmetric DDIM step, with its backward (K3-bwd), and the DDPM
// ancestral step, for Hopper (sm_90a). Elementwise passes in f32 whatever
// the I/O dtype (float32 or bfloat16).
//
// Replaces: the JAX functions `core/ddim.py` `ddim_step` (and the gradient
// XLA derives for it) and `ddpm_step`, which XLA fused on the TPU (no
// Pallas kernel). Math, per element, with a = alpha-bar at t, a' = alpha-bar
// at t_next and eta per sample:
//   x0_t   = (x - eps_mod * sqrt(1 - a)) / sqrt(a)
//   c1     = eta * sqrt(max((1 - a / a') * (1 - a') / (1 - a), 0))
//   c2     = sqrt(max((1 - a') - c1 * c1, 0))
//   x_next = sqrt(a') * x0_t + c2 * eps + c1 * noise
//            (sqrt(a') * x0_t + sqrt(1 - a') * eps * dt_lambda where the
//            sample's apply_dt > 0)
// The backward, from the cotangents g_x_next and g_x0_t (either absent):
//   gx0        = g_x0_t + sqrt(a') * g_x_next;   dx = gx0 / sqrt(a)
//   d eps_mod  = (-sqrt(1 - a) / sqrt(a)) * gx0
//   d eps      = c2 * g_x_next   (sqrt(1 - a') * dt_lambda where apply_dt)
// writing only the gradients asked for. The DDPM step, with b_t, a_t and t
// per sample and logvar per element or per sample:
//   out = 1 / sqrt(1 - b_t) * (x - b_t / sqrt(1 - a_t) * eps)
//         + [t != 0] * exp(logvar / 2) * noise
// Every product and sum rounds where the plain PyTorch version's separate
// ops round (__fmul_rn / __fadd_rn: no contraction into FMAs); sqrtf,
// division and expf are IEEE (no fast math).
//
// Bound: device-memory bytes. Each input element is read once and each
// output written once, with a few dozen FLOPs; nothing is reused.
//
// Design: one launch per call, grid (chunks of a sample, sample). A block's
// sample is blockIdx.y: its thread 0 computes the sample's constants (the
// square roots, c1, c2, the dt override) once, into shared memory, while
// every thread's loads are in flight, and no element divides an integer.
// Per-sample operands are read in place, through a pointer and a
// per-sample stride (0 for a [1] tensor, 1 for [B]), or passed by value.
// Three instances per pair of dtypes; the wrapper picks one, and the entry
// checks that its layout and alignment hold:
//   flat:   eps (eps_mod, a per-element logvar) contiguous like x: each
//           thread moves one 16-byte vector per operand, 4 f32 or 8 bf16
//           elements (8 when either dtype is bf16: two f32 vectors);
//   rows:   eps and eps_mod the first C = 3 channels of a learn_sigma
//           model's [B, H, W, 2C] output: a block takes a tile of 256
//           pixels; its thread 0 brings the tile's x, noise and full
//           2C-channel rows of eps and eps_mod into shared memory by bulk
//           copies (TMA) on one mbarrier (the 32-byte sectors hold both
//           halves of the rows anyway, so reading them whole costs no extra
//           device-memory traffic), each thread computes its pixels from
//           shared memory, and the block writes the tile's outputs back
//           with 16-byte stores; the DDPM step takes eps and the learned
//           log-variance from the same rows;
//   scalar: any other layout or alignment: one row (pixel) per thread,
//           element by element through the row strides.
// eps_mod that is eps itself is read once. Flat and scalar blocks have 256
// threads, halved (down to 64) while the grid has fewer than two blocks
// per SM of the 132; a rows block has 256 threads, one pixel each.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

enum Mode { kScalar = 0, kFlat = 1, kRows = 2 };
constexpr int kRowC = 3;  // the rows instance: the first 3 channels of rows of 6
constexpr int kRowR = 6;
constexpr int kTilePx = 256;      // the rows instance: pixels per block
constexpr int kTileThreads = 256;  // one pixel each
constexpr int kTileAlign = 8;     // rows per sample a multiple of this: whole 16-byte tiles
constexpr int kMaxThreads = 256;
constexpr int kMinThreads = 64;
constexpr int64_t kFillBlocks = 264;  // two blocks per SM on 132 SMs

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// the plain version's separate ops, each rounded (no FMA contraction)
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
// torch.clamp(v, min=0): NaN stays NaN
__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }

// elements per thread in the flat instance: one 16-byte vector of the
// narrower dtype
template <typename TA, typename TB>
__host__ __device__ constexpr int flat_n() {
  return sizeof(TA) == 4 && sizeof(TB) == 4 ? 4 : 8;
}

// N elements of T as 16-byte vectors in registers
template <typename T, int N>
struct Vecs {
  static constexpr int kPer = 16 / (int)sizeof(T);
  static_assert(N % kPer == 0, "whole 16-byte vectors");
  static constexpr int kN = N / kPer;
  uint4 r[kN];

  __device__ __forceinline__ void load(const T* p) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < kN; ++k) r[k] = __ldg(q + k);
  }
  __device__ __forceinline__ void store(T* p) const {
    uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int k = 0; k < kN; ++k) q[k] = r[k];
  }
  __device__ __forceinline__ void unpack(float (&f)[N]) const {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const uint32_t w[4] = {r[k].x, r[k].y, r[k].z, r[k].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (std::is_same<T, float>::value) {
          f[k * 4 + j] = __uint_as_float(w[j]);
        } else {
          f[k * 8 + 2 * j] = __uint_as_float(w[j] << 16);
          f[k * 8 + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
        }
      }
    }
  }
  __device__ __forceinline__ void pack(const float (&f)[N]) {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (std::is_same<T, float>::value) {
          w[j] = __float_as_uint(f[k * 4 + j]);
        } else {
          w[j] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[k * 8 + 2 * j])) |
                 ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[k * 8 + 2 * j + 1])) << 16);
        }
      }
      r[k] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
};

// ---------------------------------------------------------------------------
// bulk copies (TMA) into shared memory, completing on an mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// `bytes` (a multiple of 16) from shared memory to device memory, by the
// block's threads in 16-byte stores
__device__ __forceinline__ void tile_store(void* dst, const void* src, int bytes) {
  uint4* d = static_cast<uint4*>(dst);
  const uint4* q = static_cast<const uint4*>(src);
  for (int v = threadIdx.x; v < bytes / 16; v += blockDim.x) d[v] = q[v];
}

// a per-sample f32 operand: p[s * stride], or v where p is null
struct Coef {
  const float* p;
  int64_t stride;
  float v;
  __device__ __forceinline__ float at(int64_t s) const {
    return p != nullptr ? __ldg(p + s * stride) : v;
  }
};

// ---------------------------------------------------------------------------
// K3 and K3-bwd
// ---------------------------------------------------------------------------

struct DdimCoefs {
  Coef at, at_next, eta, use_dt;  // use_dt: read only with has_dt
  float dt_lambda;
  int has_dt;
};

struct DdimConst {
  float sa, s1a, san, s1an;  // sqrt(a), sqrt(1 - a), sqrt(a'), sqrt(1 - a')
  float c1, c2;
  float k_em;   // d x0_t / d eps_mod = -sqrt(1 - a) / sqrt(a)
  float c_eps;  // d x_next / d eps: c2, or sqrt(1 - a') * dt_lambda where dt
  float dt_lambda;
  int dt;       // the dt override applies to this sample
};

__device__ DdimConst ddim_const(const DdimCoefs& c, int64_t s) {
  const float a = c.at.at(s), an = c.at_next.at(s), eta = c.eta.at(s);
  DdimConst k;
  k.sa = sqrtf(a);
  k.s1a = sqrtf(sub(1.f, a));
  k.san = sqrtf(an);
  k.s1an = sqrtf(sub(1.f, an));
  const float ratio = clamp0(mul(sub(1.f, a / an), sub(1.f, an)) / sub(1.f, a));
  k.c1 = mul(eta, sqrtf(ratio));
  k.c2 = sqrtf(clamp0(sub(sub(1.f, an), mul(k.c1, k.c1))));
  k.k_em = -k.s1a / k.sa;
  k.dt = c.has_dt && c.use_dt.at(s) > 0.f;
  k.dt_lambda = c.dt_lambda;
  k.c_eps = k.dt ? mul(k.s1an, c.dt_lambda) : k.c2;
  return k;
}

// one element of the forward
__device__ __forceinline__ void ddim_elem(const DdimConst& k, float x, float e, float em, float z,
                                          bool noise, float& x0, float& xn) {
  x0 = sub(x, mul(em, k.s1a)) / k.sa;
  if (k.dt) {
    xn = add(mul(k.san, x0), mul(mul(k.s1an, e), k.dt_lambda));
  } else {
    xn = add(mul(k.san, x0), mul(k.c2, e));
    if (noise) xn = add(xn, mul(k.c1, z));
  }
}

struct DdimParams {
  const void* x;
  const void* eps;
  const void* eps_mod;  // null: eps itself
  const void* noise;    // null: no noise term
  void* x_next;
  void* x0_t;
  DdimCoefs c;
  int64_t rows;   // rows (pixels) per sample
  int64_t items;  // a thread's items per sample: rows, flat vectors or groups of pixels
  int64_t row_e, row_em;  // row strides of eps and eps_mod, in elements
  int channels;
};

template <typename TX, typename TE, int MODE>
__global__ void __launch_bounds__(kMaxThreads) ddim_fwd(const DdimParams p) {
  __shared__ DdimConst sk;
  const int64_t s = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < p.items;
  const bool noise = p.noise != nullptr;
  if constexpr (MODE == kScalar) {
    if (threadIdx.x == 0) sk = ddim_const(p.c, s);
    __syncthreads();
    if (!live) return;
    const DdimConst k = sk;
    const int64_t row = s * p.rows + i;
    const int64_t xo = row * p.channels;
    const TX* x = static_cast<const TX*>(p.x) + xo;
    const TX* z = noise ? static_cast<const TX*>(p.noise) + xo : nullptr;
    const TE* e = static_cast<const TE*>(p.eps) + row * p.row_e;
    const TE* em = p.eps_mod != nullptr ? static_cast<const TE*>(p.eps_mod) + row * p.row_em : e;
    TX* xn_out = static_cast<TX*>(p.x_next) + xo;
    TX* x0_out = static_cast<TX*>(p.x0_t) + xo;
    for (int c = 0; c < p.channels; ++c) {
      float x0, xn;
      ddim_elem(k, to_f(x[c]), to_f(e[c]), to_f(em[c]), noise ? to_f(z[c]) : 0.f, noise, x0, xn);
      xn_out[c] = from_f<TX>(xn);
      x0_out[c] = from_f<TX>(x0);
    }
  } else {
    constexpr int N = flat_n<TX, TE>();  // elements per thread, of every operand
    const int64_t item = s * p.items + i;
    const bool same = p.eps_mod == nullptr;
    Vecs<TX, N> xr, zr;
    Vecs<TE, N> er, emr;
    if (live) {  // in flight while thread 0 computes the constants
      xr.load(static_cast<const TX*>(p.x) + item * N);
      er.load(static_cast<const TE*>(p.eps) + item * N);
      if (!same) emr.load(static_cast<const TE*>(p.eps_mod) + item * N);
      if (noise) zr.load(static_cast<const TX*>(p.noise) + item * N);
    }
    if (threadIdx.x == 0) sk = ddim_const(p.c, s);
    __syncthreads();
    if (!live) return;
    const DdimConst k = sk;
    float xv[N], zv[N], ev[N], emv[N], x0v[N], xnv[N];
    xr.unpack(xv);
    er.unpack(ev);
    if (same) {
#pragma unroll
      for (int j = 0; j < N; ++j) emv[j] = ev[j];
    } else {
      emr.unpack(emv);
    }
    if (noise) {
      zr.unpack(zv);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) zv[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < N; ++j) ddim_elem(k, xv[j], ev[j], emv[j], zv[j], noise, x0v[j], xnv[j]);
    Vecs<TX, N> out;
    out.pack(xnv);
    out.store(static_cast<TX*>(p.x_next) + item * N);
    out.pack(x0v);
    out.store(static_cast<TX*>(p.x0_t) + item * N);
  }
}

// the rows instance: one tile of kTilePx pixels per block, through shared
// memory (p.items: tiles per sample)
template <typename TX, typename TE>
__global__ void __launch_bounds__(kTileThreads) ddim_fwd_rows(const DdimParams p) {
  __shared__ alignas(16) uint8_t sx[kTilePx * kRowC * sizeof(TX)];   // x, then x0_t
  __shared__ alignas(16) uint8_t sz[kTilePx * kRowC * sizeof(TX)];   // noise, then x_next
  __shared__ alignas(16) uint8_t se[kTilePx * kRowR * sizeof(TE)];   // eps's rows
  __shared__ alignas(16) uint8_t sem[kTilePx * kRowR * sizeof(TE)];  // eps_mod's rows
  __shared__ alignas(8) uint64_t bar;
  __shared__ DdimConst sk;
  TX* xs = reinterpret_cast<TX*>(sx);
  TX* zs = reinterpret_cast<TX*>(sz);
  const TE* es = reinterpret_cast<const TE*>(se);
  const TE* ems = reinterpret_cast<const TE*>(sem);
  const int64_t s = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * kTilePx;
  const int np = (int)(p.rows - p0 < kTilePx ? p.rows - p0 : kTilePx);  // a multiple of 8
  const int64_t row0 = s * p.rows + p0;
  const bool noise = p.noise != nullptr, same = p.eps_mod == nullptr;
  const uint32_t bx = np * kRowC * sizeof(TX), be = np * kRowR * sizeof(TE);
  if (threadIdx.x == 0) {
    mbar_init(&bar);
    mbar_expect_tx(&bar, bx * (noise ? 2 : 1) + be * (same ? 1 : 2));
    bulk_load(sx, static_cast<const TX*>(p.x) + row0 * kRowC, bx, &bar);
    if (noise) bulk_load(sz, static_cast<const TX*>(p.noise) + row0 * kRowC, bx, &bar);
    bulk_load(se, static_cast<const TE*>(p.eps) + row0 * kRowR, be, &bar);
    if (!same) bulk_load(sem, static_cast<const TE*>(p.eps_mod) + row0 * kRowR, be, &bar);
    sk = ddim_const(p.c, s);  // while the copies are in flight
  }
  __syncthreads();  // the mbarrier's init and the constants
  mbar_wait(&bar, 0);
  const DdimConst k = sk;
  // consecutive threads on consecutive pixels
  for (int px = threadIdx.x; px < np; px += kTileThreads) {
#pragma unroll
    for (int c = 0; c < kRowC; ++c) {
      const float e = to_f(es[px * kRowR + c]);
      const float em = same ? e : to_f(ems[px * kRowR + c]);
      const float z = noise ? to_f(zs[px * kRowC + c]) : 0.f;
      float x0, xn;
      ddim_elem(k, to_f(xs[px * kRowC + c]), e, em, z, noise, x0, xn);
      xs[px * kRowC + c] = from_f<TX>(x0);  // each thread's own pixels: in place
      zs[px * kRowC + c] = from_f<TX>(xn);
    }
  }
  __syncthreads();
  tile_store(static_cast<TX*>(p.x0_t) + row0 * kRowC, sx, bx);
  tile_store(static_cast<TX*>(p.x_next) + row0 * kRowC, sz, bx);
}

struct DdimBwdParams {
  const void* g_xn;  // cotangent of x_next, or null
  const void* g_x0;  // cotangent of x0_t, or null
  void* dx;          // each gradient, or null where it is not asked for
  void* deps;
  void* deps_mod;
  DdimCoefs c;
  int64_t items;  // a thread's items per sample: elements or flat vectors
};

// one element of the backward
__device__ __forceinline__ void ddim_bwd_elem(const DdimConst& k, bool has_gn, bool has_g0,
                                              float gn, float g0, float& dx, float& de,
                                              float& dem) {
  float gx0 = g0;
  if (has_gn) {
    const float t = mul(k.san, gn);
    gx0 = has_g0 ? add(g0, t) : t;
  }
  dx = gx0 / k.sa;
  dem = mul(k.k_em, gx0);
  de = has_gn ? mul(k.c_eps, gn) : 0.f;
}

template <typename TX, typename TE, int MODE>
__global__ void __launch_bounds__(kMaxThreads) ddim_bwd(const DdimBwdParams p) {
  __shared__ DdimConst sk;
  const int64_t s = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < p.items;
  const bool has_gn = p.g_xn != nullptr, has_g0 = p.g_x0 != nullptr;
  constexpr int N = MODE == kFlat ? flat_n<TX, TE>() : 1;
  const int64_t off = (s * p.items + i) * N;
  if constexpr (MODE == kScalar) {
    if (threadIdx.x == 0) sk = ddim_const(p.c, s);
    __syncthreads();
    if (!live) return;
    const DdimConst k = sk;
    const float gn = has_gn ? to_f(static_cast<const TX*>(p.g_xn)[off]) : 0.f;
    const float g0 = has_g0 ? to_f(static_cast<const TX*>(p.g_x0)[off]) : 0.f;
    float dx, de, dem;
    ddim_bwd_elem(k, has_gn, has_g0, gn, g0, dx, de, dem);
    if (p.dx != nullptr) static_cast<TX*>(p.dx)[off] = from_f<TX>(dx);
    if (p.deps != nullptr) static_cast<TE*>(p.deps)[off] = from_f<TE>(de);
    if (p.deps_mod != nullptr) static_cast<TE*>(p.deps_mod)[off] = from_f<TE>(dem);
  } else {
    Vecs<TX, N> gnr, g0r;
    if (live) {
      if (has_gn) gnr.load(static_cast<const TX*>(p.g_xn) + off);
      if (has_g0) g0r.load(static_cast<const TX*>(p.g_x0) + off);
    }
    if (threadIdx.x == 0) sk = ddim_const(p.c, s);
    __syncthreads();
    if (!live) return;
    const DdimConst k = sk;
    float gn[N], g0[N], dx[N], de[N], dem[N];
#pragma unroll
    for (int j = 0; j < N; ++j) gn[j] = g0[j] = 0.f;
    if (has_gn) gnr.unpack(gn);
    if (has_g0) g0r.unpack(g0);
#pragma unroll
    for (int j = 0; j < N; ++j) ddim_bwd_elem(k, has_gn, has_g0, gn[j], g0[j], dx[j], de[j], dem[j]);
    if (p.dx != nullptr) {
      Vecs<TX, N> o;
      o.pack(dx);
      o.store(static_cast<TX*>(p.dx) + off);
    }
    Vecs<TE, N> o;
    if (p.deps != nullptr) {
      o.pack(de);
      o.store(static_cast<TE*>(p.deps) + off);
    }
    if (p.deps_mod != nullptr) {
      o.pack(dem);
      o.store(static_cast<TE*>(p.deps_mod) + off);
    }
  }
}

// ---------------------------------------------------------------------------
// the DDPM step
// ---------------------------------------------------------------------------

enum LogVar { kLvSample = 0, kLvElement = 1, kLvPaired = 2 };

struct DdpmParams {
  const void* x;
  const void* eps;
  const void* logvar;  // per element (kLvElement), else unread
  const void* noise;
  void* out;
  Coef bt, at, t, lv;  // lv: the per-sample log-variance (kLvSample)
  int64_t rows, items, row_e, row_l;
  int lv_mode;  // kLvPaired: the rows' channels C..2C (rows instance)
  int channels;
};

struct DdpmConst {
  float k;     // 1 / sqrt(1 - b_t)
  float w;     // b_t / sqrt(1 - a_t)
  float keep;  // 0 where t == 0, else 1
  float sd;    // keep * exp(logvar / 2) of a per-sample logvar
};

__device__ DdpmConst ddpm_const(const DdpmParams& p, int64_t s) {
  const float bt = p.bt.at(s), at = p.at.at(s);
  DdpmConst k;
  k.w = bt / sqrtf(sub(1.f, at));
  k.k = 1.f / sqrtf(sub(1.f, bt));
  k.keep = p.t.at(s) == 0.f ? 0.f : 1.f;
  k.sd = p.lv_mode == kLvSample ? mul(k.keep, expf(mul(0.5f, p.lv.at(s)))) : 0.f;
  return k;
}

__device__ __forceinline__ float ddpm_elem(const DdpmConst& k, float x, float e, float sd,
                                           float z) {
  return add(mul(k.k, sub(x, mul(k.w, e))), mul(sd, z));
}

template <typename TX, typename TE, int MODE>
__global__ void __launch_bounds__(kMaxThreads) ddpm_fwd(const DdpmParams p) {
  __shared__ DdpmConst sk;
  const int64_t s = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < p.items;
  if constexpr (MODE == kScalar) {
    if (threadIdx.x == 0) sk = ddpm_const(p, s);
    __syncthreads();
    if (!live) return;
    const DdpmConst k = sk;
    const int64_t row = s * p.rows + i;
    const int64_t xo = row * p.channels;
    const TX* x = static_cast<const TX*>(p.x) + xo;
    const TX* z = static_cast<const TX*>(p.noise) + xo;
    const TE* e = static_cast<const TE*>(p.eps) + row * p.row_e;
    const TE* lv = p.lv_mode == kLvSample ? nullptr : static_cast<const TE*>(p.logvar) + row * p.row_l;
    TX* out = static_cast<TX*>(p.out) + xo;
    for (int c = 0; c < p.channels; ++c) {
      const float sd = lv == nullptr ? k.sd : mul(k.keep, expf(mul(0.5f, to_f(lv[c]))));
      out[c] = from_f<TX>(ddpm_elem(k, to_f(x[c]), to_f(e[c]), sd, to_f(z[c])));
    }
  } else {
    constexpr int N = flat_n<TX, TE>();
    const int64_t item = s * p.items + i;
    const bool lv_elem = p.lv_mode == kLvElement;  // its own contiguous operand
    Vecs<TX, N> xr, zr;
    Vecs<TE, N> er, lr;
    if (live) {
      xr.load(static_cast<const TX*>(p.x) + item * N);
      er.load(static_cast<const TE*>(p.eps) + item * N);
      zr.load(static_cast<const TX*>(p.noise) + item * N);
      if (lv_elem) lr.load(static_cast<const TE*>(p.logvar) + item * N);
    }
    if (threadIdx.x == 0) sk = ddpm_const(p, s);
    __syncthreads();
    if (!live) return;
    const DdpmConst k = sk;
    float xv[N], zv[N], ev[N], lv[N], ov[N];
    xr.unpack(xv);
    zr.unpack(zv);
    er.unpack(ev);
    if (lv_elem) lr.unpack(lv);
#pragma unroll
    for (int j = 0; j < N; ++j)
      ov[j] = ddpm_elem(k, xv[j], ev[j], lv_elem ? mul(k.keep, expf(mul(0.5f, lv[j]))) : k.sd,
                        zv[j]);
    Vecs<TX, N> o;
    o.pack(ov);
    o.store(static_cast<TX*>(p.out) + item * N);
  }
}

// the rows instance: one tile of kTilePx pixels per block, eps and a paired
// log-variance from the same rows in shared memory (p.items: tiles per
// sample)
template <typename TX, typename TE>
__global__ void __launch_bounds__(kTileThreads) ddpm_fwd_rows(const DdpmParams p) {
  __shared__ alignas(16) uint8_t sx[kTilePx * kRowC * sizeof(TX)];  // x, then the output
  __shared__ alignas(16) uint8_t sz[kTilePx * kRowC * sizeof(TX)];  // noise
  __shared__ alignas(16) uint8_t se[kTilePx * kRowR * sizeof(TE)];  // the rows
  __shared__ alignas(8) uint64_t bar;
  __shared__ DdpmConst sk;
  TX* xs = reinterpret_cast<TX*>(sx);
  const TX* zs = reinterpret_cast<const TX*>(sz);
  const TE* es = reinterpret_cast<const TE*>(se);
  const int64_t s = blockIdx.y;
  const int64_t p0 = (int64_t)blockIdx.x * kTilePx;
  const int np = (int)(p.rows - p0 < kTilePx ? p.rows - p0 : kTilePx);  // a multiple of 8
  const int64_t row0 = s * p.rows + p0;
  const bool paired = p.lv_mode == kLvPaired;
  const uint32_t bx = np * kRowC * sizeof(TX), be = np * kRowR * sizeof(TE);
  if (threadIdx.x == 0) {
    mbar_init(&bar);
    mbar_expect_tx(&bar, 2 * bx + be);
    bulk_load(sx, static_cast<const TX*>(p.x) + row0 * kRowC, bx, &bar);
    bulk_load(sz, static_cast<const TX*>(p.noise) + row0 * kRowC, bx, &bar);
    bulk_load(se, static_cast<const TE*>(p.eps) + row0 * kRowR, be, &bar);
    sk = ddpm_const(p, s);
  }
  __syncthreads();
  mbar_wait(&bar, 0);
  const DdpmConst k = sk;
  for (int px = threadIdx.x; px < np; px += kTileThreads) {
#pragma unroll
    for (int c = 0; c < kRowC; ++c) {
      // a paired log-variance: C channels after eps in the same row
      const float sd =
          paired ? mul(k.keep, expf(mul(0.5f, to_f(es[px * kRowR + kRowC + c])))) : k.sd;
      xs[px * kRowC + c] = from_f<TX>(
          ddpm_elem(k, to_f(xs[px * kRowC + c]), to_f(es[px * kRowR + c]), sd,
                    to_f(zs[px * kRowC + c])));
    }
  }
  __syncthreads();
  tile_store(static_cast<TX*>(p.out) + row0 * kRowC, sx, bx);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// What the wrapper packs (`struct.pack`): 8-byte fields, no padding.
struct HostCoef {
  const float* p;
  int64_t stride;
  double v;
};

struct DdimArgs {
  const void* x;
  const void* eps;
  const void* eps_mod;
  const void* noise;
  void* x_next;
  void* x0_t;
  HostCoef at, at_next, eta, apply_dt;
  double dt_lambda;
  int64_t has_dt, batch, rows, channels, row_e, row_em, mode, tx, te;
};
static_assert(sizeof(DdimArgs) == 8 * 28, "the wrapper packs 28 fields");

struct DdimBwdArgs {
  const void* g_x_next;
  const void* g_x0_t;
  void* dx;
  void* deps;
  void* deps_mod;
  HostCoef at, at_next, eta, apply_dt;
  double dt_lambda;
  int64_t has_dt, batch, per_sample, mode, tx, te;
};
static_assert(sizeof(DdimBwdArgs) == 8 * 24, "the wrapper packs 24 fields");

struct DdpmArgs {
  const void* x;
  const void* eps;
  const void* logvar;
  const void* noise;
  void* out;
  HostCoef bt, at, t, lv;
  int64_t lv_mode, batch, rows, channels, row_e, row_l, mode, tx, te;
};
static_assert(sizeof(DdpmArgs) == 8 * 26, "the wrapper packs 26 fields");

Coef coef(const HostCoef& h) { return Coef{h.p, h.stride, (float)h.v}; }

bool aligned16(const void* p) { return p == nullptr || ((uintptr_t)p & 15) == 0; }

DdimCoefs ddim_coefs(const HostCoef& at, const HostCoef& an, const HostCoef& eta,
                     const HostCoef& dt, double dt_lambda, int64_t has_dt) {
  return DdimCoefs{coef(at), coef(an), coef(eta), coef(dt), (float)dt_lambda, has_dt != 0};
}

bool dtypes_ok(int64_t tx, int64_t te) { return (tx == 0 || tx == 1) && (te == 0 || te == 1); }

// the rows instance: kTileThreads threads for each tile of a sample
template <typename K, typename P>
int launch_tiles(K kernel, const P& prm, int64_t tiles, int64_t batch, cudaStream_t stream) {
  if (tiles == 0 || batch == 0) return 0;
  if (batch > 65535 || tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)tiles, (unsigned)batch), kTileThreads, 0, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <typename K, typename P>
int launch(K kernel, const P& prm, int64_t items, int64_t batch, cudaStream_t stream) {
  if (items == 0 || batch == 0) return 0;
  int threads = kMaxThreads;
  while (threads > kMinThreads && batch * ((items + threads - 1) / threads) < kFillBlocks)
    threads /= 2;
  const int64_t chunks = (items + threads - 1) / threads;
  if (batch > 65535 || chunks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)chunks, (unsigned)batch), threads, 0, stream>>>(prm);
  return (int)cudaGetLastError();
}

// items per sample of an instance (rows, flat vectors or tiles), or -1
// where its layout does not hold
int64_t items_for(int64_t mode, int64_t rows, int64_t channels, int flat_n, bool rows_ok) {
  if (mode == kScalar) return rows;
  if (mode == kFlat) return (rows * channels) % flat_n == 0 ? rows * channels / flat_n : -1;
  if (mode == kRows)
    return rows_ok && channels == kRowC && rows % kTileAlign == 0 ? (rows + kTilePx - 1) / kTilePx
                                                                  : -1;
  return -1;
}

template <typename TX, typename TE>
int ddim_fwd_launch(DdimParams prm, const DdimArgs& a, cudaStream_t st) {
  const bool rows_ok = a.row_e == kRowR && (a.eps_mod == nullptr || a.row_em == kRowR);
  const bool flat_ok = a.row_e == a.channels && (a.eps_mod == nullptr || a.row_em == a.channels);
  prm.items = items_for(a.mode, a.rows, a.channels, flat_n<TX, TE>(), rows_ok);
  if (prm.items < 0 || (a.mode == kFlat && !flat_ok)) return (int)cudaErrorInvalidValue;
  switch (a.mode) {
    case kFlat: return launch(ddim_fwd<TX, TE, kFlat>, prm, prm.items, a.batch, st);
    case kRows: return launch_tiles(ddim_fwd_rows<TX, TE>, prm, prm.items, a.batch, st);
    default: return launch(ddim_fwd<TX, TE, kScalar>, prm, prm.items, a.batch, st);
  }
}

template <typename TX, typename TE>
int ddim_bwd_launch(DdimBwdParams prm, const DdimBwdArgs& a, cudaStream_t st) {
  constexpr int n = flat_n<TX, TE>();
  if (a.mode == kFlat) {
    if (a.per_sample % n) return (int)cudaErrorInvalidValue;
    prm.items = a.per_sample / n;
    return launch(ddim_bwd<TX, TE, kFlat>, prm, prm.items, a.batch, st);
  }
  prm.items = a.per_sample;
  return launch(ddim_bwd<TX, TE, kScalar>, prm, prm.items, a.batch, st);
}

template <typename TX, typename TE>
int ddpm_launch(DdpmParams prm, const DdpmArgs& a, cudaStream_t st) {
  const bool rows_ok = a.row_e == kRowR && a.lv_mode != kLvElement;
  const bool flat_ok = a.row_e == a.channels && a.lv_mode != kLvPaired &&
                       (a.lv_mode == kLvSample || a.row_l == a.channels);
  prm.items = items_for(a.mode, a.rows, a.channels, flat_n<TX, TE>(), rows_ok);
  if (prm.items < 0 || (a.mode == kFlat && !flat_ok) || (a.mode == kScalar && a.lv_mode == kLvPaired))
    return (int)cudaErrorInvalidValue;
  switch (a.mode) {
    case kFlat: return launch(ddpm_fwd<TX, TE, kFlat>, prm, prm.items, a.batch, st);
    case kRows: return launch_tiles(ddpm_fwd_rows<TX, TE>, prm, prm.items, a.batch, st);
    default: return launch(ddpm_fwd<TX, TE, kScalar>, prm, prm.items, a.batch, st);
  }
}

// the entry for the pair of dtypes (0 = float32, 1 = bfloat16)
template <template <typename, typename> class F, typename P, typename A>
int by_dtypes(const P& prm, const A& a, cudaStream_t st) {
  if (a.tx == 0) return a.te == 0 ? F<float, float>::run(prm, a, st) : F<float, bf16>::run(prm, a, st);
  return a.te == 0 ? F<bf16, float>::run(prm, a, st) : F<bf16, bf16>::run(prm, a, st);
}
template <typename TX, typename TE>
struct DdimFwd {
  static int run(const DdimParams& p, const DdimArgs& a, cudaStream_t s) {
    return ddim_fwd_launch<TX, TE>(p, a, s);
  }
};
template <typename TX, typename TE>
struct DdimBwd {
  static int run(const DdimBwdParams& p, const DdimBwdArgs& a, cudaStream_t s) {
    return ddim_bwd_launch<TX, TE>(p, a, s);
  }
};
template <typename TX, typename TE>
struct Ddpm {
  static int run(const DdpmParams& p, const DdpmArgs& a, cudaStream_t s) {
    return ddpm_launch<TX, TE>(p, a, s);
  }
};

}  // namespace

// Each entry takes its arguments as the wrapper packs them (`DdimArgs`,
// `DdimBwdArgs`, `DdpmArgs`) and the stream.
//
// K3: x, noise (or null), x_next, x0_t in the carry's dtype `tx`; eps and
// eps_mod (null: eps itself) rows of `channels` elements `row_e` / `row_em`
// apart, in `te`; per-sample a, a', eta and apply_dt (read only with
// has_dt). mode: 0 scalar, 1 flat, 2 rows. One kernel launch; returns
// cudaGetLastError(), or cudaErrorInvalidValue where the instance's layout
// or alignment does not hold.
extern "C" int asyrp_ddim_step(const void* args, void* stream) {
  const DdimArgs* a = static_cast<const DdimArgs*>(args);
  if (!dtypes_ok(a->tx, a->te) || a->mode < kScalar || a->mode > kRows || a->channels <= 0)
    return (int)cudaErrorInvalidValue;
  if (a->mode != kScalar &&
      !(aligned16(a->x) && aligned16(a->eps) && aligned16(a->eps_mod) && aligned16(a->noise) &&
        aligned16(a->x_next) && aligned16(a->x0_t)))
    return (int)cudaErrorInvalidValue;
  DdimParams prm;
  prm.x = a->x;
  prm.eps = a->eps;
  prm.eps_mod = a->eps_mod;
  prm.noise = a->noise;
  prm.x_next = a->x_next;
  prm.x0_t = a->x0_t;
  prm.c = ddim_coefs(a->at, a->at_next, a->eta, a->apply_dt, a->dt_lambda, a->has_dt);
  prm.rows = a->rows;
  prm.items = 0;
  prm.row_e = a->row_e;
  prm.row_em = a->row_em;
  prm.channels = (int)a->channels;
  return by_dtypes<DdimFwd>(prm, *a, static_cast<cudaStream_t>(stream));
}

// K3-bwd: the cotangents g_x_next, g_x0_t (either null) and dx in `tx`;
// d eps, d eps_mod in `te`; each output null where it is not asked for.
// All contiguous, `per_sample` elements a sample. mode: 0 scalar, 1 flat.
// One kernel launch.
extern "C" int asyrp_ddim_step_bwd(const void* args, void* stream) {
  const DdimBwdArgs* a = static_cast<const DdimBwdArgs*>(args);
  if (!dtypes_ok(a->tx, a->te) || (a->mode != kScalar && a->mode != kFlat))
    return (int)cudaErrorInvalidValue;
  if (a->mode == kFlat &&
      !(aligned16(a->g_x_next) && aligned16(a->g_x0_t) && aligned16(a->dx) &&
        aligned16(a->deps) && aligned16(a->deps_mod)))
    return (int)cudaErrorInvalidValue;
  DdimBwdParams prm;
  prm.g_xn = a->g_x_next;
  prm.g_x0 = a->g_x0_t;
  prm.dx = a->dx;
  prm.deps = a->deps;
  prm.deps_mod = a->deps_mod;
  prm.c = ddim_coefs(a->at, a->at_next, a->eta, a->apply_dt, a->dt_lambda, a->has_dt);
  prm.items = 0;
  return by_dtypes<DdimBwd>(prm, *a, static_cast<cudaStream_t>(stream));
}

// The DDPM step: x, noise, out in `tx`; eps (rows `row_e` apart) and a
// per-element logvar (rows `row_l` apart) in `te`. lv_mode: 0 the
// per-sample `lv`, 1 per element at `logvar`, 2 per element in eps's rows,
// `channels` after eps (rows instance). mode: 0 scalar, 1 flat, 2 rows. One
// kernel launch.
extern "C" int asyrp_ddpm_step(const void* args, void* stream) {
  const DdpmArgs* a = static_cast<const DdpmArgs*>(args);
  if (!dtypes_ok(a->tx, a->te) || a->mode < kScalar || a->mode > kRows || a->channels <= 0 ||
      a->lv_mode < kLvSample || a->lv_mode > kLvPaired || a->noise == nullptr)
    return (int)cudaErrorInvalidValue;
  const void* lv_ptr = a->lv_mode == kLvElement ? a->logvar : nullptr;
  if (a->mode != kScalar &&
      !(aligned16(a->x) && aligned16(a->eps) && aligned16(lv_ptr) && aligned16(a->noise) &&
        aligned16(a->out)))
    return (int)cudaErrorInvalidValue;
  DdpmParams prm;
  prm.x = a->x;
  prm.eps = a->eps;
  prm.logvar = a->logvar;
  prm.noise = a->noise;
  prm.out = a->out;
  prm.bt = coef(a->bt);
  prm.at = coef(a->at);
  prm.t = coef(a->t);
  prm.lv = coef(a->lv);
  prm.rows = a->rows;
  prm.items = 0;
  prm.row_e = a->row_e;
  prm.row_l = a->row_l;
  prm.lv_mode = (int)a->lv_mode;
  prm.channels = (int)a->channels;
  return by_dtypes<Ddpm>(prm, *a, static_cast<cudaStream_t>(stream));
}
