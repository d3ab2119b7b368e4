// ENC and VIEW: the point encode and the view-direction encode, for Hopper
// (sm_90a). Bound in ops/encode.py, used by models/mipnerf360.py::_encode and
// nerf_forward.
//
// They replace no TPU kernel. The JAX package writes the encode as plain jnp
// (mipnerf360_tpu/core/fused_encode.py::factored_ipe, core/encoding.py) and
// leaves it to XLA's fusion. PyTorch runs each step of it as a pass of its
// own over [rows, 21] float32 tensors (some 35 launches in factored_ipe, 7 a
// scale in scale_ipe), joins 24 slices and the view features with
// torch.cat, and the MLP then casts the joined float32 features to its
// compute dtype: the largest layer of the render, a fifth of the train step.
//
// ENC writes the first MLP layer's whole input, one row per sample,
// [rays * samples, width] in the compute dtype (bf16 rounded to nearest
// even, by the card's conversion instruction as PyTorch's cast; or float32),
// straight from the ray intervals: for each sample the frustum's moments
// (cone, the stable forms, or cylinder), the contraction scalars a, b, q of
// the rank-1 contracted covariance, then for each of the 21 rows k of
// P_BASIS the phase gamma_k and attenuation sigma_k, and for each scale i
// exp(-0.5 4^i sigma_k) sin(2^i gamma_k) and its cos twin in scale_ipe's
// order (42 features a scale); then, where the view features go in the row
// (the repo's layout), viewdir_enc's 4 a scale of the sample's ray; then
// zeros to `width`. VIEW writes unit_viewdir_enc's 3 + 6 a scale features a
// ray (the published layout's view branch).
//
// Arithmetic: every step of the plain version (ops/encode.py's, which is
// core/fused_encode.py's on the card), in its order, each rounded to float32
// as PyTorch's separate passes round it: the explicit __f*_rn intrinsics keep
// the compiler from contracting a product and a sum into one FMA. Where
// PyTorch divides a tensor by a Python number on the card it multiplies by
// the number's float32 reciprocal, and so does this kernel (1/3, 1/12).
// The projections P mu and P d are FMA chains over the 3 coordinates in
// order, as cuBLAS's single-precision GEMM sums its K = 3; the 3-term sums
// (|d|^2, |mu|^2, d . mu) add coordinates 0 and 2, then 1, as PyTorch's sum
// reduction over a last axis of 3 does (two lanes, then a shuffle). The
// functions are the precise ones PyTorch calls: sinf/cosf (as sincosf),
// expf, powf(x, 4), sqrtf, acosf, atanf, IEEE division; no intrinsic of the
// __sinf kind and no fast-math flag.
//
// What bounds it: the output bytes, or the precise transcendentals' issue.
// A render chunk's level of garden_quality writes 524,288 rows of 520 bf16
// features (0.55 GB: 0.16 ms at 3.35 TB/s). The issue: each (row, k) pair
// takes one expf and one sincosf a scale, 60 instructions a (row, k, scale)
// triple on the scale loop's taken path in the SASS (sm_90a), 15,120 a row
// at 12 scales: 0.24 ms at 524,288 rows over 132 SMs x 128 lanes at 1.98
// GHz. So at 12 scales the issue binds (at 1 scale, the parity presets' 58
// features, the bytes). Measured on the H100 at 524,288 x 520: 0.41 ms, 58%
// of the issue bound; the rest is each block's serial start (one warp's
// chain of divisions, powf and sqrt per row) and its final store.
//
// Design: a block of 336 threads takes 16 consecutive sample rows, one
// (row, k) pair a thread, and four blocks stay resident on an SM. First one
// warp computes each row's scalars (moments, the contraction, |mu|, the
// rank-1 terms) into shared memory while the other warps stage P_BASIS in
// shared memory (the constant cache would serialise a warp's reads of
// different rows of it) and write what needs no row scalars: the view
// features and the padding. Then each thread forms its pair's projections
// and sigma_k and loops over the scales. The block's slice of the output is
// one contiguous byte range (16 rows x width x 2 or 4 bytes, a multiple of
// 16), which it builds in shared memory and writes with 16-byte stores,
// whatever the width (the parity presets' 58 too); the last block's ragged
// tail goes element by element. P_BASIS is in constant memory and the
// scales are computed (2^i and -0.5 4^i, exact), so nothing is uploaded
// from the host. The kernel reads t_vals and the per-ray inputs with their
// row strides (a slice of t_vals needs no copy), launches on the caller's
// stream, allocates nothing and does not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBasis = 21;                    // rows of P_BASIS
constexpr int kTileRows = 16;                 // sample rows a block writes
constexpr int kThreads = kBasis * kTileRows;  // one (row, k) pair a thread
constexpr int kMinBlocks = 64 / kTileRows;    // resident a SM: 64 rows
// The first warp computes the rows' scalars; the warps after it stage
// P_BASIS meanwhile.
static_assert(kTileRows <= 32 && kThreads - 32 >= 3 * kBasis,
              "a block's first warp takes its rows, the rest the basis");
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMinDeg = -62, kMaxDeg = 62;

// core/encoding.py's P_BASIS, each entry the float32 it rounds to.
__constant__ float kP[kBasis][3] = {
    {0.8506507873535156f, 0.0f, 0.525731086730957f},
    {0.80901700258255f, 0.5f, 0.30901700258255005f},
    {0.525731086730957f, 0.8506507873535156f, 0.0f},
    {1.0f, 0.0f, 0.0f},
    {0.80901700258255f, 0.5f, -0.30901700258255005f},
    {0.8506507873535156f, 0.0f, -0.525731086730957f},
    {0.30901700258255005f, 0.80901700258255f, -0.5f},
    {0.0f, 0.525731086730957f, -0.8506507873535156f},
    {0.5f, 0.30901700258255005f, -0.80901700258255f},
    {0.0f, 1.0f, 0.0f},
    {-0.525731086730957f, 0.8506507873535156f, 0.0f},
    {-0.30901700258255005f, 0.80901700258255f, -0.5f},
    {0.0f, 0.525731086730957f, 0.8506507873535156f},
    {-0.30901700258255005f, 0.80901700258255f, 0.5f},
    {0.30901700258255005f, 0.80901700258255f, 0.5f},
    {0.5f, 0.30901700258255005f, 0.80901700258255f},
    {0.5f, -0.30901700258255005f, 0.80901700258255f},
    {0.0f, 0.0f, 1.0f},
    {-0.5f, 0.30901700258255005f, 0.80901700258255f},
    {-0.80901700258255f, 0.5f, 0.30901700258255005f},
    {-0.80901700258255f, 0.5f, -0.30901700258255005f},
};

// Python numbers as PyTorch's passes take them in float32.
constexpr float kThird = 1.0f / 3.0f;    // x / 3.0 on the card: x * (1/3)
constexpr float kTwelfth = 1.0f / 12.0f;
constexpr float k4_15 = static_cast<float>(4.0 / 15.0);
constexpr float k5_12 = static_cast<float>(5.0 / 12.0);
constexpr float kEps = static_cast<float>(1e-10);  // clamps of |d|^2, |mu|^2
constexpr float kViewEps = static_cast<float>(1e-6);
constexpr float kHalfPi = static_cast<float>(0.5 * 3.14159265358979323846);
constexpr float kTiny = 1.17549435e-38f;  // torch.finfo(float32).tiny

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// torch.clamp(x, -1, 1).
__device__ __forceinline__ float clamp_unit(float x) {
  return isnan(x) ? x : fminf(fmaxf(x, -1.0f), 1.0f);
}

// PyTorch's sum over a last axis of 3: (v0 + v2) + v1.
__device__ __forceinline__ float sum3(float v0, float v1, float v2) {
  return __fadd_rn(__fadd_rn(v0, v2), v1);
}

// (P v)_k as cuBLAS forms it for K = 3: FMAs in order from 0; `p` is row
// k of P_BASIS.
__device__ __forceinline__ float project(const float* p, float v0, float v1,
                                         float v2) {
  return __fmaf_rn(p[2], v2, __fmaf_rn(p[1], v1, __fmaf_rn(p[0], v0, 0.0f)));
}

// 2^e, exactly, for -126 <= e <= 127: the launchers take degrees from
// kMinDeg to kMaxDeg, so every 2^i and -0.5 4^i they need is in range.
__device__ __forceinline__ float pow2(int e) {
  return __int_as_float((e + 127) << 23);
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(uint16_t* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// What the (row, k) threads of a row read: the mean mu and direction d, |mu|
// (clamped), the contraction's scale of the phase, and the rank-1 terms of
// sigma: beta, gamma, a^2, 2ab, gamma (d . muhat), b^2 q.
struct Row {
  float mu[3], d[3], n, scale, beta, gamma, a2, ab2, gd, bq;
};

struct Rays {
  const float* t;  // [rays, samples + 1], row stride t_stride
  const float* o;  // [rays, 3]
  const float* d;  // [rays, 3]
  const float* r;  // [rays, 1]
  const float* v;  // [rays, 3] or null: no view features in the row
  int64_t t_stride, o_stride, d_stride, r_stride, v_stride;
};

// core/fused_encode.py::factored_ipe up to sigma, for one sample.
__device__ Row row_scalars(const Rays& in, int64_t ray, int j, bool cone) {
  const float t0 = in.t[ray * in.t_stride + j];
  const float t1 = in.t[ray * in.t_stride + j + 1];
  const float radius = in.r[ray * in.r_stride];
  float t_mean, t_var, r_var;
  if (cone) {  // core/gaussians.py::conical_frustum_to_gaussian, stable
    const float mu = __fmul_rn(__fadd_rn(t0, t1), 0.5f);
    const float hw = __fmul_rn(__fsub_rn(t1, t0), 0.5f);
    const float mu2 = __fmul_rn(mu, mu);
    const float hw2 = __fmul_rn(hw, hw);
    const float hw4 = powf(hw, 4.0f);
    const float denom = __fadd_rn(__fmul_rn(mu2, 3.0f), hw2);
    t_mean = __fadd_rn(
        mu, __fdiv_rn(__fmul_rn(__fmul_rn(mu, 2.0f), hw2), denom));
    t_var = __fsub_rn(
        __fmul_rn(hw2, kThird),
        __fdiv_rn(__fmul_rn(k4_15, __fmul_rn(hw4, __fsub_rn(
                                           __fmul_rn(mu2, 12.0f), hw2))),
                  __fmul_rn(denom, denom)));
    r_var = __fmul_rn(
        __fmul_rn(radius, radius),
        __fsub_rn(__fadd_rn(__fmul_rn(mu2, 0.25f), __fmul_rn(k5_12, hw2)),
                  __fdiv_rn(__fmul_rn(k4_15, hw4), denom)));
  } else {  // cylinder_to_gaussian
    t_mean = __fmul_rn(__fadd_rn(t0, t1), 0.5f);
    const float w = __fsub_rn(t1, t0);
    t_var = __fmul_rn(__fmul_rn(w, w), kTwelfth);
    r_var = __fmul_rn(__fmul_rn(radius, radius), 0.25f);
  }
  Row s;
  const float* d = in.d + ray * in.d_stride;
  const float* o = in.o + ray * in.o_stride;
  float dd[3], mm[3], md[3];
  for (int c = 0; c < 3; ++c) {
    s.d[c] = d[c];
    s.mu[c] = __fadd_rn(o[c], __fmul_rn(d[c], t_mean));
    dd[c] = __fmul_rn(d[c], d[c]);
    mm[c] = __fmul_rn(s.mu[c], s.mu[c]);
    md[c] = __fmul_rn(s.mu[c], d[c]);
  }
  const float d_mag_sq = clamp_min(sum3(dd[0], dd[1], dd[2]), kEps);
  s.beta = r_var;
  s.gamma = __fsub_rn(t_var, __fdiv_rn(r_var, d_mag_sq));
  const float n2 = sum3(mm[0], mm[1], mm[2]);
  s.n = __fsqrt_rn(clamp_min(n2, kEps));
  const bool inside = n2 <= 1.0f;
  const float nn = __fmul_rn(s.n, s.n);
  const float a =
      inside ? 1.0f : __fdiv_rn(__fsub_rn(__fmul_rn(s.n, 2.0f), 1.0f), nn);
  const float b = inside ? 0.0f : __fsub_rn(__fdiv_rn(1.0f, nn), a);
  const float dm = __fdiv_rn(sum3(md[0], md[1], md[2]), s.n);  // d . muhat
  const float q = __fadd_rn(s.beta, __fmul_rn(s.gamma, __fmul_rn(dm, dm)));
  s.scale = inside ? 1.0f
                   : __fdiv_rn(__fsub_rn(2.0f, __fdiv_rn(1.0f, s.n)), s.n);
  s.a2 = __fmul_rn(a, a);
  s.ab2 = __fmul_rn(__fmul_rn(a, b), 2.0f);
  s.gd = __fmul_rn(s.gamma, dm);
  s.bq = __fmul_rn(__fmul_rn(b, b), q);
  return s;
}

// ENC: one block, kTileRows sample rows from `row0`; `out` [rows, width].
template <typename Out>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    encode_points(Rays in, Out* __restrict__ out, int64_t rows, int samples,
                  int cone, int min_deg, int scales, int view_min_deg,
                  int view_scales, int width) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Row row_of[kTileRows];
  __shared__ float basis[kBasis][3];
  Out* tile = reinterpret_cast<Out*>(smem);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int count = rows - row0 < kTileRows ? static_cast<int>(rows - row0)
                                            : kTileRows;
  // The ray and sample of the block's first row; row r's are j0 + r on.
  const int64_t ray0 = row0 / samples;
  const int j0 = static_cast<int>(row0 - ray0 * samples);
  const int pos = 2 * kBasis * scales;
  const int used = pos + (in.v != nullptr ? 4 * view_scales : 0);
  const int pad = width - used;
  if (threadIdx.x < count) {
    const int j = j0 + threadIdx.x;
    row_of[threadIdx.x] =
        row_scalars(in, ray0 + j / samples, j % samples, cone);
  } else if (threadIdx.x >= 32) {
    // Meanwhile the other warps stage P_BASIS in shared memory (where the
    // threads of a warp read different rows of it without the constant
    // cache's serialising), and write what needs no row scalars: after the
    // point features, core/encoding.py::viewdir_enc of each row's ray (sin
    // and cos of theta at each scale, then of phi), then the zeros.
    const int first = threadIdx.x - 32, stride = kThreads - 32;
    if (first < 3 * kBasis) (&basis[0][0])[first] = (&kP[0][0])[first];
    if (in.v != nullptr) {
      for (int it = first; it < count * view_scales; it += stride) {
        const int row = it / view_scales, i = it % view_scales;
        const float* v = in.v + (ray0 + (j0 + row) / samples) * in.v_stride;
        const float theta = acosf(clamp_unit(v[2]));
        const float denom = __fadd_rn(v[0], kViewEps);
        const float phi =
            atanf(__fdiv_rn(v[1], denom == 0.0f ? kTiny : denom));
        const float scale = pow2(view_min_deg + i);
        float st, ct, sp, cp;
        sincosf(__fmul_rn(theta, scale), &st, &ct);
        sincosf(__fmul_rn(phi, scale), &sp, &cp);
        Out* dst = tile + row * width + pos + i;
        put(dst, st);
        put(dst + view_scales, ct);
        put(dst + 2 * view_scales, sp);
        put(dst + 3 * view_scales, cp);
      }
    }
    for (int it = first; it < count * pad; it += stride)
      put(tile + (it / pad) * width + used + it % pad, 0.0f);
  }
  __syncthreads();

  const int r = threadIdx.x / kBasis, k = threadIdx.x % kBasis;
  if (r < count) {
    const Row& s = row_of[r];
    const float p_mu = project(basis[k], s.mu[0], s.mu[1], s.mu[2]);
    const float p_d = project(basis[k], s.d[0], s.d[1], s.d[2]);
    const float p_muhat = __fdiv_rn(p_mu, s.n);
    const float pm2 = __fmul_rn(p_muhat, p_muhat);
    const float term1 = __fmul_rn(
        s.a2, __fadd_rn(s.beta, __fmul_rn(s.gamma, __fmul_rn(p_d, p_d))));
    const float inner = __fadd_rn(__fmul_rn(s.beta, pm2),
                                  __fmul_rn(__fmul_rn(s.gd, p_muhat), p_d));
    const float sigma = __fadd_rn(__fadd_rn(term1, __fmul_rn(s.ab2, inner)),
                                  __fmul_rn(s.bq, pm2));
    const float phase = __fmul_rn(s.scale, p_mu);
    // 2^i and -0.5 4^i, each exact, stepped by exact products.
    float two_i = pow2(min_deg);
    float four_i = -pow2(2 * min_deg - 1);
    Out* dst = tile + r * width + k;
#pragma unroll 1
    for (int i = 0; i < scales; ++i) {
      const float attn = expf(__fmul_rn(sigma, four_i));
      float sn, cs;
      sincosf(__fmul_rn(phase, two_i), &sn, &cs);
      put(dst + 2 * kBasis * i, __fmul_rn(attn, sn));
      put(dst + 2 * kBasis * i + kBasis, __fmul_rn(attn, cs));
      two_i *= 2.0f;
      four_i *= 4.0f;
    }
  }
  __syncthreads();

  // The block's rows are one contiguous range of the output, 16-byte
  // aligned (16 rows of 2- or 4-byte features).
  const int64_t elems = static_cast<int64_t>(count) * width;
  const int64_t vecs = elems * sizeof(Out) / 16;
  const uint4* src = reinterpret_cast<const uint4*>(tile);
  uint4* to = reinterpret_cast<uint4*>(out + row0 * width);
  for (int64_t e = threadIdx.x; e < vecs; e += kThreads) to[e] = src[e];
  for (int64_t e = vecs * 16 / sizeof(Out) + threadIdx.x; e < elems;
       e += kThreads)
    out[row0 * width + e] = tile[e];
}

// VIEW: core/encoding.py::unit_viewdir_enc, [rays, 3 + 6 scales]: the unit
// vector, sin(2^i v_c) scale-major, then sin(2^i v_c + pi/2).
template <typename Out>
__global__ void __launch_bounds__(256)
    encode_viewdirs(const float* __restrict__ v, int64_t v_stride,
                    Out* __restrict__ out, int64_t rays, int min_deg,
                    int scales) {
  const int feats = 3 + 6 * scales;
  const int64_t total = rays * feats;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t ray = e / feats;
    const int f = static_cast<int>(e % feats);
    const float* u = v + ray * v_stride;
    float value;
    if (f < 3) {
      value = u[f];
    } else {
      const int j = (f - 3) % (3 * scales);
      float x = __fmul_rn(u[j % 3], pow2(min_deg + j / 3));
      if (f - 3 >= 3 * scales) x = __fadd_rn(x, kHalfPi);
      value = sinf(x);
    }
    put(out + e, value);
  }
}

template <typename Out>
int launch_points(const Rays& in, void* out, int64_t rays, int samples,
                  int cone, int min_deg, int scales, int view_min_deg,
                  int view_scales, int width, cudaStream_t stream) {
  const int64_t rows = rays * samples;
  const int64_t blocks = (rows + kTileRows - 1) / kTileRows;
  const size_t smem = static_cast<size_t>(kTileRows) * width * sizeof(Out);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        encode_points<Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  encode_points<Out><<<static_cast<unsigned>(blocks), kThreads, smem,
                       stream>>>(in, static_cast<Out*>(out), rows, samples,
                                 cone, min_deg, scales, view_min_deg,
                                 view_scales, width);
  return static_cast<int>(cudaGetLastError());
}

// Whether scales [lo, lo + count) lie within kMinDeg..kMaxDeg.
bool degrees_in_range(int lo, int count) {
  return lo >= kMinDeg && count >= 1 && lo + count - 1 <= kMaxDeg;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Launches ENC on `stream`: out [rays * samples, width] (bf16 when `bf16`,
// else float32, 16-byte aligned) from t_vals [rays, samples + 1], origins and
// directions [rays, 3], radii [rays, 1] and, when not null, viewdirs [rays,
// 3] (the view features in the row), all float32 with the given row strides
// and unit column strides. Returns cudaGetLastError().
extern "C" int encode_points_launch(
    const void* t_vals, long long t_stride, const void* origins,
    long long o_stride, const void* directions, long long d_stride,
    const void* radii, long long r_stride, const void* viewdirs,
    long long v_stride, void* out, long long rays, int samples, int cone,
    int min_deg, int scales, int view_min_deg, int view_scales, int width,
    int bf16, void* stream_) {
  const int used = 2 * kBasis * scales + (viewdirs ? 4 * view_scales : 0);
  if (rays <= 0 || samples <= 0 || !degrees_in_range(min_deg, scales) ||
      (viewdirs && !degrees_in_range(view_min_deg, view_scales)) ||
      width < used || !aligned16(out))
    return cudaErrorInvalidValue;
  Rays in{static_cast<const float*>(t_vals), static_cast<const float*>(origins),
          static_cast<const float*>(directions),
          static_cast<const float*>(radii), static_cast<const float*>(viewdirs),
          t_stride, o_stride, d_stride, r_stride, v_stride};
  const auto stream = static_cast<cudaStream_t>(stream_);
  if (bf16)
    return launch_points<uint16_t>(in, out, rays, samples, cone, min_deg,
                                   scales, view_min_deg, view_scales, width,
                                   stream);
  return launch_points<float>(in, out, rays, samples, cone, min_deg, scales,
                              view_min_deg, view_scales, width, stream);
}

// Launches VIEW on `stream`: out [rays, 3 + 6 scales] (bf16 when `bf16`,
// else float32) from viewdirs [rays, 3] float32 with row stride v_stride.
// Returns cudaGetLastError().
extern "C" int encode_viewdirs_launch(const void* viewdirs,
                                      long long v_stride, void* out,
                                      long long rays, int min_deg, int scales,
                                      int blocks, int bf16, void* stream_) {
  if (rays <= 0 || !degrees_in_range(min_deg, scales) || blocks <= 0)
    return cudaErrorInvalidValue;
  const auto v = static_cast<const float*>(viewdirs);
  const auto stream = static_cast<cudaStream_t>(stream_);
  const int64_t need = (rays * (3 + 6 * scales) + 255) / 256;
  const unsigned grid = static_cast<unsigned>(need < blocks ? need : blocks);
  if (bf16)
    encode_viewdirs<uint16_t><<<grid, 256, 0, stream>>>(
        v, v_stride, static_cast<uint16_t*>(out), rays, min_deg, scales);
  else
    encode_viewdirs<float><<<grid, 256, 0, stream>>>(
        v, v_stride, static_cast<float*>(out), rays, min_deg, scales);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* encode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
