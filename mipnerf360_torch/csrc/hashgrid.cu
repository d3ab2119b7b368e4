// H1 and H2: Zip-NeRF's hash-grid encode, forward and backward, for Hopper
// (sm_90a). Bound in ops/hashgrid.py, used by models/mipnerf360.py::_encode
// on the grid layout (ModelConfig.encoding == "hashgrid").
//
// They replace no TPU kernel: the JAX package has no grid layout. The plain
// version (ops/hashgrid.py on the CPU) composes core/gaussians.py's
// multisample_cast, core/contract.py's contract_isotropic and
// core/hashgrid.py's lookup; composed of PyTorch passes on the card it would
// write [points, levels, 8] index and weight tensors, gather [points,
// levels, 8, features] table entries and reduce them, some 100 passes over
// up to 2 GB each for one sampling level of a step.
//
// H1 writes one sampling level's MLP input, [rays * samples, levels *
// features] in the compute dtype (bf16 rounded to nearest even, or float32),
// straight from the ray intervals: for each sample its 6 points (t_j matched
// to the frustum's mean and variance along the ray, at angle theta_j around
// it, turned and mirrored by the step's uniforms or by the render's fixed
// rule; r t_j / sqrt(2) off the axis in the ray's basis, std 0.5 r t_j /
// sqrt(2)), each contracted with its std scaled by the cube root of the
// contraction Jacobian's determinant, both mapped to the unit cube of the
// grid; then for each level the cell's 8 corners (dense index where the
// level's (n+1)^3 corners fit the table, else the Instant-NGP hash), the
// trilinear weights and the downweight erf(1 / sqrt(8 sigma^2 n^2)); the
// mean over the 6 points. H2 recomputes the same points and scatters g
// omega w / 6 of each corner into the table's gradient with atomic adds:
// one vector red.global.add.v4.f32 for an entry of 4 features (sm_90's
// float4 atomicAdd), scalar red.global.add.f32 otherwise; the lanes of a
// warp that hit one entry sum their addends first and add once. The positions
// take no gradient (the intervals are resampled under stop-gradient), so
// H2 reads the intervals, the rays, the uniforms and the cotangent, and
// writes nothing but the gradient.
//
// Arithmetic: float32 throughout, the formulas of the plain version in its
// order, but not bit for bit (the compiler contracts products and sums into
// FMAs; sincosf, cbrtf and erff are CUDA's): the features differ from the
// plain version's by float32 round-off, and a corner index differs where a
// point lies within round-off of a cell boundary, where its weight is within
// round-off of 0 or 1. H2's atomic adds sum in no fixed order across warps.
//
// What bounds it: the gathers and the atomics, not the bytes. A step of the
// garden_zip cell forms 2 x 25,165,824 proposal points and 12,582,912 NeRF
// points, 10 levels each, 8 corners a level: 5.0G corner reads forward and
// as many atomic adds backward, most of them random 4- or 16-byte accesses
// into tables of up to 224 MB (the NeRF's, over the 50 MB L2); the
// unavoidable bytes (the intervals and rays read, the features written, the
// cotangent read, each table's gradient written) are about 1.3 GB a step,
// 0.4 ms at 3.35 TB/s.
//
// Design: a block of 192 threads takes 32 consecutive sample rows, one
// (row, point) pair a thread: the thread forms its point once and walks the
// levels (corner reads of 4 features as one 16-byte load). H1 puts each
// point's downweighted level features in shared memory ([32 rows][6 points]
// [levels * features] floats, at most 48 KiB); then the block sums each
// row's 6 points in order and writes its 32 rows, one contiguous range of
// the output, feature by feature with consecutive threads on consecutive
// features. H2 reads the row's cotangent once a level; for each of the 8
// corners the warp groups its lanes by entry (match.any), each group's
// addends are summed in lane order through shared memory, and its lowest
// lane adds the sum: one atomic an entry a warp instead of one a point.
// Both read the intervals, rays and uniforms with their row strides (a
// slice of the step's noise needs no copy), launch on the caller's stream,
// allocate nothing and do not synchronise; the caller zeroes the gradient.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPoints = 6;                   // MULTISAMPLES
constexpr int kRows = 32;                    // sample rows a block takes
constexpr int kThreads = kRows * kPoints;    // one (row, point) a thread
constexpr int kMaxLevels = 16;
constexpr int kMaxWidth = 64;                // levels * features a row
constexpr uint32_t kPrimeY = 2654435761u;
constexpr uint32_t kPrimeZ = 805459861u;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kBox = 2.0f;                 // the contracted ball's cube
constexpr float kNormEps = 1e-10f;           // core/contract.py _NORM_EPS
// core/gaussians.py PATTERN_ANGLES, in units of pi / 3.
__constant__ float kAngles[kPoints] = {0.0f, 2.0f, 4.0f, 3.0f, 5.0f, 1.0f};

struct Levels {
  int res[kMaxLevels];
  int dense[kMaxLevels];
  uint32_t mask[kMaxLevels];     // table size - 1 of a hashed level
  int64_t offset[kMaxLevels];    // the level's first entry
};

struct Inputs {
  const float* t;       // [rays, samples + 1]
  const float* o;       // [rays, 3]
  const float* d;       // [rays, 3]
  const float* r;       // [rays, 1]
  const float* turn;    // [rays, samples] or null: the render's pattern
  const float* mirror;  // [rays, samples]
  int64_t t_stride, o_stride, d_stride, r_stride, turn_stride, mirror_stride;
};

// A point in the grid's unit cube and k = 1 / (sqrt(8) sigma), sigma its
// std in the cube's units: the downweight at resolution n is erf(k / n).
struct Point {
  float p[3];
  float k;
};

// core/gaussians.py::multisample_cast, core/contract.py::contract_isotropic
// and core/hashgrid.py::unit_points for point j of sample `i` of `ray`.
__device__ Point make_point(const Inputs& in, int64_t ray, int i, int j) {
  const float t0 = in.t[ray * in.t_stride + i];
  const float t1 = in.t[ray * in.t_stride + i + 1];
  const float tm = 0.5f * (t0 + t1), td = 0.5f * (t1 - t0);
  const float tm2 = tm * tm, td2 = td * td;
  const float spread = 3.0f / sqrtf(7.0f) *
                       (2.0f * static_cast<float>(j) / (kPoints - 1) - 1.0f);
  const float root = sqrtf((td2 - tm2) * (td2 - tm2) + 4.0f * tm2 * tm2);
  const float t =
      t0 + td / (td2 + 3.0f * tm2) * (t1 * t1 + 2.0f * tm2 + spread * root);
  const float base = kAngles[j] * (kPi / 3.0f);
  float theta;
  if (in.turn != nullptr) {
    theta = base + 2.0f * kPi * in.turn[ray * in.turn_stride + i];
    if (in.mirror[ray * in.mirror_stride + i] < 0.5f)
      theta = 5.0f * kPi / 3.0f - theta;
  } else {
    theta = (i & 1) ? 5.0f * kPi / 3.0f - (base + kPi / 6.0f) : base;
  }
  float sn, cs;
  sincosf(theta, &sn, &cs);
  const float* d = in.d + ray * in.d_stride;
  const float* o = in.o + ray * in.o_stride;
  const float inv = 1.0f / sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  const float nx = d[0] * inv, ny = d[1] * inv, nz = d[2] * inv;
  // core/gaussians.py::ray_basis (Duff et al. 2017).
  const float s = copysignf(1.0f, nz);
  const float a = -1.0f / (s + nz);
  const float b = nx * ny * a;
  const float u[3] = {1.0f + s * nx * nx * a, s * b, -s * nx};
  const float v[3] = {b, s + ny * ny * a, -ny};
  const float off = in.r[ray * in.r_stride] * t / sqrtf(2.0f);
  float x[3];
  for (int c = 0; c < 3; ++c)
    x[c] = o[c] + t * d[c] + off * (cs * u[c] + sn * v[c]);
  float sigma = 0.5f * off;
  const float n2 = x[0] * x[0] + x[1] * x[1] + x[2] * x[2];
  if (n2 > 1.0f) {
    const float n = sqrtf(fmaxf(n2, kNormEps));
    const float scale = (2.0f - 1.0f / n) / n;
    for (int c = 0; c < 3; ++c) x[c] *= scale;
    const float c3 = cbrtf(fmaxf(2.0f * n - 1.0f, 0.0f));
    sigma *= c3 * c3 / (n * n);
  }
  Point pt;
  for (int c = 0; c < 3; ++c)
    pt.p[c] = fminf(fmaxf((x[c] + kBox) / (2.0f * kBox), 0.0f), 1.0f);
  pt.k = 1.0f / (sqrtf(8.0f) * (sigma / (2.0f * kBox)));
  return pt;
}

// The cell of `pt` at level `l`: its lower corner and fractions.
struct Cell {
  uint32_t i[3];
  float f[3];
};

__device__ __forceinline__ Cell cell_of(const Point& pt, int n) {
  Cell c;
  for (int a = 0; a < 3; ++a) {
    const float x = pt.p[a] * static_cast<float>(n);
    const float lo = fminf(fmaxf(floorf(x), 0.0f), static_cast<float>(n - 1));
    c.i[a] = static_cast<uint32_t>(lo);
    c.f[a] = x - lo;
  }
  return c;
}

// Entry of corner `k` (offset (k & 1, k >> 1 & 1, k >> 2 & 1)) of `c` at
// level `l`, and its trilinear weight.
__device__ __forceinline__ int64_t corner(const Levels& lv, int l,
                                          const Cell& c, int k, float* w) {
  const uint32_t x = c.i[0] + (k & 1), y = c.i[1] + ((k >> 1) & 1),
                 z = c.i[2] + ((k >> 2) & 1);
  *w = ((k & 1) ? c.f[0] : 1.0f - c.f[0]) *
       (((k >> 1) & 1) ? c.f[1] : 1.0f - c.f[1]) *
       (((k >> 2) & 1) ? c.f[2] : 1.0f - c.f[2]);
  const uint32_t side = static_cast<uint32_t>(lv.res[l]) + 1u;
  const uint32_t idx = lv.dense[l] ? x + side * (y + side * z)
                                   : (x ^ (y * kPrimeY) ^ (z * kPrimeZ)) &
                                         lv.mask[l];
  return lv.offset[l] + idx;
}

template <int F>
__device__ __forceinline__ void load(const float* __restrict__ e, float* v) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int q = 0; q < F; q += 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(e + q));
      v[q] = x.x; v[q + 1] = x.y; v[q + 2] = x.z; v[q + 3] = x.w;
    }
  } else if constexpr (F == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(e));
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = __ldg(e);
  }
}

template <int F>
__device__ __forceinline__ void scatter(float* e, const float* v) {
  if constexpr (F % 4 == 0) {
#pragma unroll
    for (int q = 0; q < F; q += 4)
      atomicAdd(reinterpret_cast<float4*>(e + q),
                make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]));
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(e), make_float2(v[0], v[1]));
  } else {
    atomicAdd(e, v[0]);
  }
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(uint16_t* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float get(const float* p) { return *p; }
__device__ __forceinline__ float get(const uint16_t* p) {
  return __bfloat162float(__ushort_as_bfloat16(*p));
}

// H1: block b takes rows [32 b, 32 b + 32); `out` [rows, levels * F].
template <int F, typename Out>
__global__ void __launch_bounds__(kThreads)
    hashgrid_fwd(Inputs in, const float* __restrict__ table,
                 Out* __restrict__ out, int64_t rows, int samples, int levels,
                 Levels lv) {
  extern __shared__ float part[];   // [kRows][kPoints][width]
  const int width = levels * F;
  const int lr = threadIdx.x / kPoints, j = threadIdx.x % kPoints;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t row = row0 + lr;
  if (row < rows) {
    const int64_t ray = row / samples;
    const Point pt = make_point(in, ray, static_cast<int>(row - ray * samples),
                                j);
    float* mine = part + threadIdx.x * width;
    for (int l = 0; l < levels; ++l) {
      const Cell c = cell_of(pt, lv.res[l]);
      float acc[F];
#pragma unroll
      for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float w, e[F];
        load<F>(table + corner(lv, l, c, k, &w) * F, e);
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] += w * e[f];
      }
      const float omega = erff(pt.k / static_cast<float>(lv.res[l]));
#pragma unroll
      for (int f = 0; f < F; ++f) mine[l * F + f] = acc[f] * omega;
    }
  }
  __syncthreads();
  const int64_t left = rows - row0;
  const int count = left < kRows ? static_cast<int>(left) : kRows;
  for (int e = threadIdx.x; e < count * width; e += kThreads) {
    const int r = e / width, q = e - r * width;
    const float* src = part + r * kPoints * width + q;
    float sum = src[0];
#pragma unroll
    for (int p = 1; p < kPoints; ++p) sum += src[p * width];
    put(out + row0 * width + e, sum / static_cast<float>(kPoints));
  }
}

// H2: the gradient of H1's table from `g` [rows, levels * F] (row stride
// g_stride), added into `grad` [entries, F]. The lanes of a warp that add
// into the same entry (a sample's 6 points share most levels' cells, and
// neighbouring samples the coarse levels') first sum their addends, in lane
// order, through shared memory; the lowest of them adds the sum.
template <int F, typename G>
__global__ void __launch_bounds__(kThreads)
    hashgrid_bwd(Inputs in, const G* __restrict__ g, int64_t g_stride,
                 float* __restrict__ grad, int64_t rows, int samples,
                 int levels, Levels lv) {
  __shared__ float addend[kThreads][F];
  const int lr = threadIdx.x / kPoints, j = threadIdx.x % kPoints;
  const int lane = threadIdx.x & 31, warp0 = threadIdx.x & ~31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + lr;
  const bool valid = row < rows;
  Point pt{};
  const G* gr = g;
  if (valid) {
    const int64_t ray = row / samples;
    pt = make_point(in, ray, static_cast<int>(row - ray * samples), j);
    gr = g + row * g_stride;
  }
  for (int l = 0; l < levels; ++l) {
    float s[F];
    bool any = false;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      s[f] = valid ? get(gr + l * F + f) *
                         (erff(pt.k / static_cast<float>(lv.res[l])) /
                          static_cast<float>(kPoints))
                   : 0.0f;
      any |= s[f] != 0.0f;
    }
    if (!__any_sync(0xffffffffu, any)) continue;
    const Cell c = cell_of(pt, lv.res[l]);
#pragma unroll 1
    for (int k = 0; k < 8; ++k) {
      float w;
      const int64_t e = valid ? corner(lv, l, c, k, &w) : -1 - lane;
#pragma unroll
      for (int f = 0; f < F; ++f)
        addend[threadIdx.x][f] = valid ? s[f] * w : 0.0f;
      const unsigned peers = __match_any_sync(
          0xffffffffu, static_cast<unsigned long long>(e));
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1) {
        float v[F];
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = 0.0f;
        for (unsigned m = peers; m; m &= m - 1) {
          const float* a = addend[warp0 + __ffs(m) - 1];
#pragma unroll
          for (int f = 0; f < F; ++f) v[f] += a[f];
        }
        scatter<F>(grad + e * F, v);
      }
      __syncwarp();
    }
  }
}

bool make_inputs(const void* t, long long ts, const void* o, long long os,
                 const void* d, long long ds, const void* r, long long rs,
                 const void* turn, long long turns, const void* mirror,
                 long long mirrors, Inputs* in) {
  if ((turn == nullptr) != (mirror == nullptr)) return false;
  *in = Inputs{static_cast<const float*>(t), static_cast<const float*>(o),
               static_cast<const float*>(d), static_cast<const float*>(r),
               static_cast<const float*>(turn),
               static_cast<const float*>(mirror), ts, os, ds, rs, turns,
               mirrors};
  return true;
}

// The levels' layout, as core/hashgrid.py::grid_spec makes it: dense where
// (n + 1)^3 <= 2^log2_table.
bool make_levels(int levels, const int* res, const long long* offsets,
                 int log2_table, Levels* lv) {
  if (levels < 1 || levels > kMaxLevels || log2_table < 1 || log2_table > 30)
    return false;
  const long long table = 1ll << log2_table;
  for (int l = 0; l < levels; ++l) {
    const long long side = static_cast<long long>(res[l]) + 1;
    if (res[l] < 1 || side > (1 << 20) || offsets[l] < 0) return false;
    lv->res[l] = res[l];
    lv->dense[l] = side * side * side <= table;
    lv->mask[l] = static_cast<uint32_t>(table - 1);
    lv->offset[l] = offsets[l];
  }
  return true;
}

bool takes(int features, int levels) {
  return (features == 1 || features == 2 || features == 4 || features == 8) &&
         levels * features <= kMaxWidth;
}

template <int F, typename Out>
int launch_fwd(const Inputs& in, const float* table, void* out, int64_t rows,
               int samples, int levels, const Levels& lv,
               cudaStream_t stream) {
  const int64_t blocks = (rows + kRows - 1) / kRows;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kThreads) * levels * F *
                      sizeof(float);
  hashgrid_fwd<F, Out><<<static_cast<unsigned>(blocks), kThreads, smem,
                         stream>>>(in, table, static_cast<Out*>(out), rows,
                                   samples, levels, lv);
  return static_cast<int>(cudaGetLastError());
}

template <typename Out>
int dispatch_fwd(int features, const Inputs& in, const float* table,
                 void* out, int64_t rows, int samples, int levels,
                 const Levels& lv, cudaStream_t stream) {
  switch (features) {
    case 1: return launch_fwd<1, Out>(in, table, out, rows, samples, levels, lv, stream);
    case 2: return launch_fwd<2, Out>(in, table, out, rows, samples, levels, lv, stream);
    case 4: return launch_fwd<4, Out>(in, table, out, rows, samples, levels, lv, stream);
    default: return launch_fwd<8, Out>(in, table, out, rows, samples, levels, lv, stream);
  }
}

template <int F, typename G>
int launch_bwd(const Inputs& in, const void* g, int64_t g_stride,
               float* grad, int64_t rows, int samples, int levels,
               const Levels& lv, cudaStream_t stream) {
  const int64_t blocks = (rows + kRows - 1) / kRows;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  hashgrid_bwd<F, G><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      in, static_cast<const G*>(g), g_stride, grad, rows, samples, levels, lv);
  return static_cast<int>(cudaGetLastError());
}

template <typename G>
int dispatch_bwd(int features, const Inputs& in, const void* g,
                 int64_t g_stride, float* grad, int64_t rows, int samples,
                 int levels, const Levels& lv, cudaStream_t stream) {
  switch (features) {
    case 1: return launch_bwd<1, G>(in, g, g_stride, grad, rows, samples, levels, lv, stream);
    case 2: return launch_bwd<2, G>(in, g, g_stride, grad, rows, samples, levels, lv, stream);
    case 4: return launch_bwd<4, G>(in, g, g_stride, grad, rows, samples, levels, lv, stream);
    default: return launch_bwd<8, G>(in, g, g_stride, grad, rows, samples, levels, lv, stream);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Launches H1 on `stream`: out [rays * samples, levels * features] (bf16
// when `bf16`, else float32) from t_vals [rays, samples + 1], origins and
// directions [rays, 3], radii [rays, 1] and, when not null, the training
// pattern's turn and mirror uniforms [rays, samples], all float32 with the
// given row strides and unit column strides; `table` [entries, features]
// float32, level l's first entry offsets[l], its resolution res[l]. Returns
// cudaGetLastError().
extern "C" int hashgrid_forward_launch(
    const void* t_vals, long long t_stride, const void* origins,
    long long o_stride, const void* directions, long long d_stride,
    const void* radii, long long r_stride, const void* turn,
    long long turn_stride, const void* mirror, long long mirror_stride,
    const void* table, int features, int levels, const int* res,
    const long long* offsets, int log2_table, void* out, int bf16,
    long long rays, int samples, void* stream_) {
  Inputs in;
  Levels lv;
  if (rays <= 0 || samples <= 0 || !takes(features, levels) ||
      !make_inputs(t_vals, t_stride, origins, o_stride, directions, d_stride,
                   radii, r_stride, turn, turn_stride, mirror, mirror_stride,
                   &in) ||
      !make_levels(levels, res, offsets, log2_table, &lv) ||
      !aligned16(table))
    return cudaErrorInvalidValue;
  const auto stream = static_cast<cudaStream_t>(stream_);
  const auto tab = static_cast<const float*>(table);
  const int64_t rows = rays * samples;
  if (bf16)
    return dispatch_fwd<uint16_t>(features, in, tab, out, rows, samples,
                                  levels, lv, stream);
  return dispatch_fwd<float>(features, in, tab, out, rows, samples, levels,
                             lv, stream);
}

// Launches H2 on `stream`: adds the table gradient of H1's encode against
// the cotangent g [rays * samples, levels * features] (bf16 when `g_bf16`,
// else float32; row stride g_stride) into `grad` [entries, features]
// float32, which the caller zeroes. The other arguments as H1's. Returns
// cudaGetLastError().
extern "C" int hashgrid_backward_launch(
    const void* t_vals, long long t_stride, const void* origins,
    long long o_stride, const void* directions, long long d_stride,
    const void* radii, long long r_stride, const void* turn,
    long long turn_stride, const void* mirror, long long mirror_stride,
    void* grad, int features, int levels, const int* res,
    const long long* offsets, int log2_table, const void* g,
    long long g_stride, int g_bf16, long long rays, int samples,
    void* stream_) {
  Inputs in;
  Levels lv;
  if (rays <= 0 || samples <= 0 || !takes(features, levels) ||
      !make_inputs(t_vals, t_stride, origins, o_stride, directions, d_stride,
                   radii, r_stride, turn, turn_stride, mirror, mirror_stride,
                   &in) ||
      !make_levels(levels, res, offsets, log2_table, &lv) ||
      !aligned16(grad) || g_stride < levels * features)
    return cudaErrorInvalidValue;
  const auto stream = static_cast<cudaStream_t>(stream_);
  const auto out = static_cast<float*>(grad);
  const int64_t rows = rays * samples;
  if (g_bf16)
    return dispatch_bwd<uint16_t>(features, in, g, g_stride, out, rows,
                                  samples, levels, lv, stream);
  return dispatch_bwd<float>(features, in, g, g_stride, out, rows, samples,
                             levels, lv, stream);
}

extern "C" const char* hashgrid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
