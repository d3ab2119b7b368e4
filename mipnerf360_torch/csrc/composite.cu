// K1 and K2: the composite of density into compositing weights, forward and
// backward, for Hopper (sm_90a).
//
// K1 replaces the TPU kernel mipnerf360_tpu/ops/pallas/composite.py::_fwd_kernel
// (with its in-kernel prefix sum ops/pallas/common.py::cumsum_lanes, K3).
// Per ray, with N samples:
//
//     delta_i = (t_{i+1} - t_i) * ||dir||
//     dd_i    = density_i * delta_i
//     T_i     = exp(-sum_{j<i} dd_j)
//     w_i     = -expm1(-dd_i) * T_i
//
// -expm1f matches the plain PyTorch version (core/rendering.py) where the TPU
// kernel needed a Taylor branch below dd = 1e-2 (Mosaic has no expm1). Only w
// is written: the TPU kernel's second output, trans, has no reader.
//
// K2 replaces composite.py::_bwd_kernel, the custom-VJP backward: given the
// cotangent g of w it recomputes the forward and writes
//
//     d_density_j = (g_j * exp(-dd_j) * T_j - sum_{i>j} g_i * w_i) * delta_j
//
// (t_vals and dirs get no cotangent: they are data or under stop-gradient).
//
// What bounds them. At the train batch (B = 4096 rays, N = 64) K1 reads
// ~2.2 MB (density, t_vals, dirs) and writes ~1.0 MB (w): 0.96 us at
// 3.35 TB/s. K2 reads ~3.2 MB (g as well) and writes ~1.0 MB: 1.27 us. But
// the grid fits the 132 SMs in one wave, so every block starts at once and
// the time is the launch, one memory round trip, and then the instructions
// each SM issues for its rays: per sample K1 evaluates expm1f and expf, K2
// expm1f and two expf (tens of instructions each with the accurate
// functions); the rest is scan, indexing and bounds. chip_smoke.py prints
// each kernel's SASS instruction count beside its time.
//
// Design: one memory round trip per tile, the ray in registers, and as few
// instructions per sample as the arithmetic allows.
// - Lane groups. A group of G lanes (a power of two, at most 32) owns one
//   ray and each lane K = 4 consecutive samples, so one register chunk
//   covers G*K samples; G is the least power of two with G*K >= N, at most
//   32 (16 at N = 64). A block of 256 threads holds R = 256/G rays (16 at
//   N = 64: B = 4096 gives 256 blocks over the 132 SMs) and no shared
//   memory. A lane forms dd serially, takes a lane-local inclusive sum and
//   one __shfl_up_sync scan over the group (log2 G steps, unrolled: G is a
//   template argument). The exclusive prefix comes from the neighbour's
//   inclusive value, never as incl - dd, so no cancellation enters T. K2
//   takes the suffix sum of g*w the same way with __shfl_down_sync, adding
//   only the terms of the suffix (the TPU kernel's total - prefix cancels).
// - The copy. A lane loads its K densities (and g) with one 16-byte load
//   where the row is aligned, its K + 1 t_vals and its ray's dir, all
//   before any arithmetic, straight into registers: for N <= 128 (every
//   preset here takes 64) the tile pays one round trip, with no barrier and
//   no second pass, and results leave with one 16-byte store per lane. A
//   launch whose N fills the lanes (N == G*K), whose B is a multiple of R
//   and whose rows are 16-byte aligned (the train batch and the render
//   chunks) takes a kWhole instance with no bounds or alignment checks.
//   Staging the tile in shared memory first, by cp.async.bulk onto an
//   mbarrier, was built and measured slower at N = 64 (PERF.md): with
//   every block resident at once its round trip overlaps nothing, and it
//   adds a barrier, the wait and the shared-memory reads.
// - N > 128: a warp per ray (G = 32) loops over 128-sample chunks with the
//   carry, one round trip per chunk. K2 parks T of every chunk but the last
//   in its output row on the way forward (each lane reads back only what it
//   wrote, so no barrier), keeps the last chunk in registers, and walks
//   back over the earlier chunks reloading their inputs and T.
// - expf and expm1f; no fast-math intrinsics. Any B >= 1 and N >= 1 work,
//   so nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kPerLane = 4;    // K: consecutive samples a lane holds
constexpr int kThreads = 256;  // threads per block
constexpr int kMaxGroup = 32;  // G at most: a warp per ray
constexpr unsigned kFullMask = 0xffffffffu;

// ||dir|| of the thread's ray; 0 for a lane past the last ray.
__device__ __forceinline__ float dir_norm(const float* dirs, int64_t ray,
                                          bool valid) {
  if (!valid) return 0.f;
  const float* d = dirs + 3 * ray;
  const float x = d[0], y = d[1], z = d[2];
  return sqrtf(x * x + y * y + z * z);
}

// Exclusive prefix of dd along the ray at each of the lane's samples, from
// `carry` (the sum over earlier chunks) on. Returns the lane's inclusive sum
// over the group; lane G-1's is the chunk's total.
template <int G>
__device__ __forceinline__ float prefix(const float (&dd)[kPerLane],
                                        float (&pre)[kPerLane], float carry,
                                        int gl) {
  float s[kPerLane];
  s[0] = dd[0];
#pragma unroll
  for (int j = 1; j < kPerLane; ++j) s[j] = s[j - 1] + dd[j];
  float incl = s[kPerLane - 1];
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const float v = __shfl_up_sync(kFullMask, incl, off, G);
    if (gl >= off) incl += v;
  }
  // from the neighbour's inclusive sum, not incl - own total: no cancellation
  float excl = __shfl_up_sync(kFullMask, incl, 1, G);
  if (gl == 0) excl = 0.f;
  const float base = carry + excl;
  pre[0] = base;
#pragma unroll
  for (int j = 1; j < kPerLane; ++j) pre[j] = base + s[j - 1];
  return incl;
}

// Sum of gw over the ray's samples after each of the lane's samples, from
// `carry` (the sum over later chunks) on. Returns the lane's inclusive
// suffix over the group; lane 0's is the chunk's total.
template <int G>
__device__ __forceinline__ float suffix(const float (&gw)[kPerLane],
                                        float (&suf)[kPerLane], float carry,
                                        int gl) {
  float u[kPerLane];
  u[kPerLane - 1] = gw[kPerLane - 1];
#pragma unroll
  for (int j = kPerLane - 2; j >= 0; --j) u[j] = u[j + 1] + gw[j];
  float incl = u[0];
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    const float v = __shfl_down_sync(kFullMask, incl, off, G);
    if (gl + off < G) incl += v;
  }
  float excl = __shfl_down_sync(kFullMask, incl, 1, G);
  if (gl == G - 1) excl = 0.f;
  const float base = carry + excl;
  suf[kPerLane - 1] = base;
#pragma unroll
  for (int j = 0; j < kPerLane - 1; ++j) suf[j] = base + u[j + 1];
  return incl;
}

// Writes the lane's K results from row[i0] on, short of `cols`: 16-byte
// stores where the row allows them (always with kWhole, see below), else one
// store each.
template <bool kWhole>
__device__ __forceinline__ void store_lane(float* row, int i0, int cols,
                                           const float (&o)[kPerLane]) {
  static_assert(kPerLane % 4 == 0, "whole float4s per lane");
  if constexpr (!kWhole) {
    if (i0 + kPerLane > cols || (reinterpret_cast<uintptr_t>(row) & 15) != 0) {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        if (i0 + j < cols) row[i0 + j] = o[j];
      return;
    }
  }
  // __stwb: a plain 16-byte store, which the compiler otherwise splits
#pragma unroll
  for (int j = 0; j < kPerLane; j += 4)
    __stwb(reinterpret_cast<float4*>(row + i0 + j),
           make_float4(o[j], o[j + 1], o[j + 2], o[j + 3]));
}

// The lane's K values from row[i0] on, 0 at and past `cols`: 16-byte loads
// where the row allows them.
// kWhole: the launch has N == G*K, whole blocks of rays and 16-byte-aligned
// rows, so no lane checks a bound or an alignment.
template <bool kWhole>
__device__ __forceinline__ void load_lane(const float* row, int i0, int cols,
                                          float (&v)[kPerLane]) {
  if constexpr (!kWhole) {
    if (i0 + kPerLane > cols || (reinterpret_cast<uintptr_t>(row) & 15) != 0) {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        v[j] = i0 + j < cols ? row[i0 + j] : 0.f;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < kPerLane; j += 4) {
    const float4 q = *reinterpret_cast<const float4*>(row + i0 + j);
    v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
  }
}

// t_{i0} .. t_{i0+K} of a row of cols + 1 t_vals (none when cols <= 0), then
// delta and dd of the lane's K samples.
template <bool kWhole>
__device__ __forceinline__ void lane_dd(const float* t_row, int i0, int cols,
                                        const float (&dens)[kPerLane],
                                        float dnorm, float (&delta)[kPerLane],
                                        float (&dd)[kPerLane]) {
  float t[kPerLane + 1];
#pragma unroll
  for (int j = 0; j <= kPerLane; ++j)
    t[j] = kWhole || (i0 + j <= cols && cols > 0) ? t_row[i0 + j] : 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    delta[j] = kWhole || i0 + j < cols ? (t[j + 1] - t[j]) * dnorm : 0.f;
    dd[j] = dens[j] * delta[j];
  }
}

// Each kernel: a group of G lanes owns ray `ray`; chunk c is the ray's
// samples c .. c + G*K - 1, of which lane gl holds K from c + gl*K on, and
// `last` is where the last chunk starts (0 unless N > 128, so with G < 32
// it is 0 at compile time). `cols` is N, or 0 for a lane past the last ray,
// so that lane loads and stores nothing but still joins its group's
// shuffles. The density load comes first in each chunk: with the dir's
// loads first, K2 measured slower on the card.
template <int G, bool kWhole>
__global__ void __launch_bounds__(kThreads)
composite_fwd_regs(const float* __restrict__ density,   // [B, N]
                   const float* __restrict__ t_vals,    // [B, N+1]
                   const float* __restrict__ dirs,      // [B, 3]
                   float* __restrict__ w,               // [B, N]
                   int64_t num_rays, int n_arg) {
  constexpr int kChunk = G * kPerLane;
  constexpr bool kOneChunk = kWhole || G < kMaxGroup;  // N <= G*K
  const int n = kWhole ? kChunk : n_arg;
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * (kThreads / G) +
                      threadIdx.x / G;
  const int gl = threadIdx.x % G, i0 = gl * kPerLane;
  const bool valid = kWhole || ray < num_rays;
  const int cols = valid ? n : 0;
  const float* dens_row = density + ray * n;
  const float* t_row = t_vals + ray * (static_cast<int64_t>(n) + 1);
  float* w_row = w + ray * n;
  const int last = kOneChunk ? 0 : (n - 1) / kChunk * kChunk;
  float carry = 0.f;
  for (int c = 0; c <= last; c += kChunk) {
    float dens[kPerLane], delta[kPerLane], dd[kPerLane], pre[kPerLane],
        o[kPerLane];
    load_lane<kWhole>(dens_row + c, i0, cols - c, dens);
    const float dnorm = dir_norm(dirs, ray, valid);
    lane_dd<kWhole>(t_row + c, i0, cols - c, dens, dnorm, delta, dd);
    const float incl = prefix<G>(dd, pre, carry, gl);
    if (c < last) carry += __shfl_sync(kFullMask, incl, G - 1, G);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) o[j] = -expm1f(-dd[j]) * expf(-pre[j]);
    store_lane<kWhole>(w_row + c, i0, cols - c, o);
  }
}

template <int G, bool kWhole>
__global__ void __launch_bounds__(kThreads)
composite_bwd_regs(const float* __restrict__ density,   // [B, N]
                   const float* __restrict__ t_vals,    // [B, N+1]
                   const float* __restrict__ dirs,      // [B, 3]
                   const float* __restrict__ g,         // [B, N]
                   float* __restrict__ d_density,       // [B, N]
                   int64_t num_rays, int n_arg) {
  constexpr int kChunk = G * kPerLane;
  constexpr bool kOneChunk = kWhole || G < kMaxGroup;  // N <= G*K
  const int n = kWhole ? kChunk : n_arg;
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * (kThreads / G) +
                      threadIdx.x / G;
  const int gl = threadIdx.x % G, i0 = gl * kPerLane;
  const bool valid = kWhole || ray < num_rays;
  const int cols = valid ? n : 0;
  const float* dens_row = density + ray * n;
  const float* g_row = g + ray * n;
  const float* t_row = t_vals + ray * (static_cast<int64_t>(n) + 1);
  float* out_row = d_density + ray * n;
  const int last = kOneChunk ? 0 : (n - 1) / kChunk * kChunk;

  // Chunks before the last (N > 128 only): T, parked in the output row.
  float carry = 0.f;
  for (int c = 0; c < last; c += kChunk) {
    float dens[kPerLane], delta[kPerLane], dd[kPerLane], pre[kPerLane],
        trans[kPerLane];
    load_lane<kWhole>(dens_row + c, i0, cols - c, dens);
    const float dnorm = dir_norm(dirs, ray, valid);
    lane_dd<kWhole>(t_row + c, i0, cols - c, dens, dnorm, delta, dd);
    const float incl = prefix<G>(dd, pre, carry, gl);
    carry += __shfl_sync(kFullMask, incl, G - 1, G);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) trans[j] = expf(-pre[j]);
    store_lane<kWhole>(out_row + c, i0, cols - c, trans);
  }
  // Chunks from the last to the first: T (from the prefix in the last
  // chunk, read back in the others), g*w and the local term g*exp(-dd)*T,
  // the suffix sum of g*w, then d_density.
  float tail = 0.f;
  for (int c = last; c >= 0; c -= kChunk) {
    float dens[kPerLane], gr[kPerLane], trans[kPerLane], delta[kPerLane],
        dd[kPerLane];
    load_lane<kWhole>(dens_row + c, i0, cols - c, dens);
    load_lane<kWhole>(g_row + c, i0, cols - c, gr);
    if (c != last) load_lane<kWhole>(out_row + c, i0, cols - c, trans);
    const float dnorm = dir_norm(dirs, ray, valid);
    lane_dd<kWhole>(t_row + c, i0, cols - c, dens, dnorm, delta, dd);
    if (c == last) {
      float pre[kPerLane];
      prefix<G>(dd, pre, carry, gl);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) trans[j] = expf(-pre[j]);
    }
    float gw[kPerLane], local[kPerLane], suf[kPerLane], o[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      gw[j] = gr[j] * (-expm1f(-dd[j]) * trans[j]);
      local[j] = gr[j] * expf(-dd[j]) * trans[j];
    }
    const float incl = suffix<G>(gw, suf, tail, gl);
    if (c > 0) tail += __shfl_sync(kFullMask, incl, 0, G);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) o[j] = (local[j] - suf[j]) * delta[j];
    store_lane<kWhole>(out_row + c, i0, cols - c, o);
  }
}

// G for a ray of n samples: the least power of two with G*K >= n, at most
// a warp.
inline int group_for(int n) {
  int g = 1;
  while (g < kMaxGroup && g * kPerLane < n) g *= 2;
  return g;
}

// The kernels' launches, one per (G, kWhole).
template <int G, bool kWhole>
struct FwdRegs {
  static void run(unsigned blocks, cudaStream_t stream, const float* density,
                  const float* t_vals, const float* dirs, float* w,
                  int64_t num_rays, int n) {
    composite_fwd_regs<G, kWhole><<<blocks, kThreads, 0, stream>>>(
        density, t_vals, dirs, w, num_rays, n);
  }
};

template <int G, bool kWhole>
struct BwdRegs {
  static void run(unsigned blocks, cudaStream_t stream, const float* density,
                  const float* t_vals, const float* dirs, const float* g,
                  float* d_density, int64_t num_rays, int n) {
    composite_bwd_regs<G, kWhole><<<blocks, kThreads, 0, stream>>>(
        density, t_vals, dirs, g, d_density, num_rays, n);
  }
};

template <template <int, bool> class Launch, bool kWhole, class... A>
void launch_regs(int group, A... args) {
  switch (group) {
    case 1: Launch<1, kWhole>::run(args...); break;
    case 2: Launch<2, kWhole>::run(args...); break;
    case 4: Launch<4, kWhole>::run(args...); break;
    case 8: Launch<8, kWhole>::run(args...); break;
    case 16: Launch<16, kWhole>::run(args...); break;
    default: Launch<32, kWhole>::run(args...);
  }
}

// Launches a kernel for N samples per ray: the kWhole instance when N fills
// the lanes, the rays fill the blocks and the rows `rows` read and write
// with 16-byte accesses are 16-byte aligned.
template <template <int, bool> class Launch, class... A>
int launch_for(long long num_rays, int n,
               std::initializer_list<const void*> rows, A... args) {
  const int group = group_for(n);
  const int rays = kThreads / group;
  const long long blocks = (num_rays + rays - 1) / rays;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  bool whole = n == group * kPerLane && num_rays % rays == 0;
  for (const void* p : rows)
    whole = whole && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  if (whole)
    launch_regs<Launch, true>(group, static_cast<unsigned>(blocks), args...);
  else
    launch_regs<Launch, false>(group, static_cast<unsigned>(blocks), args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K1 on `stream`. Pointers are device pointers to contiguous
// float32 arrays; returns cudaGetLastError() (0 on success).
extern "C" int composite_fwd(const void* density_, const void* t_vals_,
                             const void* dirs_, void* w_, long long num_rays,
                             int n, void* stream_) {
  if (num_rays <= 0 || n <= 0) return cudaErrorInvalidValue;
  const auto density = static_cast<const float*>(density_);
  const auto w = static_cast<float*>(w_);
  return launch_for<FwdRegs>(num_rays, n, {density, w},
                             static_cast<cudaStream_t>(stream_), density,
                             static_cast<const float*>(t_vals_),
                             static_cast<const float*>(dirs_), w,
                             static_cast<int64_t>(num_rays), n);
}

// Launches K2 on `stream`: d_density from the cotangent g of w. Pointers are
// device pointers to contiguous float32 arrays; returns cudaGetLastError().
extern "C" int composite_bwd(const void* density_, const void* t_vals_,
                             const void* dirs_, const void* g_,
                             void* d_density_, long long num_rays, int n,
                             void* stream_) {
  if (num_rays <= 0 || n <= 0) return cudaErrorInvalidValue;
  const auto density = static_cast<const float*>(density_);
  const auto g = static_cast<const float*>(g_);
  const auto d_density = static_cast<float*>(d_density_);
  return launch_for<BwdRegs>(num_rays, n, {density, g, d_density},
                             static_cast<cudaStream_t>(stream_), density,
                             static_cast<const float*>(t_vals_),
                             static_cast<const float*>(dirs_), g, d_density,
                             static_cast<int64_t>(num_rays), n);
}

extern "C" const char* composite_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
