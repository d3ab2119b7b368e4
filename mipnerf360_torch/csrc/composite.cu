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
// Design: one warp per ray. Lanes stride the sample axis 32 samples at a
// time; an inclusive __shfl_up_sync scan of dd within each 32-sample segment
// plus a running carry across segments replaces the TPU's [N, N] triangular
// matmul. The warp computes ||dir|| itself. Any B >= 1 and N >= 1 work, so
// nothing is padded. Loads and stores are coalesced along the sample axis.
// K2 makes two passes over the ray: a forward pass that writes T_j into the
// output row as scratch, then a backward pass over the segments in reverse
// that reads T_j back, and takes the suffix sum of g*w from a reverse warp
// scan (__shfl_down_sync) with a running carry. The TPU kernel takes that
// suffix as total - inclusive prefix, which cancels; the reverse scan adds
// only the terms that belong to the suffix. Each lane reads back only what
// it wrote itself, so the passes need no barrier.
//
// Bound on the card: memory. At the train batch (B = 4096 rays, N = 64) K1
// reads ~2.2 MB (density, t_vals, dirs) and writes ~1.0 MB (w), a floor of
// ~1 us at 3.35 TB/s, and does ~10 flops per sample; K2 reads ~3.2 MB (g as
// well) and writes ~1.0 MB, ~1.3 us. At that size both are bound by launch
// latency, and both are tiny beside the two MLPs they sit between (~15.7
// MFLOP per sample forward at the quality preset).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;  // one ray per warp, 8 rays per block
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
composite_fwd_kernel(const float* __restrict__ density,   // [B, N]
                     const float* __restrict__ t_vals,    // [B, N+1]
                     const float* __restrict__ dirs,      // [B, 3]
                     float* __restrict__ w,               // [B, N]
                     int64_t num_rays, int num_samples) {
  const int lane = threadIdx.x & 31;
  const int64_t ray =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ray >= num_rays) return;  // uniform across the warp

  const float dx = dirs[ray * 3 + 0];
  const float dy = dirs[ray * 3 + 1];
  const float dz = dirs[ray * 3 + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);

  const float* dens = density + ray * num_samples;
  const float* t = t_vals + ray * (static_cast<int64_t>(num_samples) + 1);
  float* out = w + ray * num_samples;

  float carry = 0.f;  // sum of dd over the segments already done
  for (int seg = 0; seg < num_samples; seg += 32) {
    const int i = seg + lane;
    float dd = 0.f;
    if (i < num_samples) dd = dens[i] * ((t[i + 1] - t[i]) * dnorm);

    // Inclusive scan of dd across the warp (Hillis-Steele, 5 steps).
    float incl = dd;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl += v;
    }
    // Exclusive prefix taken from the neighbour, not as incl - dd, so no
    // cancellation enters the transmittance.
    float excl = __shfl_up_sync(kFullMask, incl, 1);
    if (lane == 0) excl = 0.f;

    if (i < num_samples) out[i] = -expm1f(-dd) * expf(-(carry + excl));
    carry += __shfl_sync(kFullMask, incl, 31);
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
composite_bwd_kernel(const float* __restrict__ density,   // [B, N]
                     const float* __restrict__ t_vals,    // [B, N+1]
                     const float* __restrict__ dirs,      // [B, 3]
                     const float* __restrict__ g,         // [B, N]
                     float* __restrict__ d_density,       // [B, N]
                     int64_t num_rays, int num_samples) {
  const int lane = threadIdx.x & 31;
  const int64_t ray =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ray >= num_rays) return;  // uniform across the warp

  const float dx = dirs[ray * 3 + 0];
  const float dy = dirs[ray * 3 + 1];
  const float dz = dirs[ray * 3 + 2];
  const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);

  const float* dens = density + ray * num_samples;
  const float* t = t_vals + ray * (static_cast<int64_t>(num_samples) + 1);
  const float* gr = g + ray * num_samples;
  float* out = d_density + ray * num_samples;

  // Pass 1, forward: T_j as in K1, parked in out[j].
  float carry = 0.f;
  for (int seg = 0; seg < num_samples; seg += 32) {
    const int i = seg + lane;
    float dd = 0.f;
    if (i < num_samples) dd = dens[i] * ((t[i + 1] - t[i]) * dnorm);
    float incl = dd;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFullMask, incl, off);
      if (lane >= off) incl += v;
    }
    float excl = __shfl_up_sync(kFullMask, incl, 1);
    if (lane == 0) excl = 0.f;
    if (i < num_samples) out[i] = expf(-(carry + excl));
    carry += __shfl_sync(kFullMask, incl, 31);
  }

  // Pass 2, backward over the segments: the suffix sum of g*w by a reverse
  // scan, the last segment first.
  float suffix_carry = 0.f;  // sum of g*w over the segments already done
  for (int seg = ((num_samples - 1) / 32) * 32; seg >= 0; seg -= 32) {
    const int i = seg + lane;
    float gw = 0.f, local = 0.f, delta = 0.f;
    if (i < num_samples) {
      delta = (t[i + 1] - t[i]) * dnorm;
      const float dd = dens[i] * delta;
      const float trans = out[i];
      const float gi = gr[i];
      gw = gi * (-expm1f(-dd) * trans);
      local = gi * expf(-dd) * trans;
    }
    // Inclusive reverse scan: lane l holds the sum over lanes l..31.
    float incl = gw;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_down_sync(kFullMask, incl, off);
      if (lane + off < 32) incl += v;
    }
    // Exclusive suffix from the neighbour, as the forward takes its prefix.
    float excl = __shfl_down_sync(kFullMask, incl, 1);
    if (lane == 31) excl = 0.f;
    if (i < num_samples) out[i] = (local - (suffix_carry + excl)) * delta;
    suffix_carry += __shfl_sync(kFullMask, incl, 0);
  }
}

}  // namespace

// Launches K1 on `stream`. Pointers are device pointers to contiguous
// float32 arrays; returns cudaGetLastError() (0 on success).
extern "C" int composite_fwd(const void* density, const void* t_vals,
                             const void* dirs, void* w, long long num_rays,
                             int num_samples, void* stream) {
  if (num_rays <= 0 || num_samples <= 0) return cudaErrorInvalidValue;
  const long long blocks = (num_rays + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  composite_fwd_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(density), static_cast<const float*>(t_vals),
      static_cast<const float*>(dirs), static_cast<float*>(w), num_rays,
      num_samples);
  return static_cast<int>(cudaGetLastError());
}

// Launches K2 on `stream`: d_density from the cotangent g of w. Pointers are
// device pointers to contiguous float32 arrays; returns cudaGetLastError().
extern "C" int composite_bwd(const void* density, const void* t_vals,
                             const void* dirs, const void* g, void* d_density,
                             long long num_rays, int num_samples,
                             void* stream) {
  if (num_rays <= 0 || num_samples <= 0) return cudaErrorInvalidValue;
  const long long blocks = (num_rays + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  composite_bwd_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(density), static_cast<const float*>(t_vals),
      static_cast<const float*>(dirs), static_cast<const float*>(g),
      static_cast<float*>(d_density), num_rays, num_samples);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* composite_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
