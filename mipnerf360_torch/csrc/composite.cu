// K1: density -> compositing weights, the forward transmittance scan, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mipnerf360_tpu/ops/pallas/composite.py::_fwd_kernel
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
// Design: one warp per ray. Lanes stride the sample axis 32 samples at a
// time; an inclusive __shfl_up_sync scan of dd within each 32-sample segment
// plus a running carry across segments replaces the TPU's [N, N] triangular
// matmul. The warp computes ||dir|| itself. Any B >= 1 and N >= 1 work, so
// nothing is padded. Loads and stores are coalesced along the sample axis.
//
// Bound on the card: memory. At the render chunk (B = 4096 rays, N = 64) it
// reads ~2.2 MB (density, t_vals, dirs) and writes ~1.0 MB (w), a floor of
// ~1 us at 3.35 TB/s, and does ~10 flops per sample; at that size it is
// bound by launch latency. Either way it is tiny beside the two MLPs it
// sits between (~15.7 MFLOP per sample at the quality preset).
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

extern "C" const char* composite_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
