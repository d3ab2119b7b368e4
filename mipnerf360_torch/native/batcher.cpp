// Native host-side batch sampler/gatherer for the training data path (a copy
// of mipnerf360_tpu/native/batcher.cpp).
//
// The trainer stages K steps per chunk, so the host assembles a [K, B] index
// stack (or a [K, B, c] stack of gathered rays) per chunk; at large K*B the
// NumPy version serializes on the GIL. This library does the index
// generation and the strided gather in parallel C++ threads.
//
// Randomness is a counter-based splitmix64 stream: draw j of stream
// (seed, start) is splitmix64(seed ^ splitmix64(start + j)) % n_rays.
// Stateless => resume-deterministic (the trainer passes start = global ray
// counter) and bit-identical to the NumPy path in native/__init__.py.
//
// Built at first use by native/__init__.py:
//   g++ -O3 -shared -fPIC -std=c++17 -pthread batcher.cpp -o <build dir>/...

#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

void run_parallel(int64_t total, int n_threads,
                  const std::function<void(int64_t, int64_t)>& body) {
  if (n_threads <= 1 || total < (1 << 14)) {
    body(0, total);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (total + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < total ? lo + chunk : total;
    if (lo >= hi) break;
    threads.emplace_back([&body, lo, hi] { body(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// out[j] = splitmix64(seed ^ splitmix64(start + j)) % n_rays, j in [0, total)
void mnr_sample_indices(uint64_t seed, uint64_t start, int64_t total,
                        int64_t n_rays, int64_t* out, int n_threads) {
  run_parallel(total, n_threads, [=](int64_t lo, int64_t hi) {
    for (int64_t j = lo; j < hi; ++j) {
      out[j] = static_cast<int64_t>(
          splitmix64(seed ^ splitmix64(start + static_cast<uint64_t>(j))) %
          static_cast<uint64_t>(n_rays));
    }
  });
}

// For each of n_arrays [n_rays, dim_a] float32 sources, gather `total` rows
// given by idx into the matching [total, dim_a] destination.
void mnr_gather_rows(const float* const* srcs, const int64_t* dims,
                     int n_arrays, const int64_t* idx, int64_t total,
                     float* const* dsts, int n_threads) {
  run_parallel(total, n_threads, [=](int64_t lo, int64_t hi) {
    for (int a = 0; a < n_arrays; ++a) {
      const float* src = srcs[a];
      float* dst = dsts[a];
      const int64_t dim = dims[a];
      for (int64_t j = lo; j < hi; ++j) {
        std::memcpy(dst + j * dim, src + idx[j] * dim,
                    static_cast<size_t>(dim) * sizeof(float));
      }
    }
  });
}

// Fused: sample indices and gather in one pass (no index materialization).
void mnr_fill_batch_stack(uint64_t seed, uint64_t start, int64_t total,
                          int64_t n_rays, const float* const* srcs,
                          const int64_t* dims, int n_arrays,
                          float* const* dsts, int n_threads) {
  run_parallel(total, n_threads, [=](int64_t lo, int64_t hi) {
    for (int64_t j = lo; j < hi; ++j) {
      const int64_t row = static_cast<int64_t>(
          splitmix64(seed ^ splitmix64(start + static_cast<uint64_t>(j))) %
          static_cast<uint64_t>(n_rays));
      for (int a = 0; a < n_arrays; ++a) {
        const int64_t dim = dims[a];
        std::memcpy(dsts[a] + j * dim, srcs[a] + row * dim,
                    static_cast<size_t>(dim) * sizeof(float));
      }
    }
  });
}

}  // extern "C"
