// E1, E2 and E3: the epilogue of the MLP layers around cuBLAS's GEMMs, for
// Hopper (sm_90a). Bound in ops/mlp_epilogue.py, used by models/mlp.py.
//
// They replace no TPU kernel. The JAX package writes the layer as plain jnp
// (mipnerf360_tpu/models/mlp.py::apply_linear, apply_mlp: an f32-output dot,
// the f32 bias add, the cast to bf16, the activation) and XLA fuses that
// chain into the dot's epilogue and its backward into a few loop fusions.
// PyTorch runs each step as a pass of its own over the [M, width] tensor
// (M = rays x samples), which made the epilogue the largest layer of the
// train step. These kernels do the same arithmetic in one pass each:
//
// E1 (forward, every hidden layer): h = relu(bf16(y + b)), y the f32 GEMM
//    output, b the f32 bias, added in f32 before the rounding. ReLU commutes
//    with the rounding to nearest. A layer with a second input (the
//    published trunk's skip, the view branch's direction encoding) has a
//    second f32 GEMM output y1 of the same shape:
//    h = relu(bf16((y + y1) + b)).
// E2 (backward, every hidden layer below another): g = bf16(dx) where h > 0,
//    else 0, with dx = dx0 (+ dx1) the f32 GEMM output of the layer above
//    (two parts where that layer's cotangent was split in hi + lo), h this
//    layer's saved bf16 output; db = the column sums of g in f32.
// E3 (backward, the last hidden layer under one or two heads of at most 4
//    outputs in all): each head's dx = sum_k hi_k w_jk + sum_k lo_k w_jk in
//    f32, k in order (hi + lo the head's f32 cotangent, split), rounded to
//    bf16, as the two thin GEMMs and the cast did. One head (split = 0, the
//    proposal MLP): g = that dx where h > 0, as E2. Two heads (split = 1, the
//    NeRF trunk with its density and rgb heads): s = dx_0 + dx_1 in f32, then
//    the mask, db, and s written as hi = bf16(s), lo = bf16(s - hi), the
//    split cotangent of the trunk's last GEMM pair. With one head and split,
//    a wide head's dX from its GEMM (f32, `extra`) is rounded to bf16 and
//    added to the thin head's: s = dx_0 + bf16(extra) (the published trunk
//    under its density head and bottleneck).
//
// The mask is h <= 0 -> 0, as threshold_backward reads the saved output: a
// NaN in h passes the gradient. Rounding is to nearest even, by the card's
// conversion instruction, as PyTorch's casts. The bias gradient has no
// atomics: each block of rows writes its column sums (each thread's rows in
// order, then the block's row slots in order) to a [blocks, N] scratch, and
// a second pass sums that in block order, so repeated runs give the same
// bits.
//
// What bounds them: bytes. Per element E1 reads 4 (8 with a second input)
// and writes 2; E2 reads 4 (8 with two parts) and 2 and writes
// 2; E3 reads 2 (6 with a wide head's dX) and writes 2 (4 split).
// At M = 262,144 and N = 1,024 E1 moves 1.61 GB (0.48 ms at 3.35 TB/s), E2
// 2.15 GB (0.64 ms), E3 split 1.61 GB (0.48 ms). The arithmetic is a few
// operations per element, far under the card's rate.
//
// Design: one memory round trip per element, 16-byte accesses. A thread
// holds 8 consecutive columns: one 16-byte load of bf16, two of f32, one
// 16-byte store. So N is a multiple of 8 with N/8 dividing the 256 threads
// of a block (8 to 2048 in powers of two: every width of the presets), and
// every [M, N] pointer and the bias are 16-byte aligned; the launchers
// refuse anything else, and models/mlp.py sends other widths down the
// layer-by-layer chain. E1 strides over the whole array. E2 and E3 give
// each block a run of rows and each thread fixed columns, so its column
// sums stay in registers; 256 / (N/8) rows are in flight per block, and the
// grid is 4 blocks per SM. E3 keeps the heads' weights at its columns in
// registers and reads each row's 2-8 head cotangents through L1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;    // threads per block
constexpr int kVec = 8;          // columns a thread holds
constexpr int kMaxHeads = 2;
constexpr int kMaxHeadCols = 4;  // outputs of all heads together, at most

__device__ __forceinline__ float bf16_to_f32(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// Round to nearest even: one cvt.rn.bf16.f32, as PyTorch's casts on the card.
__device__ __forceinline__ uint32_t f32_to_bf16(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// max(v, 0) of a bf16 value, NaN kept (torch.relu's).
__device__ __forceinline__ uint32_t relu_bf16(uint32_t b) {
  return ((b & 0x8000u) && (b & 0x7fffu) <= 0x7f80u) ? 0u : b;
}

// h <= 0 for a bf16 value (false for NaN).
__device__ __forceinline__ bool not_positive(uint32_t h) {
  const uint32_t mag = h & 0x7fffu;
  return mag == 0u || ((h & 0x8000u) && mag <= 0x7f80u);
}

__device__ __forceinline__ void load_f32(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load_bf16(const uint16_t* p,
                                          uint32_t (&v)[kVec]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = w[k] & 0xffffu;
    v[2 * k + 1] = w[k] >> 16;
  }
}

__device__ __forceinline__ void store_bf16(uint16_t* p,
                                           const uint32_t (&v)[kVec]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16),
                 v[4] | (v[5] << 16), v[6] | (v[7] << 16));
}

// E1: h = relu(bf16(y + b)) over y [M, N]; `total` = M * N. kTwo: y1
// [M, N] is added to y first.
template <bool kTwo>
__global__ void __launch_bounds__(kThreads)
    mlp_e1_bias_relu(const float* __restrict__ y,
                     const float* __restrict__ y1,
                     const float* __restrict__ bias,
                     uint16_t* __restrict__ h, int64_t total, int n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads * kVec;
  for (int64_t e = (static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x) * kVec;
       e < total; e += stride) {
    const int col = static_cast<int>(e % n);
    float v[kVec], b[kVec];
    load_f32(y + e, v);
    if constexpr (kTwo) {
      float v1[kVec];
      load_f32(y1 + e, v1);
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[k] += v1[k];
    }
    load_f32(bias + col, b);
    uint32_t out[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      out[k] = relu_bf16(f32_to_bf16(v[k] + b[k]));
    store_bf16(h + e, out);
  }
}

// The columns and rows a thread of a row block covers: 8 columns from
// `col`, rows r0 + slot, r0 + slot + slots, ...
struct Cover {
  int col, slot, slots;
  __device__ __forceinline__ explicit Cover(int n) {
    const int per_row = n / kVec;
    slots = kThreads / per_row;
    slot = threadIdx.x / per_row;
    col = (threadIdx.x % per_row) * kVec;
  }
};

// Writes the block's column sums: each thread's, summed over the block's
// row slots in slot order.
__device__ __forceinline__ void write_partial(const Cover& c,
                                              const float (&acc)[kVec],
                                              float* __restrict__ partial,
                                              int n) {
  float* row = partial + static_cast<int64_t>(blockIdx.x) * n;
  __shared__ float sums[kThreads * kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) sums[threadIdx.x * kVec + k] = acc[k];
  __syncthreads();
  if (c.slot == 0) {
    const int per_row = kThreads / c.slots;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      float s = sums[threadIdx.x * kVec + k];
      for (int q = 1; q < c.slots; ++q)
        s += sums[(q * per_row + threadIdx.x) * kVec + k];
      row[c.col + k] = s;
    }
  }
}

// E2: g = bf16(dx0 (+ dx1)) where h > 0, else 0; the block's column sums of
// g into `partial`.
template <int kParts>
__global__ void __launch_bounds__(kThreads)
    mlp_e2_relu_bwd(const float* __restrict__ dx0,
                    const float* __restrict__ dx1,
                    const uint16_t* __restrict__ h, uint16_t* __restrict__ g,
                    float* __restrict__ partial, int64_t m, int n,
                    int64_t rows_per_block) {
  const Cover c(n);
  float acc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < m ? r0 + rows_per_block : m;
#pragma unroll 4
  for (int64_t r = r0 + c.slot; r < r1; r += c.slots) {
    const int64_t e = r * n + c.col;
    float d[kVec];
    load_f32(dx0 + e, d);
    if constexpr (kParts == 2) {
      float d1[kVec];
      load_f32(dx1 + e, d1);
#pragma unroll
      for (int k = 0; k < kVec; ++k) d[k] += d1[k];
    }
    uint32_t hb[kVec], gb[kVec];
    load_bf16(h + e, hb);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      gb[k] = not_positive(hb[k]) ? 0u : f32_to_bf16(d[k]);
      acc[k] += bf16_to_f32(gb[k]);
    }
    store_bf16(g + e, gb);
  }
  write_partial(c, acc, partial, n);
}

// The heads of E3: head t's split cotangent hi[t], lo[t] [M, width[t]] and
// its weights w[t] [N, width[t]], all bf16. Output q of all heads together
// is output q of head 0 for q < width[0], else output q - width[0] of head 1.
struct Heads {
  const uint16_t* hi[kMaxHeads];
  const uint16_t* lo[kMaxHeads];
  const uint16_t* w[kMaxHeads];
  int width[kMaxHeads];
  int count;
};

// Where output q of the heads lives: its head's array, row stride and column.
__device__ __forceinline__ int64_t head_index(const Heads& heads, int q,
                                              int64_t row) {
  return q < heads.width[0] ? row * heads.width[0] + q
                            : row * heads.width[1] + q - heads.width[0];
}

__device__ __forceinline__ const uint16_t* head_array(
    const uint16_t* const (&arrays)[kMaxHeads], const Heads& heads, int q) {
  return q < heads.width[0] ? arrays[0] : arrays[1];
}

// E3: the heads' dx formed here, then as E2 (kSplit false, one head: g into
// out0) or summed over the heads (and `extra`, rounded, where not null),
// masked and split (kSplit: hi into out0, lo into out1); the block's column
// sums into `partial`.
template <bool kSplit>
__global__ void __launch_bounds__(kThreads)
    mlp_e3_heads_relu_bwd(Heads heads, const uint16_t* __restrict__ h,
                          const float* __restrict__ extra,
                          uint16_t* __restrict__ out0,
                          uint16_t* __restrict__ out1,
                          float* __restrict__ partial, int64_t m, int n,
                          int64_t rows_per_block) {
  const Cover c(n);
  const int outs = heads.width[0] + (heads.count == 2 ? heads.width[1] : 0);
  // the heads' weights at this thread's columns
  float w[kMaxHeadCols][kVec];
#pragma unroll
  for (int q = 0; q < kMaxHeadCols; ++q) {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      w[q][k] = q < outs ? bf16_to_f32(head_array(heads.w, heads, q)[
                               head_index(heads, q, c.col + k)])
                         : 0.f;
  }
  float acc[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < m ? r0 + rows_per_block : m;
  for (int64_t r = r0 + c.slot; r < r1; r += c.slots) {
    const int64_t e = r * n + c.col;
    uint32_t hb[kVec];
    load_bf16(h + e, hb);
    float ex[kVec];
    if (kSplit && extra) load_f32(extra + e, ex);
    float hi[kMaxHeadCols], lo[kMaxHeadCols];
#pragma unroll
    for (int q = 0; q < kMaxHeadCols; ++q) {
      const int64_t i = head_index(heads, q, r);
      hi[q] = q < outs ? bf16_to_f32(head_array(heads.hi, heads, q)[i]) : 0.f;
      lo[q] = q < outs ? bf16_to_f32(head_array(heads.lo, heads, q)[i]) : 0.f;
    }
    uint32_t o0[kVec], o1[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      // Sums of products of bf16 values, exact in f32, so each fused
      // multiply-add rounds as the separate add would; from -0, so the
      // first is the product itself, sign of zero included.
      float a0 = -0.f, b0 = -0.f, a1 = -0.f, b1 = -0.f;
#pragma unroll
      for (int q = 0; q < kMaxHeadCols; ++q) {
        if (q >= outs) continue;
        if (q < heads.width[0]) {
          a0 = fmaf(hi[q], w[q][k], a0);
          b0 = fmaf(lo[q], w[q][k], b0);
        } else {
          a1 = fmaf(hi[q], w[q][k], a1);
          b1 = fmaf(lo[q], w[q][k], b1);
        }
      }
      const uint32_t r_bits = f32_to_bf16(a0 + b0);
      if constexpr (kSplit) {
        float s = bf16_to_f32(r_bits);
        if (heads.count == 2) s += bf16_to_f32(f32_to_bf16(a1 + b1));
        if (extra) s += bf16_to_f32(f32_to_bf16(ex[k]));
        if (not_positive(hb[k])) s = 0.f;
        acc[k] += s;
        o0[k] = f32_to_bf16(s);
        o1[k] = f32_to_bf16(s - bf16_to_f32(o0[k]));
      } else {
        o0[k] = not_positive(hb[k]) ? 0u : r_bits;
        acc[k] += bf16_to_f32(o0[k]);
      }
    }
    store_bf16(out0 + e, o0);
    if constexpr (kSplit) store_bf16(out1 + e, o1);
  }
  write_partial(c, acc, partial, n);
}

// db[j] = the sum over blocks b of partial[b, j], in block order within each
// of the 8 warps' interleaved runs, then the warps in order.
__global__ void __launch_bounds__(kThreads)
    mlp_bias_grad_reduce(const float* __restrict__ partial,
                         float* __restrict__ db, int blocks, int n) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float sums[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < n)
    for (int b = warp; b < blocks; b += kWarps)
      s += partial[static_cast<int64_t>(b) * n + col];
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < n) {
    float t = sums[0][lane];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) t += sums[q][lane];
    db[col] = t;
  }
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  return true;
}

// Whether the kernels take width n and these pointers (the file's note).
bool takes(int n, std::initializer_list<const void*> ptrs) {
  if (n % kVec) return false;
  const int per_row = n / kVec;
  return per_row <= kThreads && kThreads % per_row == 0 && aligned16(ptrs);
}

int64_t rows_per_block(long long m, int blocks) {
  return (m + blocks - 1) / blocks;
}

// The second pass of E2 and E3, and the launch error of both.
int reduce_bias_grad(const float* partial, float* db, int blocks, int n,
                     cudaStream_t stream) {
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  mlp_bias_grad_reduce<<<(n + 31) / 32, kThreads, 0, stream>>>(partial, db,
                                                               blocks, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches E1 on `stream`: h [m, n] bf16 = relu(bf16(y + b)), y [m, n] and
// b [n] float32; where y1 is not null, relu(bf16((y + y1) + b)) with y1
// [m, n] float32. Pointers are device pointers to contiguous arrays; `blocks` caps the
// grid. Returns cudaGetLastError() (0 on success).
extern "C" int mlp_epilogue_e1(const void* y_, const void* y1_,
                               const void* b_, void* h_, long long m, int n,
                               int blocks, void* stream_) {
  if (m <= 0 || n <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  const auto y = static_cast<const float*>(y_);
  const auto y1 = static_cast<const float*>(y1_);
  const auto b = static_cast<const float*>(b_);
  const auto h = static_cast<uint16_t*>(h_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  if (!takes(n, {y, y1, b, h})) return cudaErrorInvalidValue;
  const int64_t total = static_cast<int64_t>(m) * n;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kVec;
  const int64_t need = (total + per_block - 1) / per_block;
  const unsigned grid = static_cast<unsigned>(need < blocks ? need : blocks);
  if (y1)
    mlp_e1_bias_relu<true><<<grid, kThreads, 0, stream>>>(y, y1, b, h, total,
                                                           n);
  else
    mlp_e1_bias_relu<false><<<grid, kThreads, 0, stream>>>(y, y1, b, h,
                                                            total, n);
  return static_cast<int>(cudaGetLastError());
}

// Launches E2 on `stream`: g [m, n] bf16 and db [n] float32 from dx0 (and
// dx1 when not null) [m, n] float32 and h [m, n] bf16; `partial` is
// [blocks, n] float32 scratch. Returns cudaGetLastError().
extern "C" int mlp_epilogue_e2(const void* dx0_, const void* dx1_,
                               const void* h_, void* g_, void* partial_,
                               void* db_, long long m, int n, int blocks,
                               void* stream_) {
  if (m <= 0 || n <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  const auto dx0 = static_cast<const float*>(dx0_);
  const auto dx1 = static_cast<const float*>(dx1_);
  const auto h = static_cast<const uint16_t*>(h_);
  const auto g = static_cast<uint16_t*>(g_);
  const auto partial = static_cast<float*>(partial_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  if (!takes(n, {dx0, dx1, h, g})) return cudaErrorInvalidValue;
  const int64_t rows = rows_per_block(m, blocks);
  if (dx1)
    mlp_e2_relu_bwd<2><<<blocks, kThreads, 0, stream>>>(dx0, dx1, h, g,
                                                     partial, m, n, rows);
  else
    mlp_e2_relu_bwd<1><<<blocks, kThreads, 0, stream>>>(dx0, dx1, h, g,
                                                     partial, m, n, rows);
  return reduce_bias_grad(partial, static_cast<float*>(db_), blocks, n,
                          stream);
}

// Launches E3 on `stream`. Head t (t < count, count 1 or 2) gives hi_t,
// lo_t [m, width_t] and w_t [n, width_t] bf16, widths summing to at most 4.
// split = 0 (one head): g [m, n] bf16 into out0; split = 1: hi and lo [m, n]
// bf16 into out0 and out1. `extra`, null or (split, one head) a wide head's
// dX [m, n] float32. db [n] float32; `partial` is [blocks, n] float32
// scratch. Returns cudaGetLastError().
extern "C" int mlp_epilogue_e3(const void* hi0, const void* lo0,
                               const void* w0, int width0, const void* hi1,
                               const void* lo1, const void* w1, int width1,
                               int count, const void* h_, const void* extra_,
                               void* out0_, void* out1_, void* partial_,
                               void* db_, long long m, int n, int blocks,
                               int split, void* stream_) {
  if (m <= 0 || n <= 0 || blocks <= 0 || count < 1 || count > kMaxHeads ||
      width0 < 1 || (count == 2 && width1 < 1) ||
      width0 + (count == 2 ? width1 : 0) > kMaxHeadCols ||
      (!split && count != 1) || (extra_ && (!split || count != 1)))
    return cudaErrorInvalidValue;
  Heads heads{};
  heads.hi[0] = static_cast<const uint16_t*>(hi0);
  heads.lo[0] = static_cast<const uint16_t*>(lo0);
  heads.w[0] = static_cast<const uint16_t*>(w0);
  heads.width[0] = width0;
  heads.hi[1] = static_cast<const uint16_t*>(hi1);
  heads.lo[1] = static_cast<const uint16_t*>(lo1);
  heads.w[1] = static_cast<const uint16_t*>(w1);
  heads.width[1] = count == 2 ? width1 : 0;
  heads.count = count;
  const auto h = static_cast<const uint16_t*>(h_);
  const auto extra = static_cast<const float*>(extra_);
  const auto out0 = static_cast<uint16_t*>(out0_);
  const auto out1 = static_cast<uint16_t*>(out1_);
  const auto partial = static_cast<float*>(partial_);
  const auto stream = static_cast<cudaStream_t>(stream_);
  if (!(split ? takes(n, {h, extra, out0, out1}) : takes(n, {h, out0})))
    return cudaErrorInvalidValue;
  const int64_t rows = rows_per_block(m, blocks);
  if (split)
    mlp_e3_heads_relu_bwd<true><<<blocks, kThreads, 0, stream>>>(
        heads, h, extra, out0, out1, partial, m, n, rows);
  else
    mlp_e3_heads_relu_bwd<false><<<blocks, kThreads, 0, stream>>>(
        heads, h, extra, out0, out1, partial, m, n, rows);
  return reduce_bias_grad(partial, static_cast<float*>(db_), blocks, n,
                          stream);
}

extern "C" const char* mlp_epilogue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
