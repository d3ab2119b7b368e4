// G1: one ReLU layer of the MLP forward, relu(bf16(x @ w + b)), in one GEMM
// for Hopper (sm_90a). Bound in ops/mlp_gemm.py, used by
// models/mlp.py::relu_stack_heads.
//
// It replaces no TPU kernel. The JAX package writes the layer as plain jnp
// (mipnerf360_tpu/models/mlp.py::apply_linear, apply_mlp: an f32-output dot,
// the f32 bias add, the cast to bf16, the ReLU) and XLA fuses the bias, the
// cast and the ReLU into the dot. On the card the port ran that layer as
// cuBLAS's f32-output GEMM and then E1 (csrc/mlp_epilogue.cu): the GEMM wrote
// the [M, N] f32 product (4 bytes an element) and E1 read it back to write
// the bf16 output (2 bytes). G1 applies the bias, the rounding and the ReLU
// to the f32 accumulators and writes only the bf16 output.
//
// Arithmetic: x [M, K] bf16, w [K, N] bf16, b [N] f32. The accumulators sum
// x w in f32 (the tensor cores' products of bf16 are exact); then, as E1:
// the f32 bias added, rounded to bf16 to nearest even (the card's conversion
// instruction, as PyTorch's cast), and the ReLU, NaN kept. The sum runs in
// another order than cuBLAS's, so an output can differ from the cuBLAS + E1
// chain's by one bf16 ulp where the two f32 sums straddle a rounding
// boundary. A layer with a second input (the published trunk's skip) takes
// x0 [M, K0] with w[:K0] and x1 [M, K1] with w[K0:] in one K loop: the f32
// sum of both products (the chain added two f32 products), then the bias.
//
// What bounds it: at the NeRF layers (K = N = 1024) the tensor cores,
// 2 M K N operations at 989 TFLOP/s (M = 262,144: 569 us, against 320 us for
// its bytes); at the proposal layers (K = N = 256) the bytes, the input read
// and the output written once (M = 262,144: 80 us, against 36 us of
// operations). Without G1 the f32 product is written and read once more:
// 8 bytes an element.
//
// Design (a persistent, warp-specialised TMA and wgmma kernel): one block
// an SM, of three warpgroups, walks the [128 x BN] output tiles with N
// fastest, so the blocks that run together share their rows of x, which
// are read from device memory once and then from L2; w (at most 3 MB) stays
// in L2. Warpgroup 0 gives up its registers (setmaxnreg) and one of its
// threads keeps a ring of 3-4 stages full by TMA: each stage a [128 x 64]
// box of x and BN/64 [64 x 64] boxes of w, 128-byte swizzled, each stage's
// arrival signalled on an mbarrier. Warpgroups 1 and 2 take the registers
// and 64 rows of the tile each: per stage four wgmma m64nBNk16 (x K-major,
// w N-major, transposed by the instruction), one group in flight, the stage
// handed back when its group is done. The epilogue adds the bias (read
// through L1), rounds, applies the ReLU and writes the tile into shared
// memory in the swizzled layout (conflict-free 4-byte stores), from where
// one TMA store per 64 columns writes it out while the warpgroup starts the
// next tile; the store is waited for only before that buffer is written
// again. K tails and the M tail are TMA's: the boxes read zeros past the
// input's width and rows (and past w's rows), and the stores clip at M.
// BN = 256, 128 or 64 by N (a template parameter, chosen by N alone); the
// stages fill what shared memory the tile's output buffer leaves.
// TMA needs each input's rows 16-byte aligned: a width that is a multiple
// of 8 at a pitch that is one too; models/mlp.py keeps the cuBLAS + E1
// chain for layers G1 does not take (the published view layer's 27
// direction features). The tensor maps are encoded on the host at each
// call through the driver's cuTensorMapEncodeTiled, fetched by the runtime
// (no link to libcuda).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBM = 128;             // rows of an output tile
constexpr int kBK = 64;              // K of a stage: one 128-byte swizzle row
constexpr int kConsumers = 2;        // warpgroups that multiply, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kMaxSmem = 232448;     // a block's shared memory on sm_90
constexpr int kMaxStages = 4;

template <int BN>
struct Layout {
  static constexpr int kA = kBM * kBK * 2;     // x box of a stage
  static constexpr int kB = kBK * BN * 2;      // BN / 64 boxes of w
  static constexpr int kStage = kA + kB;
  static constexpr int kC = kBM * BN * 2;      // the output tile
  static constexpr int kFit = (kMaxSmem - 1024 - kC - 128) / kStage;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kCOffset = kStages * kStage;   // after A and B rings
  static constexpr int kBarOffset = kCOffset + kC;
  // 1024 bytes of slack: the swizzled boxes start on 1024-byte boundaries.
  static constexpr int kBytes = 1024 + kBarOffset + 2 * kStages * 8;
  static_assert(kStages >= 3, "a tile of this width leaves too few stages");
  static_assert(kBytes <= kMaxSmem, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// A 2-D box of `map` at (inner, outer) into shared memory; completion is
// counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int inner, int outer, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(inner), "r"(outer),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int inner,
                                          int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}],"
      " [%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(inner), "r"(outer), "r"(smem_u32(src))
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A wgmma operand in shared memory, 128-byte swizzled: `lead` and `stride`
// in bytes (for K-major x the stride between 8-row groups, the lead unused;
// for N-major w the lead between 64-column boxes, the stride between 8-row
// groups of K).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead,
                                              uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulators across a wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t a,
                                      uint64_t b, int accumulate);

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A K-major, B N-major, both
// 128-byte swizzled in shared memory; `accumulate` 0 overwrites D.
template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A K-major, B N-major, both
// 128-byte swizzled in shared memory; `accumulate` 0 overwrites D.
template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256]: A K-major, B N-major, both
// 128-byte swizzled in shared memory; `accumulate` 0 overwrites D.
template <>
__device__ __forceinline__ void wgmma<256>(float (&d)[128], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// max(v, 0) of a bf16 value, NaN kept (torch.relu's; E1's).
__device__ __forceinline__ uint32_t relu_bf16(uint32_t b) {
  return ((b & 0x8000u) && (b & 0x7fffu) <= 0x7f80u) ? 0u : b;
}

// relu(bf16(v + b)), v an accumulator and b the f32 bias, as E1.
__device__ __forceinline__ uint32_t bias_relu(float v, float b) {
  return relu_bf16(__bfloat16_as_ushort(__float2bfloat16_rn(v + b)));
}

// out [m, N] = relu(bf16(a0 w0 (+ a1 w1) + bias)) over `tiles` [128 x BN]
// tiles, `tiles_n` of them across N; `kb0` and `kb1` stages of K from the
// first and the second input.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_gemm_bias_relu(const __grid_constant__ CUtensorMap a0,
                       const __grid_constant__ CUtensorMap a1,
                       const __grid_constant__ CUtensorMap w0,
                       const __grid_constant__ CUtensorMap w1,
                       const __grid_constant__ CUtensorMap out,
                       const float* __restrict__ bias, int m, int tiles_n,
                       int tiles, int kb0, int kb1) {
  using L = Layout<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring_a = smem;
  uint8_t* ring_b = smem + L::kStages * L::kA;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + L::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int kb = kb0 + kb1;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // The producer: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * BN;
        for (int k = 0; k < kb; ++k) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], L::kStage);
          const bool second = k >= kb0;
          const int kk = (second ? k - kb0 : k) * kBK;
          tma_load(ring_a + stage * L::kA, second ? &a1 : &a0, kk, m0,
                   &full[stage]);
#pragma unroll
          for (int s = 0; s < BN / 64; ++s)
            tma_load(ring_b + stage * L::kB + s * kBK * 128,
                     second ? &w1 : &w0, n0 + s * 64, kk, &full[stage]);
          if (++stage == L::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // A consumer: rows 64 (wg - 1) to 64 wg of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    const int row = (t >> 5) * 16 + (lane >> 2);  // and row + 8
    const uint32_t a_base = smem_u32(ring_a) + cw * 64 * 128;
    const uint32_t b_base = smem_u32(ring_b);
    uint8_t* c_tile = smem + L::kCOffset + cw * 64 * BN * 2;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * BN;
      int prev = 0;
      for (int k = 0; k < kb; ++k) {
        mbar_wait(&full[stage], phase);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < kBK / 16; ++s)
          wgmma<BN>(acc,
                    smem_desc(a_base + stage * L::kA + s * 32, 16, 1024),
                    smem_desc(b_base + stage * L::kB + s * 16 * 128,
                              kBK * 128, 1024),
                    (k | s) != 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (k > 0 && t == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == L::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs<BN / 2>(acc);
      if (t == 0) mbar_arrive(&empty[prev]);

      // The epilogue. The previous tile's store must have read the buffer.
      if (t == 0)
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      bar_sync(1 + cw, 128);
      const float* b_tile = bias + n0 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 b = __ldg(reinterpret_cast<const float2*>(b_tile + 8 * j));
        const uint32_t lo = bias_relu(acc[4 * j], b.x) |
                            (bias_relu(acc[4 * j + 1], b.y) << 16);
        const uint32_t hi = bias_relu(acc[4 * j + 2], b.x) |
                            (bias_relu(acc[4 * j + 3], b.y) << 16);
        // Column block j / 8 is a [64 x 64] box of 128-byte rows; its 16-byte
        // chunk j % 8 of row r sits at chunk (j % 8) ^ (r % 8).
        uint8_t* box = c_tile + (j / 8) * 64 * 128;
        const int off = (((j & 7) ^ (row & 7)) << 4) + 4 * (lane & 3);
        *reinterpret_cast<uint32_t*>(box + row * 128 + off) = lo;
        *reinterpret_cast<uint32_t*>(box + (row + 8) * 128 + off) = hi;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1 + cw, 128);
      if (t == 0 && m0 + cw * 64 < m) {
#pragma unroll
        for (int s = 0; s < BN / 64; ++s)
          tma_store(&out, c_tile + s * 64 * 128, n0 + s * 64, m0 + cw * 64);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a bf16 [rows, cols] matrix with rows `pitch` elements apart,
// read or written in 128-byte swizzled boxes of [box_rows x 64].
bool make_map(CUtensorMap* map, const void* ptr, long long rows, int cols,
              long long pitch, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                   const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Lets the kernel of tile width BN use its shared memory on the current
// device: set once a device (the attribute is the device context's), not at
// every call.
template <int BN>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};  // a bit per device
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (bit & done.load(std::memory_order_relaxed)) return cudaSuccess;
  e = cudaFuncSetAttribute(mlp_gemm_bias_relu<BN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Layout<BN>::kBytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

template <int BN>
int launch(const CUtensorMap (&maps)[5], const float* bias, long long m,
           int n, int kb0, int kb1, int sms, cudaStream_t stream) {
  using L = Layout<BN>;
  const cudaError_t e = allow_smem<BN>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_n = n / BN;
  const long long tiles = (m + kBM - 1) / kBM * tiles_n;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  mlp_gemm_bias_relu<BN><<<grid, kThreads, L::kBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], bias, static_cast<int>(m),
      tiles_n, static_cast<int>(tiles), kb0, kb1);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Launches G1 on `stream`: out [m, n] bf16 = relu(bf16(x0 w[:k0] (+ x1
// w[k0:]) + bias)), x0 [m, k0] and x1 [m, k1] bf16 with rows pitch0 and
// pitch1 elements apart (x1 null for one input), w [k0 + k1, n] bf16
// contiguous, bias [n] f32, over at most `sms` blocks. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.
extern "C" int mlp_gemm_launch(const void* x0, long long pitch0, int k0,
                               const void* x1, long long pitch1, int k1,
                               const void* w, const void* bias, void* out,
                               long long m, int n, int sms, void* stream_) {
  const bool two = x1 != nullptr;
  if (m <= 0 || m >= (1ll << 31) || n <= 0 || n % 64 || k0 <= 0 ||
      sms <= 0 || pitch0 < k0 || pitch0 % 8 || (two && (k1 <= 0 ||
      pitch1 < k1 || pitch1 % 8 || !aligned(x1))) || !aligned(x0) ||
      !aligned(w) || !aligned(bias) || !aligned(out))
    return cudaErrorInvalidValue;
  if (!encoder()) return cudaErrorNotSupported;
  const int bn = n % 256 == 0 ? 256 : n % 128 == 0 ? 128 : 64;
  const auto w_rows = static_cast<const uint16_t*>(w);
  CUtensorMap maps[5];  // x0, x1, w[:k0], w[k0:], out
  bool ok = make_map(&maps[0], x0, m, k0, pitch0, kBM) &&
            make_map(&maps[2], w, k0, n, n, kBK) &&
            make_map(&maps[4], out, m, n, n, 64);
  if (two)
    ok = ok && make_map(&maps[1], x1, m, k1, pitch1, kBM) &&
         make_map(&maps[3], w_rows + static_cast<long long>(k0) * n, k1, n,
                  n, kBK);
  else
    maps[1] = maps[0], maps[3] = maps[2];
  if (!ok) return cudaErrorInvalidValue;
  const int kb0 = (k0 + kBK - 1) / kBK;
  const int kb1 = two ? (k1 + kBK - 1) / kBK : 0;
  const auto b = static_cast<const float*>(bias);
  const auto stream = static_cast<cudaStream_t>(stream_);
  if (bn == 256) return launch<256>(maps, b, m, n, kb0, kb1, sms, stream);
  if (bn == 128) return launch<128>(maps, b, m, n, kb0, kb1, sms, stream);
  return launch<64>(maps, b, m, n, kb0, kb1, sms, stream);
}

extern "C" const char* mlp_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
