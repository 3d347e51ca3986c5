// bf16 GEMM with f32 accumulation for Hopper (sm_90a): wgmma, a TMA/mbarrier
// ring and persistent blocks.
//
// Replaces the TPU kernel kube_gpu_stats_tpu/loadgen/pallas_burn.py::_build
// (the body under pl.pallas_call): C[M,N] = A[M,K] @ B[K,N] for row-major
// contiguous bf16 A and B, f32 C, M, N and K multiples of 128. On the TPU the
// K axis was the last, sequential grid axis and the sum lived in the output
// block across grid steps; here a block keeps a tile's sum in registers while
// it walks K itself, and stores C once.
//
// Bound: 2*M*N*K operations against A and B read once and C written once,
// about 1,000 FLOP per byte at 4096^3, far above the H100's ~295 FLOP/byte
// ridge. So it is bound by tensor-core operations: 2*M*N*K at 989 TFLOP/s
// dense bf16 on H100 SXM (NVIDIA data sheet), 0.139 ms at 4096^3.
//
// What the design does about it:
// - Only warpgroup wgmma reaches that rate. Each block has two consumer
//   warpgroups; each owns 64 rows of a 128 x BN tile (BN = 256 or 128) and
//   issues wgmma.m64nBNk16 with both operands read from shared memory, four
//   per 64-deep K stage, the sum in BN/2 f32 registers a thread.
// - Loads must not stall the math. One producer thread issues TMA copies into
//   a ring of shared-memory stages; a "full" mbarrier per stage counts the
//   bytes in, an "empty" one counts the consumer warps out. Consumers keep one
//   stage's wgmma group in flight while they wait for the next stage.
// - A persistent grid (one block per SM) walks the tiles in a grouped order,
//   so blocks in flight share A and B panels in L2, and the producer runs
//   ahead into the next tile while the consumers store the last one.
// - C (f32, as large as A and B together at a square shape) is stored
//   straight from registers, in float4s after shuffles within each quad of
//   lanes; the shared memory holds no C tile.
// - setmaxnreg moves registers from the producer warpgroup (40) to the
//   consumers (232), which hold the accumulators.
//
// Shared-memory layouts (128-byte TMA swizzle, read by wgmma descriptors):
// - A stage: one 128 (M) x 64 (K) box, rows of 128 bytes: K-major.
// - B stage: BN/64 boxes of 64 (K) x 64 (N), each row 128 bytes of N: B is
//   MN-major, so wgmma runs with B transposed (imm-trans-b = 1), the
//   descriptor's leading offset steps from one 64-column box to the next and
//   its stride offset from one 8-row group of K to the next, and each k16
//   step moves 16 rows down the box.
//
// The instance (BN) and the grid come from gemm_plan(), which the wrapper's
// tiled_burn.gemm_plan mirrors and kts_tiled_gemm_plan exports; keep the
// three in step.
//
// C interface: kts_tiled_gemm_bf16_f32 launches on the given stream, does not
// synchronise, allocates nothing and returns cudaGetLastError() (or a CUDA
// error code of its own when it refuses the shape or cannot encode the TMA
// descriptors). The caller guarantees M, N, K are multiples of 128 and the
// pointers 16-byte aligned.

#include <cuda.h>  // CUtensorMap and its enums only; no -lcuda needed
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kBlockM = 128;
constexpr int kBlockK = 64;     // 64 bf16 = 128 bytes: one swizzled row
constexpr int kBoxN = 64;       // B box width, 128 bytes
constexpr int kConsumers = 2;   // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kGroupM = 8;      // M blocks per group of the tile order
constexpr int kSwizzleAlign = 1024;  // 8 rows x 128 bytes: the swizzle atom

template <int BN>
struct Shape {
  static constexpr int kStages = BN == 256 ? 4 : 6;
  static constexpr int kABytes = kBlockM * kBlockK * 2;  // 16 KB
  static constexpr int kBBytes = kBlockK * BN * 2;       // 32 or 16 KB
  static constexpr int kBoxBytes = kBlockK * kBoxN * 2;  // 8 KB
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmemBytes =
      kStages * kStageBytes + 2 * kStages * 8 + kSwizzleAlign;
  static_assert(kSmemBytes <= 232448, "more shared memory than a block has");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// One 2-D TMA box into shared memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner), "r"(outer)
      : "memory");
}

// wgmma shared-memory descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

template <int N>
__device__ __forceinline__ void keep_in_registers(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

#define KTS_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A[64 x 16] @ B[16 x BN]: A K-major, B MN-major (transposed), both
// from shared memory; scale_d = 0 overwrites d instead of adding to it.
template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t a,
                                      uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma<256>(float (&d)[128], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : KTS_D8(0), KTS_D8(8), KTS_D8(16), KTS_D8(24), KTS_D8(32), KTS_D8(40),
        KTS_D8(48), KTS_D8(56), KTS_D8(64), KTS_D8(72), KTS_D8(80),
        KTS_D8(88), KTS_D8(96), KTS_D8(104), KTS_D8(112), KTS_D8(120)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : KTS_D8(0), KTS_D8(8), KTS_D8(16), KTS_D8(24), KTS_D8(32), KTS_D8(40),
        KTS_D8(48), KTS_D8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef KTS_D8

// Tile t of the grouped order: kGroupM M blocks at a time, each group walked
// column by column, so consecutive tiles share B panels and a group's tiles
// share A panels. Mirrored by tiled_burn.tile_coords.
__device__ __forceinline__ void tile_coords(int t, int num_m, int num_n,
                                            int& m_blk, int& n_blk) {
  const int per_group = kGroupM * num_n;
  const int first_m = t / per_group * kGroupM;
  const int rows = min(num_m - first_m, kGroupM);
  const int r = t % per_group;
  m_blk = first_m + r % rows;
  n_blk = r / rows;
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_bf16_f32(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  float* __restrict__ c, int m, int n, int k) {
  using S = Shape<BN>;
  extern __shared__ uint8_t smem_raw[];
  // The swizzle repeats every 1024 bytes; wgmma's descriptors and TMA's
  // writes agree only on stages that start on that boundary.
  const uint32_t base =
      (smem_addr(smem_raw) + kSwizzleAlign - 1) & ~uint32_t(kSwizzleAlign - 1);
  const uint32_t a_ring = base;
  const uint32_t b_ring = base + S::kStages * S::kABytes;
  const uint32_t full_bar = base + S::kStages * S::kStageBytes;
  const uint32_t empty_bar = full_bar + S::kStages * 8;

  const int num_m = m / kBlockM;
  const int num_n = n / BN;
  const int tiles = num_m * num_n;
  const int k_blocks = k / kBlockK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);                 // the producer
      mbar_init(empty_bar + 8 * s, kConsumers * 4);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  // One if/else for the two roles, never rejoined: ptxas ignores setmaxnreg
  // (warning C7508) when it cannot tell which path a warpgroup runs.
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];" ::"l"(
                       reinterpret_cast<uint64_t>(&map_b))
                   : "memory");
      // Stage and phase run on across tiles: the ring does not restart.
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m_blk, n_blk;
        tile_coords(t, num_m, num_n, m_blk, n_blk);
        for (int kb = 0; kb < k_blocks; ++kb) {
          // The first pass over the ring finds every stage free.
          mbar_wait(empty_bar + 8 * stage, phase ^ 1);
          const uint32_t full = full_bar + 8 * stage;
          mbar_arrive_expect_tx(full, S::kStageBytes);
          tma_load(a_ring + stage * S::kABytes, &map_a, full, kb * kBlockK,
                   m_blk * kBlockM);
#pragma unroll
          for (int j = 0; j < BN / kBoxN; ++j) {
            tma_load(b_ring + stage * S::kBBytes + j * S::kBoxBytes, &map_b,
                     full, n_blk * BN + j * kBoxN, kb * kBlockK);
          }
          if (++stage == S::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int wg = threadIdx.x / 128 - 1;  // which 64 rows of the tile
    const int warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m_blk, n_blk;
      tile_coords(t, num_m, num_n, m_blk, n_blk);
      int held = 0;  // the stage whose wgmma group may still be reading
      for (int kb = 0; kb < k_blocks; ++kb) {
        mbar_wait(full_bar + 8 * stage, phase);
        const uint32_t a_tile = a_ring + stage * S::kABytes + wg * 64 * 128;
        const uint32_t b_tile = b_ring + stage * S::kBBytes;
        keep_in_registers(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockK / 16; ++kk) {
          // A: k16 is 32 bytes along a swizzled row; 8-row groups 1 KB apart.
          // B: k16 is 16 rows of 128 bytes; 8-row groups of K 1 KB apart,
          // 64-column boxes kBoxBytes apart.
          const uint64_t da = sw128_desc(a_tile + kk * 32, 16, 1024);
          const uint64_t db =
              sw128_desc(b_tile + kk * 16 * 128, S::kBoxBytes, 1024);
          wgmma<BN>(acc, da, db, (kb | kk) != 0);
        }
        wgmma_commit();
        keep_in_registers(acc);
        // The group before this one is done: its stage goes back to the
        // producer. This one keeps the tensor cores busy meanwhile.
        wgmma_wait<1>();
        keep_in_registers(acc);
        if (kb > 0 && lane == 0) mbar_arrive(empty_bar + 8 * held);
        held = stage;
        if (++stage == S::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      keep_in_registers(acc);
      if (lane == 0) mbar_arrive(empty_bar + 8 * held);

      // The accumulator layout of wgmma m64nBN: register 4j + 2h + e holds
      // row 16 * warp + lane / 4 + 8h, column 8j + 2q + e, q = lane % 4.
      // Column groups 2p and 2p + 1 of a row are 16 floats across a quad of
      // lanes: thread q holds a = columns 2q, 2q + 1 and b = 8 + 2q, 9 + 2q.
      // Two exchanges of a pair (even lanes offer a, odd lanes b, then the
      // reverse) give thread q columns 4q..4q + 3, so a warp's store writes
      // 64 contiguous bytes in each of its 8 rows, not 32.
      const int q = lane % 4;
      const int base_lane = lane & ~3;
      const int src1 = base_lane + ((q >> 1) | ((q & 1) << 1));
      const int src2 = src1 ^ 1;
      const bool even = (q & 1) == 0;
      const size_t row =
          static_cast<size_t>(m_blk) * kBlockM + wg * 64 + warp * 16 + lane / 4;
      float* out = c + row * n + static_cast<size_t>(n_blk) * BN + 4 * q;
#pragma unroll
      for (int p = 0; p < BN / 16; ++p) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float a0 = acc[8 * p + 2 * h], a1 = acc[8 * p + 2 * h + 1];
          const float b0 = acc[8 * p + 4 + 2 * h];
          const float b1 = acc[8 * p + 5 + 2 * h];
          const float s1x = __shfl_sync(0xffffffffu, even ? a0 : b0, src1);
          const float s1y = __shfl_sync(0xffffffffu, even ? a1 : b1, src1);
          const float s2x = __shfl_sync(0xffffffffu, even ? b0 : a0, src2);
          const float s2y = __shfl_sync(0xffffffffu, even ? b1 : a1, src2);
          const float4 v = q < 2 ? make_float4(s1x, s1y, s2x, s2y)
                                 : make_float4(s2x, s2y, s1x, s1y);
          *reinterpret_cast<float4*>(out + 8 * h * static_cast<size_t>(n) +
                                     16 * p) = v;
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled's type, spelled out so that only cuda.h's types are
// needed; the function is looked up in libcuda at run time.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* fn_ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn_ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn_ptr, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(fn_ptr)
               : nullptr;
  }();
  return fn;
}

// A row-major [rows, cols] bf16 matrix, read in boxes of box_rows x 64
// columns (128 bytes) with the 128-byte swizzle.
bool encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The instance and the grid. BN = 256 halves the B traffic into shared
// memory per operation, but needs N % 256 == 0, and on a shape with few tiles
// its tiles, twice the work each, leave SMs idle: take it when its busiest
// block has no more than half the 128-wide instance's tiles to do.
void gemm_plan(int m, int n, int sms, int* block_n, int* grid) {
  const int tiles_128 = m / kBlockM * (n / 128);
  const int tiles_256 = n % 256 ? 0 : m / kBlockM * (n / 256);
  const bool wide =
      tiles_256 > 0 && 2 * ceil_div(tiles_256, sms) <= ceil_div(tiles_128, sms);
  *block_n = wide ? 256 : 128;
  const int tiles = wide ? tiles_256 : tiles_128;
  *grid = tiles < sms ? tiles : sms;
}

// cudaFuncSetAttribute holds per device: set it once on each, per instance.
constexpr int kMaxDevices = 64;
std::atomic<int> g_sm_count[kMaxDevices];
std::atomic<bool> g_smem_set[kMaxDevices][2];

template <int BN>
cudaError_t allow_smem(int dev) {
  const bool cached = dev < kMaxDevices;
  if (cached && g_smem_set[dev][BN == 256].load()) return cudaSuccess;
  const cudaError_t rc =
      cudaFuncSetAttribute(gemm_bf16_f32<BN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Shape<BN>::kSmemBytes);
  if (cached && rc == cudaSuccess) g_smem_set[dev][BN == 256].store(true);
  return rc;
}

cudaError_t sm_count(int dev, int* sms) {
  if (dev < kMaxDevices && (*sms = g_sm_count[dev].load()) > 0) {
    return cudaSuccess;
  }
  const cudaError_t rc =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (dev < kMaxDevices && rc == cudaSuccess) g_sm_count[dev].store(*sms);
  return rc;
}

template <int BN>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_b, float* c,
           int m, int n, int k, int grid, int dev, cudaStream_t stream) {
  const cudaError_t rc = allow_smem<BN>(dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  gemm_bf16_f32<BN><<<grid, kThreads, Shape<BN>::kSmemBytes, stream>>>(
      map_a, map_b, c, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan kts_tiled_gemm_bf16_f32 launches with on a card of `sms` SMs.
extern "C" int kts_tiled_gemm_plan(int m, int n, int sms, int* block_n,
                                   int* grid) {
  if (m <= 0 || n <= 0 || sms <= 0 || m % kBlockM || n % 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gemm_plan(m, n, sms, block_n, grid);
  return 0;
}

extern "C" int kts_tiled_gemm_bf16_f32(const void* a, const void* b, void* c,
                                       int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || m % kBlockM || n % 128 || k % 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  int sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = sm_count(dev, &sms);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map_a, map_b;
  if (!encode_map(encode, &map_a, a, m, k, kBlockM) ||
      !encode_map(encode, &map_b, b, k, n, kBlockK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int block_n = 0;
  int grid = 0;
  gemm_plan(m, n, sms, &block_n, &grid);
  const auto s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(c);
  return block_n == 256
             ? launch<256>(map_a, map_b, out, m, n, k, grid, dev, s)
             : launch<128>(map_a, map_b, out, m, n, k, grid, dev, s);
}
