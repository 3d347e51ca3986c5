// Tiled bf16 GEMM with f32 accumulation for Hopper (sm_90a).
//
// Replaces the TPU kernel kube_gpu_stats_tpu/loadgen/pallas_burn.py::_build
// (the body under pl.pallas_call): C[M,N] = A[M,K] @ B[K,N] for row-major
// contiguous bf16 A and B, f32 C. On the TPU the K axis was the last,
// sequential grid axis and the sum lived in the output block across grid
// steps. Blocks on a GPU run in no order, so here one block owns one 128x128
// output tile and walks K itself, in chunks of 32, keeping the sum in
// registers (wmma accumulator fragments) until a single store at the end.
//
// Bound: at M = N = K = 4096 the kernel does 2*M*N*K = 137 GFLOP against
// 128 MiB of compulsory traffic (A and B read once, C written once), about
// 1,000 FLOP per byte, far above the H100's ~295 FLOP/byte ridge. It is bound
// by tensor-core operations: 2*M*N*K at 989 TFLOP/s dense bf16 on H100 SXM
// (NVIDIA data sheet), 0.139 ms at 4096^3.
//
// What this simple design leaves for later: it issues warp-level mma.sync
// through nvcuda::wmma, not Hopper's warpgroup wgmma; it stages A and B
// through registers into shared memory with 16-byte loads, not TMA; and it
// does not pipeline (one shared-memory stage, loads and math alternate
// between barriers).
//
// C interface: kts_tiled_gemm_bf16_f32 launches on the given stream, does not
// synchronise, allocates nothing and returns cudaGetLastError(). The caller
// guarantees M, N, K are multiples of 128 and the pointers 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kBlockM = 128;
constexpr int kBlockN = 128;
constexpr int kBlockK = 32;
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;  // 256
constexpr int kWarpTileM = kBlockM / kWarpsM;     // 64 rows per warp
constexpr int kWarpTileN = kBlockN / kWarpsN;     // 32 columns per warp
constexpr int kFrag = 16;                         // wmma m16n16k16
constexpr int kFragsM = kWarpTileM / kFrag;       // 4
constexpr int kFragsN = kWarpTileN / kFrag;       // 2
constexpr int kVec = 8;                           // bf16 per 16-byte load
// Each shared-memory row is padded by 16 bytes: rows stay 16-byte aligned for
// the vector stores and every fragment start stays 32-byte aligned, as
// load_matrix_sync requires, while neighbouring rows land on other banks.
constexpr int kPad = 8;
constexpr int kLdA = kBlockK + kPad;  // 40 bf16 = 80 bytes
constexpr int kLdB = kBlockN + kPad;  // 136 bf16 = 272 bytes
constexpr int kLoadsA = kBlockM * kBlockK / kVec / kThreads;  // 2 per thread
constexpr int kLoadsB = kBlockK * kBlockN / kVec / kThreads;  // 2 per thread

static_assert(kBlockM * kBlockK % (kVec * kThreads) == 0, "A chunk split");
static_assert(kBlockK * kBlockN % (kVec * kThreads) == 0, "B chunk split");

__global__ void __launch_bounds__(kThreads)
tiled_gemm_bf16_f32(const __nv_bfloat16* __restrict__ a,
                    const __nv_bfloat16* __restrict__ b,
                    float* __restrict__ c, int n, int k) {
  __shared__ __align__(128) __nv_bfloat16 a_s[kBlockM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 b_s[kBlockK * kLdB];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / kWarpsN;
  const int warp_n = warp % kWarpsN;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * kBlockM;
  const size_t col0 = static_cast<size_t>(blockIdx.x) * kBlockN;
  const size_t ldk = static_cast<size_t>(k);
  const size_t ldn = static_cast<size_t>(n);

  wmma::fragment<wmma::accumulator, kFrag, kFrag, kFrag, float>
      acc[kFragsM][kFragsN];
#pragma unroll
  for (int i = 0; i < kFragsM; ++i) {
#pragma unroll
    for (int j = 0; j < kFragsN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }

  const __nv_bfloat16* a_blk = a + row0 * ldk;
  const __nv_bfloat16* b_blk = b + col0;

  for (int k0 = 0; k0 < k; k0 += kBlockK) {
    // A chunk: 128 rows x 32 columns, four 16-byte vectors per row.
#pragma unroll
    for (int it = 0; it < kLoadsA; ++it) {
      const int v = tid + it * kThreads;
      const int r = v / (kBlockK / kVec);
      const int col = (v % (kBlockK / kVec)) * kVec;
      *reinterpret_cast<uint4*>(&a_s[r * kLdA + col]) =
          *reinterpret_cast<const uint4*>(a_blk + r * ldk + k0 + col);
    }
    // B chunk: 32 rows x 128 columns, sixteen 16-byte vectors per row.
#pragma unroll
    for (int it = 0; it < kLoadsB; ++it) {
      const int v = tid + it * kThreads;
      const int r = v / (kBlockN / kVec);
      const int col = (v % (kBlockN / kVec)) * kVec;
      *reinterpret_cast<uint4*>(&b_s[r * kLdB + col]) =
          *reinterpret_cast<const uint4*>(b_blk + (k0 + r) * ldn + col);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBlockK; kk += kFrag) {
      wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, __nv_bfloat16,
                     wmma::row_major>
          a_frag[kFragsM];
      wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, __nv_bfloat16,
                     wmma::row_major>
          b_frag[kFragsN];
#pragma unroll
      for (int i = 0; i < kFragsM; ++i) {
        wmma::load_matrix_sync(
            a_frag[i], &a_s[(warp_m * kWarpTileM + i * kFrag) * kLdA + kk],
            kLdA);
      }
#pragma unroll
      for (int j = 0; j < kFragsN; ++j) {
        wmma::load_matrix_sync(
            b_frag[j], &b_s[kk * kLdB + warp_n * kWarpTileN + j * kFrag],
            kLdB);
      }
#pragma unroll
      for (int i = 0; i < kFragsM; ++i) {
#pragma unroll
        for (int j = 0; j < kFragsN; ++j) {
          wmma::mma_sync(acc[i][j], a_frag[i], b_frag[j], acc[i][j]);
        }
      }
    }
    // The next chunk overwrites a_s and b_s: every warp must be done reading.
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kFragsM; ++i) {
#pragma unroll
    for (int j = 0; j < kFragsN; ++j) {
      float* dst = c + (row0 + warp_m * kWarpTileM + i * kFrag) * ldn + col0 +
                   warp_n * kWarpTileN + j * kFrag;
      wmma::store_matrix_sync(dst, acc[i][j], n, wmma::mem_row_major);
    }
  }
}

}  // namespace

extern "C" int kts_tiled_gemm_bf16_f32(const void* a, const void* b, void* c,
                                       int m, int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || m % kBlockM || n % kBlockN ||
      k % kBlockK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n / kBlockN, m / kBlockM);
  tiled_gemm_bf16_f32<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<float*>(c), n, k);
  return static_cast<int>(cudaGetLastError());
}
