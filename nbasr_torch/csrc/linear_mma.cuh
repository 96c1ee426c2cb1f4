// The fused cell's dense linear node on Hopper's tensor cores (sm_90a):
// one GEMM body, included by fused_cell.cu (the forward, z = src W) and
// fused_cell_bwd.cu (dx, g += dzc W^T, and dW = src^T dzc), for bf16
// operands with f32 sums.  Part of the replacement of the JAX kernels'
// _emit_linear (nbasr_tpu/ops/fused_cell.py), whose products run on the
// TPU's matrix unit.  f32 cells keep the SIMT kernels beside the callers:
// f32 on the tensor cores would be TF32, a lower precision than f32.
//
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): each product
// is 2 * rows * C * C operations against about 3 passes over [rows, C]
// (two operands and the output); at C = 600 that is 400 operations a
// byte, above the card's 295, so the tensor cores bound the product and
// the epilogue's traffic (multipliers, branch adds, f32 gradient buffers)
// comes close to it.
//
// Design: a block computes one kBM x kBN output tile (of one row chunk of
// dW).  One producer warp keeps kStages stages of operand tiles in flight
// by TMA (128-byte swizzle; zero fill beyond the matrices' edges, which
// covers the C = 600/1000/1200 tails and any row count), each stage on a
// full and an empty mbarrier; two consumer warpgroups each run
// wgmma.m64n128k16 on 64 rows of the tile, keeping one stage's products in
// flight while they wait for the next.  Each operand is read as it lies:
// a K-major tile is one box of 64 k by 128 rows, an MN-major tile (W in
// the forward, src and dzc in dW) two boxes of 64 columns by 64 k, which
// wgmma reads transposed.  Two blocks share an SM, so one block's
// epilogue overlaps the other's products.  The epilogue is the caller's,
// run over the f32 tile of the accumulators staged in shared memory, read
// back in 16-byte vectors along the output rows with several rows' global
// loads in flight a thread (an epilogue straight from the registers, on
// each thread's column pairs eight rows apart, waited on one load after
// another: the forward and dx ran at 10-20% of the peak); no float
// atomics, and one order of summation per output, so two runs give the
// same bits.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace lmma {

constexpr int kBM = 128;             // output tile rows (two warpgroups of 64)
constexpr int kBN = 128;             // output tile columns: one wgmma's N
constexpr int kBK = 64;              // k a stage: one 128-byte swizzle row
constexpr int kStages = 3;
constexpr int kConsumers = 2;        // warpgroups
constexpr int kThreads = kConsumers * 128 + 32;  // and one producer warp
constexpr int kHalf = 64 * kBK * 2;              // 64 rows (or columns) x kBK
constexpr int kTileBytes = 2 * kHalf;            // one operand's stage
constexpr int kStageBytes = 2 * kTileBytes;
// the stages on 1024 bytes (the swizzle's period), then the barriers
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
constexpr int kSwizzleRow = 128;     // bytes; 8 rows make one swizzle atom
// The staged f32 output tile's row stride in floats: 8 past kBN, so that
// the fragments' eight rows of a store fall on distinct banks.
constexpr int kLd = kBN + 8;
static_assert(kBM * kLd * 4 <= kStages * kStageBytes, "the f32 tile fits in the stages");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Until the phase of `parity` has completed.
__device__ __forceinline__ void bar_wait(uint32_t bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LMMA_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LMMA_WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of `map` at (inner, outer) into shared memory at dst, completing
// on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, int inner, int outer,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(inner), "r"(outer), "r"(bar)
      : "memory");
}

// A wgmma operand in shared memory with the 128-byte swizzle: start
// address, leading and stride byte offsets (the fields hold them / 16).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] B[16 x 128] of one warpgroup; kTA / kTB: the
// operand is MN-major (read transposed), else K-major.
template <bool kTA, bool kTB>
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(static_cast<int>(kTA)), "n"(static_cast<int>(kTB)));
}

// The descriptor of k16 step kk of an operand stage at addr: K-major, 128
// rows of 128 bytes (the step is 32 bytes along each row, eight-row groups
// 1024 bytes apart); MN-major, 64-column blocks kHalf apart of kBK rows of
// 128 bytes (the step is 16 rows).
template <bool kMN>
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr, int kk) {
  return kMN ? smem_desc(addr + kk * 16 * kSwizzleRow, kHalf, 8 * kSwizzleRow)
             : smem_desc(addr + kk * 32, 16, 8 * kSwizzleRow);
}

// One operand stage: a K-major tile is one box (64 k, 128 rows) at (k0,
// mn0); an MN-major tile two boxes (64 columns, 64 k) at (mn0, k0) and
// (mn0 + 64, k0).
template <bool kMN>
__device__ __forceinline__ void load_operand(uint32_t dst, const CUtensorMap& map, int mn0, int k0,
                                             uint32_t bar) {
  if (kMN) {
    tma_load(dst, map, mn0, k0, bar);
    tma_load(dst + kHalf, map, mn0 + 64, k0, bar);
  } else {
    tma_load(dst, map, k0, mn0, bar);
  }
}

// The consumer warpgroups' own barrier (the producer warp has left).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
}

// The body of a GEMM kernel: out[M, N] = A[M, K] B[K, N], A from ma and B
// from mb (kTA / kTB: stored MN-major), tile blockIdx.x (N tiles fastest,
// so blocks running together share A's rows in L2), k tiles of row chunk
// blockIdx.y of gridDim.y (k_tiles split evenly, in order); then the tile
// staged in shared memory (f32, row stride kLd) and
// epi.tile(tile, m0, n0, M, N) run by the consumer threads, which writes
// what lies inside [M, N) (a tile_pass).  Launched with kThreads threads
// and kSmem bytes of dynamic shared memory.
template <bool kTA, bool kTB, typename Epi>
__device__ __forceinline__ void gemm_tile(const CUtensorMap& ma, const CUtensorMap& mb, long long M,
                                          int N, int k_tiles, const Epi& epi) {
  extern __shared__ __align__(16) unsigned char lmma_smem[];
  const uint32_t raw = smem_addr(lmma_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * kStageBytes;
  const auto full = [&](int s) { return bars + 8u * s; };
  const auto empty = [&](int s) { return bars + 8u * (kStages + s); };
  const int n_tiles = (N + kBN - 1) / kBN;
  const int m0 = static_cast<int>(blockIdx.x / n_tiles) * kBM;
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * kBN;
  const int kt0 = static_cast<int>(static_cast<long long>(k_tiles) * blockIdx.y / gridDim.y);
  const int kt1 = static_cast<int>(static_cast<long long>(k_tiles) * (blockIdx.y + 1) / gridDim.y);
  const int nk = kt1 - kt0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // the producer
    if (lane == 0)
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        bar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        bar_expect(full(s), kStageBytes);
        const int k0 = (kt0 + it) * kBK;
        const uint32_t a = base + s * kStageBytes;
        load_operand<kTA>(a, ma, m0, k0, full(s));
        load_operand<kTB>(a + kTileBytes, mb, n0, k0, full(s));
      }
    return;
  }

  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages;
    bar_wait(full(s), (it / kStages) & 1);
    const uint32_t a = base + s * kStageBytes + wg * kHalf;
    const uint32_t b = base + s * kStageBytes + kTileBytes;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_128<kTA, kTB>(acc, operand_desc<kTA>(a, kk), operand_desc<kTB>(b, kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_acc(acc);
    // the stage before this one has been read: hand it back
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    if (it > 0 && lane == 0) bar_arrive(empty((it - 1) % kStages));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);

  // The accumulators into shared memory as an f32 tile [kBM][kLd], over
  // the stages once both warpgroups' products have read them: thread t of
  // a warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns
  // 8 j + 2 (t % 4) (+ 1) in acc[4 j + 2 h + e].
  float* tile = reinterpret_cast<float*>(lmma_smem + (base - raw));
  consumers_sync();
  const int tr = wg * 64 + (warp % 4) * 16 + lane / 4, tc = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
      *reinterpret_cast<float2*>(tile + (tr + 8 * h) * kLd + tc + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  consumers_sync();
  // a local copy, so that the epilogue's members are not read again
  // through the parameter's address, which its stores might alias
  const Epi local = epi;
  local.tile(tile, m0, n0, M, N);
}

// A pass of the consumer threads over the staged tile in vectors of V
// columns, P rows of vectors a thread at a time: f(s, r, c, live) with s
// the P vectors' values in shared memory, r their output rows, c the
// first column, live[q] whether row r[q] lies inside M.  A thread's
// vectors share one column c, which lies inside N (N % V == 0).
template <int V, int P, typename F>
__device__ __forceinline__ void tile_pass(const float* tile, long long m0, int n0, long long M,
                                          int N, F&& f) {
  constexpr int kPerRow = kBN / V, kRowsPerPass = kConsumers * 128 / kPerRow;
  const int t = threadIdx.x;
  const int c = n0 + (t % kPerRow) * V;
  if (c >= N) return;
#pragma unroll 1
  for (int p0 = 0; p0 < kBM; p0 += P * kRowsPerPass) {
    const float* sv[P];
    long long r[P];
    bool live[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int tr = p0 + q * kRowsPerPass + t / kPerRow;
      sv[q] = tile + tr * kLd + (t % kPerRow) * V;
      r[q] = m0 + tr;
      live[q] = r[q] < M;
    }
    f(sv, r, c, live);
  }
}

// cuTensorMapEncodeTiled of libcuda, found through the runtime (the
// libraries link no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

// A dense row-major bf16 matrix [outer][inner] as boxes of 64 x box_outer.
inline bool tensor_map(CUtensorMap* map, const void* p, long long inner, long long outer,
                       int box_outer) {
  const EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims, strides, box,
                steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool on16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Launches `kernel` (a __global__ wrapper of gemm_tile<kTA, kTB, Epi>) for
// out[M, N] = A B over K, A dense [M][K] (kTA: [K][M]) at a, B dense
// [N][K] (kTB: [K][N]) at b, in `chunks` row chunks of K.  Refuses what
// TMA or the tiles do not take: operands off 16 bytes, an inner width off
// 8 elements, coordinates beyond int, more chunks than k tiles.
template <bool kTA, bool kTB, typename Kernel, typename Epi>
int launch(Kernel kernel, const void* a, const void* b, long long M, int N, long long K, int chunks,
           const Epi& epi, cudaStream_t s) {
  const long long k_tiles = (K + kBK - 1) / kBK;
  const long long tiles = (M + kBM - 1) / kBM * ((N + kBN - 1) / kBN);
  if (M < 1 || N < 1 || K < 1 || N % 8 != 0 || (kTA ? M : K) % 8 != 0 || !on16(a) || !on16(b) ||
      M > (1LL << 31) - kBM || K > (1LL << 31) - kBK || N > (1 << 30) || chunks < 1 ||
      chunks > k_tiles || chunks > 65535 || tiles > (1LL << 31) - 1)
    return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const bool ok = (kTA ? tensor_map(&ma, a, M, K, 64) : tensor_map(&ma, a, K, M, kBM)) &&
                  (kTB ? tensor_map(&mb, b, N, K, 64) : tensor_map(&mb, b, K, N, kBN));
  if (!ok) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(chunks)), kThreads, kSmem, s>>>(
      ma, mb, M, N, static_cast<int>(k_tiles), epi);
  return cudaGetLastError();
}

}  // namespace lmma
