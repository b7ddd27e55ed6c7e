// W4A8 GEMM on Hopper's tensor cores (sm_90a): int8 activations times
// split-halves packed int4 weights, with a fused dequant epilogue.
//
// Replaces the Pallas TPU kernel brevitas_tpu/kernels/int4.py::int4_matmul
// (_int4_kernel:96):
//
//     y[m, n] = act( float(sum_k x[m, k] * w[k, n]) * (x_scale * w_scale[n]) + bias[n] )
//
// x (M, K) int8 row-major holds full-range 8-bit activation codes. w arrives
// packed as pack_int4_rows bytes, wp (K/2, N) int8 row-major: byte row j holds
// weight row j in its LOW nibble and weight row j + K/2 in its HIGH nibble,
// each a signed int4 in [-8, 7]. The sum is an int32 accumulator (|x| <= 128,
// |w| <= 8, so K up to 2^21 cannot overflow; the wrapper refuses more); y
// (M, N) float32. The caller folds zero points and the uint8 re-centre into
// the bias, so the kernel stays symmetric. The int32 sum is exact in any
// order and the epilogue rounds each step as the plain version does, so the
// result equals int4_matmul_reference bit for bit.
//
// What bounds it on the H100 (3.35 TB/s, 1,979 int8 TOP/s): bytes. A W4A8
// Llama decode step (43 launches at M 16) reads 39 MB of packed weights,
// 13 us; a prefill forward (43 launches at M 4096) writes 1.08 GB of float32
// output, 0.42 ms, against 0.64 TOP (0.32 ms). The 39 MB of packed weights
// fit in the 50 MB L2, so a step timed with hot inputs can read under the
// HBM bound.
//
// Design: int8_matmul.cu's "swap AB" on wgmma.m64nBTk32.s32.s8.s8, with the
// packed weights in place of int8 ones. The output features are wgmma's
// 64-row M side, built in REGISTERS: each consumer warp takes an
// ldmatrix.trans of the packed (K/2, N) tile (16-bit elements = feature
// pairs, rows picked so that a thread receives four consecutive packed rows)
// and two byte permutes; each such register of packed bytes then gives two A
// fragments, its low nibbles for K rows j.. and its high nibbles for K rows
// K/2 + j.., each sign-extended to s8 exactly by hopper.cuh's s4_lo_to_s8 (an
// and-xor, an add and a xor). The tokens are wgmma's N side (BT in {16, 32,
// 64, 128}), read from K-major x tiles. A stage holds BJ = 128 packed rows x
// 128 features (16 KB, 256 K values: half the bytes an int8 stage spends on
// the same K) and two x tiles, columns [j0, j0 + 128) and [K/2 + j0, K/2 +
// j0 + 128); packed rows past K/2 are zero, so whatever x holds beside them
// adds nothing. A CTA computes 128 features x BT tokens: two consumer
// warpgroups issue 8 wgmma a stage, one producer warpgroup keeps a 4-stage
// ring in flight (TMA, 128-byte swizzle, mbarrier completion). The epilogue
// and the split-K sum are hopper.cuh's, shared with int8_matmul.
//
// Variants, chosen in the launcher from M, N and K/2 (int4_matmul_plan says
// which; int4_matmul_launch_splits forces one): "tiled" (one CTA per output
// tile) when the tiles fill at least half the SMs; otherwise "split-K": a
// cluster of S <= 8 CTAs splits the packed rows, and each rank sums 1/S of
// the tile's int32 partials over the cluster through distributed shared
// memory (exact in any order). An operand whose row stride, base address
// or tile origin TMA cannot take (N % 16 != 0: N 10 or 1000; K/2 % 16 != 0,
// where the high-half x tile starts off a 16-byte boundary) is
// loaded by the producer threads with masked byte loads into the same
// swizzled tiles: the same kernel, never the plain version.
// chip_smoke.py times every split count at the decode, edge and prefill
// shapes; PERF.md records the crossover.
//
// Resources (ptxas -v, sm_90a, CUDA 12.9): BT 128 / 64 / 32 / 16 use 122 /
// 92 / 75 / 67 registers a thread, no spills, 384 threads; dynamic shared
// memory 197,696 / 132,160 / 99,392 / 83,008 bytes (4 stages of a 16 KB
// packed tile and two BT x 128-byte x tiles, the barriers, 1 KB for
// alignment).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBF = 128;                    // output features per CTA: 2 warpgroups x 64
constexpr int kBJ = 128;                    // packed rows per stage: 256 K values
constexpr int kStages = 4;
constexpr int kConsumers = kGemmConsumers;  // two warpgroups issue wgmma
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kWTile = kBJ * kBF;           // 16 KB: wp[j0 + r][n0 + c]
constexpr int kXRow = 128;                  // bytes of an x tile row: 128 K values
constexpr int kMaxSplits = 8;               // portable cluster size

template <int BT>
__host__ __device__ constexpr int x_stage() {
  return 2 * BT * kXRow;  // the low-half and the high-half x tiles
}

template <int BT>
constexpr int smem_bytes() {
  return kStages * (kWTile + x_stage<BT>()) + 2 * kStages * 8 + 1024;
}

template <int BT>
__global__ void __launch_bounds__(kThreads, 1)
int4_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w, const int8_t* __restrict__ x,
                 const int8_t* __restrict__ wp, const float* __restrict__ x_scale,
                 const float* __restrict__ w_scale, const float* __restrict__ bias,
                 float* __restrict__ y, int M, int N, int K2, int relu, int splits, int tma_x,
                 int tma_w) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* w_tiles = smem;                     // kStages x [128 j][128 n] packed
  uint8_t* x_tiles = smem + kStages * kWTile;  // kStages x 2 x [BT m][128 k]
  uint64_t* full = reinterpret_cast<uint64_t*>(x_tiles + kStages * x_stage<BT>());
  uint64_t* empty = full + kStages;

  const int K = 2 * K2;
  const int n0 = blockIdx.x * kBF;
  const int split = blockIdx.y % splits;  // = the CTA's rank in its cluster
  const int m0 = (blockIdx.y / splits) * BT;
  const int ksteps = (K2 + kBJ - 1) / kBJ;
  const int per = (ksteps + splits - 1) / splits;
  const int kbeg = split * per;
  const int nk = max(0, min(ksteps, kbeg + per) - kbeg);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128);                 // every producer thread arrives
      mbar_init(&empty[s], kConsumers / 32);    // every consumer warp releases
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  int acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0;

  if (wg == 2) {
    // producer: fill stage s once the consumers have released it
    const int pt = threadIdx.x - kConsumers;
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      const int j0 = (kbeg + i) * kBJ;
      uint8_t* wt = w_tiles + s * kWTile;
      uint8_t* xt = x_tiles + s * x_stage<BT>();
      if (!tma_w) load_tile_bytes(wt, wp, N, K2, N, j0, n0, kBJ, pt);
      if (!tma_x) {
        load_tile_bytes(xt, x, K, M, K, m0, j0, BT, pt);
        load_tile_bytes(xt + BT * kXRow, x, K, M, K, m0, K2 + j0, BT, pt);
      }
      if (!(tma_w && tma_x)) fence_proxy_async();
      if (pt == 0) {
        mbar_arrive_expect_tx(&full[s], (tma_w ? kWTile : 0) + (tma_x ? x_stage<BT>() : 0));
        if (tma_w) tma_load_2d(wt, &map_w, &full[s], n0, j0);
        if (tma_x) {
          tma_load_2d(xt, &map_x, &full[s], j0, m0);
          tma_load_2d(xt + BT * kXRow, &map_x, &full[s], K2 + j0, m0);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // consumers: warp (wg, warp) owns features 64 wg + 16 warp + [0, 16), the
    // 16-byte chunk 4 wg + warp of every packed row; A row g is feature 2g, A
    // row g + 8 feature 2g + 1. ldmatrix lane (i = lane / 8, rho = lane % 8)
    // gives the address of matrix i's row rho: packed row 16 (i / 2) +
    // 4 (rho / 2) + 2 (i % 2) + rho % 2 of the 32-row slab, so that thread
    // (g, t) receives packed rows 4t..4t+3 and 16 + 4t.., each a byte pair of
    // features 2g, 2g + 1.
    const int chunk = 4 * wg + warp;
    const int mat = lane >> 3, rho = lane & 7;
    const int krow = 16 * (mat >> 1) + 4 * (rho >> 1) + 2 * (mat & 1) + (rho & 1);
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* wt = w_tiles + s * kWTile;
      // a[kk]: low nibbles, K rows j0 + 32 kk..; a[4 + kk]: high nibbles,
      // K rows K/2 + j0 + 32 kk..
      uint32_t a[8][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, wt + swizzle128(32 * kk + krow, chunk));
        const uint32_t p[4] = {
            __byte_perm(r[0], r[1], 0x6420),   // feature 2g, packed rows 4t..4t+3
            __byte_perm(r[0], r[1], 0x7531),   // feature 2g + 1
            __byte_perm(r[2], r[3], 0x6420),   // feature 2g, rows 16 + 4t..
            __byte_perm(r[2], r[3], 0x7531)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[kk][e] = s4_lo_to_s8(p[e]);
          a[4 + kk][e] = s4_hi_to_s8(p[e]);
        }
      }
      const uint8_t* xt = x_tiles + s * x_stage<BT>();
      const uint64_t desc_lo = desc_sw128(xt), desc_hi = desc_sw128(xt + BT * kXRow);
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_s8<BT>(acc, a[kk], desc_lo + 2 * kk, 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_s8<BT>(acc, a[4 + kk], desc_hi + 2 * kk, 1);
      wgmma_commit();
      wgmma_wait_all();
      pin(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  const float xsc = *x_scale;
  if (splits > 1) {
    // the ring is drained (every stage was waited on): its shared memory
    // holds the partial tiles
    splitk_store<BT>(smem, acc, kThreads, split, splits, y, M, N, m0, n0, xsc, w_scale, bias,
                     relu);
    return;
  }
  if (wg < 2) store_tile<BT>(acc, threadIdx.x, y, M, N, m0, n0, xsc, w_scale, bias, relu);
}

struct Plan {
  int bt, splits, tma_x, tma_w;
};

Plan plan_for(int M, int N, int K2, const void* x, const void* wp) {
  const GemmTiles t = gemm_tiles(M, N, cdiv(K2, kBJ));
  Plan p;
  p.bt = t.bt;
  p.splits = t.splits;
  // x's row stride (2 K2 bytes) and the high-half tile's first column (K2 +
  // j0) must both be 16-byte aligned for TMA
  p.tma_x = K2 % 16 == 0 && aligned16(x);
  p.tma_w = N % 16 == 0 && aligned16(wp);
  return p;
}

template <int BT>
int launch(const Plan& p, const void* x, const void* wp, const void* x_scale,
           const void* w_scale, const void* bias, void* y, int M, int N, int K2, int relu,
           cudaStream_t stream) {
  CUtensorMap map_x{}, map_w{};  // left zero where the producer loads by hand
  if (p.tma_x &&
      !tensor_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, M, 2 * K2, 2 * K2, BT, kXRow))
    return (int)cudaErrorInvalidValue;
  if (p.tma_w && !tensor_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, wp, K2, N, N, kBJ, kBF))
    return (int)cudaErrorInvalidValue;
  return launch_kernel(int4_gemm_kernel<BT>, dim3(cdiv(N, kBF), cdiv(M, BT) * p.splits),
                       kThreads, smem_bytes<BT>(), dim3(1, p.splits, 1), stream, map_x, map_w,
                       static_cast<const int8_t*>(x), static_cast<const int8_t*>(wp),
                       static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
                       static_cast<const float*>(bias), static_cast<float*>(y), M, N, K2, relu,
                       p.splits, p.tma_x, p.tma_w);
}

}  // namespace

// The variant the launcher takes for these arguments (K2 = K / 2, the packed
// rows): tokens per tile (bits 0-7), K splits (bits 8-15; 1 = tiled), x by
// TMA (bit 16), the packed weights by TMA (bit 17).
extern "C" int int4_matmul_plan(int M, int N, int K2, const void* x, const void* w_packed) {
  const Plan p = plan_for(M, N, K2, x, w_packed);
  return p.bt | (p.splits << 8) | (p.tma_x << 16) | (p.tma_w << 17);
}

// Launches on `stream` with `splits` K splits (0: the planned variant);
// returns a CUDA error code (0 on success). x has 2 * K2 columns. `bias` may
// be null. `x_scale` points to one float, `w_scale` to N floats, on the card.
extern "C" int int4_matmul_launch_splits(const void* x, const void* w_packed,
                                         const void* x_scale, const void* w_scale,
                                         const void* bias, void* y, int M, int N, int K2,
                                         int relu, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K2 <= 0 || splits < 0 || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  Plan p = plan_for(M, N, K2, x, w_packed);
  if (splits > 0) p.splits = std::min(splits, cdiv(K2, kBJ));
  if ((long long)cdiv(M, p.bt) * p.splits > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.bt) {
    case 16: return launch<16>(p, x, w_packed, x_scale, w_scale, bias, y, M, N, K2, relu, s);
    case 32: return launch<32>(p, x, w_packed, x_scale, w_scale, bias, y, M, N, K2, relu, s);
    case 64: return launch<64>(p, x, w_packed, x_scale, w_scale, bias, y, M, N, K2, relu, s);
    default: return launch<128>(p, x, w_packed, x_scale, w_scale, bias, y, M, N, K2, relu, s);
  }
}

// The planned variant: the launcher the int4_matmul wrapper binds.
extern "C" int int4_matmul_launch(const void* x, const void* w_packed, const void* x_scale,
                                  const void* w_scale, const void* bias, void* y, int M,
                                  int N, int K2, int relu, void* stream) {
  return int4_matmul_launch_splits(x, w_packed, x_scale, w_scale, bias, y, M, N, K2, relu, 0,
                                   stream);
}
