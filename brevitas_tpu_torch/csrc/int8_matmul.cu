// int8 GEMM with a fused dequant epilogue on Hopper's tensor cores (sm_90a).
//
// Replaces the Pallas TPU kernel brevitas_tpu/kernels/int_matmul.py::int8_matmul
// (_kernel:48, _kernel_kblocked:58):
//
//     y[m, n] = act( float(sum_k x[m, k] * w[k, n]) * (x_scale * w_scale[n]) + bias[n] )
//
// x (M, K) int8 and w (K, N) int8, both row-major; an int32 accumulator; y
// (M, N) float32. The caller folds zero points and the uint8 re-centre into
// the bias, so the kernel stays symmetric. The int32 sum is exact in any
// order and the epilogue rounds each step as the plain version does, so the
// result equals int8_matmul_reference bit for bit.
//
// What bounds it on the H100 (3.35 TB/s, 1,979 int8 TOP/s). A Llama
// prefill forward (43 launches at M 4096; K, N in 1024-2752) moves 1.43 GB,
// 1.08 GB of it the float32 output (0.43 ms), against 0.64 TOP (0.32 ms):
// bytes. A decode step (43 launches at M 16) reads 78 MB of weights: bytes,
// 23 us. LFC at M 128-1024 (K, N <= 1024): bytes, 0.4-1.9 us a launch.
//
// Design: "swap AB" on wgmma. The weight's (K, N) layout is N-major and s8
// wgmma reads only K-major operands from shared memory, so the output
// features are wgmma's 64-row M side and come from REGISTERS: each warp
// builds its A fragment from the N-major weight tile with ldmatrix.trans
// (16-bit elements = feature pairs, rows picked so that a thread receives K
// bytes 4t..4t+3) and two byte permutes per register. The tokens are
// wgmma's N side (BT in {16, 32, 64, 128}), read from a K-major x tile. No
// transposed copy of any weight exists. A CTA computes 128 features x BT
// tokens: two consumer warpgroups issue wgmma.m64nBTk32.s32.s8.s8, one
// producer warpgroup keeps a 4-stage ring of 128-byte-deep K slabs in
// flight (TMA, 128-byte swizzle, mbarrier completion; zero fill at every
// edge). The epilogue runs from the accumulator registers and writes each
// output once, a feature pair per float2 store.
//
// Variants, chosen in the launcher from M, N and K (int8_matmul_plan says
// which; int8_matmul_launch_splits forces one): "tiled" (one CTA per output
// tile) when the tiles fill at least half the SMs; otherwise "split-K": a
// cluster of S <= 8 CTAs splits K, each CTA leaves its int32 partial tile
// in its shared memory, and each sums 1/S of the tile over the cluster
// through distributed shared memory (exact in any order) and runs the
// epilogue on it. Decode (M 16, N 1024) thus streams its weights from 64
// SMs, not 8. chip_smoke.py times every split count at decode, serve, lfc8
// and prefill shapes; PERF.md records the crossover. An operand whose row
// stride or base address TMA cannot describe (N % 16 != 0: LFC's head has N
// 10; K % 16 != 0) is loaded by the producer threads with masked byte loads
// into the same swizzled tiles: the same kernel, never the plain version.
//
// Resources (ptxas -v, sm_90a, CUDA 12.9): BT 128 / 64 / 32 / 16 use 110 /
// 75 / 59 / 51 registers a thread, no spills, 384 threads; dynamic shared
// memory 132,160 / 99,392 / 83,008 / 74,816 bytes (4 stages of a 16 KB
// weight tile and a BT x 128-byte x tile, the barriers, 1 KB for alignment).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBF = 128;                  // output features per CTA: 2 warpgroups x 64
constexpr int kBK = 128;                  // K bytes per stage: one swizzled row
constexpr int kStages = 4;
constexpr int kConsumers = kGemmConsumers;  // two warpgroups issue wgmma
constexpr int kThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kWTile = kBK * kBF;         // 16 KB: w[k0 + r][n0 + c]
constexpr int kMaxSplits = 8;             // portable cluster size

template <int BT>
constexpr int smem_bytes() {
  return kStages * (kWTile + BT * kBK) + 2 * kStages * 8 + 1024;
}

template <int BT>
__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w, const int8_t* __restrict__ x,
                 const int8_t* __restrict__ w, const float* __restrict__ x_scale,
                 const float* __restrict__ w_scale, const float* __restrict__ bias,
                 float* __restrict__ y, int M, int N, int K, int relu, int splits, int tma_x,
                 int tma_w) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* w_tiles = smem;                     // kStages x [128 k][128 n]
  uint8_t* x_tiles = smem + kStages * kWTile;  // kStages x [BT m][128 k]
  uint64_t* full = reinterpret_cast<uint64_t*>(x_tiles + kStages * BT * kBK);
  uint64_t* empty = full + kStages;

  const int n0 = blockIdx.x * kBF;
  const int split = blockIdx.y % splits;  // = the CTA's rank in its cluster
  const int m0 = (blockIdx.y / splits) * BT;
  const int ksteps = (K + kBK - 1) / kBK;
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
      const int k0 = (kbeg + i) * kBK;
      uint8_t* wt = w_tiles + s * kWTile;
      uint8_t* xt = x_tiles + s * BT * kBK;
      if (!tma_w) load_tile_bytes(wt, w, N, K, N, k0, n0, kBK, pt);
      if (!tma_x) load_tile_bytes(xt, x, K, M, K, m0, k0, BT, pt);
      if (!(tma_w && tma_x)) fence_proxy_async();
      if (pt == 0) {
        mbar_arrive_expect_tx(&full[s], (tma_w ? kWTile : 0) + (tma_x ? BT * kBK : 0));
        if (tma_w) tma_load_2d(wt, &map_w, &full[s], n0, k0);
        if (tma_x) tma_load_2d(xt, &map_x, &full[s], k0, m0);
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // consumers: warp (wg, warp) owns features 64 wg + 16 warp + [0, 16), the
    // 16-byte chunk 4 wg + warp of every w row; A row g is feature 2g, A row
    // g + 8 feature 2g + 1. ldmatrix lane (i = lane / 8, rho = lane % 8) gives
    // the address of matrix i's row rho: K row 16 (i / 2) + 4 (rho / 2) +
    // 2 (i % 2) + rho % 2 of the 32-row slab, so that thread (g, t) receives
    // K rows 4t, 4t + 1 (matrix 0), 4t + 2, 4t + 3 (matrix 1), and 16 + the
    // same (matrices 2, 3), each a byte pair of features 2g, 2g + 1.
    const int chunk = 4 * wg + warp;
    const int mat = lane >> 3, rho = lane & 7;
    const int krow = 16 * (mat >> 1) + 4 * (rho >> 1) + 2 * (mat & 1) + (rho & 1);
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* wt = w_tiles + s * kWTile;
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, wt + swizzle128(32 * kk + krow, chunk));
        a[kk][0] = __byte_perm(r[0], r[1], 0x6420);  // feature 2g, K 4t..4t+3
        a[kk][1] = __byte_perm(r[0], r[1], 0x7531);  // feature 2g + 1
        a[kk][2] = __byte_perm(r[2], r[3], 0x6420);  // feature 2g, K 16 + 4t..
        a[kk][3] = __byte_perm(r[2], r[3], 0x7531);
      }
      const uint64_t desc = desc_sw128(x_tiles + s * BT * kBK);
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_s8<BT>(acc, a[kk], desc + 2 * kk, 1);
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

Plan plan_for(int M, int N, int K, const void* x, const void* w) {
  const GemmTiles t = gemm_tiles(M, N, cdiv(K, kBK));
  Plan p;
  p.bt = t.bt;
  p.splits = t.splits;
  p.tma_x = K % 16 == 0 && aligned16(x);
  p.tma_w = N % 16 == 0 && aligned16(w);
  return p;
}

template <int BT>
int launch(const Plan& p, const void* x, const void* w, const void* x_scale,
           const void* w_scale, const void* bias, void* y, int M, int N, int K, int relu,
           cudaStream_t stream) {
  CUtensorMap map_x{}, map_w{};  // left zero where the producer loads by hand
  if (p.tma_x && !tensor_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, M, K, K, BT, kBK))
    return (int)cudaErrorInvalidValue;
  if (p.tma_w && !tensor_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, N, kBK, kBF))
    return (int)cudaErrorInvalidValue;
  return launch_kernel(int8_gemm_kernel<BT>, dim3(cdiv(N, kBF), cdiv(M, BT) * p.splits),
                       kThreads, smem_bytes<BT>(), dim3(1, p.splits, 1), stream, map_x, map_w,
                       static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                       static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
                       static_cast<const float*>(bias), static_cast<float*>(y), M, N, K, relu,
                       p.splits, p.tma_x, p.tma_w);
}

}  // namespace

// The variant the launcher takes for these arguments: tokens per tile
// (bits 0-7), K splits (bits 8-15; 1 = tiled), x by TMA (bit 16), w by TMA
// (bit 17).
extern "C" int int8_matmul_plan(int M, int N, int K, const void* x, const void* w) {
  const Plan p = plan_for(M, N, K, x, w);
  return p.bt | (p.splits << 8) | (p.tma_x << 16) | (p.tma_w << 17);
}

// Launches on `stream` with `splits` K splits (0: the planned variant);
// returns a CUDA error code (0 on success). `bias` may be null. `x_scale`
// points to one float, `w_scale` to N floats, on the card.
extern "C" int int8_matmul_launch_splits(const void* x, const void* w, const void* x_scale,
                                         const void* w_scale, const void* bias, void* y,
                                         int M, int N, int K, int relu, int splits,
                                         void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits < 0 || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  Plan p = plan_for(M, N, K, x, w);
  if (splits > 0) p.splits = std::min(splits, cdiv(K, kBK));
  if ((long long)cdiv(M, p.bt) * p.splits > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.bt) {
    case 16: return launch<16>(p, x, w, x_scale, w_scale, bias, y, M, N, K, relu, s);
    case 32: return launch<32>(p, x, w, x_scale, w_scale, bias, y, M, N, K, relu, s);
    case 64: return launch<64>(p, x, w, x_scale, w_scale, bias, y, M, N, K, relu, s);
    default: return launch<128>(p, x, w, x_scale, w_scale, bias, y, M, N, K, relu, s);
  }
}

// The planned variant: the launcher the int8_matmul wrapper binds.
extern "C" int int8_matmul_launch(const void* x, const void* w, const void* x_scale,
                                  const void* w_scale, const void* bias, void* y,
                                  int M, int N, int K, int relu, void* stream) {
  return int8_matmul_launch_splits(x, w, x_scale, w_scale, bias, y, M, N, K, relu, 0, stream);
}
