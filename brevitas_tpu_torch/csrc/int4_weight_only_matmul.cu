// w4a16 GEMM on Hopper's bf16 tensor cores: float32 activations rounded to
// bf16 times split-halves packed int4 weights (sm_90a).
//
// Replaces the Pallas TPU kernel
// brevitas_tpu/kernels/int4.py::int4_weight_only_matmul (_int4_w16_kernel:196):
//
//     y[m, n] = act( (sum_k bf16(x[m, k]) * w[k, n]) * w_scale[n] + bias[n] )
//
// x (M, K) float32, rounded to bf16 (round to nearest even, as
// `.to(torch.bfloat16)`) on its way into shared memory; w_packed (K/2, N)
// int8 in pack_int4_rows' layout: byte row j holds weight row j in its low
// nibble and row j + K/2 in its high nibble. y (M, N) float32. A bf16 x
// int4 product is exact in float32, so only the summation differs from the
// plain version.
//
// What bounds it on the H100: at LFC's layers (M 1024, K 784-1024, N 1024)
// a launch moves 8.4 MB (float32 x in, float32 y out, 0.5 MB of packed
// weights: 2.5 us at 3.35 TB/s) against 2.1 GFLOP (2.2 us at 989 bf16
// TFLOP/s): bytes, with the operations close behind.
//
// Design: "swap AB" on wgmma.m64nBTk16.f32.bf16.bf16, as in int8_matmul.cu.
// The output features are wgmma's 64-row M side, built in registers: a
// ldmatrix.trans of the packed (K/2, N) tile gives thread (g, t) the bytes
// of features 2g, 2g + 1 at packed rows 2t, 2t + 1 (and + 8); a byte
// permute, one lop3 (0x4300 | (nibble ^ 8) is the bf16 136 + v) and an
// exact bf16x2 FMA (- 136) turn each byte's two nibbles into the A
// fragments of two K chunks, rows j and j + K/2. The tokens are wgmma's N
// side (BT 16 or 32). A stage is a slab of 64 packed rows (128 K values):
// the producer warpgroup copies the matching x columns, x[:, j0..j0+64) and
// x[:, K/2 + j0..), three slabs ahead with 16-byte cp.async, converts them
// with cvt.rn.bf16x2.f32 and stores them as two K-major, 128-byte-swizzled
// bf16 blocks; the packed slab arrives by TMA into a 4-stage ring with
// mbarriers. Where TMA cannot describe the weight (N % 16 != 0: LFC's head
// has N 10) a weight no wider than 128 is still contiguous per slab and
// comes by one bulk copy, repacked in shared memory; wider ones by masked
// byte loads. Ragged K/2 (392 at K 784) is zero-filled on both operands. A
// CTA computes 128 FS features (FS 64-feature sets per consumer warpgroup,
// two warpgroups) x BT tokens: 256 x 32 where those tiles fill half the
// SMs (LFC at M 1024: x crosses L2 4 times, not 8), else 128 x 32 or 128 x
// 16. The float32 sums stay in the tensor core's accumulator across K;
// chip_smoke.py prints each shape's largest error as a share of the bound
// (under 0.01 at every shape on the H100).
//
// Resources (ptxas -v, sm_90a, CUDA 12.9): (BT, FS) = (32, 2) / (32, 1) /
// (16, 1) use 128 / 93 / 71 registers a thread, no spills, 384 threads;
// dynamic shared memory 197,728 / 164,960 / 115,808 bytes (a 4-stage ring
// of packed slabs and bf16 x tiles, 4 float32 x slots and 4 narrow-weight
// slots, the barriers, 1 KB for alignment).

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBF = 128;                    // features per packed tile: 2 warpgroups x 64
constexpr int kBJ = 64;                     // packed rows per stage: 128 K values
constexpr int kStages = 4;
constexpr int kRaw = 4;                     // float32 x slots: 3 slabs ahead (cp.async)
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + one producer warpgroup
constexpr int kWTile = kBJ * kBF;           // 8 KB: w_packed[j0 + r][n0 + c]
constexpr int kXRow = 128;                  // bytes of a bf16 x block row: 64 K values

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// two signed nibbles, one in bits 0-3 and one in bits 16-19 of `h`, as two
// exact bf16 values
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t h) {
  const uint32_t biased = (h & 0x000F000Fu) ^ 0x43084308u;  // 0x4300 | (nibble ^ 8): 136 + v
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));  // * 1 - 136
  return d;
}

// The packed rows j0..j0+rows-1 of a weight no wider than one tile (N <=
// 128), copied whole into `raw` (row r at r * N), into the swizzled tile;
// columns N.. stay as zeroed at the start, rows `rows`.. are zeroed.
__device__ void repack_w(uint8_t* tile, const uint8_t* raw, int N, int rows, int tid) {
  for (int q = tid; q < kBJ * N; q += 128) {
    const int r = q / N, n = q - r * N;
    tile[swizzle128(r, n >> 4) + (n & 15)] = r < rows ? raw[q] : 0;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// The bf16 x tile of packed rows j0..j0+63 is two blocks of BT rows x 128
// bytes: block 0 holds x[m0 + r][j0 + c], block 1 x[m0 + r][K2 + j0 + c],
// c < 64, zero where m >= M or j0 + c >= K2. Its chunk q (8 values) is row
// r = q / 16, block (q % 16) / 8, 16-byte chunk q % 8 of that block's row.
// Producer thread `tid` owns chunks tid + 128u.
__device__ __forceinline__ const float* x_chunk(const float* x, int K2, int m0, int j0, int q,
                                                int* j, int* m) {
  const int r = q >> 4, c = q & 15;
  *m = m0 + r;
  *j = j0 + 8 * (c & 7);
  return x + (size_t)(*m) * (2 * K2) + (c < 8 ? 0 : K2) + *j;
}

__device__ __forceinline__ uint8_t* tile_chunk(uint8_t* tile, int q, int rows) {
  const int c = q & 15;
  return tile + (c >> 3) * rows * kXRow + swizzle128(q >> 4, c & 7);
}

// 16-byte path (K2 % 4 == 0, x 16-byte aligned): the thread's chunks as
// float32 into its own 32 bytes of the staging slot, asynchronously
template <int BT>
__device__ void stage_x_f32(uint8_t* raw, const float* x, int M, int K2, int m0, int j0,
                            int tid) {
#pragma unroll
  for (int u = 0; u < BT / 8; ++u) {
    const int q = tid + 128 * u;
    int j, m;
    const float* p = x_chunk(x, K2, m0, j0, q, &j, &m);
    const bool lo = m < M && j < K2, hi = m < M && j + 4 < K2;
    cp_async16(raw + 32 * q, lo ? p : x, lo);
    cp_async16(raw + 32 * q + 16, hi ? p + 4 : x, hi);
  }
}

// ... then, once they have landed, to bf16 in the swizzled tile
template <int BT>
__device__ void convert_x(uint8_t* tile, const uint8_t* raw, int tid) {
#pragma unroll
  for (int u = 0; u < BT / 8; ++u) {
    const int q = tid + 128 * u;
    const float4 lo = *reinterpret_cast<const float4*>(raw + 32 * q);
    const float4 hi = *reinterpret_cast<const float4*>(raw + 32 * q + 16);
    *reinterpret_cast<uint4*>(tile_chunk(tile, q, BT)) =
        make_uint4(bf16x2(lo.x, lo.y), bf16x2(lo.z, lo.w), bf16x2(hi.x, hi.y),
                   bf16x2(hi.z, hi.w));
  }
}

// scalar path for any K2 and alignment: straight into the tile
template <int BT>
__device__ void load_x_scalar(uint8_t* tile, const float* x, int M, int K2, int m0, int j0,
                              int tid) {
  for (int u = 0; u < BT / 8; ++u) {
    const int q = tid + 128 * u;
    int j, m;
    const float* p = x_chunk(x, K2, m0, j0, q, &j, &m);
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (m < M && j + e < K2) ? p[e] : 0.0f;
    *reinterpret_cast<uint4*>(tile_chunk(tile, q, BT)) =
        make_uint4(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]), bf16x2(v[4], v[5]),
                   bf16x2(v[6], v[7]));
  }
}

__device__ __forceinline__ float epilogue(float acc, float scale, float b, bool has_bias,
                                          int relu) {
  float v = __fmul_rn(acc, scale);
  if (has_bias) v = __fadd_rn(v, b);
  if (relu) v = v > 0.0f ? v : 0.0f;
  return v;
}

// How the packed weight slab reaches shared memory.
enum WLoad { kWTma = 0, kWBulk = 1, kWBytes = 2 };

// FS sets of 64 features per consumer warpgroup: a CTA computes 128 FS
// features x BT tokens.
template <int BT, int FS>
__global__ void __launch_bounds__(kThreads, 1)
int4_w16_kernel(const __grid_constant__ CUtensorMap map_w, const float* __restrict__ x,
                const int8_t* __restrict__ wp, const float* __restrict__ w_scale,
                const float* __restrict__ bias, float* __restrict__ y, int M, int N, int K2,
                int relu, int w_load, int vec_x) {
  constexpr int kW = FS * kWTile;          // packed bytes a stage: FS tiles of 128 features
  constexpr int kX = BT * 2 * kXRow;       // bf16 x bytes a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* w_tiles = smem;                     // kStages x FS x [64 j][128 n] packed
  uint8_t* x_tiles = smem + kStages * kW;      // kStages x 2 x [BT m][64 K] bf16
  uint8_t* x_raw = x_tiles + kStages * kX;     // kRaw x BT x 128 float32
  uint8_t* w_raw = x_raw + kRaw * 2 * kX;      // kRaw x 64 N bytes (kWBulk)
  uint64_t* full = reinterpret_cast<uint64_t*>(w_raw + kRaw * kWTile);
  uint64_t* empty = full + kStages;
  uint64_t* w_landed = empty + kStages;

  const int n0 = blockIdx.x * kBF * FS;
  const int m0 = blockIdx.y * BT;
  const int nk = (K2 + kBJ - 1) / kBJ;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], kConsumers / 32);
    }
    for (int s = 0; s < kRaw; ++s) mbar_init(&w_landed[s], 1);
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;

  if (wg == 2) {
    // producer: x (and a narrow weight's slabs) run kRaw - 1 slabs ahead
    // through cp.async (bulk copies); each x slab is converted by the
    // threads that copied it
    const int pt = threadIdx.x - kConsumers;
    auto issue_w = [&](int i) {  // thread 0: slab i of a weight with N <= 128
      const int j0 = i * kBJ;
      const uint32_t bytes = (min(K2, j0 + kBJ) - j0) * N;
      fence_proxy_async();
      mbar_arrive_expect_tx(&w_landed[i % kRaw], bytes);
      bulk_load(w_raw + (i % kRaw) * kWTile, wp + (size_t)j0 * N, bytes, &w_landed[i % kRaw]);
    };
    if (w_load == kWBulk) {  // repack_w writes only the first N columns
      for (int q = pt; q < kStages * kW / 16; q += 128)
        reinterpret_cast<uint4*>(w_tiles)[q] = make_uint4(0, 0, 0, 0);
      fence_proxy_async();
    }
    for (int i = 0; i < kRaw - 1; ++i) {
      if (vec_x && i < nk) stage_x_f32<BT>(x_raw + i * 2 * kX, x, M, K2, m0, i * kBJ, pt);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      if (w_load == kWBulk && pt == 0 && i < nk) issue_w(i);
    }
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      const int ahead = i + kRaw - 1;
      if (w_load == kWBulk) {
        // every producer thread is done with slot (i - 1) % kRaw
        asm volatile("bar.sync 2, 128;\n" ::: "memory");
        if (pt == 0 && ahead < nk) issue_w(ahead);
      }
      if (vec_x) {
        if (ahead < nk)
          stage_x_f32<BT>(x_raw + (ahead % kRaw) * 2 * kX, x, M, K2, m0, ahead * kBJ, pt);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group %0;\n" :: "n"(kRaw - 1) : "memory");
      }
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      const int j0 = i * kBJ;
      uint8_t* wt = w_tiles + s * kW;
      uint8_t* xt = x_tiles + s * kX;
      if (w_load == kWBulk) {
        mbar_wait(&w_landed[i % kRaw], (i / kRaw) & 1);
        repack_w(wt, w_raw + (i % kRaw) * kWTile, N, min(K2, j0 + kBJ) - j0, pt);
      } else if (w_load == kWBytes) {
#pragma unroll
        for (int f = 0; f < FS; ++f)
          load_tile_bytes(wt + f * kWTile, wp, N, K2, N, j0, n0 + kBF * f, kBJ, pt);
      }
      if (vec_x)
        convert_x<BT>(xt, x_raw + (i % kRaw) * 2 * kX, pt);
      else
        load_x_scalar<BT>(xt, x, M, K2, m0, j0, pt);
      fence_proxy_async();
      if (pt == 0) {
        mbar_arrive_expect_tx(&full[s], w_load == kWTma ? kW : 0);
        if (w_load == kWTma) {
#pragma unroll
          for (int f = 0; f < FS; ++f)
            tma_load_2d(wt + f * kWTile, &map_w, &full[s], n0 + kBF * f, j0);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warp (wg, warp) owns, for each set f, the 16 features
  // 64 (FS wg + f) + 16 warp + [0, 16) of the CTA: tile (FS wg + f) / 2, its
  // 16-byte chunk 4 ((FS wg + f) % 2) + warp of every packed row. A row g is
  // feature 2g, A row g + 8 feature 2g + 1. ldmatrix h, lane l addresses
  // packed row 32h + l of the slab, so thread (g, t) receives from its
  // matrix q rows 32h + 8q + 2t and 32h + 8q + 2t + 1.
  float acc[FS][BT / 2];
#pragma unroll
  for (int f = 0; f < FS; ++f)
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) acc[f][i] = 0.0f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    // K chunks (16 values each) of the stage: 0-3 are packed rows j0..j0+63
    // (low nibbles, x block 0), 4-7 rows K/2 + j0.. (high nibbles, block 1)
    uint32_t a[FS][8][4];
#pragma unroll
    for (int f = 0; f < FS; ++f) {
      const int set = FS * wg + f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, w_tiles + s * kW + (set / 2) * kWTile +
                                 swizzle128(32 * h + lane, 4 * (set % 2) + warp));
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          // even bytes: feature 2g; odd bytes: feature 2g + 1; one packed
          // row per 16-bit half
          const uint32_t e0 = __byte_perm(r[2 * q], 0, 0x4240),
                         o0 = __byte_perm(r[2 * q], 0, 0x4341);
          const uint32_t e1 = __byte_perm(r[2 * q + 1], 0, 0x4240),
                         o1 = __byte_perm(r[2 * q + 1], 0, 0x4341);
          uint32_t* lo = a[f][2 * h + q];
          uint32_t* hi = a[f][4 + 2 * h + q];
          lo[0] = nibbles_to_bf16x2(e0);
          lo[1] = nibbles_to_bf16x2(o0);
          lo[2] = nibbles_to_bf16x2(e1);
          lo[3] = nibbles_to_bf16x2(o1);
          hi[0] = nibbles_to_bf16x2(e0 >> 4);
          hi[1] = nibbles_to_bf16x2(o0 >> 4);
          hi[2] = nibbles_to_bf16x2(e1 >> 4);
          hi[3] = nibbles_to_bf16x2(o1 >> 4);
        }
      }
    }
    const uint8_t* xt = x_tiles + s * BT * 2 * kXRow;
#pragma unroll
    for (int f = 0; f < FS; ++f) pin(acc[f]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t desc = desc_sw128(xt + (kk / 4) * BT * kXRow) + 2 * (kk % 4);
#pragma unroll
      for (int f = 0; f < FS; ++f) wgmma_bf16<BT>(acc[f], a[f][kk], desc, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int f = 0; f < FS; ++f) pin(acc[f]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue from the registers: acc[f][4j + e] is feature n, token
  // 8j + 2t + e; acc[f][4j + 2 + e] feature n + 1
  const int g = lane >> 2, t = lane & 3;
  const bool has_bias = bias != nullptr;
#pragma unroll
  for (int f = 0; f < FS; ++f) {
    const int n = n0 + 64 * (FS * wg + f) + 16 * warp + 2 * g;
    const bool ok0 = n < N, ok1 = n + 1 < N;
    const float s0 = ok0 ? w_scale[n] : 0.0f, s1 = ok1 ? w_scale[n + 1] : 0.0f;
    const float b0 = has_bias && ok0 ? bias[n] : 0.0f;
    const float b1 = has_bias && ok1 ? bias[n + 1] : 0.0f;
    const bool pair = ok1 && (N % 2 == 0);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t + e;
        if (m >= M || !ok0) continue;
        const float o0 = epilogue(acc[f][4 * j + e], s0, b0, has_bias, relu);
        const float o1 = epilogue(acc[f][4 * j + 2 + e], s1, b1, has_bias, relu);
        float* out = y + (size_t)m * N + n;
        if (pair) {
          *reinterpret_cast<float2*>(out) = make_float2(o0, o1);
        } else {
          out[0] = o0;
          if (ok1) out[1] = o1;
        }
      }
    }
  }
}

struct Plan {
  int bt, fs, w_load, vec_x;
};

Plan plan_for(int M, int N, int K2, const void* x, const void* wp) {
  Plan p;
  const int half = sm_count() / 2;
  if (N > kBF && cdiv(N, 2 * kBF) * cdiv(M, 32) >= half) {
    // 256 features x 32 tokens: x crosses L2 half as often as with 128
    p.bt = 32;
    p.fs = 2;
  } else {
    // 128 features x 32 tokens, or 16 where that fills more of the SMs
    p.bt = M <= 16 || cdiv(N, kBF) * cdiv(M, 32) < half ? 16 : 32;
    p.fs = 1;
  }
  if (N % 16 == 0 && aligned16(wp))
    p.w_load = kWTma;
  else if (N <= kBF && (long long)K2 * N % 16 == 0 && aligned16(wp))
    p.w_load = kWBulk;  // a narrow weight's slab is contiguous: one bulk copy
  else
    p.w_load = kWBytes;
  p.vec_x = K2 % 4 == 0 && aligned16(x);
  return p;
}

template <int BT, int FS>
int launch(const Plan& p, const void* x, const void* wp, const void* w_scale, const void* bias,
           void* y, int M, int N, int K2, int relu, cudaStream_t stream) {
  CUtensorMap map_w{};  // left zero where the weight is not loaded by TMA
  if (p.w_load == kWTma &&
      !tensor_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, wp, K2, N, N, kBJ, kBF))
    return (int)cudaErrorInvalidValue;
  auto kernel = int4_w16_kernel<BT, FS>;
  const int smem = kStages * (FS * kWTile + BT * 2 * kXRow) +
                   kRaw * (BT * 4 * kXRow + kWTile) + (2 * kStages + kRaw) * 8 + 1024;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(cdiv(N, FS * kBF), cdiv(M, BT));
  kernel<<<grid, kThreads, smem, stream>>>(
      map_w, static_cast<const float*>(x), static_cast<const int8_t*>(wp),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias),
      static_cast<float*>(y), M, N, K2, relu, p.w_load, p.vec_x);
  return (int)cudaGetLastError();
}

}  // namespace

// The variant the launcher takes: tokens per tile (bits 0-7), 64-feature
// sets per warpgroup (bits 8-15), x by 16-byte cp.async (bit 16), the
// packed weights by TMA (bits 17-18 = 0), bulk copy (1) or byte loads (2).
extern "C" int int4_weight_only_matmul_plan(int M, int N, int K2, const void* x,
                                            const void* w_packed) {
  const Plan p = plan_for(M, N, K2, x, w_packed);
  return p.bt | (p.fs << 8) | (p.vec_x << 16) | (p.w_load << 17);
}

// Launches on `stream`; returns a CUDA error code (0 on success). `bias` may
// be null. `w_scale` points to N floats on the card. K2 = K / 2.
extern "C" int int4_weight_only_matmul_launch(const void* x, const void* w_packed,
                                              const void* w_scale, const void* bias,
                                              void* y, int M, int N, int K2, int relu,
                                              void* stream) {
  if (M <= 0 || N <= 0 || K2 <= 0 || cdiv(M, 16) > 65535) return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(M, N, K2, x, w_packed);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.fs == 2) return launch<32, 2>(p, x, w_packed, w_scale, bias, y, M, N, K2, relu, s);
  if (p.bt == 32) return launch<32, 1>(p, x, w_packed, w_scale, bias, y, M, N, K2, relu, s);
  return launch<16, 1>(p, x, w_packed, w_scale, bias, y, M, N, K2, relu, s);
}
