// w4a16 GEMM: bf16 activations times split-halves packed int4 weights,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// brevitas_tpu/kernels/int4.py::int4_weight_only_matmul (_int4_w16_kernel:196):
//
//     y[m, n] = act( (sum_k bf16(x[m, k]) * w[k, n]) * w_scale[n] + bias[n] )
//
// x (M, K) float32, rounded to bf16 on load as the reference does; w_packed
// (K/2, N) int8 in pack_int4_rows' layout: byte row j holds weight row j in
// its low nibble and row j + K/2 in its high nibble. y (M, N) float32.
//
// What bounds it on the H100: at the serving shapes (M <= 1024, K <= 1024,
// N <= 1024) the float32 activations and outputs (up to 8 MB) against
// 3.35 TB/s outweigh 2.1 GFLOP against 989 bf16 TFLOP/s, so the bound is
// bytes; the weights move at 4 bits. This first kernel reaches neither: it
// multiplies in float32 on the CUDA cores, not on the tensor cores, and with
// one 64 x 64 tile per block LFC's shapes launch only 16 to 256 blocks, each
// thread issuing thousands of loads and FMAs; measured on the H100 it takes
// 90-130 us per call whatever M is. The simple design: one block computes a
// 64 x 64 output tile; per step it stages 16 packed weight rows, unpacked in
// registers to the two weight rows each byte holds, and the matching two
// 16-column slabs of x rounded to bf16, in shared memory; 256 threads each
// keep a 4 x 4 float32 accumulator tile. A bf16 times int4 product is exact in float32, so
// only the summation order differs from the plain version. Edges are masked
// with zeros (K/2 = 392 and N = 10 occur). Making it fast (wgmma bf16, TMA)
// is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 64;        // output columns per block
constexpr int kBP = 16;        // packed weight rows per step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
int4_w16_kernel(const float* __restrict__ x, const int8_t* __restrict__ wp,
                const float* __restrict__ w_scale, const float* __restrict__ bias,
                float* __restrict__ y, int M, int N, int K2, int relu) {
  __shared__ float x_lo[kBM][kBP + 1];  // x[:, j0 + c]
  __shared__ float x_hi[kBM][kBP + 1];  // x[:, K/2 + j0 + c]
  __shared__ float w_lo[kBP][kBN];      // weight rows j0 + r
  __shared__ float w_hi[kBP][kBN];      // weight rows K/2 + j0 + r
  const int K = 2 * K2;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4] = {};

  for (int j0 = 0; j0 < K2; j0 += kBP) {
    for (int e = tid; e < kBM * kBP; e += kThreads) {
      const int r = e / kBP, c = e % kBP;
      const int m = m0 + r, j = j0 + c;
      float lo = 0.0f, hi = 0.0f;
      if (m < M && j < K2) {
        const float* row = x + (size_t)m * K;
        lo = __bfloat162float(__float2bfloat16_rn(row[j]));
        hi = __bfloat162float(__float2bfloat16_rn(row[K2 + j]));
      }
      x_lo[r][c] = lo;
      x_hi[r][c] = hi;
    }
    for (int e = tid; e < kBP * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int j = j0 + r, n = n0 + c;
      int lo = 0, hi = 0;
      if (j < K2 && n < N) {
        const int p = wp[(size_t)j * N + n];  // the byte, sign-extended
        lo = ((p & 0xF) ^ 8) - 8;  // low nibble sign-extended, = (int8_t)(p << 4) >> 4
        hi = p >> 4;               // high nibble, arithmetic shift
      }
      w_lo[r][c] = (float)lo;
      w_hi[r][c] = (float)hi;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBP; ++kk) {
      float al[4], ah[4], bl[4], bh[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        al[i] = x_lo[ty + 16 * i][kk];
        ah[i] = x_hi[ty + 16 * i][kk];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bl[j] = w_lo[kk][tx + 16 * j];
        bh[j] = w_hi[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(al[i], bl[j], acc[i][j]);
          acc[i][j] = fmaf(ah[i], bh[j], acc[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = __fmul_rn(acc[i][j], w_scale[n]);
      if (bias != nullptr) v = __fadd_rn(v, bias[n]);
      if (relu) v = v > 0.0f ? v : 0.0f;
      y[(size_t)m * N + n] = v;
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). `bias` may
// be null. `w_scale` points to N floats on the card. K2 = K / 2.
extern "C" int int4_weight_only_matmul_launch(const void* x, const void* w_packed,
                                              const void* w_scale, const void* bias,
                                              void* y, int M, int N, int K2, int relu,
                                              void* stream) {
  if (M <= 0 || N <= 0 || K2 <= 0 || (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int4_w16_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w_packed),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias),
      static_cast<float*>(y), M, N, K2, relu);
  return (int)cudaGetLastError();
}
