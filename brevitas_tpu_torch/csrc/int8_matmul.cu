// int8 GEMM with a fused dequant epilogue, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel brevitas_tpu/kernels/int_matmul.py::int8_matmul
// (_kernel:48, _kernel_kblocked:58):
//
//     y[m, n] = act( float(sum_k x[m, k] * w[k, n]) * (x_scale * w_scale[n]) + bias[n] )
//
// x (M, K) int8 and w (K, N) int8, both row-major; the sum is an int32
// accumulator; y (M, N) float32. The caller folds zero points and the uint8
// re-centre into the bias, so the kernel stays symmetric.
//
// What bounds it on the H100: at the serving shapes (M <= 1024, K <= 1024,
// N <= 1024) the work is under 2.2 int8 GOP against 1,979 TOP/s, while the
// float32 output alone is up to 4 MB against 3.35 TB/s, so the bound is
// bytes. This first kernel reaches neither: it multiplies with __dp4a on the
// CUDA cores, not on the tensor cores, and with one 64 x 64 tile per block
// LFC's shapes launch only 16 to 256 blocks for 132 SMs, each thread issuing
// thousands of byte loads, shifts and dp4a; measured on the H100 it takes
// 30-60 us per call and hardly depends on M. The simple design: one block
// computes a 64 x 64 output tile; int8 slabs of 128 K values stage in shared
// memory as packed 4-byte words (the layout __dp4a reads), the weight slab
// transposed so both operands read along k; each of 256 threads keeps a
// 4 x 4 int32 accumulator tile in registers; the epilogue runs on the
// registers and writes each output once. Edges in M, N and K are masked
// with zeros (K = 784 and N = 10 occur). Making it fast (wgmma s8 fed by
// TMA) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 128;       // K values per shared-memory slab
constexpr int kKW = kBK / 4;   // 4-byte words per slab row
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ x_scale,
                   const float* __restrict__ w_scale,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int M, int N, int K, int relu) {
  // +1 word per row keeps the strided reads of the transposed slab free of
  // shared-memory bank conflicts
  __shared__ int xs[kBM][kKW + 1];
  __shared__ int wt[kBN][kKW + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  int acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < kBM * kKW; e += kThreads) {
      const int r = e / kKW, q = e % kKW;
      const int m = m0 + r, k = k0 + 4 * q;
      uint32_t v = 0;
      if (m < M) {
        const int8_t* row = x + (size_t)m * K;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (k + t < K) v |= (uint32_t)(uint8_t)row[k + t] << (8 * t);
      }
      xs[r][q] = (int)v;
    }
    for (int e = tid; e < kBN * kKW; e += kThreads) {
      const int c = e % kBN, q = e / kBN;
      const int n = n0 + c, k = k0 + 4 * q;
      uint32_t v = 0;
      if (n < N) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (k + t < K) v |= (uint32_t)(uint8_t)w[(size_t)(k + t) * N + n] << (8 * t);
      }
      wt[c][q] = (int)v;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kKW; ++q) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][q];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = wt[tx + 16 * j][q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float xsc = *x_scale;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      // the reference's order, each step rounded on its own (no FMA):
      // float(acc) * (x_scale * w_scale[n]), then + bias[n], then ReLU
      float v = __fmul_rn(__int2float_rn(acc[i][j]), __fmul_rn(xsc, w_scale[n]));
      if (bias != nullptr) v = __fadd_rn(v, bias[n]);
      if (relu) v = v > 0.0f ? v : 0.0f;
      y[(size_t)m * N + n] = v;
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). `bias` may
// be null. `x_scale` points to one float, `w_scale` to N floats, on the card.
extern "C" int int8_matmul_launch(const void* x, const void* w, const void* x_scale,
                                  const void* w_scale, const void* bias, void* y,
                                  int M, int N, int K, int relu, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), static_cast<float*>(y), M, N, K, relu);
  return (int)cudaGetLastError();
}
