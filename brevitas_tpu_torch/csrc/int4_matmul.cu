// W4A8 GEMM: int8 activations times split-halves packed int4 weights, with a
// fused dequant epilogue, written by hand for Hopper (sm_90a).
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
// the bias, so the kernel stays symmetric.
//
// What bounds it on the H100: at decode (M = 16) the packed weights dominate
// the bytes and the work is tiny, so the bound is bytes; at prefill (M = 4096)
// the float32 output dominates the bytes and the bound is bytes too, though
// close to the int8 tensor-core rate. This first kernel reaches neither: like
// csrc/int8_matmul.cu it multiplies with __dp4a on the CUDA cores. The simple
// design: one block computes a 64 x 64 output tile; each step stages one slab
// of kBJ packed rows [j0, j0 + kBJ) in shared memory, unpacked on the way into
// two transposed weight slabs of 4-byte words (the layout __dp4a reads): the
// low nibbles pair with x columns [j0, j0 + kBJ), the high nibbles with x
// columns [K/2 + j0, K/2 + j0 + kBJ), and both x slabs stage beside them. So
// every packed byte is read from device memory once per block column and
// unpacked once. Each of 256 threads keeps a 4 x 4 int32 accumulator tile in
// registers; the epilogue runs on the registers and writes each output once.
// Edges in M, N and K/2 are masked with zero codes, which add nothing (K/2 =
// 3, 392 and 1376 occur, N = 10, 2000 and 2752, M = 1). At decode the grid is
// only 16 to 43 blocks for 132 SMs; a narrower N tile, split-K, and wgmma fed
// by TMA are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;        // output rows per block
constexpr int kBN = 64;        // output columns per block
constexpr int kBJ = 64;        // packed rows per slab (2 * kBJ K values)
constexpr int kJW = kBJ / 4;   // 4-byte words per slab row
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

// The two signed nibbles of a packed byte, sign-extended from a widened int:
// the low one by shifting it to the top and back (arithmetic), the high one
// by an arithmetic shift of the sign-extended byte. A uint8_t path would give
// codes in [0, 15].
__device__ __forceinline__ int low_nibble(int b) {
  return static_cast<int>(static_cast<unsigned>(b) << 28) >> 28;
}
__device__ __forceinline__ int high_nibble(int b) { return b >> 4; }

__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                   const float* __restrict__ x_scale,
                   const float* __restrict__ w_scale,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int M, int N, int Kp2, int relu) {
  // +1 word per row keeps the strided reads of the transposed slabs free of
  // shared-memory bank conflicts
  __shared__ int xlo[kBM][kJW + 1];
  __shared__ int xhi[kBM][kJW + 1];
  __shared__ int wlo[kBN][kJW + 1];
  __shared__ int whi[kBN][kJW + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const size_t K = 2 * (size_t)Kp2;
  int acc[4][4] = {};

  for (int j0 = 0; j0 < Kp2; j0 += kBJ) {
    for (int e = tid; e < kBM * kJW; e += kThreads) {
      const int r = e / kJW, q = e % kJW;
      const int m = m0 + r, j = j0 + 4 * q;
      uint32_t lo = 0, hi = 0;
      if (m < M) {
        const int8_t* row = x + (size_t)m * K;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (j + t < Kp2) {
            lo |= (uint32_t)(uint8_t)row[j + t] << (8 * t);
            hi |= (uint32_t)(uint8_t)row[Kp2 + j + t] << (8 * t);
          }
        }
      }
      xlo[r][q] = (int)lo;
      xhi[r][q] = (int)hi;
    }
    for (int e = tid; e < kBN * kJW; e += kThreads) {
      const int c = e % kBN, q = e / kBN;
      const int n = n0 + c, j = j0 + 4 * q;
      uint32_t lo = 0, hi = 0;
      if (n < N) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (j + t < Kp2) {
            const int b = (int)wp[(size_t)(j + t) * N + n];  // sign-extended byte
            lo |= (uint32_t)(low_nibble(b) & 0xFF) << (8 * t);
            hi |= (uint32_t)(high_nibble(b) & 0xFF) << (8 * t);
          }
        }
      }
      wlo[c][q] = (int)lo;
      whi[c][q] = (int)hi;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kJW; ++q) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xlo[ty + 16 * i][q];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) b[jj] = wlo[tx + 16 * jj][q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = __dp4a(a[i], b[jj], acc[i][jj]);
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xhi[ty + 16 * i][q];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) b[jj] = whi[tx + 16 * jj][q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = __dp4a(a[i], b[jj], acc[i][jj]);
    }
    __syncthreads();
  }

  const float xsc = *x_scale;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx + 16 * jj;
      if (n >= N) continue;
      // the reference's order, each step rounded on its own (no FMA):
      // float(acc) * (x_scale * w_scale[n]), then + bias[n], then ReLU
      float v = __fmul_rn(__int2float_rn(acc[i][jj]), __fmul_rn(xsc, w_scale[n]));
      if (bias != nullptr) v = __fadd_rn(v, bias[n]);
      if (relu) v = v > 0.0f ? v : 0.0f;
      y[(size_t)m * N + n] = v;
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). `Kp2` is
// K / 2, the packed rows; x has 2 * Kp2 columns. `bias` may be null.
// `x_scale` points to one float, `w_scale` to N floats, on the card.
extern "C" int int4_matmul_launch(const void* x, const void* w_packed, const void* x_scale,
                                  const void* w_scale, const void* bias, void* y,
                                  int M, int N, int Kp2, int relu, void* stream) {
  if (M <= 0 || N <= 0 || Kp2 <= 0 || (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int4_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w_packed),
      static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), static_cast<float*>(y), M, N, Kp2, relu);
  return (int)cudaGetLastError();
}
