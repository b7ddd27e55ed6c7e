// One decode step of int8 attention against an int4-packed KV cache,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// brevitas_tpu/kernels/int8_attention.py::int4kv_decode_attention
// (_int4kv_decode_kernel:289). The cache packs two positions per byte, split
// halves over positions: byte row r of a (rows, Lh, D) cache holds position
// r in its low nibble and position r + Lh in its high nibble, both signed
// 4-bit codes. For query row bh (one new token), KV row bh / groups:
//
//     s[t]   = float(sum_d q[d] * k[t, d]) * qk_scale,  valid for t <= pos
//     p[t]   = exp(s[t] - max s) / sum exp(s - max s)    over valid t
//     pq[t]  = clip(rint(p[t] / p_scale), 0, p_levels)
//     out[d] = float(sum_t pq[t] * v[t, d]) * (p_scale * v_scale)
//
// q (BH, D) int8 (the (BH, 1, D) query), out (BH, D) float32; codes, when
// not null, (BH, 2 Lh) uint8 receives pq (the caller zero-fills it).
//
// The nibbles are unpacked in registers, sign-extended as (b << 28) >> 28 and
// b >> 4 on the byte as a 32-bit int, so the unpacked cache never exists in
// memory. One block per query row; each thread takes whole byte rows, so one
// load of a packed row serves both of its positions. The softmax is exact as
// in int8_attention.cu: three passes over the rows (max, sum, then p, codes
// and PV), each rounding step as the plain version rounds it (__fmul_rn,
// __fdiv_rn, expf, rintf); only the order of the sum differs. PV sums exact
// int32 products per thread, then across threads; the result does not depend
// on the order.
//
// What bounds it on the H100: at the decode shape (BH 256, Lh 512, D 64,
// pos 1023) the packed K and V are 16.8 MB, 5 us at 3.35 TB/s, against
// 0.07 GOP; so bytes. This first kernel reads each packed K row three times
// (from L2 after the first), byte by byte, and multiplies with __dp4a on the
// CUDA cores; vector loads, and splitting a long cache over several blocks,
// are later work.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxD = 256;
constexpr int kMaxW = kMaxD / 4;

__device__ __forceinline__ int lo_nibble(int b) { return (int)((uint32_t)b << 28) >> 28; }
__device__ __forceinline__ int hi_nibble(int b) { return b >> 4; }

// packed row -> dot products of q with the low-nibble and high-nibble rows
__device__ __forceinline__ void dots(const int* qw, const int8_t* row, int D, int& lo,
                                     int& hi) {
  lo = 0;
  hi = 0;
  for (int d0 = 0; d0 < D; d0 += 4) {
    uint32_t wl = 0, wh = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (d0 + t < D) {
        const int b = row[d0 + t];
        wl |= (uint32_t)(lo_nibble(b) & 0xFF) << (8 * t);
        wh |= (uint32_t)(hi_nibble(b) & 0xFF) << (8 * t);
      }
    }
    lo = __dp4a(qw[d0 / 4], (int)wl, lo);
    hi = __dp4a(qw[d0 / 4], (int)wh, hi);
  }
}

// reductions over the block in a fixed order: lanes by butterfly, then
// warps in index order
__device__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kThreads / 32; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kThreads / 32; ++w) r = __fadd_rn(r, red[w]);
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kThreads)
int4kv_decode_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ kp,
                     const int8_t* __restrict__ vp, const float* __restrict__ scales,
                     float* __restrict__ out, uint8_t* __restrict__ codes,
                     int Lh, int D, int groups, int pos, int p_levels) {
  __shared__ int qw[kMaxW];
  __shared__ float red[kThreads / 32];
  __shared__ int pq_s[kThreads][2];
  __shared__ int acc_s[kThreads];

  const int tid = threadIdx.x, bh = blockIdx.x;
  const int8_t* krows = kp + (size_t)(bh / groups) * Lh * D;
  const int8_t* vrows = vp + (size_t)(bh / groups) * Lh * D;
  const float qk_scale = scales[0], p_scale = scales[1], v_scale = scales[2];
  for (int w = tid; w < (D + 3) / 4; w += kThreads) {
    uint32_t v = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (4 * w + t < D) v |= (uint32_t)(uint8_t)q[(size_t)bh * D + 4 * w + t] << (8 * t);
    qw[w] = (int)v;
  }
  __syncthreads();

  // byte rows with at least one valid position; the high nibble of row r is
  // valid when r + Lh <= pos
  const int n_rows = min(Lh, pos + 1);

  float m = -INFINITY;
  for (int r = tid; r < n_rows; r += kThreads) {
    int lo, hi;
    dots(qw, krows + (size_t)r * D, D, lo, hi);
    m = fmaxf(m, __fmul_rn(__int2float_rn(lo), qk_scale));
    if (r + Lh <= pos) m = fmaxf(m, __fmul_rn(__int2float_rn(hi), qk_scale));
  }
  m = block_max(m, red);

  float sum = 0.0f;
  for (int r = tid; r < n_rows; r += kThreads) {
    int lo, hi;
    dots(qw, krows + (size_t)r * D, D, lo, hi);
    sum = __fadd_rn(sum, expf(__fsub_rn(__fmul_rn(__int2float_rn(lo), qk_scale), m)));
    if (r + Lh <= pos)
      sum = __fadd_rn(sum, expf(__fsub_rn(__fmul_rn(__int2float_rn(hi), qk_scale), m)));
  }
  sum = block_sum(sum, red);

  // PV: threads split as (row group g, column d); each group sums every
  // G-th row of a chunk of kThreads rows
  const int G = kThreads / D;
  const int g = tid / D, d = tid % D;
  int acc = 0;
  for (int c0 = 0; c0 < n_rows; c0 += kThreads) {
    const int r = c0 + tid;
    int code[2] = {0, 0};
    if (r < n_rows) {
      int dot[2];
      dots(qw, krows + (size_t)r * D, D, dot[0], dot[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && r + Lh > pos) break;
        const float s = __fmul_rn(__int2float_rn(dot[h]), qk_scale);
        const float p = __fdiv_rn(expf(__fsub_rn(s, m)), sum);
        const float c = rintf(__fdiv_rn(p, p_scale));
        code[h] = (int)fminf(fmaxf(c, 0.0f), (float)p_levels);
        if (codes != nullptr) codes[(size_t)bh * 2 * Lh + h * Lh + r] = (uint8_t)code[h];
      }
    }
    pq_s[tid][0] = code[0];
    pq_s[tid][1] = code[1];
    __syncthreads();
    if (g < G) {
      const int rows = min(kThreads, n_rows - c0);
      for (int rr = g; rr < rows; rr += G) {
        const int b = vrows[(size_t)(c0 + rr) * D + d];
        acc += pq_s[rr][0] * lo_nibble(b) + pq_s[rr][1] * hi_nibble(b);
      }
    }
    __syncthreads();
  }
  acc_s[tid] = g < G ? acc : 0;
  __syncthreads();
  if (tid < D) {
    int total = 0;
    for (int gg = 0; gg < G; ++gg) total += acc_s[gg * D + tid];
    out[(size_t)bh * D + tid] =
        __fmul_rn(__int2float_rn(total), __fmul_rn(p_scale, v_scale));
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). `scales`
// points to (qk_scale, p_scale, v_scale) on the card; `codes` may be null.
extern "C" int int4kv_decode_attention_launch(const void* q, const void* k_packed,
                                              const void* v_packed, const void* scales,
                                              void* out, void* codes, int BH, int Lh,
                                              int D, int groups, int pos, int p_levels,
                                              void* stream) {
  if (BH <= 0 || Lh <= 0 || D <= 0 || D > kMaxD || groups <= 0 || BH % groups != 0 ||
      pos < 0 || p_levels <= 0 || p_levels > 255)
    return (int)cudaErrorInvalidValue;
  int4kv_decode_kernel<<<BH, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k_packed),
      static_cast<const int8_t*>(v_packed), static_cast<const float*>(scales),
      static_cast<float*>(out), static_cast<uint8_t*>(codes), Lh, D, groups, pos,
      p_levels);
  return (int)cudaGetLastError();
}
