// Fused int8 attention (prefill), written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel brevitas_tpu/kernels/int8_attention.py::int8_attention
// (_attn_kernel:60). Per (batch*head, query row i):
//
//     s[j]   = float(sum_d q[i, d] * k[j, d]) * qk_scale      (int32 products)
//     s[j]   = finfo(float32).min / 2   where masked (causal: j > i + Tk - Tq)
//     p[j]   = exp(s[j] - max_j s) / sum_j exp(s[j] - max_j s)
//     pq[j]  = clip(rint(p[j] / p_scale), 0, p_levels)
//     out[d] = float(sum_j pq[j] * v[j, d]) * (p_scale * v_scale)  (int32 sums)
//
// q (BH, Tq, D), k and v (BH / groups, Tk, D) int8, row-major; query row bh
// reads KV row bh / groups (grouped-query attention without copying the
// cache). out (BH, Tq, D) float32; codes, when not null, (BH, Tq, Tk) uint8
// receives pq (the caller zero-fills it; masked columns stay 0).
//
// Exactness. The softmax is the reference's, not an online one: a running
// rescale would round p differently and move codes across .5 boundaries. So
// each block makes three passes over the keys, recomputing the int8 scores
// from K tiles in shared memory: (1) the row max, (2) the row sum of
// expf(s - max), (3) p, its code and the PV product. Every step rounds as the
// plain version does: __fmul_rn/__fdiv_rn (no FMA contraction, no
// --use_fast_math), expf, rintf (half to even, like torch.round). Only the
// order of the row sum differs from the plain version, so a code can differ
// by one where p / p_scale lies within a few ulps of a .5 boundary. PV is
// exact in int32 while Tk * p_levels * 128 < 2^31 (the wrapper checks), so
// the result does not depend on summation order.
//
// Masking. Columns past a row's causal limit give exp(-huge) = 0 exactly and
// are skipped. A fully masked row (Tk < Tq, i < Tq - Tk) sees every column at
// the masked score, so exp(0) = 1 everywhere and p = 1 / Tk, the reference's
// uniform softmax.
//
// What bounds it on the H100: at the prefill shape (BH 128, T 512, D 64,
// causal) the inputs and output are about 29 MB, 9 us at 3.35 TB/s, and the
// int8 work about 4.3 GOP (two products of half the T x T square), 2 us at
// 1,979 TOP/s; so bytes. This first kernel is far from it by design: it
// multiplies with __dp4a and plain int32 multiply-adds on the CUDA cores,
// recomputes QK^T three times, and loads bytes one at a time. Tensor cores
// (wgmma s8) fed by TMA, and keeping the score rows in shared memory, are
// later work.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 16;                 // query rows per block
constexpr int kBK = 64;                 // keys per shared-memory tile
constexpr int kThreads = 256;           // 8 warps, 2 query rows each
constexpr int kMaxD = 256;
constexpr int kMaxW = kMaxD / 4;        // 4-byte words per row
constexpr int kOutPerThread = kBQ * kMaxD / kThreads;
constexpr float kMasked = -0x1.fffffep+126f;  // finfo(float32).min / 2

__device__ __forceinline__ uint32_t pack4(const int8_t* row, int d0, int D) {
  uint32_t v = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (d0 + t < D) v |= (uint32_t)(uint8_t)row[d0 + t] << (8 * t);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
int8_attention_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                      const int8_t* __restrict__ v, const float* __restrict__ scales,
                      float* __restrict__ out, uint8_t* __restrict__ codes,
                      int Tq, int Tk, int D, int groups, int p_levels, int causal,
                      int n_qblocks) {
  __shared__ int qw[kBQ][kMaxW];
  // +1 word per key row: lanes reading 32 different keys hit 32 banks
  __shared__ int kw[kBK][kMaxW + 1];
  __shared__ int8_t vs[kBK][kMaxD];
  __shared__ int pq_s[kBQ][kBK];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x / n_qblocks;
  const int q0 = (blockIdx.x % n_qblocks) * kBQ;
  const int nw = (D + 3) / 4;
  const int8_t* qp = q + (size_t)bh * Tq * D;
  const int8_t* kp = k + (size_t)(bh / groups) * Tk * D;
  const int8_t* vp = v + (size_t)(bh / groups) * Tk * D;
  const float qk_scale = scales[0], p_scale = scales[1], v_scale = scales[2];

  for (int e = tid; e < kBQ * nw; e += kThreads) {
    const int r = e / nw, w = e % nw;
    qw[r][w] = q0 + r < Tq ? (int)pack4(qp + (size_t)(q0 + r) * D, 4 * w, D) : 0;
  }

  // this warp's two rows: how many leading keys each sees, and whether the
  // row is fully masked (then every key counts, at the masked score)
  int lim[2];
  bool fully[2];
  int block_lim = 0;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = q0 + 2 * warp + rr;
    const int c = i + Tk - Tq;
    fully[rr] = i < Tq && causal && c < 0;
    lim[rr] = i >= Tq ? 0 : (!causal || fully[rr]) ? Tk : min(Tk, c + 1);
  }
  for (int r = 0; r < kBQ; ++r) {
    const int i = q0 + r;
    if (i >= Tq) break;
    const int c = i + Tk - Tq;
    block_lim = max(block_lim, (!causal || c < 0) ? Tk : min(Tk, c + 1));
  }

  float row_max[2] = {-INFINITY, -INFINITY};
  float row_sum[2] = {0.0f, 0.0f};
  int acc[kOutPerThread];
#pragma unroll
  for (int t = 0; t < kOutPerThread; ++t) acc[t] = 0;

  for (int pass = 0; pass < 3; ++pass) {
    float part[2] = {pass == 0 ? -INFINITY : 0.0f, pass == 0 ? -INFINITY : 0.0f};
    for (int t0 = 0; t0 < block_lim; t0 += kBK) {
      __syncthreads();  // the previous tile (or the q rows) is consumed / ready
      for (int e = tid; e < kBK * nw; e += kThreads) {
        const int j = e / nw, w = e % nw;
        kw[j][w] = t0 + j < Tk ? (int)pack4(kp + (size_t)(t0 + j) * D, 4 * w, D) : 0;
      }
      if (pass == 2) {
        for (int e = tid; e < kBK * D; e += kThreads) {
          const int j = e / D, d = e % D;
          vs[j][d] = t0 + j < Tk ? vp[(size_t)(t0 + j) * D + d] : (int8_t)0;
        }
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = 2 * warp + rr;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = lane + 32 * jj, key = t0 + j;
          const bool in = key < lim[rr];
          float s = kMasked;
          if (in && !fully[rr]) {
            int dot = 0;
            for (int w = 0; w < nw; ++w) dot = __dp4a(qw[r][w], kw[j][w], dot);
            s = __fmul_rn(__int2float_rn(dot), qk_scale);
          }
          if (pass == 0) {
            if (in) part[rr] = fmaxf(part[rr], s);
          } else if (pass == 1) {
            if (in) part[rr] = __fadd_rn(part[rr], expf(__fsub_rn(s, row_max[rr])));
          } else {
            int code = 0;
            if (in) {
              const float p = __fdiv_rn(expf(__fsub_rn(s, row_max[rr])), row_sum[rr]);
              const float c = rintf(__fdiv_rn(p, p_scale));
              code = (int)fminf(fmaxf(c, 0.0f), (float)p_levels);
              if (codes != nullptr)
                codes[((size_t)bh * Tq + q0 + r) * Tk + key] = (uint8_t)code;
            }
            pq_s[r][j] = code;
          }
        }
      }
      if (pass == 2) {
        __syncthreads();
#pragma unroll
        for (int t = 0; t < kOutPerThread; ++t) {
          const int o = tid + t * kThreads;
          if (o < kBQ * D) {
            const int r = o / D, d = o % D;
            int a = acc[t];
#pragma unroll 8
            for (int j = 0; j < kBK; ++j) a += pq_s[r][j] * (int)vs[j][d];
            acc[t] = a;
          }
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (pass == 0) row_max[rr] = warp_max(part[rr]);
      if (pass == 1) row_sum[rr] = warp_sum(part[rr]);
    }
  }

  const float pv_scale = __fmul_rn(p_scale, v_scale);
#pragma unroll
  for (int t = 0; t < kOutPerThread; ++t) {
    const int o = tid + t * kThreads;
    if (o < kBQ * D) {
      const int r = o / D, d = o % D;
      if (q0 + r < Tq)
        out[((size_t)bh * Tq + q0 + r) * D + d] = __fmul_rn(__int2float_rn(acc[t]), pv_scale);
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). `scales`
// points to (qk_scale, p_scale, v_scale) on the card; `codes` may be null.
extern "C" int int8_attention_launch(const void* q, const void* k, const void* v,
                                     const void* scales, void* out, void* codes,
                                     int BH, int Tq, int Tk, int D, int groups,
                                     int p_levels, int causal, void* stream) {
  if (BH <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > kMaxD || groups <= 0 ||
      BH % groups != 0 || p_levels <= 0 || p_levels > 255)
    return (int)cudaErrorInvalidValue;
  const int n_qblocks = (Tq + kBQ - 1) / kBQ;
  const long long blocks = (long long)BH * n_qblocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int8_attention_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(scales),
      static_cast<float*>(out), static_cast<uint8_t*>(codes), Tq, Tk, D, groups,
      p_levels, causal, n_qblocks);
  return (int)cudaGetLastError();
}
