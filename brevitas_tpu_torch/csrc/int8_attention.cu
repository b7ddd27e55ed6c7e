// Fused int8 attention (prefill) on Hopper's tensor cores (sm_90a).
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
// a block makes three passes over its keys, recomputing the int32 scores
// each time: (1) the row max, (2) the row sum of expf(s - max), (3) p, its
// code and the PV product. Every step rounds as the plain version does:
// __fmul_rn / __fsub_rn / __fdiv_rn (no FMA contraction, no
// --use_fast_math), expf, rintf (half to even, like torch.round). Only the
// order of the row sum differs from the plain version, so a code can differ
// by one where p / p_scale lies within a few ulps of a .5 boundary. PV is
// exact in int32 while Tk * p_levels * 128 < 2^31 (the wrapper checks), so
// the output is exactly the PV product of the kernel's own codes.
//
// Masking. Columns past a row's causal limit give exp(-huge) = 0 exactly and
// are skipped: their code is 0. A fully masked row (Tk < Tq, i < Tq - Tk)
// sees every column at the masked score, so exp(0) = 1 everywhere and p =
// 1 / Tk, the reference's uniform softmax.
//
// What bounds it on the H100: at the prefill shape (BH 128, T 512, D 64,
// causal) the inputs and output are about 29 MB, 8.8 us at 3.35 TB/s, and
// the int8 products about 4.3 GOP, 2 us at 1,979 TOP/s; so bytes. The exact
// elementwise softmax sets a floor of its own: about 16.8 M unmasked scores,
// each with two expf, two IEEE divides and a round (60-70 instructions),
// about 35-40 us of the SMs' issue rate.
//
// Design. A CTA is one warpgroup (128 threads) over 64 query rows of one
// head; heavy causal blocks (the last query rows) are scheduled first.
//   - QK^T on s8 wgmma (m64n64k32): Q is the register A operand, loaded once
//     from device memory into fragments (rows 16 w + g and + 8 of warp w,
//     D padded to a multiple of 32 with zeros); each K tile (64 keys x D
//     bytes, K-major as the (Tk, D) rows already are) is the shared-memory B
//     operand. K and V tiles come through a 2-stage ring by TMA (128-byte
//     swizzle, mbarrier completion, zero fill past the tensor); where TMA
//     cannot describe a row (D % 16 != 0, or an unaligned base) all threads
//     fill the same tiles with masked byte loads. One ring serves the three
//     passes in turn: 3 x (tiles) loads, V only in pass 3.
//   - Reductions: a thread holds two rows' scores (columns 8 j + 2 t + e);
//     the row max and sum run over its columns in order, then a butterfly
//     over the quad of threads that share the rows (the four lanes agree to
//     the bit). A warp owns its 16 rows: no cross-warp step.
//   - PV on u8 x s8 wgmma (m64n64k32, 64 output columns a chunk): the codes
//     are the register A operand, packed from pass 3's own accumulator
//     fragments with no shuffle, by taking the keys of a 32-key step in the
//     order the fragments hold them: A position 16 h + 4 t + b is key
//     16 h + 8 (b / 2) + 2 t + b % 2. V's tile is transposed into a (D x 64)
//     K-major tile in that same key order (4 x 4 byte blocks by byte
//     permutes, hopper.cuh's transpose4x4) while the pass's QK^T wgmma runs.
//   - Causal: a block loads only the key tiles up to its last row's limit;
//     each score is masked against its own row's limit.
// The launcher (int8_attention_plan says what it takes) instantiates the
// kernel for DC = ceil(D / 64) output chunks, 1 to 4.
//
//   - Each pass's elementwise loop is straight-line: a column past its row's
//     limit is computed and dropped by a select, never by a branch.
// On an H100 at the prefill shape it takes about 0.1 ms, nearer the
// softmax's issue floor than the byte bound: pass 3 holds half of a block's
// cycles, and each __fdiv_rn ends a basic block at its slow-path check
// (PERF.md; kernel_probes.py stamps the passes).
//
// Resources (ptxas -v, sm_90a): 128 / 194 / 213 / 255 registers at DC 1 / 2
// / 3 / 4, 24 bytes of spill at DC 4 only (four CTAs an SM at DC 1);
// dynamic shared memory 2 stages x (K and V tiles of ceil(D / 128) x 8 KB)
// + the transposed V tile (DC x 8 KB) + barriers: 41 / 49 / 90 / 98 KB.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kRows = 64;         // query rows a CTA: wgmma's M
constexpr int kKeys = 64;         // keys a tile
constexpr int kThreads = 128;     // one warpgroup
constexpr int kStages = 2;
constexpr int kMaxD = 256;
constexpr int kTile = kKeys * 128;  // one 128-byte column block of a tile
constexpr float kMasked = -0x1.fffffep+126f;  // finfo(float32).min / 2

template <int DC>
__host__ __device__ constexpr int col_blocks() {
  return (DC + 1) / 2;  // 128-byte column blocks of a K or V tile
}

template <int DC>
constexpr int smem_bytes() {
  return kStages * 2 * col_blocks<DC>() * kTile + DC * kTile + kStages * 8 + 1024;
}

// 4 bytes of a row at `col`, zero past D; a word load where rows are
// word-aligned
__device__ __forceinline__ uint32_t row_word(const int8_t* row, int col, int D, bool words) {
  if (col >= D) return 0;
  if (words) return *reinterpret_cast<const uint32_t*>(row + col);
  uint32_t w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (col + b < D) w |= (uint32_t)(uint8_t)row[col + b] << (8 * b);
  return w;
}

template <int DC>
__global__ void __launch_bounds__(kThreads)
int8_attention_kernel(const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, const int8_t* __restrict__ q,
                      const int8_t* __restrict__ k, const int8_t* __restrict__ v,
                      const float* __restrict__ scales, float* __restrict__ out,
                      uint8_t* __restrict__ codes, int BH, int Tq, int Tk, int D, int groups,
                      int p_levels, int causal, int n_qblocks, int tma) {
  constexpr int DB = col_blocks<DC>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ring = smem;                             // kStages x (K tile, V tile)
  uint8_t* vt = smem + kStages * 2 * DB * kTile;    // V^T: DC x (64 d x 128 bytes)
  uint64_t* full = reinterpret_cast<uint64_t*>(vt + DC * kTile);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  // the last query blocks of a head carry the most causal tiles: first
  const int bh = blockIdx.x % BH;
  const int q0 = (n_qblocks - 1 - blockIdx.x / BH) * kRows;
  const int kvh = bh / groups;
  const float qk_scale = scales[0], p_scale = scales[1], v_scale = scales[2];

  // this thread's two rows (16 warp + g, + 8): the keys each sees, and
  // whether it is fully masked (then every key counts, at the masked score)
  int lim[2];
  bool fully[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = q0 + 16 * warp + g + 8 * rr;
    const int c = i + Tk - Tq;
    fully[rr] = i < Tq && causal && c < 0;
    lim[rr] = i >= Tq ? 0 : (!causal || fully[rr]) ? Tk : min(Tk, c + 1);
  }
  const int i_last = min(q0 + kRows, Tq) - 1;
  const int block_lim = (!causal || q0 + Tk - Tq < 0) ? Tk : min(Tk, i_last + Tk - Tq + 1);
  const int nt = (block_lim + kKeys - 1) / kKeys;
  const int total = 3 * nt;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
  }
  __syncthreads();

  const int8_t* kp = k + (size_t)kvh * Tk * D;
  const int8_t* vp = v + (size_t)kvh * Tk * D;
  // load L of the ring: tile L % nt of pass L / nt; called by every thread
  auto issue = [&](int L) {
    if (L >= total) return;
    const int s = L % kStages, t0 = (L % nt) * kKeys;
    const bool with_v = L / nt == 2;
    uint8_t* kt = ring + s * 2 * DB * kTile;
    uint8_t* vtile = kt + DB * kTile;
    if (tma) {
      if (tid == 0) {
        mbar_arrive_expect_tx(&full[s], (with_v ? 2 : 1) * DB * kTile);
        for (int cb = 0; cb < DB; ++cb) {
          tma_load_2d(kt + cb * kTile, &map_k, &full[s], 128 * cb, kvh * Tk + t0);
          if (with_v) tma_load_2d(vtile + cb * kTile, &map_v, &full[s], 128 * cb, kvh * Tk + t0);
        }
      }
    } else {
      for (int cb = 0; cb < DB; ++cb) {
        load_tile_bytes(kt + cb * kTile, kp, D, Tk, D, t0, 128 * cb, kKeys, tid);
        if (with_v) load_tile_bytes(vtile + cb * kTile, vp, D, Tk, D, t0, 128 * cb, kKeys, tid);
      }
      fence_proxy_async();
      __syncthreads();
      if (tid == 0) mbar_arrive(&full[s]);
    }
  };
  for (int L = 0; L < kStages; ++L) issue(L);

  // Q fragments: a[0] row 16 warp + g, bytes 32 kk + 4t..; a[1] row + 8;
  // a[2], a[3] the same rows at 32 kk + 16 + 4t..; zero past D and Tq (so
  // the k-steps past D add nothing, whatever the K tile holds there)
  const bool q_words = D % 4 == 0 && (reinterpret_cast<uintptr_t>(q) & 3) == 0;
  uint32_t qa[2 * DC][4];
#pragma unroll
  for (int kk = 0; kk < 2 * DC; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = q0 + 16 * warp + g + 8 * (x & 1);
      const int col = 32 * kk + 16 * (x >> 1) + 4 * t;
      qa[kk][x] = i < Tq ? row_word(q + ((size_t)bh * Tq + i) * D, col, D, q_words) : 0u;
    }
  }

  float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.0f, 0.0f};
  int o[DC][32];
#pragma unroll
  for (int n = 0; n < DC; ++n)
#pragma unroll
    for (int x = 0; x < 32; ++x) o[n][x] = 0;
  int sacc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) sacc[x] = 0;

  int L = 0;
  for (int pass = 0; pass < 3; ++pass) {
    float part[2] = {pass == 0 ? -INFINITY : 0.0f, pass == 0 ? -INFINITY : 0.0f};
    for (int it = 0; it < nt; ++it, ++L) {
      const int s = L % kStages;
      mbar_wait(&full[s], (L / kStages) & 1);
      const uint8_t* kt = ring + s * 2 * DB * kTile;
      pin(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2 * DC; ++kk)
        wgmma_s8<64>(sacc, qa[kk], desc_sw128(kt + (kk / 4) * kTile) + 2 * (kk % 4), kk > 0);
      wgmma_commit();
      if (pass == 2) {
        // V's tile into vt, transposed, in the PV key order: task (G, tt,
        // dq) takes keys 16 G + {2 tt, 2 tt + 1, 8 + 2 tt, 9 + 2 tt} at
        // columns 4 dq..4 dq + 3, which land at positions 16 G + 4 tt + b
        // of rows 4 dq + c
        const uint8_t* vtile = kt + DB * kTile;
#pragma unroll
        for (int x0 = 0; x0 < 256 * DC; x0 += kThreads) {
          const int x = x0 + tid, gt = x & 15, dq = x >> 4;
          const int G = gt >> 2, tt = gt & 3, d = 4 * dq;
          const uint8_t* vb = vtile + (d >> 7) * kTile + (d & 15);
          const int chunk = (d & 127) >> 4;
          uint32_t rows4[4], col[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int key = 16 * G + 8 * (b >> 1) + 2 * tt + (b & 1);
            rows4[b] = *reinterpret_cast<const uint32_t*>(vb + swizzle128(key, chunk));
          }
          transpose4x4(rows4, col);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int dd = d + c;
            *reinterpret_cast<uint32_t*>(vt + (dd >> 6) * kTile + swizzle128(dd & 63, G) +
                                         4 * tt) = col[c];
          }
        }
        fence_proxy_async();
      }
      wgmma_wait_all();
      pin(sacc);

      // register x holds row 16 warp + g + 8 rr, column t0 + 8 j + 2 t + e;
      // its code is byte 2 (j % 2) + e of A register pa[j / 4][rr + 2 ((j / 2) % 2)]
      // (the 32-key step j / 4, position 16 h + 4 t + b of the note). A
      // column past the row's limit is dropped by a select: its exp may be
      // inf, which a product would not drop
      const int t0 = it * kKeys;
      uint32_t pa[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
      auto column = [&](int x) { return t0 + 8 * (x >> 2) + 2 * t + (x & 1); };
      auto score = [&](int x) {
        return fully[(x >> 1) & 1] ? kMasked : __fmul_rn(__int2float_rn(sacc[x]), qk_scale);
      };
      if (pass == 0) {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int rr = (x >> 1) & 1;
          const float sc = score(x);
          part[rr] = column(x) < lim[rr] ? fmaxf(part[rr], sc) : part[rr];
        }
      } else if (pass == 1) {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int rr = (x >> 1) & 1;
          const float ex = expf(__fsub_rn(score(x), row_max[rr]));
          part[rr] = column(x) < lim[rr] ? __fadd_rn(part[rr], ex) : part[rr];
        }
      } else {
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const int j = x >> 2, rr = (x >> 1) & 1, e = x & 1;
          const bool in = column(x) < lim[rr];
          const float p = __fdiv_rn(expf(__fsub_rn(score(x), row_max[rr])), row_sum[rr]);
          const float c = rintf(__fdiv_rn(p, p_scale));
          const uint32_t code = in ? (uint32_t)fminf(fmaxf(c, 0.0f), (float)p_levels) : 0u;
          pa[j >> 2][rr + 2 * ((j >> 1) & 1)] |= code << (8 * (2 * (j & 1) + e));
          if (codes != nullptr && in)
            codes[((size_t)bh * Tq + q0 + 16 * warp + g + 8 * rr) * Tk + column(x)] =
                (uint8_t)code;
        }
      }

      if (pass == 2) {
        __syncthreads();  // vt is whole
#pragma unroll
        for (int n = 0; n < DC; ++n) pin(o[n]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int n = 0; n < DC; ++n)
            wgmma_u8s8<64>(o[n], pa[kk], desc_sw128(vt + n * kTile) + 2 * kk, 1);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int n = 0; n < DC; ++n) pin(o[n]);
      }
      __syncthreads();  // every warp is done with stage s (and vt)
      issue(L + kStages);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float v0 = part[rr];
      if (pass == 0) {
        v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 1));
        row_max[rr] = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 2));
      } else if (pass == 1) {
        v0 = __fadd_rn(v0, __shfl_xor_sync(0xffffffffu, v0, 1));
        row_sum[rr] = __fadd_rn(v0, __shfl_xor_sync(0xffffffffu, v0, 2));
      }
    }
  }

  const float pv_scale = __fmul_rn(p_scale, v_scale);
#pragma unroll
  for (int n = 0; n < DC; ++n)
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int j = x >> 2, rr = (x >> 1) & 1, e = x & 1;
      const int i = q0 + 16 * warp + g + 8 * rr, d = 64 * n + 8 * j + 2 * t + e;
      if (i < Tq && d < D)
        out[((size_t)bh * Tq + i) * D + d] = __fmul_rn(__int2float_rn(o[n][x]), pv_scale);
    }
}

struct Plan {
  int dc, tma;
};

// k_aligned, v_aligned: whether K and V start on a 16-byte boundary
Plan plan_for(int D, bool k_aligned, bool v_aligned) {
  Plan p;
  p.dc = (D + 63) / 64;
  p.tma = D % 16 == 0 && k_aligned && v_aligned;
  return p;
}

template <int DC>
int launch(const Plan& p, const void* q, const void* k, const void* v, const void* scales,
           void* out, void* codes, int BH, int Tq, int Tk, int D, int groups, int p_levels,
           int causal, cudaStream_t stream) {
  CUtensorMap map_k{}, map_v{};  // left zero where the threads load bytes
  const uint64_t rows = (uint64_t)(BH / groups) * Tk;
  if (p.tma && !(tensor_map(&map_k, CU_TENSOR_MAP_DATA_TYPE_UINT8, k, rows, D, D, kKeys, 128) &&
                 tensor_map(&map_v, CU_TENSOR_MAP_DATA_TYPE_UINT8, v, rows, D, D, kKeys, 128)))
    return (int)cudaErrorInvalidValue;
  const int n_qblocks = cdiv(Tq, kRows);
  const long long blocks = (long long)BH * n_qblocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return launch_kernel(int8_attention_kernel<DC>, dim3((unsigned)blocks), kThreads,
                       smem_bytes<DC>(), dim3(1, 1, 1), stream, map_k, map_v,
                       static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
                       static_cast<const int8_t*>(v), static_cast<const float*>(scales),
                       static_cast<float*>(out), static_cast<uint8_t*>(codes), BH, Tq, Tk, D,
                       groups, p_levels, causal, n_qblocks, p.tma);
}

}  // namespace

// The variant the launcher takes: 64-column output chunks (bits 0-7), K
// and V by TMA (bit 8). kernels/int8_attention.py::int8_attention_plan is
// its Python twin.
extern "C" int int8_attention_plan(int D, int k_aligned, int v_aligned) {
  const Plan p = plan_for(D, k_aligned != 0, v_aligned != 0);
  return p.dc | (p.tma << 8);
}

// Launches on `stream`; returns a CUDA error code (0 on success). `scales`
// points to (qk_scale, p_scale, v_scale) on the card; `codes` may be null.
extern "C" int int8_attention_launch(const void* q, const void* k, const void* v,
                                     const void* scales, void* out, void* codes,
                                     int BH, int Tq, int Tk, int D, int groups,
                                     int p_levels, int causal, void* stream) {
  if (BH <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > kMaxD || groups <= 0 ||
      BH % groups != 0 || p_levels <= 0 || p_levels > 255)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(D, aligned16(k), aligned16(v));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.dc) {
    case 1: return launch<1>(p, q, k, v, scales, out, codes, BH, Tq, Tk, D, groups, p_levels, causal, s);
    case 2: return launch<2>(p, q, k, v, scales, out, codes, BH, Tq, Tk, D, groups, p_levels, causal, s);
    case 3: return launch<3>(p, q, k, v, scales, out, codes, BH, Tq, Tk, D, groups, p_levels, causal, s);
    default: return launch<4>(p, q, k, v, scales, out, codes, BH, Tq, Tk, D, groups, p_levels, causal, s);
  }
}
