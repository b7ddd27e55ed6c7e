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
// What bounds it on the H100: bytes. A valid byte row is read once for K
// and once for V: at the decode shape (BH 256, Lh 512, D 64) 2.2 MB at pos
// 63 (0.65 us at 3.35 TB/s) and 16.8 MB at pos 1023 (5.0 us), against 0.07
// GOP at most. No tensor cores: decode has one query row per head, a 1-row
// product, so the launch latency and the bytes are all there is.
//
// Design: one pass over the cache. A CTA takes R query rows that share one
// KV head (R divides kv_groups, at most 8) and a chunk of the valid byte
// rows; S <= 8 CTAs may split the rows over a thread-block cluster.
//   1. Thread 0 starts the chunk's packed K rows, then its packed V rows,
//      into shared memory before any barrier, each with one cp.async.bulk
//      completing on an mbarrier (a chunk is contiguous, rows x D bytes; the
//      copy is widened to the 16-byte granules that hold it). V lands while
//      the scores are formed. A chunk larger than 48 KB goes in tiles.
//   2. Scores once: 2 to 8 lanes take each packed row (16-byte loads where
//      the rows are aligned) and run dp4a.s32.u32 of the query bytes
//      against the nibbles as unsigned bytes u = n ^ 8 (hopper.cuh's
//      nibbles_u_lo, one lop3 a word), less 8 x the query bytes' sum: the
//      signed code is u - 8, so the dot product is exact in int. Lanes
//      combine by shuffle; the lead lane scales each
//      score as __fmul_rn(__int2float_rn(dot), qk_scale), keeps it in shared
//      memory (2 floats a byte row) and its running max. K is read once.
//   3. The max, then the sum of expf(s - max), in a fixed order: each
//      thread's strided share, a butterfly in the warp, the warps in index
//      order, then the cluster's ranks in rank order through distributed
//      shared memory; so every rank holds the same bits whatever the
//      scheduling. Each exp is kept in place of its score.
//   4. p = __fdiv_rn(exp, sum), code = clip(rintf(__fdiv_rn(p, p_scale)), 0,
//      p_levels), each step rounded as the plain version rounds it; only the
//      order of the exp sum differs (a code may flip at a .5 tie). The codes
//      are kept as bytes, zero where a position is not valid.
//   5. PV: a thread takes four columns of four rows, transposes the four row
//      words into column words with byte permutes, and runs dp4a of the
//      rows' codes against each column's u bytes, less 8 x the codes' sum:
//      int32 sums, then integer atomics in shared memory across threads and
//      a rank-order sum across the cluster, exact in any order; so the
//      output is exactly the PV product of the kernel's own codes.
// The launcher (int4kv_decode_attention_plan says what it takes;
// ..._launch_splits forces S) picks R from kv_groups, 256 threads a CTA
// where it scores more than 128 (query row, byte row) pairs and 128 below,
// and S > 1 only where the CTAs do not fill the SMs and each rank keeps at
// least 256 rows: chip_smoke.py's forced-split tables (PERF.md) put a
// cluster at 2-4 us of fixed time, lost at 256 CTAs over 512 rows, and a
// win from about 1,024 rows at 16 CTAs, best at 256 rows a rank. Where a
// chunk's scores do not fit in shared memory (R x l_half beyond about
// 100,000 rows) they go to a scratch buffer that the wrapper allocates.
//
// Resources (ptxas -v, sm_90a): 47-75 registers a thread by (R, threads),
// no spills (chip_smoke.py's build phase prints each); dynamic shared
// memory is sized per launch: the K and V chunks, the scores and codes,
// the reduction slots.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMaxD = 256;
constexpr int kMaxWarps = 8;           // 256 threads for long chunks, 128 for short
constexpr int kMaxSplits = 8;          // portable cluster size
constexpr int kTileCap = 48 * 1024;    // bytes of a K or V tile in shared memory
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMinRowsPerSplit = 256;  // a rank takes at least this many byte rows

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }
__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// byte offsets of the shared-memory regions of one CTA
struct Layout {
  int kbuf, vbuf, qs, qsum, sc, cl, ch, red, xmax, xsum, gmax, gsum, xpv, bars, bytes;
};

__host__ __device__ inline Layout layout_for(int R, int D, int tile_rows, int per, int spill) {
  const int W = (D + 3) / 4;
  // a tile widened to 16-byte granules, and the rows of its last quad
  const int buf = align16(round4(tile_rows) * D + 32);
  Layout l;
  int o = 0;
  l.kbuf = o; o += buf;
  l.vbuf = o; o += buf;
  l.qs = o; o += align16(R * W * 4);
  l.qsum = o; o += align16(R * 8 * 4);
  l.sc = o; o += spill ? 0 : align16(R * 2 * per * 4);
  l.cl = o; o += align16(R * round4(per));
  l.ch = o; o += align16(R * round4(per));
  l.red = o; o += align16(kMaxWarps * R * 4);
  l.xmax = o; o += align16(R * 4);
  l.xsum = o; o += align16(R * 4);
  l.gmax = o; o += align16(R * 4);
  l.gsum = o; o += align16(R * 4);
  l.xpv = o; o += align16(R * 4 * W * 4);
  l.bars = o; o += 16;
  l.bytes = o;
  return l;
}

// the word of packed bytes at p (bytes at and past `n` zero where the rows
// are not 4-byte aligned)
__device__ __forceinline__ uint32_t load_word(const uint8_t* p, int words_ok, int n) {
  if (words_ok) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (b < n) v |= (uint32_t)p[b] << (8 * b);
  return v;
}

// c + sum of (signed bytes of a) x (unsigned bytes of b)
__device__ __forceinline__ int dp4a_su(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// rows [r0, r1) of a packed cache head into `buf`, widened to the 16-byte
// granules that hold them (every byte read lies in a granule that holds a
// byte of the cache); returns the offset of row r0 in `buf`
__device__ __forceinline__ int issue_rows(uint8_t* buf, uint64_t* bar, const int8_t* head,
                                          int r0, int r1, int D, bool reuse = true) {
  const uintptr_t start = reinterpret_cast<uintptr_t>(head) + (size_t)r0 * D;
  const uintptr_t end = reinterpret_cast<uintptr_t>(head) + (size_t)r1 * D;
  const uintptr_t a0 = start & ~uintptr_t(15), a1 = (end + 15) & ~uintptr_t(15);
  if (threadIdx.x == 0) {
    if (reuse) fence_proxy_async();  // the buffer was read through the generic proxy
    mbar_arrive_expect_tx(bar, (uint32_t)(a1 - a0));
    bulk_load(buf, reinterpret_cast<const void*>(a0), (uint32_t)(a1 - a0), bar);
  }
  return (int)(start - a0);
}

// the combined value over the CTA's threads and then the cluster's ranks of
// each of R per-thread partials, in a fixed order; into result[0..R)
template <int R, int NT, bool kMax>
__device__ __forceinline__ void reduce_rows(float (&v)[R], float* red, float* xchg,
                                            float* result, int S) {
  constexpr int kWarps = NT / 32;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v[i], o);
      v[i] = kMax ? fmaxf(v[i], u) : __fadd_rn(v[i], u);
    }
    if (lane == 0) red[warp * R + i] = v[i];
  }
  __syncthreads();
  if (tid < R) {
    float r = red[tid];
    for (int w = 1; w < kWarps; ++w)
      r = kMax ? fmaxf(r, red[w * R + tid]) : __fadd_rn(r, red[w * R + tid]);
    xchg[tid] = r;
    if (S == 1) result[tid] = r;
  }
  if (S > 1) {
    cluster_sync();
    if (tid < R) {
      const uint32_t local = smem_addr(xchg + tid);
      float r = __uint_as_float(ld_cluster_u32(cluster_map(local, 0)));
      for (int rank = 1; rank < S; ++rank) {
        const float u = __uint_as_float(ld_cluster_u32(cluster_map(local, rank)));
        r = kMax ? fmaxf(r, u) : __fadd_rn(r, u);
      }
      result[tid] = r;
    }
  }
  __syncthreads();
}

template <int R, int NT>
__global__ void __launch_bounds__(NT)
int4kv_decode_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ kp,
                     const int8_t* __restrict__ vp, const float* __restrict__ scales,
                     float* __restrict__ out, uint8_t* __restrict__ codes,
                     float* __restrict__ scratch, int Lh, int D, int groups, int pos,
                     int p_levels, int S, int tile_rows, int spill, int words_ok) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int rank = blockIdx.x % S;  // = the CTA's rank in its cluster
  const int bh0 = (blockIdx.x / S) * R;
  const int W = (D + 3) / 4;

  // the query words first (word w of row i at R W index i W + w, at most 4
  // a thread): their loads need no barrier
  constexpr int kQWords = (8 * (kMaxD / 4) + 127) / 128;
  uint32_t qword[kQWords];
#pragma unroll
  for (int k = 0; k < kQWords; ++k) {
    const int idx = tid + k * NT, i = idx / W, w = idx % W;
    qword[k] = 0;
    if (idx < R * W) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * w + b < D)
          qword[k] |= (uint32_t)(uint8_t)q[(size_t)(bh0 + i) * D + 4 * w + b] << (8 * b);
    }
  }

  const int n_rows = min(Lh, pos + 1);  // byte rows with a valid position
  const int per = (n_rows + S - 1) / S;
  const Layout L = layout_for(R, D, tile_rows, per, spill);
  uint8_t* kbuf = smem + L.kbuf;
  uint8_t* vbuf = smem + L.vbuf;
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem + L.qs);
  int* qsum = reinterpret_cast<int*>(smem + L.qsum);
  uint8_t* cl = smem + L.cl;
  uint8_t* ch = smem + L.ch;
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* xmax = reinterpret_cast<float*>(smem + L.xmax);
  float* xsum = reinterpret_cast<float*>(smem + L.xsum);
  float* gmax = reinterpret_cast<float*>(smem + L.gmax);
  float* gsum = reinterpret_cast<float*>(smem + L.gsum);
  int* xpv = reinterpret_cast<int*>(smem + L.xpv);
  uint64_t* kbar = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* vbar = kbar + 1;

  const int kv = bh0 / groups;      // R divides groups: one KV head for the CTA
  const int c0 = min(n_rows, rank * per), c1 = min(n_rows, c0 + per);
  const int cr = c1 - c0;
  const int nt = (cr + tile_rows - 1) / tile_rows;
  const int8_t* khead = kp + (size_t)kv * Lh * D;
  const int8_t* vhead = vp + (size_t)kv * Lh * D;
  // scores, then exp(score - max), of query row i, byte row c0 + r, half h
  // at sc[i * rstride + 2 r + h]
  float* sc = spill ? scratch + (size_t)bh0 * 2 * Lh + 2 * c0
                    : reinterpret_cast<float*>(smem + L.sc);
  const size_t rstride = spill ? (size_t)2 * Lh : (size_t)2 * per;
  const int cstride = round4(per);  // codes of query row i, half h: (h ? ch : cl)[i * cstride + r]
  const float qk_scale = scales[0], p_scale = scales[1], v_scale = scales[2];

  // thread 0 starts K's first tile, then V's, before any barrier: no other
  // thread touches the mbarriers until after the next one
  if (tid == 0) {
    mbar_init(kbar, 1);
    mbar_init(vbar, 1);
    fence_mbar_init();
  }
  int koff = 0, voff = 0;
  if (nt > 0) {
    koff = issue_rows(kbuf, kbar, khead, c0, min(c1, c0 + tile_rows), D, false);
    voff = issue_rows(vbuf, vbar, vhead, c0, min(c1, c0 + tile_rows), D, false);
  }
  for (int i = tid; i < R * 4 * W; i += NT) xpv[i] = 0;
#pragma unroll
  for (int k = 0; k < kQWords; ++k)
    if (tid + k * NT < R * W) qs[tid + k * NT] = qword[k];
  __syncthreads();

  // 2. scores: `lanes` lanes per (byte row, query row) item. Lane l takes
  // 16-byte chunks l, l + lanes, .. of the row where the rows are 16-byte
  // aligned, else words l, l + lanes, ..
  const bool vec = words_ok && D % 16 == 0 && koff % 16 == 0;
  const int units = vec ? D / 16 : W;
  const int lanes = units >= 8 ? 8 : units >= 4 ? 4 : units >= 2 ? 2 : 1;
  const int lane_in = tid % lanes, slot = tid / lanes, slots = NT / lanes;
  if (tid < R * 8) {  // the sum of the query bytes each lane multiplies
    const int i = tid / 8, l = tid % 8;
    int sq = 0;
    if (l < lanes) {
      for (int u = l; u < units; u += lanes) {
        const int w0 = vec ? 4 * u : u, nw = vec ? 4 : 1;
        for (int w = w0; w < w0 + nw; ++w) sq = __dp4a((int)qs[i * W + w], 0x01010101, sq);
      }
    }
    qsum[i * 8 + l] = sq;
  }
  // slots is a multiple of R, so a thread always scores query row slot % R
  const int my_i = slot % R;
  float my_max = -INFINITY;  // over the valid scores this thread keeps
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const int r_lo = c0 + t * tile_rows, rows_t = min(c1, r_lo + tile_rows) - r_lo;
    if (t > 0) {
      __syncthreads();  // every thread is done with the previous tile
      koff = issue_rows(kbuf, kbar, khead, r_lo, r_lo + rows_t, D);
    }
    mbar_wait(kbar, t & 1);
    for (int base = 0; base < rows_t * R; base += 2 * slots) {
      // two items a pass, for more independent work in flight
      int lo[2] = {0, 0}, hi[2] = {0, 0}, r[2];
      bool valid[2];
      const uint32_t* qi_words = qs + my_i * W;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int item = base + slot + a * slots;
        valid[a] = item < rows_t * R;
        r[a] = valid[a] ? item / R : 0;
        if (!valid[a]) continue;
        const uint8_t* row = kbuf + koff + r[a] * D;
        if (vec) {
          for (int u = lane_in; u < units; u += lanes) {
            const uint4 k4 = *reinterpret_cast<const uint4*>(row + 16 * u);
            const uint4 q4 = *reinterpret_cast<const uint4*>(qi_words + 4 * u);
            lo[a] = dp4a_su(q4.x, nibbles_u_lo(k4.x), lo[a]);
            hi[a] = dp4a_su(q4.x, nibbles_u_hi(k4.x), hi[a]);
            lo[a] = dp4a_su(q4.y, nibbles_u_lo(k4.y), lo[a]);
            hi[a] = dp4a_su(q4.y, nibbles_u_hi(k4.y), hi[a]);
            lo[a] = dp4a_su(q4.z, nibbles_u_lo(k4.z), lo[a]);
            hi[a] = dp4a_su(q4.z, nibbles_u_hi(k4.z), hi[a]);
            lo[a] = dp4a_su(q4.w, nibbles_u_lo(k4.w), lo[a]);
            hi[a] = dp4a_su(q4.w, nibbles_u_hi(k4.w), hi[a]);
          }
        } else {
          for (int w = lane_in; w < W; w += lanes) {
            const uint32_t kw = load_word(row + 4 * w, words_ok, D - 4 * w);
            lo[a] = dp4a_su(qi_words[w], nibbles_u_lo(kw), lo[a]);
            hi[a] = dp4a_su(qi_words[w], nibbles_u_hi(kw), hi[a]);
          }
        }
        const int corr = 8 * qsum[my_i * 8 + lane_in];  // the codes are u - 8
        lo[a] -= corr;
        hi[a] -= corr;
      }
      for (int o = lanes / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          lo[a] += __shfl_xor_sync(0xffffffffu, lo[a], o);
          hi[a] += __shfl_xor_sync(0xffffffffu, hi[a], o);
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        if (!valid[a] || lane_in != 0) continue;
        float* s = sc + my_i * rstride + 2 * (r_lo - c0 + r[a]);
        s[0] = __fmul_rn(__int2float_rn(lo[a]), qk_scale);
        s[1] = __fmul_rn(__int2float_rn(hi[a]), qk_scale);  // used only where valid
        my_max = fmaxf(my_max, s[0]);
        if (r_lo + r[a] + Lh <= pos) my_max = fmaxf(my_max, s[1]);
      }
    }
  }
  float part[R];
#pragma unroll
  for (int j = 0; j < R; ++j) part[j] = j == my_i ? my_max : -INFINITY;

  // 3. the max, then the sum of exp(s - max), over the valid positions of
  // every rank; each exp is kept in place of its score
  reduce_rows<R, NT, true>(part, red, xmax, gmax, S);  // its first barrier ends step 2
#pragma unroll
  for (int i = 0; i < R; ++i) part[i] = 0.0f;
#pragma unroll 4
  for (int idx = tid; idx < 2 * cr; idx += NT) {
    if ((idx & 1) && c0 + idx / 2 + Lh > pos) continue;  // high half not yet valid
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float e = expf(__fsub_rn(sc[i * rstride + idx], gmax[i]));
      sc[i * rstride + idx] = e;
      part[i] = __fadd_rn(part[i], e);
    }
  }
  reduce_rows<R, NT, false>(part, red, xsum, gsum, S);

  // 4. the codes, as bytes by half: zero where a position is not valid and
  // in the padding of the last quad of rows
  for (int idx = tid; idx < 2 * round4(cr); idx += NT) {
    const int h = idx & 1, r = idx / 2;
    const bool valid = r < cr && (h == 0 || c0 + r + Lh <= pos);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      int code = 0;
      if (valid) {
        const float p = __fdiv_rn(sc[i * rstride + idx], gsum[i]);
        const float c = rintf(__fdiv_rn(p, p_scale));
        code = (int)fminf(fmaxf(c, 0.0f), (float)p_levels);
        if (codes != nullptr)
          codes[(size_t)(bh0 + i) * 2 * Lh + h * Lh + c0 + r] = (uint8_t)code;
      }
      (h ? ch : cl)[i * cstride + r] = (uint8_t)code;
    }
  }
  __syncthreads();

  // 5. PV: thread (quad group gg, word wv) takes columns 4 wv..4 wv+3 of
  // rows 4 q..4 q+3, quads q = gg, gg + G, ... of each tile: the four row
  // words transposed to four column words by byte permutes, then a dp4a of
  // the rows' codes against each column's u bytes, less 8 x the codes' sum
  const int G = NT / W, gg = tid / W, wv = tid % W;
  const bool active = gg < G;
  uint32_t acc[R][4], csum[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    csum[i] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0;
  }
  for (int t = 0; t < nt; ++t) {
    const int r_lo = c0 + t * tile_rows, rows_t = min(c1, r_lo + tile_rows) - r_lo;
    if (t > 0) {
      __syncthreads();
      voff = issue_rows(vbuf, vbar, vhead, r_lo, r_lo + rows_t, D);
    }
    mbar_wait(vbar, t & 1);
    if (active) {
      for (int qd = gg; 4 * qd < rows_t; qd += G) {
        const uint8_t* v0 = vbuf + voff + 4 * qd * D + 4 * wv;
        const uint32_t a0 = load_word(v0, words_ok, D - 4 * wv);
        const uint32_t a1 = load_word(v0 + D, words_ok, D - 4 * wv);
        const uint32_t a2 = load_word(v0 + 2 * D, words_ok, D - 4 * wv);
        const uint32_t a3 = load_word(v0 + 3 * D, words_ok, D - 4 * wv);
        const uint32_t t0 = __byte_perm(a0, a1, 0x5140), t1 = __byte_perm(a0, a1, 0x7362);
        const uint32_t t2 = __byte_perm(a2, a3, 0x5140), t3 = __byte_perm(a2, a3, 0x7362);
        const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                                 __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
        const int rel = r_lo - c0 + 4 * qd;  // the quad's first row in the chunk
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const uint32_t cl4 = *reinterpret_cast<const uint32_t*>(cl + i * cstride + rel);
          const uint32_t ch4 = *reinterpret_cast<const uint32_t*>(ch + i * cstride + rel);
          csum[i] = __dp4a(cl4, 0x01010101u, csum[i]);
          csum[i] = __dp4a(ch4, 0x01010101u, csum[i]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][e] = __dp4a(cl4, nibbles_u_lo(col[e]), acc[i][e]);
            acc[i][e] = __dp4a(ch4, nibbles_u_hi(col[e]), acc[i][e]);
          }
        }
      }
    }
  }
  // across the quad groups: integer atomics in shared memory, exact in any
  // order (the unsigned sums wrap as int32 does); xpv[i][d] for d < 4 W
  if (active) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        atomicAdd(&xpv[i * 4 * W + 4 * wv + e], (int)(acc[i][e] - 8u * csum[i]));
  }
  __syncthreads();
  const float pv_scale = __fmul_rn(p_scale, v_scale);
  if (S == 1) {
    for (int it = tid; it < R * D; it += NT)
      out[(size_t)bh0 * D + it] =
          __fmul_rn(__int2float_rn(xpv[(it / D) * 4 * W + it % D]), pv_scale);
    return;
  }
  // the ranks' int32 partials, summed through distributed shared memory:
  // rank c writes the outputs it, it % S == c
  cluster_sync();
  for (int it = rank + S * tid; it < R * D; it += S * NT) {
    const uint32_t local = smem_addr(xpv + (it / D) * 4 * W + it % D);
    int total = 0;
    for (int c = 0; c < S; ++c) total += (int)ld_cluster_u32(cluster_map(local, c));
    out[(size_t)bh0 * D + it] = __fmul_rn(__int2float_rn(total), pv_scale);
  }
  cluster_sync();  // no CTA leaves while another may still read its partials
}

struct Plan {
  int rows, splits, threads, tile_rows, spill, smem;
};

// R query rows a CTA, S ranks a cluster, the tile, and whether the scores go
// to scratch; `force` > 0 fixes S (at most the valid byte rows)
Plan plan_for(int BH, int Lh, int D, int groups, int pos, int force) {
  Plan p;
  p.rows = groups % 8 == 0 ? 8 : groups % 4 == 0 ? 4 : groups % 2 == 0 ? 2 : 1;
  const int n_rows = std::min(Lh, pos + 1);
  // more ranks only while the CTAs do not fill the SMs, each keeping at
  // least kMinRowsPerSplit rows: a cluster costs 2-4 us of fixed time
  const int ctas = BH / p.rows;
  int s = force;
  if (s == 0)
    s = ctas >= sm_count() ? 1 : std::min(cdiv(sm_count(), ctas), cdiv(n_rows, kMinRowsPerSplit));
  for (;;) {
    s = std::max(1, std::min(std::min(s, kMaxSplits), n_rows));
    p.splits = cdiv(n_rows, cdiv(n_rows, s));  // no rank left without rows
    const int per = cdiv(n_rows, p.splits);
    // a tile holds whole quads of rows, but for the chunk's last one
    p.tile_rows = std::min(per, std::max(4, ((kTileCap - 32) / D) & ~3));
    // 256 threads where a CTA scores more than 128 (query row, byte row)
    // pairs: enough warps to hide the latency of a long chunk, while three
    // CTAs still fit on an SM (512 would fit one: two waves at BH 256)
    p.threads = p.rows * per > 128 ? 256 : 128;
    p.spill = layout_for(p.rows, D, p.tile_rows, per, 0).bytes > kSmemLimit;
    p.smem = layout_for(p.rows, D, p.tile_rows, per, p.spill).bytes;
    // a chunk whose codes do not fit even with the scores in scratch takes
    // more ranks, then one query row a CTA (always enough for the lengths
    // the wrapper accepts)
    if (p.smem <= kSmemLimit || force > 0) return p;
    if (p.splits < std::min(kMaxSplits, n_rows)) {
      s = 2 * p.splits;
    } else if (p.rows > 1) {
      p.rows = 1;
    } else {
      return p;  // the launch reports that it cannot fit
    }
  }
}

template <int R, int NT>
int launch(const Plan& p, const void* q, const void* kp, const void* vp, const void* scales,
           void* out, void* codes, void* scratch, int BH, int Lh, int D, int groups, int pos,
           int p_levels, cudaStream_t stream) {
  const int words_ok = D % 4 == 0 && reinterpret_cast<uintptr_t>(kp) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(vp) % 4 == 0;
  return launch_kernel(int4kv_decode_kernel<R, NT>, dim3(p.splits * (BH / R)), NT, p.smem,
                       dim3(p.splits, 1, 1), stream, static_cast<const int8_t*>(q),
                       static_cast<const int8_t*>(kp), static_cast<const int8_t*>(vp),
                       static_cast<const float*>(scales), static_cast<float*>(out),
                       static_cast<uint8_t*>(codes), static_cast<float*>(scratch), Lh, D,
                       groups, pos, p_levels, p.splits, p.tile_rows, p.spill, words_ok);
}

bool valid_args(int BH, int Lh, int D, int groups, int pos) {
  return BH > 0 && Lh > 0 && D > 0 && D <= kMaxD && groups > 0 && BH % groups == 0 &&
         pos >= 0 && pos < 2 * Lh && (long long)Lh * D < (1LL << 31);
}

}  // namespace

// The variant the launcher takes for these arguments: query rows a CTA
// (bits 0-7), cluster ranks (bits 8-15), the scores in a scratch buffer of
// BH x 2 Lh floats (bit 16), 256 threads a CTA, not 128 (bit 17), and rows
// a tile (bits 18-30, at most 8191 shown); -1 for invalid arguments.
// `splits` > 0 forces the ranks, as the launch below does.
extern "C" int int4kv_decode_attention_plan(int BH, int Lh, int D, int groups, int pos,
                                            int splits) {
  if (!valid_args(BH, Lh, D, groups, pos) || splits < 0 || splits > kMaxSplits) return -1;
  const Plan p = plan_for(BH, Lh, D, groups, pos, splits);
  return p.rows | (p.splits << 8) | (p.spill << 16) | ((p.threads == 256) << 17) |
         (std::min(p.tile_rows, 8191) << 18);
}

// Launches on `stream` with `splits` cluster ranks (0: the planned variant);
// returns a CUDA error code (0 on success). `scales` points to (qk_scale,
// p_scale, v_scale) on the card; `codes` may be null; `scratch` (BH x 2 Lh
// floats) may be null unless the plan keeps the scores there. pos < 2 Lh.
extern "C" int int4kv_decode_attention_launch_splits(
    const void* q, const void* k_packed, const void* v_packed, const void* scales, void* out,
    void* codes, void* scratch, int BH, int Lh, int D, int groups, int pos, int p_levels,
    int splits, void* stream) {
  if (!valid_args(BH, Lh, D, groups, pos) || p_levels <= 0 || p_levels > 255 || splits < 0 ||
      splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(BH, Lh, D, groups, pos, splits);
  if (p.spill && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.threads == 256) {
    switch (p.rows) {
      case 8: return launch<8, 256>(p, q, k_packed, v_packed, scales, out, codes, scratch, BH, Lh, D, groups, pos, p_levels, s);
      case 4: return launch<4, 256>(p, q, k_packed, v_packed, scales, out, codes, scratch, BH, Lh, D, groups, pos, p_levels, s);
      case 2: return launch<2, 256>(p, q, k_packed, v_packed, scales, out, codes, scratch, BH, Lh, D, groups, pos, p_levels, s);
      default: return launch<1, 256>(p, q, k_packed, v_packed, scales, out, codes, scratch, BH, Lh, D, groups, pos, p_levels, s);
    }
  }
  switch (p.rows) {
    case 8: return launch<8, 128>(p, q, k_packed, v_packed, scales, out, codes, scratch, BH, Lh, D, groups, pos, p_levels, s);
    case 4: return launch<4, 128>(p, q, k_packed, v_packed, scales, out, codes, scratch, BH, Lh, D, groups, pos, p_levels, s);
    case 2: return launch<2, 128>(p, q, k_packed, v_packed, scales, out, codes, scratch, BH, Lh, D, groups, pos, p_levels, s);
    default: return launch<1, 128>(p, q, k_packed, v_packed, scales, out, codes, scratch, BH, Lh, D, groups, pos, p_levels, s);
  }
}

// The planned variant: the launcher the int4kv_decode_attention wrapper binds.
extern "C" int int4kv_decode_attention_launch(const void* q, const void* k_packed,
                                              const void* v_packed, const void* scales,
                                              void* out, void* codes, void* scratch, int BH,
                                              int Lh, int D, int groups, int pos, int p_levels,
                                              void* stream) {
  return int4kv_decode_attention_launch_splits(q, k_packed, v_packed, scales, out, codes,
                                               scratch, BH, Lh, D, groups, pos, p_levels, 0,
                                               stream);
}
