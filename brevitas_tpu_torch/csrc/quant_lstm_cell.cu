// The quantized LSTM cell after its GEMM, forward and backward, written by
// hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel brevitas_tpu/kernels/lstm_cell.py::
// quant_lstm_cell: its forward _cell_fwd_kernel:58 and the backward of its
// custom VJP, _cell_bwd_kernel:82. One step of QuantLSTM's fused path:
//
//     gates   = xp + p                           the step's input projection
//                                                and the recurrent product
//     ga      = Q(gates, sa)                     gates (B, 4H) packed (i, f, g, o)
//     i, f, o = Q(sigmoid(ga_i, ga_f, ga_o), ss) ss (3H,) packed (i, f, o)
//     g       = Q(tanh(ga_g), st)
//     c'      = Q(f * c + i * g, sc)             c (B, H)
//     h       = Q(o * Q(tanh(c'), sth), sh)
//
// with Q(x, s) = clamp(rint(x / s), lo, hi) * s per stage: an IEEE division
// (the model path's core/quant.py; the Pallas kernel multiplies by the
// reciprocal, which moves values across rounding ties), round half to even,
// the clamp where-based (the bound wins ties, the gradient passes at
// equality). Every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn: no FMA contraction), and sigmoid and tanh are formed in float64
// and rounded once, as the plain PyTorch version
// (brevitas_tpu_torch/kernels/lstm_cell.py) forms them, so the forward agrees
// with it bit for bit on the card. The library is built without
// --use_fast_math.
//
// The scales sa and ss come with strides (gate, column): (H, 1) one per
// column, (1, 0) one per gate block, (0, 0) one broadcast value. QuantLSTM
// passes its per-tensor gate quantizers' scales as they are, so no call
// copies an expanded scale and no autograd sum folds a (4H,) gradient back.
//
// The forward's stage tables. Every float64 function of the cell takes a
// quantized value: sigmoid and tanh of a gate take fl(q_a * sa_k) for an
// integer acc code q_a in [lo, hi], tanh(c') takes fl(q_c * sc) for a cell
// code q_c. Where sa and ss are one value per gate block or one value, and
// each code range holds at most kMaxCodes values, the stage that follows
// each function is a function of the code alone: table k (i, f, g, o) holds
// Q(float(sigmoid(fl(q_a sa_k))), ss_k) (Q(float(tanh(.)), st) for g) at
// slot q_a - lo_acc, the cell table Q(float(tanh(fl(q_c sc))), sth) at slot
// q_c - lo_cell; each table ends with the slots of the codes -0 and NaN (a
// code keeps the sign of a negative value that rounds to 0, and tanh keeps
// it). quant_lstm_cell_tables_kernel builds them from the same device
// helpers as the direct chain (cell_forward), so a table holds the bits the
// chain would give; QuantLSTM builds them once per layer forward, since its
// scales change only between optimizer steps. The forward then loads the
// tables (5,168 bytes at 8-bit codes) into shared memory with one bulk copy
// that runs while its threads load the gates, and per element forms the code
// of each of its 6 quantized stages by the same division, round and clamp
// as the chain (fake_quant) and reads the next stage's value from the
// table: 6 divisions and 5 shared-memory loads in place of 11 divisions, 3
// float64 exp and 2 float64 tanh. Scales per column, and wider codes, take
// the direct chain in the same kernel.
// quant_lstm_cell_table_plan is the rule (the Python wrapper mirrors it).
//
// The gate add. The forward takes the gates as two addends, the input
// projection's step xp (float32 or bf16, read through its row stride: a
// step of the (B, T, 4H) projection is read where it lies) and the
// recurrent product p (float32), forms gates = __fadd_rn(float(xp), p)
// (torch's add, bit for bit) and writes gates once: the backward's saved
// residual. The one-tensor form reads gates and writes nothing else.
//
// The backward recomputes the forward from gates and c and applies the
// straight-through estimator of rint with the zeroing clamp, per stage
//     dx = g * in_range,   ds += g * (q - in_range * x / s).
// It is one launch. The eleven scale-gradient terms (dsa's four gates,
// dss's three, dst, dsc, dsth, dsh) are summed without atomics on values,
// in float64, in a fixed order, and each rounded once to float32; two runs
// give the same bits. The order:
//   1. a thread sums its rows in order (rows r 64 + lane of its column);
//   2. the block sums its 64 row lanes per column: each run of 8 lanes in
//      order, then the 8 runs in order. A per-column scale's gradient is
//      written here;
//   3. every other term (the four scalars, and sa or ss where their column
//      stride is 0) is summed over the block's 4 columns by a fixed shuffle
//      tree into a float64 partial per column block; a __threadfence() and
//      an atomic ticket (taken as a grid barrier takes it: one thread after
//      the block's barrier) pick the last column block, which adds each
//      term's partials (lane l of a warp those of blocks l, l + 32, .. in
//      order, then a shuffle tree over the lanes), writes the sums (a
//      broadcast sa or ss adds its gate sums in gate order) and resets the
//      ticket. The
//      order does not depend on which block arrives last. The ticket and the
//      partials live in a scratch buffer that the wrapper makes once per
//      device, so no call launches a memset; calls on one device are ordered
//      by their stream.
//
// What bounds it on the H100: bytes. The two-addend forward reads xp, p and
// c and writes gates, h and c' (60 bytes a (b, j) element in float32, 52
// with bf16 xp: 1.97 MB at the QuantLSTM QAT leg's B 64, H 512, 0.59 us at
// 3.35 TB/s; the one-tensor form 28 bytes, 0.27 us); the backward reads
// gates, c, dh and dc' and writes dgates and dc (48 bytes an element, 1.6
// MB, 0.48 us). At the leg's size a launch costs more than either; the
// direct chain's float64 exp and tanh cost about as much again, which the
// tables remove. The forward: one thread per (b, j), reading the four gate
// columns j, H + j, 2H + j, 3H + j, each coalesced across a warp's
// consecutive j. The backward: a CTA of 4
// columns x 64 row lanes (256 threads), one row a thread up to B 64 (the
// leg's (64, 512) runs 128 CTAs on 132 SMs), ceil(B / 64) rows a thread
// past it. The column sums stay inside the CTA: with a cluster of CTAs
// along the rows, its two barriers and rank-order sum in distributed shared
// memory took 2.2 of 8.5 us on an H100 (PERF.md). Any B and H (the TPU
// kernel's H % 128, B % 8 gate was a Pallas tiling rule).

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;     // forward: threads per block
constexpr int kCols = 4;          // backward: columns j per block
constexpr int kLanes = 64;        // backward: row lanes per block
constexpr int kSegs = 8;          // backward: segments of 8 row lanes
constexpr int kBwdThreads = kCols * kLanes;
constexpr int kSums = 11;         // dsa (4), dss (3), dst, dsc, dsth, dsh

// strides of sa and ss: element (gate k, column j) at k * gate + j * col
struct Strides {
  int sa_gate, sa_col, ss_gate, ss_col;
};

struct Bounds {
  float lo[6], hi[6];  // acc, sigmoid, tanh_g, cell, tanh_h, hidden
};
enum { kAcc, kSig, kTanhG, kCell, kTanhH, kHidden };

// One fake-quant stage: x / s, its code q (rounded, clamped), the output
// q * s, and whether the clamp let the gradient through.
struct Stage {
  float xs, q, y;
  bool in;
};

__device__ __forceinline__ Stage fake_quant(float x, float s, float lo, float hi) {
  Stage r;
  r.xs = __fdiv_rn(x, s);
  float q = rintf(r.xs);
  r.in = !(q > hi) && !(q < lo);
  q = q > hi ? hi : q;
  q = q < lo ? lo : q;
  r.q = q;
  r.y = __fmul_rn(q, s);
  return r;
}

// d/dx (dx) and this element's term of d/ds for upstream gradient g.
__device__ __forceinline__ float stage_dx(const Stage& st, float g) { return st.in ? g : 0.0f; }
__device__ __forceinline__ float stage_ds(const Stage& st, float g) {
  return __fmul_rn(g, __fsub_rn(st.q, st.in ? st.xs : 0.0f));
}

__device__ __forceinline__ double sigmoid64(float x) {
  return 1.0 / (1.0 + exp(-static_cast<double>(x)));
}

// The forward of one (b, j) element, every intermediate kept for the
// backward. gate[k] is the accumulator of gate k (i, f, g, o) at column j.
struct Cell {
  Stage a[4];      // gate accumulators
  double s64[3];   // sigmoid of i, f, o in float64
  Stage s[3];      // their fake-quant
  double g64;      // tanh of the g gate in float64
  Stage g;
  float cpre;      // f * c + i * g
  Stage cn;        // the new cell state
  double tc64;     // tanh(c') in float64
  Stage th;
  float hp;        // o * th
  Stage h;
};

__device__ __forceinline__ void cell_forward(const float gate[4], float c, const float sa[4],
                                             const float ss[3], float st, float sc, float sth,
                                             float sh, const Bounds& bd, Cell& z) {
  for (int k = 0; k < 4; ++k) z.a[k] = fake_quant(gate[k], sa[k], bd.lo[kAcc], bd.hi[kAcc]);
  const int sig_gate[3] = {0, 1, 3};  // i, f, o
  for (int k = 0; k < 3; ++k) {
    z.s64[k] = sigmoid64(z.a[sig_gate[k]].y);
    z.s[k] = fake_quant(__double2float_rn(z.s64[k]), ss[k], bd.lo[kSig], bd.hi[kSig]);
  }
  z.g64 = tanh(static_cast<double>(z.a[2].y));
  z.g = fake_quant(__double2float_rn(z.g64), st, bd.lo[kTanhG], bd.hi[kTanhG]);
  z.cpre = __fadd_rn(__fmul_rn(z.s[1].y, c), __fmul_rn(z.s[0].y, z.g.y));
  z.cn = fake_quant(z.cpre, sc, bd.lo[kCell], bd.hi[kCell]);
  z.tc64 = tanh(static_cast<double>(z.cn.y));
  z.th = fake_quant(__double2float_rn(z.tc64), sth, bd.lo[kTanhH], bd.hi[kTanhH]);
  z.hp = __fmul_rn(z.s[2].y, z.th.y);
  z.h = fake_quant(z.hp, sh, bd.lo[kHidden], bd.hi[kHidden]);
}

__device__ __forceinline__ void load_scales(const float* __restrict__ sa,
                                            const float* __restrict__ ss, int j,
                                            const Strides& str, float sa4[4], float ss3[3]) {
  for (int k = 0; k < 4; ++k) sa4[k] = __ldg(sa + k * str.sa_gate + j * str.sa_col);
  for (int k = 0; k < 3; ++k) ss3[k] = __ldg(ss + k * str.ss_gate + j * str.ss_col);
}

__device__ __forceinline__ void load_gates(const float* __restrict__ gates, int b, int j, int H,
                                           float gate[4]) {
  const float* row = gates + static_cast<int64_t>(b) * 4 * H;
  for (int k = 0; k < 4; ++k) gate[k] = row[k * H + j];
}

// The stage tables' layout: four gate tables (i, f, g, o) of n_acc + 2
// slots, then the cell table of n_cell + 2, padded to whole 16-byte chunks
// (the bulk copy's unit).
struct TableLayout {
  int n_acc, n_cell, gate_stride, cell_off, total;
};

__host__ __device__ inline TableLayout table_layout(int alo, int ahi, int clo, int chi) {
  TableLayout t;
  t.n_acc = ahi - alo + 1;
  t.n_cell = chi - clo + 1;
  t.gate_stride = t.n_acc + 2;
  t.cell_off = 4 * t.gate_stride;
  t.total = (t.cell_off + t.n_cell + 2 + 3) / 4 * 4;
  return t;
}

// A code range's slot of code q: q - lo, then -0 at n and NaN at n + 1.
__device__ __forceinline__ int code_slot(float q, int lo, int n) {
  const int i = static_cast<int>(q) - lo;
  return q != q ? n + 1 : (__float_as_uint(q) == 0x80000000u ? n : i);
}

// The code at slot i of a range of n codes from lo.
__device__ __forceinline__ float slot_code(int i, int lo, int n) {
  return i < n ? static_cast<float>(lo + i) : (i == n ? -0.0f : __int_as_float(0x7fffffff));
}

// One slot of the tables: the stage after a gate's sigmoid or tanh, or after
// tanh(c'), of the code at that slot, formed as cell_forward forms it.
__global__ void quant_lstm_cell_tables_kernel(const float* __restrict__ sa,
                                              const float* __restrict__ ss,
                                              const float* __restrict__ st,
                                              const float* __restrict__ sc,
                                              const float* __restrict__ sth,
                                              float* __restrict__ tables, Strides str, Bounds bd,
                                              int alo, int clo, TableLayout tl) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= tl.total) return;
  float v = 0.0f;  // the padding
  if (t < tl.cell_off) {
    const int k = t / tl.gate_stride;
    const float a = __fmul_rn(slot_code(t % tl.gate_stride, alo, tl.n_acc),
                              __ldg(sa + k * str.sa_gate));
    if (k == 2) {
      v = fake_quant(__double2float_rn(tanh(static_cast<double>(a))), __ldg(st), bd.lo[kTanhG],
                     bd.hi[kTanhG]).y;
    } else {
      const float s = __ldg(ss + (k == 3 ? 2 : k) * str.ss_gate);
      v = fake_quant(__double2float_rn(sigmoid64(a)), s, bd.lo[kSig], bd.hi[kSig]).y;
    }
  } else if (t < tl.cell_off + tl.n_cell + 2) {
    const float cn = __fmul_rn(slot_code(t - tl.cell_off, clo, tl.n_cell), __ldg(sc));
    v = fake_quant(__double2float_rn(tanh(static_cast<double>(cn))), __ldg(sth), bd.lo[kTanhH],
                   bd.hi[kTanhH]).y;
  }
  tables[t] = v;
}

// How the forward gets its gates: read as one float32 tensor, or formed as
// xp + p from a float32 or bf16 xp read at row stride xp_ld (then written).
enum { kGates = 0, kAddF32 = 1, kAddBF16 = 2 };

template <int kMode>
__device__ __forceinline__ void gate_sums(const void* __restrict__ xp, int64_t xp_ld,
                                          const float* __restrict__ p, float* __restrict__ gates,
                                          int b, int j, int H, float gate[4]) {
  const int64_t row = static_cast<int64_t>(b) * 4 * H;
  for (int k = 0; k < 4; ++k) {
    const int64_t col = static_cast<int64_t>(k) * H + j;
    if constexpr (kMode == kGates) {
      gate[k] = static_cast<const float*>(xp)[row + col];
    } else {
      const int64_t e = static_cast<int64_t>(b) * xp_ld + col;
      const float x = kMode == kAddF32
                          ? static_cast<const float*>(xp)[e]
                          : __uint_as_float(static_cast<uint32_t>(
                                static_cast<const uint16_t*>(xp)[e]) << 16);  // bf16 -> float: exact
      gate[k] = __fadd_rn(x, p[row + col]);
    }
  }
  if constexpr (kMode != kGates)
    for (int k = 0; k < 4; ++k) gates[row + static_cast<int64_t>(k) * H + j] = gate[k];
}

// The forward: one thread per (b, j). With kTables, thread 0 starts one bulk
// copy of the tables into shared memory, every thread forms its gates and
// their acc codes meanwhile, and the rest reads the tables; without, the
// direct chain (cell_forward).
template <bool kTables, int kMode>
__global__ void __launch_bounds__(kThreads)
quant_lstm_cell_kernel(const void* __restrict__ xp, const float* __restrict__ p,
                       const float* __restrict__ c, const float* __restrict__ sa,
                       const float* __restrict__ ss, const float* __restrict__ st,
                       const float* __restrict__ sc, const float* __restrict__ sth,
                       const float* __restrict__ sh, const float* __restrict__ tables,
                       float* __restrict__ gates, float* __restrict__ h,
                       float* __restrict__ c_new, int B, int H, int64_t xp_ld, Strides str,
                       Bounds bd, int alo, int clo, TableLayout tl) {
  extern __shared__ __align__(128) float tab[];
  __shared__ uint64_t bar;
  if constexpr (kTables) {
    if (threadIdx.x == 0) {
      mbar_init(&bar, 1);
      fence_mbar_init();
      mbar_arrive_expect_tx(&bar, tl.total * 4);
      bulk_load(tab, tables, tl.total * 4, &bar);
    }
  }
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = i < static_cast<int64_t>(B) * H;
  const int b = live ? static_cast<int>(i / H) : 0, j = live ? static_cast<int>(i % H) : 0;
  float gate[4], sa4[4], ss3[3];
  if (live) {
    gate_sums<kMode>(xp, xp_ld, p, gates, b, j, H, gate);
    load_scales(sa, ss, j, str, sa4, ss3);
  }
  if constexpr (kTables) {
    int slot[4];
    for (int k = 0; k < 4; ++k)
      slot[k] = live ? k * tl.gate_stride +
                           code_slot(fake_quant(gate[k], sa4[k], bd.lo[kAcc], bd.hi[kAcc]).q,
                                     alo, tl.n_acc)
                     : 0;
    const float c_old = live ? c[i] : 0.0f, s_c = __ldg(sc), s_h = __ldg(sh);
    __syncthreads();  // the barrier's initialisation, seen by every thread
    mbar_wait(&bar, 0);
    if (!live) return;
    // i, f, g, o from their tables; then as cell_forward
    const float cpre =
        __fadd_rn(__fmul_rn(tab[slot[1]], c_old), __fmul_rn(tab[slot[0]], tab[slot[2]]));
    const float q_c = fake_quant(cpre, s_c, bd.lo[kCell], bd.hi[kCell]).q;
    const float th = tab[tl.cell_off + code_slot(q_c, clo, tl.n_cell)];
    const float hp = __fmul_rn(tab[slot[3]], th);
    h[i] = fake_quant(hp, s_h, bd.lo[kHidden], bd.hi[kHidden]).y;
    c_new[i] = __fmul_rn(q_c, s_c);
  } else {
    if (!live) return;
    Cell z;
    cell_forward(gate, c[i], sa4, ss3, __ldg(st), __ldg(sc), __ldg(sth), __ldg(sh), bd, z);
    h[i] = z.h.y;
    c_new[i] = z.cn.y;
  }
}

// Backward, in one launch (the order of the sums is the note's): one CTA
// of 4 columns x 64 row lanes per column block; thread (tx, ty) takes
// column j = 4 blockIdx.x + tx and rows r 64 + ty, r < rows. `part` holds
// kSums float64 partials per column block; `ticket` counts the column
// blocks that have written theirs (0 between launches).
__global__ void __launch_bounds__(kBwdThreads)
quant_lstm_cell_backward_kernel(const float* __restrict__ gates, const float* __restrict__ c,
                                const float* __restrict__ sa, const float* __restrict__ ss,
                                const float* __restrict__ st, const float* __restrict__ sc,
                                const float* __restrict__ sth, const float* __restrict__ sh,
                                const float* __restrict__ dh, const float* __restrict__ dcn,
                                float* __restrict__ dgates, float* __restrict__ dc,
                                float* __restrict__ dsa, float* __restrict__ dss,
                                float* __restrict__ dscalars, double* __restrict__ part,
                                unsigned* __restrict__ ticket, int B, int H, int rows,
                                Strides str, Bounds bd) {
  __shared__ double red[kSums][kLanes][kCols];  // 22 KB
  __shared__ double total[kSums];
  __shared__ bool last;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kCols + tx;
  const int j = blockIdx.x * kCols + tx;
  const float s_t = __ldg(st), s_c = __ldg(sc), s_th = __ldg(sth), s_h = __ldg(sh);
  double acc[kSums];
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;

  if (j < H) {
    float sa4[4], ss3[3];
    load_scales(sa, ss, j, str, sa4, ss3);
    for (int r = 0; r < rows; ++r) {
      const int b = r * kLanes + ty;
      if (b >= B) break;
      const int64_t e = static_cast<int64_t>(b) * H + j;
      float gate[4];
      load_gates(gates, b, j, H, gate);
      const float c_old = c[e];
      Cell z;
      cell_forward(gate, c_old, sa4, ss3, s_t, s_c, s_th, s_h, bd, z);

      // h = Q(o * th, sh)
      const float g_h = dh[e];
      const float dhp = stage_dx(z.h, g_h);
      acc[10] += stage_ds(z.h, g_h);
      const float d_o = __fmul_rn(dhp, z.th.y);
      const float d_th = __fmul_rn(dhp, z.s[2].y);
      // th = Q(tanh(c'), sth)
      const float d_tc = stage_dx(z.th, d_th);
      acc[9] += stage_ds(z.th, d_th);
      const float d_cn = __fadd_rn(
          dcn[e], __double2float_rn(static_cast<double>(d_tc) * (1.0 - z.tc64 * z.tc64)));
      // c' = Q(f * c + i * g, sc)
      const float d_cpre = stage_dx(z.cn, d_cn);
      acc[8] += stage_ds(z.cn, d_cn);
      dc[e] = __fmul_rn(d_cpre, z.s[1].y);
      const float d_sig[3] = {__fmul_rn(d_cpre, z.g.y), __fmul_rn(d_cpre, c_old), d_o};
      const float d_g = __fmul_rn(d_cpre, z.s[0].y);
      // i, f, o = Q(sigmoid(.), ss); g = Q(tanh(.), st)
      float d_acc[4];
      const int sig_gate[3] = {0, 1, 3};
      for (int k = 0; k < 3; ++k) {
        const float d_s = stage_dx(z.s[k], d_sig[k]);
        acc[4 + k] += stage_ds(z.s[k], d_sig[k]);
        d_acc[sig_gate[k]] =
            __double2float_rn(static_cast<double>(d_s) * z.s64[k] * (1.0 - z.s64[k]));
      }
      const float d_gs = stage_dx(z.g, d_g);
      acc[7] += stage_ds(z.g, d_g);
      d_acc[2] = __double2float_rn(static_cast<double>(d_gs) * (1.0 - z.g64 * z.g64));
      // ga = Q(gates, sa)
      float* drow = dgates + static_cast<int64_t>(b) * 4 * H;
      for (int k = 0; k < 4; ++k) {
        drow[k * H + j] = stage_dx(z.a[k], d_acc[k]);
        acc[k] += stage_ds(z.a[k], d_acc[k]);
      }
    }
  }

  // 2. the row lanes: each segment of 8 lanes in order, then the segments
  // in order (segment sums kept in red[k][seg])
  for (int k = 0; k < kSums; ++k) red[k][ty][tx] = acc[k];
  __syncthreads();
  constexpr int kItems = kSums * kSegs * kCols;  // (term, segment, column)
  double seg_sum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = tid + kBwdThreads * i;
    seg_sum[i] = 0.0;
    if (p < kItems) {
      const int k = p / (kSegs * kCols), seg = (p / kCols) % kSegs, col = p % kCols;
#pragma unroll
      for (int l = 0; l < 8; ++l) seg_sum[i] += red[k][8 * seg + l][col];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = tid + kBwdThreads * i;
    if (p < kItems) red[p / (kSegs * kCols)][(p / kCols) % kSegs][p % kCols] = seg_sum[i];
  }
  __syncthreads();
  // 3. thread (term k, column) = tid (kCols k + column): the column's
  // total; a per-column scale's gradient is written here, every other term
  // is summed over the block's columns by a shuffle tree into its partial
  if (tid < 32 * ((kSums * kCols + 31) / 32)) {  // whole warps; lanes past the terms carry zeros
    const int k = tid / kCols, col = tid % kCols, jj = blockIdx.x * kCols + col;
    double t = 0.0;
    if (k < kSums)
      for (int seg = 0; seg < kSegs; ++seg) t += red[k][seg][col];
    const bool per_col = k < 4 ? str.sa_col != 0 : k < 7 ? str.ss_col != 0 : false;
    if (k < kSums && per_col && jj < H) {
      if (k < 4) dsa[k * H + jj] = __double2float_rn(t);
      else dss[(k - 4) * H + jj] = __double2float_rn(t);
    }
    for (int off = kCols / 2; off > 0; off /= 2) t += __shfl_down_sync(0xffffffffu, t, off);
    if (col == 0 && k < kSums && !per_col) part[static_cast<int64_t>(blockIdx.x) * kSums + k] = t;
  }
  // the ticket, as a grid barrier takes it: after the block's barrier one
  // thread fences (the partials are visible before the ticket counts them)
  // and, in the last block, fences again before the block reads the others'
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // 4. the last block: warp w adds the partials of terms w, w + 8, .., lane
  // l those of blocks l, l + 32, .. in order (every load of a round in
  // flight at once), then a shuffle tree over the lanes
  constexpr int kWarps = kBwdThreads / 32, kTermsPerWarp = (kSums + kWarps - 1) / kWarps;
  const int lane = tid % 32, warp = tid / 32;
  double t[kTermsPerWarp];
#pragma unroll
  for (int i = 0; i < kTermsPerWarp; ++i) t[i] = 0.0;
  for (unsigned x0 = lane; x0 < gridDim.x; x0 += 32 * 4) {
    double v[kTermsPerWarp][4];
#pragma unroll
    for (int i = 0; i < kTermsPerWarp; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = warp + kWarps * i;
        const unsigned x = x0 + 32 * u;
        v[i][u] = k < kSums && x < gridDim.x
                      ? __ldcg(part + static_cast<int64_t>(x) * kSums + k) : 0.0;
      }
#pragma unroll
    for (int i = 0; i < kTermsPerWarp; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) t[i] += v[i][u];
  }
#pragma unroll
  for (int i = 0; i < kTermsPerWarp; ++i) {
    for (int off = 16; off > 0; off /= 2) t[i] += __shfl_down_sync(0xffffffffu, t[i], off);
    if (lane == 0 && warp + kWarps * i < kSums) total[warp + kWarps * i] = t[i];
  }
  __syncthreads();
  if (tid == 0) {
    if (str.sa_col == 0) {
      if (str.sa_gate == 0) {
        dsa[0] = __double2float_rn(((total[0] + total[1]) + total[2]) + total[3]);
      } else {
        for (int k = 0; k < 4; ++k) dsa[k] = __double2float_rn(total[k]);
      }
    }
    if (str.ss_col == 0) {
      if (str.ss_gate == 0) {
        dss[0] = __double2float_rn((total[4] + total[5]) + total[6]);
      } else {
        for (int k = 0; k < 3; ++k) dss[k] = __double2float_rn(total[4 + k]);
      }
    }
    for (int k = 0; k < 4; ++k) dscalars[k] = __double2float_rn(total[7 + k]);
    *ticket = 0u;  // for the next launch, ordered after this one by the stream
  }
}

constexpr int kMaxCodes = 1024;         // codes a range may hold for the tables
constexpr int kMaxCodeMagnitude = 1 << 24;  // every code exact in float32

// The forward's rule: the floats of the stage tables where the tables serve
// (sa and ss one per gate block or one value; each of the acc and cell code
// ranges ordered, within +-2^24 and at most kMaxCodes long), else 0: the
// direct chain (quant_lstm_cell_table_plan; the wrapper's twin mirrors it).
int table_plan(int sa_col, int ss_col, int alo, int ahi, int clo, int chi) {
  if (sa_col != 0 || ss_col != 0) return 0;
  const int ranges[2][2] = {{alo, ahi}, {clo, chi}};
  for (const auto& r : ranges) {
    if (r[0] < -kMaxCodeMagnitude || r[1] > kMaxCodeMagnitude || r[0] > r[1]) return 0;
    if (r[1] - r[0] + 1 > kMaxCodes) return 0;
  }
  return table_layout(alo, ahi, clo, chi).total;
}

Bounds make_bounds(const int lohi[12]) {
  Bounds bd;
  for (int s = 0; s < 6; ++s) {
    bd.lo[s] = static_cast<float>(lohi[2 * s]);
    bd.hi[s] = static_cast<float>(lohi[2 * s + 1]);
  }
  return bd;
}

}  // namespace

extern "C" int quant_lstm_cell_table_plan(int sa_gate, int sa_col, int ss_gate, int ss_col,
                                          int alo, int ahi, int clo, int chi) {
  (void)sa_gate;
  (void)ss_gate;
  return table_plan(sa_col, ss_col, alo, ahi, clo, chi);
}

extern "C" int quant_lstm_cell_tables_launch(const float* sa, const float* ss, const float* st,
                                             const float* sc, const float* sth, float* tables,
                                             int sa_gate, int sa_col, int ss_gate, int ss_col,
                                             int alo, int ahi, int slo, int shi, int tlo,
                                             int thi, int clo, int chi, int thlo, int thhi,
                                             int hlo, int hhi, cudaStream_t stream) {
  const int lohi[12] = {alo, ahi, slo, shi, tlo, thi, clo, chi, thlo, thhi, hlo, hhi};
  if (quant_lstm_cell_table_plan(sa_gate, sa_col, ss_gate, ss_col, alo, ahi, clo, chi) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const TableLayout tl = table_layout(alo, ahi, clo, chi);
  const Strides str = {sa_gate, sa_col, ss_gate, ss_col};
  quant_lstm_cell_tables_kernel<<<cdiv(tl.total, kThreads), kThreads, 0, stream>>>(
      sa, ss, st, sc, sth, tables, str, make_bounds(lohi), alo, clo, tl);
  return static_cast<int>(cudaGetLastError());
}

// The forward. xp: the gates (float32, B x 4H contiguous) where p is null;
// else the first addend (float32, or bf16 where xp_bf16, rows xp_ld
// elements apart) of gates = xp + p, which are written to `gates`. tables:
// null for the direct chain, else the stage tables (16-byte aligned), which
// the rule must allow.
extern "C" int quant_lstm_cell_launch(const void* xp, const float* p, const float* c,
                                      const float* sa, const float* ss, const float* st,
                                      const float* sc, const float* sth, const float* sh,
                                      const float* tables, float* gates, float* h,
                                      float* c_new, int B, int H, int xp_ld, int xp_bf16,
                                      int sa_gate, int sa_col, int ss_gate, int ss_col, int alo,
                                      int ahi, int slo, int shi, int tlo, int thi, int clo,
                                      int chi, int thlo, int thhi, int hlo, int hhi,
                                      cudaStream_t stream) {
  const int lohi[12] = {alo, ahi, slo, shi, tlo, thi, clo, chi, thlo, thhi, hlo, hhi};
  const int mode = p == nullptr ? kGates : xp_bf16 ? kAddBF16 : kAddF32;
  if ((p == nullptr && (xp_bf16 || gates != nullptr)) || (p != nullptr && gates == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool use_tables = tables != nullptr;
  if (use_tables &&
      (quant_lstm_cell_table_plan(sa_gate, sa_col, ss_gate, ss_col, alo, ahi, clo, chi) == 0 ||
       reinterpret_cast<uintptr_t>(tables) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(B) * H;
  if (n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const Strides str = {sa_gate, sa_col, ss_gate, ss_col};
  const TableLayout tl = use_tables ? table_layout(alo, ahi, clo, chi) : TableLayout{};
  const int smem = tl.total * 4;
  auto run = [&](auto kernel) {
    kernel<<<blocks, kThreads, smem, stream>>>(xp, p, c, sa, ss, st, sc, sth, sh, tables, gates,
                                               h, c_new, B, H, static_cast<int64_t>(xp_ld), str,
                                               make_bounds(lohi), alo, clo, tl);
  };
  if (use_tables) {
    if (mode == kGates) run(quant_lstm_cell_kernel<true, kGates>);
    else if (mode == kAddF32) run(quant_lstm_cell_kernel<true, kAddF32>);
    else run(quant_lstm_cell_kernel<true, kAddBF16>);
  } else {
    if (mode == kGates) run(quant_lstm_cell_kernel<false, kGates>);
    else if (mode == kAddF32) run(quant_lstm_cell_kernel<false, kAddF32>);
    else run(quant_lstm_cell_kernel<false, kAddBF16>);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward's tiling: rows a thread (64 row lanes a block). The wrapper
// sizes `part` from the column blocks, ceil(H / 4).
extern "C" int quant_lstm_cell_backward_plan(int B) { return std::max(1, cdiv(B, kLanes)); }

extern "C" int quant_lstm_cell_backward_launch(
    const float* gates, const float* c, const float* sa, const float* ss, const float* st,
    const float* sc, const float* sth, const float* sh, const float* dh, const float* dcn,
    float* dgates, float* dc, float* dsa, float* dss, float* dscalars, double* part,
    unsigned* ticket, int B, int H, int sa_gate, int sa_col, int ss_gate, int ss_col, int alo,
    int ahi, int slo, int shi, int tlo, int thi, int clo, int chi, int thlo, int thhi, int hlo,
    int hhi, cudaStream_t stream) {
  const int lohi[12] = {alo, ahi, slo, shi, tlo, thi, clo, chi, thlo, thhi, hlo, hhi};
  if (B <= 0 || H <= 0 || (long long)B * H >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const Strides str = {sa_gate, sa_col, ss_gate, ss_col};
  quant_lstm_cell_backward_kernel<<<cdiv(H, kCols), dim3(kCols, kLanes), 0, stream>>>(
      gates, c, sa, ss, st, sc, sth, sh, dh, dcn, dgates, dc, dsa, dss, dscalars, part, ticket,
      B, H, quant_lstm_cell_backward_plan(B), str, make_bounds(lohi));
  return static_cast<int>(cudaGetLastError());
}
