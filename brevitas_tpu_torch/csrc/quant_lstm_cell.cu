// The quantized LSTM cell after its GEMM, forward and backward, written by
// hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel brevitas_tpu/kernels/lstm_cell.py::
// quant_lstm_cell: its forward _cell_fwd_kernel:58 and the backward of its
// custom VJP, _cell_bwd_kernel:82. One step of QuantLSTM's fused path:
//
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
// The backward recomputes the forward from gates and c and applies the
// straight-through estimator of rint with the zeroing clamp, per stage
//     dx = g * in_range,   ds += g * (q - in_range * x / s).
// The scale gradients are sums over the batch (sa, ss: one per column) and
// over the whole (B, H) step (st, sc, sth, sh). They are summed without
// atomics, in a fixed order, in float64: each thread sums its rows, the
// block sums its row lanes and (scalars) its columns into float64 partials,
// one row of partials per block of rows; a second kernel adds the partials
// in block order and rounds once. Two runs give the same bits.
//
// What bounds it on the H100: bytes. The forward reads gates and c and
// writes h and c' (28 bytes a (b, j) element: 0.92 MB at the QuantLSTM QAT
// leg's B 64, H 512, 0.27 us at 3.35 TB/s); the backward reads gates, c, dh
// and dc' and writes dgates and dc (48 bytes an element, 1.6 MB). The
// arithmetic is a few float64 exp and tanh an element. At the leg's size a
// launch costs more than either, and the step is a Python loop of GEMM,
// cell and glue per time step (host-bound). The simple design: one thread
// per (b, j), reading the four gate columns j, H + j, 2H + j, 3H + j, each
// coalesced across a warp's consecutive j. Any B and H (the TPU kernel's
// H % 128, B % 8 gate was a Pallas tiling rule).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // forward: threads per block
constexpr int kCols = 32;         // backward: columns j per block (one warp)
constexpr int kLanes = 8;         // backward: row lanes per block
constexpr int kRowsPerLane = 2;   // backward: rows per thread
constexpr int kRowsPerBlock = kLanes * kRowsPerLane;
constexpr int kSums = 11;         // dsa (4), dss (3), dst, dsc, dsth, dsh

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

__device__ __forceinline__ void load_element(const float* __restrict__ gates,
                                             const float* __restrict__ sa,
                                             const float* __restrict__ ss, int b, int j, int H,
                                             float gate[4], float sa4[4], float ss3[3]) {
  const float* row = gates + static_cast<int64_t>(b) * 4 * H;
  for (int k = 0; k < 4; ++k) {
    gate[k] = row[k * H + j];
    sa4[k] = __ldg(sa + k * H + j);
  }
  for (int k = 0; k < 3; ++k) ss3[k] = __ldg(ss + k * H + j);
}

__global__ void __launch_bounds__(kThreads)
quant_lstm_cell_kernel(const float* __restrict__ gates, const float* __restrict__ c,
                       const float* __restrict__ sa, const float* __restrict__ ss,
                       const float* __restrict__ st, const float* __restrict__ sc,
                       const float* __restrict__ sth, const float* __restrict__ sh,
                       float* __restrict__ h, float* __restrict__ c_new, int B, int H,
                       Bounds bd) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<int64_t>(B) * H) return;
  const int b = static_cast<int>(i / H), j = static_cast<int>(i % H);
  float gate[4], sa4[4], ss3[3];
  load_element(gates, sa, ss, b, j, H, gate, sa4, ss3);
  Cell z;
  cell_forward(gate, c[i], sa4, ss3, __ldg(st), __ldg(sc), __ldg(sth), __ldg(sh), bd, z);
  h[i] = z.h.y;
  c_new[i] = z.cn.y;
}

// Backward, first pass: the per-element gradients, and float64 partial sums
// of the scale gradients for this block's kRowsPerBlock rows: one row of
// col_part (7H columns: dsa then dss) per blockIdx.y, one row of 4 scalar
// partials per block.
__global__ void __launch_bounds__(kCols * kLanes)
quant_lstm_cell_backward_kernel(const float* __restrict__ gates, const float* __restrict__ c,
                                const float* __restrict__ sa, const float* __restrict__ ss,
                                const float* __restrict__ st, const float* __restrict__ sc,
                                const float* __restrict__ sth, const float* __restrict__ sh,
                                const float* __restrict__ dh, const float* __restrict__ dcn,
                                float* __restrict__ dgates, float* __restrict__ dc,
                                double* __restrict__ col_part, double* __restrict__ scalar_part,
                                int B, int H, Bounds bd) {
  __shared__ double red[kSums][kLanes][kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * kCols + tx;
  const float s_t = __ldg(st), s_c = __ldg(sc), s_th = __ldg(sth), s_h = __ldg(sh);
  double acc[kSums];
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;

  if (j < H) {
    for (int r = 0; r < kRowsPerLane; ++r) {
      const int b = blockIdx.y * kRowsPerBlock + r * kLanes + ty;
      if (b >= B) break;
      const int64_t e = static_cast<int64_t>(b) * H + j;
      float gate[4], sa4[4], ss3[3];
      load_element(gates, sa, ss, b, j, H, gate, sa4, ss3);
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

  for (int k = 0; k < kSums; ++k) red[k][ty][tx] = acc[k];
  __syncthreads();
  if (ty != 0) return;
  // warp 0: each lane sums its column over the row lanes, in lane order
  double tot[kSums];
  for (int k = 0; k < kSums; ++k) {
    double t = 0.0;
    for (int l = 0; l < kLanes; ++l) t += red[k][l][tx];
    tot[k] = t;
  }
  if (j < H) {
    double* row = col_part + static_cast<int64_t>(blockIdx.y) * 7 * H;
    for (int k = 0; k < 4; ++k) row[k * H + j] = tot[k];
    for (int k = 0; k < 3; ++k) row[(4 + k) * H + j] = tot[4 + k];
  }
  // the four scalar sums over the block's columns: a fixed shuffle tree
  for (int k = 7; k < kSums; ++k) {
    double t = tot[k];
    for (int off = kCols / 2; off > 0; off /= 2) t += __shfl_down_sync(0xffffffffu, t, off);
    if (tx == 0)
      scalar_part[(static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * 4 + (k - 7)] = t;
  }
}

// Backward, second pass: add the partials in block order, round once.
__global__ void __launch_bounds__(kThreads)
quant_lstm_cell_reduce_kernel(const double* __restrict__ col_part,
                              const double* __restrict__ scalar_part, float* __restrict__ dsa,
                              float* __restrict__ dss, float* __restrict__ dscalars,
                              int H, int row_blocks, int n_blocks) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < 7 * H) {
    double t = 0.0;
    for (int y = 0; y < row_blocks; ++y) t += col_part[static_cast<int64_t>(y) * 7 * H + i];
    if (i < 4 * H) {
      dsa[i] = __double2float_rn(t);
    } else {
      dss[i - 4 * H] = __double2float_rn(t);
    }
  } else if (i < 7 * H + 4) {
    const int k = i - 7 * H;
    double t = 0.0;
    for (int blk = 0; blk < n_blocks; ++blk) t += scalar_part[static_cast<int64_t>(blk) * 4 + k];
    dscalars[k] = __double2float_rn(t);
  }
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

extern "C" int quant_lstm_cell_launch(const float* gates, const float* c, const float* sa,
                                      const float* ss, const float* st, const float* sc,
                                      const float* sth, const float* sh, float* h,
                                      float* c_new, int B, int H, int alo, int ahi, int slo,
                                      int shi, int tlo, int thi, int clo, int chi, int thlo,
                                      int thhi, int hlo, int hhi, cudaStream_t stream) {
  const int lohi[12] = {alo, ahi, slo, shi, tlo, thi, clo, chi, thlo, thhi, hlo, hhi};
  const int64_t n = static_cast<int64_t>(B) * H;
  if (n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  quant_lstm_cell_kernel<<<blocks, kThreads, 0, stream>>>(gates, c, sa, ss, st, sc, sth, sh, h,
                                                          c_new, B, H, make_bounds(lohi));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int quant_lstm_cell_backward_launch(
    const float* gates, const float* c, const float* sa, const float* ss, const float* st,
    const float* sc, const float* sth, const float* sh, const float* dh, const float* dcn,
    float* dgates, float* dc, float* dsa, float* dss, float* dscalars, double* col_part,
    double* scalar_part, int B, int H, int alo, int ahi, int slo, int shi, int tlo, int thi,
    int clo, int chi, int thlo, int thhi, int hlo, int hhi, cudaStream_t stream) {
  const int lohi[12] = {alo, ahi, slo, shi, tlo, thi, clo, chi, thlo, thhi, hlo, hhi};
  if (H == 0) return 0;
  const int col_blocks = (H + kCols - 1) / kCols;
  const int row_blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  if (B > 0) {
    const dim3 grid(col_blocks, row_blocks);
    quant_lstm_cell_backward_kernel<<<grid, dim3(kCols, kLanes), 0, stream>>>(
        gates, c, sa, ss, st, sc, sth, sh, dh, dcn, dgates, dc, col_part, scalar_part, B, H,
        make_bounds(lohi));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_out = 7 * H + 4;
  quant_lstm_cell_reduce_kernel<<<(n_out + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      col_part, scalar_part, dsa, dss, dscalars, H, row_blocks, row_blocks * col_blocks);
  return static_cast<int>(cudaGetLastError());
}
