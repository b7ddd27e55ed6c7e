// Per-tensor fake-quant, forward and backward, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel brevitas_tpu/kernels/fake_quant.py::
// fake_quant: its forward _fwd_kernel:55 and the backward of its custom VJP,
// _bwd_kernel:64. With a scalar scale s and zero point zp and integer bounds
// lo, hi, for every element of x (any shape, flattened):
//
//     q  = rint(x / s + zp)            round half to even
//     qc = clamp(q, lo, hi)            where-based: the bound wins, NaN passes
//     y  = (qc - zp) * s
//
// as the model path's chain computes it (core/quant.py int_quant; the
// port's brevitas_tpu_torch/core/quant.py): an IEEE division, then a rounded
// add, rint, the clamp, a rounded subtract and a rounded multiply
// (__fdiv_rn, __fadd_rn, __fsub_rn, __fmul_rn: nvcc would contract the add
// into an FMA), so the forward equals the plain PyTorch chain bit for bit on
// the card. The Pallas kernel multiplies by 1/s, which moves values across
// rounding ties; this kernel divides. The library is built without
// --use_fast_math.
//
// The backward is the chain's autograd with the straight-through round:
//
//     dx     = (in_range ? g * s : 0) / s     (g * s) / s everywhere with ste_clamp
//     dscale = sum g * ((qc - zp) - in_range * x / s)
//     dzp    = sum -g * s over clamped elements     0 with ste_clamp
//
// dx repeats the chain's two roundings, (g * s) then / s, which differ from
// g in the last bit for about 9 % of elements (the Pallas backward returns g).
// The two sums are formed per element in float64 and summed without atomics,
// in a fixed order: each thread its kPerThread elements, the block a tree in
// shared memory into one float64 partial per block; a second kernel adds the
// partials in block order and rounds once. Two runs give the same bits. A
// caller that needs no scale or zero-point gradient passes no partials and
// the sums are skipped.
//
// What bounds it on the H100: bytes. The forward reads x and writes y (8
// bytes an element), the backward reads x and g and writes dx (12 bytes an
// element): at LFC's largest step shape, (1024, 1024), 8.4 and 12.6 MB, 2.5
// and 3.8 us at 3.35 TB/s; at CNV's largest, (256, 64, 30, 30), 118 MB
// forward, 35 us. The arithmetic is a division, a rounding and a few adds
// and products an element, far below the float32 rate.
//
// The forward streams 16-byte vectors: a thread loads one float4 of x, a
// block of 256 threads a tile of 1,024 elements, as many blocks as tiles,
// and each thread reads s and zp itself (a cached load issued beside x's).
// Its first design, 4 scalars a thread quantized and stored one after the
// other in the source, ran 1.4 % behind torch's fake-quant op over a CNV
// step on the H100; the same layout with its 4 loads issued first was 12 %
// faster, float4 a further 2-5 %, within 6 % of a copy of x to y over the
// CNV and MobileNet steps (kernel_probes.py fake_quant). 2 or 4 vectors a
// thread, a grid of one wave with a grid-stride loop, s and zp read once a
// block through shared memory, 128 or 512 threads, cache hints, and x * (1/s)
// in place of the division (another function) each gained under 1 % at
// some step and lost at others, so the division stays __fdiv_rn.
// The float4 body needs x and y on 16-byte boundaries: y is fresh, and
// where x is a view that starts off one the wrapper (kernels/fake_quant.py,
// fake_quant_plan) gives the body no vectors and the whole tensor takes the
// scalar loop of the same launch, 4 elements a thread, as do the last n % 4
// elements otherwise.
//
// The backward keeps its first design: kPerThread elements a thread at a
// stride of a block's width, so a warp's loads are coalesced; any n. Its
// block count fixes the order of the float64 sums.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kPerBlock = kThreads * kPerThread;

struct Quant {
  float s, zp, lo, hi;
};

__device__ __forceinline__ Quant load_quant(const float* s_ptr, float s_val, const float* z_ptr,
                                            float z_val, float lo, float hi) {
  Quant p;
  p.s = s_ptr != nullptr ? __ldg(s_ptr) : s_val;
  p.zp = z_ptr != nullptr ? __ldg(z_ptr) : z_val;
  p.lo = lo;
  p.hi = hi;
  return p;
}

// x / s, the clamped code qc, and whether the clamp let the gradient through.
struct Code {
  float xs, qc;
  bool in;
};

__device__ __forceinline__ Code quantize(float x, const Quant& p) {
  Code c;
  c.xs = __fdiv_rn(x, p.s);
  const float q = rintf(__fadd_rn(c.xs, p.zp));
  c.in = !(q > p.hi) && !(q < p.lo);
  float qc = q > p.hi ? p.hi : q;
  qc = qc < p.lo ? p.lo : qc;
  c.qc = qc;
  return c;
}

__device__ __forceinline__ float fake_quant_one(float x, const Quant& p) {
  return __fmul_rn(__fsub_rn(quantize(x, p).qc, p.zp), p.s);
}

__device__ __forceinline__ float4 fake_quant_one(float4 v, const Quant& p) {
  return make_float4(fake_quant_one(v.x, p), fake_quant_one(v.y, p), fake_quant_one(v.z, p),
                     fake_quant_one(v.w, p));
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 load(const float4* p) { return __ldg(p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(float4* p, float4 v) { *p = v; }

constexpr int kFwdThreads = 256;
constexpr int kFwdVecs = 1;  // 16-byte loads a thread issues before it computes

// count items (float4 or float) of x to y in tiles of kFwdThreads * K items,
// a block a tile (the loop takes any grid): each thread K of a tile at a
// stride of the block, every load issued before the first store.
template <int K, typename T>
__device__ __forceinline__ void fake_quant_stream(const T* __restrict__ x, T* __restrict__ y,
                                                  int64_t count, const Quant& p) {
  constexpr int64_t kTile = static_cast<int64_t>(kFwdThreads) * K;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kTile; t < count;
       t += static_cast<int64_t>(gridDim.x) * kTile) {
    T v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t i = t + k * kFwdThreads + threadIdx.x;
      if (i < count) v[k] = load(x + i);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int64_t i = t + k * kFwdThreads + threadIdx.x;
      if (i < count) store(y + i, fake_quant_one(v[k], p));
    }
  }
}

// vecs float4 (x and y 16-byte aligned), then the elements [4 vecs, n) one
// at a time.
__global__ void __launch_bounds__(kFwdThreads)
fake_quant_kernel(const float* __restrict__ x, float* __restrict__ y, int64_t n, int64_t vecs,
                  const float* s_ptr, float s_val, const float* z_ptr, float z_val, float lo,
                  float hi) {
  const Quant p = load_quant(s_ptr, s_val, z_ptr, z_val, lo, hi);
  fake_quant_stream<kFwdVecs>(reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(y),
                              vecs, p);
  fake_quant_stream<4 * kFwdVecs>(x + 4 * vecs, y + 4 * vecs, n - 4 * vecs, p);
}

// Backward, first pass: dx, and (when part is given) this block's float64
// partial sums of dscale and dzp at part[2 * blockIdx.x + {0, 1}].
__global__ void __launch_bounds__(kThreads)
fake_quant_backward_kernel(const float* __restrict__ x, const float* __restrict__ g,
                           float* __restrict__ dx, double* __restrict__ part, int64_t n,
                           const float* s_ptr, float s_val, const float* z_ptr, float z_val,
                           float lo, float hi, int ste_clamp) {
  __shared__ double red[2][kThreads];
  const Quant p = load_quant(s_ptr, s_val, z_ptr, z_val, lo, hi);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kPerBlock + threadIdx.x;
  double ds = 0.0, dz = 0.0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int64_t i = base + static_cast<int64_t>(k) * kThreads;
    if (i < n) {
      const Code c = quantize(x[i], p);
      const float gi = g[i];
      const bool pass = ste_clamp || c.in;
      dx[i] = __fdiv_rn(pass ? __fmul_rn(gi, p.s) : 0.0f, p.s);
      if (part != nullptr) {
        const double q = static_cast<double>(__fsub_rn(c.qc, p.zp));
        ds += static_cast<double>(gi) * (q - (pass ? static_cast<double>(c.xs) : 0.0));
        if (!pass) dz -= static_cast<double>(gi) * static_cast<double>(p.s);
      }
    }
  }
  if (part == nullptr) return;
  red[0][threadIdx.x] = ds;
  red[1][threadIdx.x] = dz;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) {
      red[0][threadIdx.x] += red[0][threadIdx.x + half];
      red[1][threadIdx.x] += red[1][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    part[2 * static_cast<int64_t>(blockIdx.x)] = red[0][0];
    part[2 * static_cast<int64_t>(blockIdx.x) + 1] = red[1][0];
  }
}

// Backward, second pass (one block): the partials in block order, each
// thread a strided run of blocks, then the same tree; rounded once.
__global__ void __launch_bounds__(kThreads)
fake_quant_reduce_kernel(const double* __restrict__ part, int64_t blocks,
                         float* __restrict__ dscale, float* __restrict__ dzp) {
  __shared__ double red[2][kThreads];
  double ds = 0.0, dz = 0.0;
  for (int64_t b = threadIdx.x; b < blocks; b += kThreads) {
    ds += part[2 * b];
    dz += part[2 * b + 1];
  }
  red[0][threadIdx.x] = ds;
  red[1][threadIdx.x] = dz;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) {
      red[0][threadIdx.x] += red[0][threadIdx.x + half];
      red[1][threadIdx.x] += red[1][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *dscale = __double2float_rn(red[0][0]);
    *dzp = __double2float_rn(red[1][0]);
  }
}

int64_t blocks_for(int64_t n) { return (n + kPerBlock - 1) / kPerBlock; }

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

extern "C" int64_t fake_quant_blocks(int64_t n) { return blocks_for(n); }

// vecs from fake_quant_plan: the float4 of the body, 0 where x or y is off a
// 16-byte boundary. A block a tile.
extern "C" int fake_quant_launch(const float* x, float* y, int64_t n, int64_t vecs,
                                 const float* s_ptr, float s_val, const float* z_ptr,
                                 float z_val, float lo, float hi, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (vecs < 0 || 4 * vecs > n) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t scalars = ceil_div(n - 4 * vecs, 4);
  const int64_t items = vecs > scalars ? vecs : scalars;
  const int64_t blocks = ceil_div(items, kFwdThreads * kFwdVecs);
  fake_quant_kernel<<<static_cast<unsigned>(blocks), kFwdThreads, 0, stream>>>(
      x, y, n, vecs, s_ptr, s_val, z_ptr, z_val, lo, hi);
  return static_cast<int>(cudaGetLastError());
}

// part: 2 * fake_quant_blocks(n) doubles, or null to skip the sums (dscale
// and dzp are then not written).
extern "C" int fake_quant_backward_launch(const float* x, const float* g, float* dx,
                                          double* part, float* dscale, float* dzp, int64_t n,
                                          const float* s_ptr, float s_val, const float* z_ptr,
                                          float z_val, float lo, float hi, int ste_clamp,
                                          cudaStream_t stream) {
  const int64_t blocks = blocks_for(n);
  if (blocks > 0) {
    fake_quant_backward_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, g, dx, part, n, s_ptr, s_val, z_ptr, z_val, lo, hi, ste_clamp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (part == nullptr) return 0;
  fake_quant_reduce_kernel<<<1, kThreads, 0, stream>>>(part, blocks, dscale, dzp);
  return static_cast<int>(cudaGetLastError());
}
