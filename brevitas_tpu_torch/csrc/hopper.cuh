// Hopper (sm_90a) building blocks shared by the port's kernels: mbarriers,
// TMA tile loads and bulk copies, wgmma with the A operand in registers,
// signed-nibble unpacking, 4 x 4 byte transposes, thread-block-cluster
// reductions, the integer GEMMs' epilogue, split-K sum and tiling
// (int8_matmul.cu, int4_matmul.cu), and on the host the tensor-map encoder
// and a clustered launch. Inline PTX only; no CUTLASS or CuTe.
//
// Shared-memory tiles use the 128-byte swizzle that TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B and wgmma reads with layout type 1: a tile is
// rows of 128 bytes, 8 rows (1024 bytes, 1024-byte aligned) to an atom, and
// the 16-byte chunk c of row r is stored at chunk c ^ (r % 8).

#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched from the driver
#include <cuda_runtime.h>

namespace hopper {

// ---- device side -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of (row, 16-byte chunk) in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swizzle128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// make this thread's generic-proxy shared-memory writes visible to the async
// proxy (wgmma operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// TMA: the box at (c0 inner, c1 outer) of `map` into shared memory; completion
// counts `bytes` of the box on `bar` (out-of-bounds elements are zero-filled)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// one contiguous copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) into shared memory, its completion counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// The four low (or high) nibbles n of a word of packed int4 bytes as
// unsigned bytes u = n ^ 8 in [0, 15], one lop3: the signed code is u - 8,
// so a dot product over them is a dp4a of u less 8 x the other operand's sum.
__device__ __forceinline__ uint32_t nibbles_u_lo(uint32_t b) {
  return (b & 0x0F0F0F0Fu) ^ 0x08080808u;
}
__device__ __forceinline__ uint32_t nibbles_u_hi(uint32_t b) { return nibbles_u_lo(b >> 4); }

// ... and as signed bytes, exactly: (u + 0x78) ^ 0x80 is u - 8 in every
// byte, and no byte carries into the next (u + 0x78 <= 0x87)
__device__ __forceinline__ uint32_t s4_lo_to_s8(uint32_t b) {
  return (nibbles_u_lo(b) + 0x78787878u) ^ 0x80808080u;
}
__device__ __forceinline__ uint32_t s4_hi_to_s8(uint32_t b) { return s4_lo_to_s8(b >> 4); }

// The 4 x 4 byte block whose row i is the word r[i] (byte c = column c),
// transposed by byte permutes: col[c] holds column c, its byte i from row i.
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410);
  col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410);
  col[3] = __byte_perm(t1, t3, 0x7632);
}

// four 8 x 8 matrices of 16-bit elements, transposed: lanes 8i..8i+7 give the
// row addresses of matrix i; lane (g = lane / 4, t = lane % 4) receives
// elements [2t][g] (low half) and [2t + 1][g] (high half) of each
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)) : "memory");
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled tile
// starting at `p` (1024-byte aligned; +2 per 32 bytes of K within the row)
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4)        // start address / 16
         | (uint64_t(1) << 16)          // leading byte offset: unused when swizzled
         | (uint64_t(1024 >> 4) << 32)  // stride byte offset: one 8-row atom
         | (uint64_t(1) << 62);         // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void pin(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64 x BT, s32) += A (64 x 32 s8, registers) * B (32 x BT s8, K-major
// shared memory). Thread (warp w, g = lane / 4, t = lane % 4) holds A rows
// 16w + g (a[0], a[2]) and 16w + g + 8 (a[1], a[3]), K bytes 4t..4t+3
// (a[0], a[1]) and 16 + 4t.. (a[2], a[3]); and D[4j + e] at row 16w + g,
// column 8j + 2t + e, D[4j + 2 + e] at row 16w + g + 8.
template <int BT>
__device__ __forceinline__ void wgmma_s8(int* d, const uint32_t* a, uint64_t desc_b, int accumulate);

template <> __device__ __forceinline__ void wgmma_s8<16>(int* d, const uint32_t* a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <> __device__ __forceinline__ void wgmma_s8<32>(int* d, const uint32_t* a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <> __device__ __forceinline__ void wgmma_s8<64>(int* d, const uint32_t* a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <> __device__ __forceinline__ void wgmma_s8<128>(int* d, const uint32_t* a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D (64 x BT, s32) += A (64 x 32 u8, registers) * B (32 x BT s8, K-major
// shared memory): the fragments as wgmma_s8's, A's bytes unsigned.
template <int BT>
__device__ __forceinline__ void wgmma_u8s8(int* d, const uint32_t* a, uint64_t desc_b, int accumulate);

template <> __device__ __forceinline__ void wgmma_u8s8<64>(int* d, const uint32_t* a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D (64 x BT, f32) = A (64 x 16 bf16, registers) * B (16 x BT bf16, K-major
// shared memory) (+ D if `accumulate`). A: a[0] row 16w + g, K 2t..2t+1;
// a[1] row 16w + g + 8; a[2], a[3] the same rows at K 8 + 2t..; D as above.
template <int BT>
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t* a, uint64_t desc_b, int accumulate);

template <> __device__ __forceinline__ void wgmma_bf16<16>(float* d, const uint32_t* a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <> __device__ __forceinline__ void wgmma_bf16<32>(float* d, const uint32_t* a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

template <> __device__ __forceinline__ void wgmma_bf16<64>(float* d, const uint32_t* a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// ---- thread-block clusters ------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA in the cluster; orders shared-memory writes
// before the barrier with reads after it, across the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared-memory address `local` of this CTA, in cluster CTA `rank`
__device__ __forceinline__ uint32_t cluster_map(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ uint4 ld_cluster_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t ld_cluster_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// Masked byte loads of a 128-byte-swizzled tile by a warpgroup (thread
// `tid` < 128): tile row r holds src[(row0 + r) * ld + col0 + c] for c < 128,
// zero outside (rows, cols). For operands whose stride TMA cannot describe.
__device__ __forceinline__ void load_tile_bytes(uint8_t* tile, const int8_t* src, int ld,
                                                int rows, int cols, int row0, int col0,
                                                int tile_rows, int tid) {
  for (int q = tid; q < tile_rows * 8; q += 128) {
    const int r = q >> 3, c = q & 7;
    const int row = row0 + r, col = col0 + 16 * c;
    uint32_t v[4] = {0, 0, 0, 0};
    if (row < rows && col < cols) {
      const int8_t* p = src + (size_t)row * ld + col;
      const int n = min(16, cols - col);
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (b < n) v[b >> 2] |= (uint32_t)(uint8_t)p[b] << (8 * (b & 3));
    }
    *reinterpret_cast<uint4*>(tile + swizzle128(r, c)) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// ---- the integer GEMMs' epilogue (int8_matmul.cu, int4_matmul.cu) ---------
//
// Both kernels lay out a CTA alike: 128 features x BT tokens, two consumer
// warpgroups (threads 0-255) of 64 features and one producer warpgroup. Warp
// w of warpgroup wg holds features n = n0 + 64 wg + 16 w + 2g (its A row g)
// and n + 1 (A row g + 8), g = lane / 4, t = lane % 4; its accumulator
// register D[4j + e] is token 8j + 2t + e of feature n, D[4j + 2 + e] the
// same token of feature n + 1.

constexpr int kGemmConsumers = 256;

// y[m, n] from its int32 sum, in the reference's order, each step rounded on
// its own (no FMA): float(acc) * (x_scale * w_scale[n]), then + bias[n],
// then ReLU
__device__ __forceinline__ float dequant(int acc, float xsc, float ws, const float* bias, int n,
                                         int relu) {
  float v = __fmul_rn(__int2float_rn(acc), __fmul_rn(xsc, ws));
  if (bias != nullptr) v = __fadd_rn(v, bias[n]);
  if (relu) v = v > 0.0f ? v : 0.0f;
  return v;
}

// y[m, n] and y[m, n + 1], masked at the edges, a float2 store where aligned
__device__ __forceinline__ void write_pair(float* y, int M, int N, int m, int n, int acc0,
                                           int acc1, float xsc, const float* w_scale,
                                           const float* bias, int relu) {
  if (m >= M || n >= N) return;
  float* out = y + (size_t)m * N + n;
  const float o0 = dequant(acc0, xsc, w_scale[n], bias, n, relu);
  if (n + 1 >= N) {
    out[0] = o0;
    return;
  }
  const float o1 = dequant(acc1, xsc, w_scale[n + 1], bias, n + 1, relu);
  if (N % 2 == 0) {
    *reinterpret_cast<float2*>(out) = make_float2(o0, o1);  // n is even
  } else {
    out[0] = o0;
    out[1] = o1;
  }
}

// the tiled epilogue: consumer thread `tid` (< 256) writes its registers
template <int BT>
__device__ __forceinline__ void store_tile(const int (&acc)[BT / 2], int tid, float* y, int M,
                                           int N, int m0, int n0, float xsc,
                                           const float* w_scale, const float* bias, int relu) {
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n = n0 + 64 * wg + 16 * warp + 2 * g;
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      write_pair(y, M, N, m0 + 8 * j + 2 * t + e, n, acc[4 * j + e], acc[4 * j + 2 + e], xsc,
                 w_scale, bias, relu);
  }
}

// The exact int32 split-K sum over a cluster of `splits` CTAs (this one rank
// `split`), called by all `threads` threads of each CTA once the ring is
// drained: every rank leaves its partial tile in its own shared memory `red`
// in fragment order (consumer thread c's registers 4j..4j+3 at quad
// j * 256 + c); then rank r sums its 1/splits share of the quads over the
// cluster through distributed shared memory, in rank order, and writes their
// outputs.
template <int BT>
__device__ __forceinline__ void splitk_store(uint8_t* red, const int (&acc)[BT / 2], int threads, int split,
                             int splits, float* y, int M, int N, int m0, int n0, float xsc,
                             const float* w_scale, const float* bias, int relu) {
  if (threadIdx.x < kGemmConsumers) {
    asm volatile("bar.sync 1, %0;\n" :: "n"(kGemmConsumers) : "memory");
#pragma unroll
    for (int i = 0; i < BT / 2; i += 4)
      *reinterpret_cast<int4*>(red + ((i / 4) * kGemmConsumers + threadIdx.x) * 16) =
          make_int4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  }
  __syncwarp();
  cluster_sync();
  const int quads = (BT / 8) * kGemmConsumers, share = (quads + splits - 1) / splits;
  const int qend = min(quads, (split + 1) * share);
  for (int q = split * share + threadIdx.x; q < qend; q += threads) {
    int4 sum = make_int4(0, 0, 0, 0);
    for (int rank = 0; rank < splits; ++rank) {
      const uint4 v = ld_cluster_v4(cluster_map(smem_addr(red + q * 16), rank));
      sum.x += (int)v.x;
      sum.y += (int)v.y;
      sum.z += (int)v.z;
      sum.w += (int)v.w;
    }
    const int c = q % kGemmConsumers, j = q / kGemmConsumers, l = c % 32;
    const int n = n0 + 64 * (c / 128) + 16 * ((c / 32) % 4) + 2 * (l >> 2);
    const int m = m0 + 8 * j + 2 * (l & 3);
    write_pair(y, M, N, m, n, sum.x, sum.z, xsc, w_scale, bias, relu);
    write_pair(y, M, N, m + 1, n, sum.y, sum.w, xsc, w_scale, bias, relu);
  }
  __syncwarp();
  cluster_sync();  // no CTA leaves while another may still read its partials
}

// the first 1024-byte-aligned address of dynamic shared memory; launches ask
// for 1 KB more than the layout needs
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t a = smem_addr(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// ---- host side ------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the library
// needs no -lcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// a map of the row-major byte matrix (rows, cols) with a row stride of
// `stride` bytes, cut into boxes of (box_rows, box_cols), the box rows 128
// bytes wide and swizzled, zero outside the matrix. False if TMA cannot
// describe it (alignment) or the driver has no encoder.
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                       uint64_t rows, uint64_t cols, uint64_t stride, uint32_t box_rows,
                       uint32_t box_cols) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || !aligned16(base) || stride % 16 != 0)
    return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// The integer GEMMs' tiling (int8_matmul, int4_matmul): the smallest token
// tile of {16, 32, 64, 128} that holds M, and, where the 128-feature output
// tiles fill at most half the SMs, a split of the `ksteps` K stages over a
// cluster of at most 8 CTAs (1: the tiled variant).
struct GemmTiles {
  int bt, splits;
};

inline GemmTiles gemm_tiles(int M, int N, int ksteps) {
  GemmTiles t;
  t.bt = M <= 16 ? 16 : M <= 32 ? 32 : M <= 64 ? 64 : 128;
  const int tiles = cdiv(N, 128) * cdiv(M, t.bt);
  t.splits = 1;
  if (2 * tiles <= sm_count()) {
    const int s = std::max(1, std::min(std::min(8, ksteps), sm_count() / tiles));
    t.splits = cdiv(ksteps, cdiv(ksteps, s));  // no split left without K
  }
  return t;
}

// `kernel` on `grid` CTAs of `threads`, with `smem` bytes of dynamic shared
// memory, in thread-block clusters of `cluster` CTAs where that is more than
// one; returns a CUDA error code (0 on success)
template <typename... Params, typename... Args>
inline int launch_kernel(void (*kernel)(Params...), dim3 grid, int threads, int smem,
                         dim3 cluster, cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = cluster.x * cluster.y * cluster.z > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace hopper
