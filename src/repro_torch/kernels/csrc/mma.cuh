// Tensor-core and async-copy helpers of the bf16 attention kernels (K3
// flash_attention.cu, K5 paged_attention.cu, and K2/K4 through
// decode_mma.cuh): 16-byte cp.async with zero fill, ldmatrix, and
// mma.sync m16n8k16 with bf16 operands and f32 accumulation.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * gid + tig):
//   A 16x16 row-major, 4 regs: (gid, 2tig..+1), (gid+8, 2tig..+1),
//     (gid, 8+2tig..+1), (gid+8, 8+2tig..+1);
//   B 16x8 column-major, 2 regs: (k 2tig..+1, n gid), (k 8+2tig..+1, n gid);
//   C/D 16x8 f32, 4 regs: (gid, 2tig), (gid, 2tig+1), (gid+8, 2tig),
//     (gid+8, 2tig+1).
// Two neighbouring C tiles of S = Q K^T are, packed to bf16, the A
// fragment of P for the next product P V, so P never leaves registers.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace repro {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes global -> shared without the registers; with
// valid == false nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, register i receives matrix i in the A/B fragment pattern.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

// The same, each matrix transposed on the way (V as a B operand).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

// d += a * b for one 16x8x16 tile, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (nearest even) in one register, `lo` in the
// low half: the element of the smaller column index, as mma wants.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x and y as a pair of bf16 pairs, hi + lo: hi rounds (x, y) to bf16,
// lo rounds what hi left out, so hi + lo carries 16 of f32's 24
// significant bits.  Two products, one with each, give a bf16 operand
// nearly f32's precision.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - __low2float(h),
                                                 y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// Max and sum over the four lanes of a quad (one row of a C fragment),
// in the same order for every row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x by the special-function unit (ex2.approx, relative error below
// 2^-22; subnormal results flush to 0, so 2^(NEG_INF - m) == 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// log2(e): the softmax runs in base 2 on scores pre-scaled by it
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory row stride, in bf16, of a [rows][HD] tile: 16 bytes of
// padding put the 8 rows an ldmatrix reads on 8 distinct bank groups
// (HD a multiple of 16).
template <int HD>
constexpr int padded_ld() { return HD + 8; }

// f(std::integral_constant<int, HD>()) for the bf16 instance of head dim
// hd: one instance for each multiple of 16 up to 160, the widest head of
// the served configs; cudaErrorInvalidValue for any other hd.
template <typename F>
cudaError_t dispatch_head_dim(int hd, F f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 48: return f(std::integral_constant<int, 48>());
    case 64: return f(std::integral_constant<int, 64>());
    case 80: return f(std::integral_constant<int, 80>());
    case 96: return f(std::integral_constant<int, 96>());
    case 112: return f(std::integral_constant<int, 112>());
    case 128: return f(std::integral_constant<int, 128>());
    case 144: return f(std::integral_constant<int, 144>());
    case 160: return f(std::integral_constant<int, 160>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro
