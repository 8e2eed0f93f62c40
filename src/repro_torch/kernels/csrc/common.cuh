// Shared helpers of the port's CUDA kernels: dtype dispatch codes,
// f32 conversion, 16-byte vector loads and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// masked-score value of the JAX kernels (exp(NEG_INF - m) == 0 in f32)
constexpr float NEG_INF = -1e30f;

// dtype codes, shared with kernels/build.py::DTYPE_CODE
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// elements of T in one 16-byte vector
template <typename T> struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// a 16-byte vector of T held as raw bits, to and from f32
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* out) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float* in) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) e[i] = from_f<T>(in[i]);
  return raw;
}

template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out) {
  unpack16<T>(*reinterpret_cast<const uint4*>(p), out);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float* in) {
  *reinterpret_cast<uint4*>(p) = pack16<T>(in);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Opt a kernel into `bytes` of dynamic shared memory (needed above 48 KB).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
