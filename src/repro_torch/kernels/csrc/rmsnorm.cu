// K1 — fused RMSNorm for Hopper.
//
// Replaces the JAX package's kernels/rmsnorm.py:rmsnorm_kernel
// (body _rmsnorm_kernel): per row of x [rows, d], the f32 mean of x^2,
// then x * rsqrt(var + eps) * scale, cast back to x's dtype.
//
// Bound on the H100: bytes.  It does 3 operations per element against
// one read of x and one write of the output, far below the card's
// operations-per-byte balance.  Design: one warp per row, 16-byte
// vector loads (8 bf16 or 4 f32 per lane), an f32 sum of squares
// reduced by warp shuffles; the second pass re-reads the row, which is
// at most a few KB and still in L1, so device memory sees one read and
// one write per element.
#include "common.cuh"

namespace {

using repro::Vec;

template <typename T>
__global__ void __launch_bounds__(256)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int rows, int d, float eps) {
  constexpr int N = Vec<T>::N;
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* orow = out + static_cast<size_t>(row) * d;
  const int nvec = d / N;

  float ss = 0.f;
  for (int i = lane; i < nvec; i += 32) {
    float v[N];
    repro::load16(xr + i * N, v);
#pragma unroll
    for (int j = 0; j < N; ++j) ss += v[j] * v[j];
  }
  ss = repro::warp_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  for (int i = lane; i < nvec; i += 32) {
    float v[N], s[N];
    repro::load16(xr + i * N, v);
    repro::load16(scale + i * N, s);
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = (v[j] * r) * s[j];
    repro::store16(orow + i * N, v);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int d, float eps, cudaStream_t stream) {
  constexpr int kThreads = 256;             // 8 rows per block
  const int blocks = (rows * 32 + kThreads - 1) / kThreads;
  rmsnorm_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(out), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: [rows, d] contiguous; scale: [d]; all of one dtype;
// d a multiple of 16 bytes' worth of elements, pointers 16-byte aligned.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out,
                             int rows, int d, float eps, int dtype,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s);
  return launch<float>(x, scale, out, rows, d, eps, s);
}
