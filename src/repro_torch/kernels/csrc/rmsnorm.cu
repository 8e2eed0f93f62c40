// K1 — fused RMSNorm for Hopper.
//
// Replaces the JAX package's kernels/rmsnorm.py:rmsnorm_kernel (body
// _rmsnorm_kernel): per row of x [rows, d], the f32 mean of x^2, then
// x * rsqrt(var + eps) * scale, cast back to x's dtype.
//
// What bounds it.  It does 3 operations per element against one read
// of x and one write of the output: with many rows (a prefill chunk of
// 256 or 1024) it is bound by bytes, and the card must be full to reach
// the memory rate.  At a decode tick's 4 rows its bytes (16-64 KB) take
// nanoseconds: there the launch and the memory round trips that a row
// waits for in series bound it.
//
// The design.  One CTA per row (grid = rows), planned by (d, dtype)
// alone in kernels/rmsnorm.py:launch_plan, which passes the plan here
// to be checked: `threads` (a multiple of 32, at most kMaxThreads) and
// `vecs` 16-byte vectors a thread (at most kMaxVecs), vector i of the
// row held by thread i % threads.  Each thread issues all its loads of
// x and scale before it uses any, keeps them in registers (8 * vecs
// registers of row data, of the up to 255 that
// __launch_bounds__(kMaxThreads) leaves a thread) and writes the output
// from them: device memory sees x read once and the output written
// once, and a row costs one round trip, not one a vector.  Vectors past
// the row's end are masked by predicate.  With 256 rows the grid holds
// 256 CTAs and every SM works.  The sum of squares runs in a fixed
// order: each thread over its vectors in order, a warp butterfly, then
// every thread adds the warp partials from shared memory in warp
// order.  No atomics, so a row's bits depend on
// (d, dtype, eps) and its own values only, never on `rows` or on where
// the row sits in the batch: generate = batch, chunks = decode calls
// and captured = eager rest on it.  No dynamic shared memory, no
// allocation, no host sync: the launch captures into CUDA graphs.
// Programmatic dependent launch was timed on the captured decode ticks
// (tools/time_rmsnorm_variants.py) and left out: it did not shorten
// them.
#include "common.cuh"

namespace {

using repro::Vec;

constexpr int kMaxThreads = 256;   // kernels/rmsnorm.py:MAX_THREADS
constexpr int kMaxVecs = 8;        // kernels/rmsnorm.py:MAX_VECS

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  constexpr int N = Vec<T>::N;
  __shared__ float partial[kMaxThreads / 32];
  const int nvec = d / N;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const uint4* xr = reinterpret_cast<const uint4*>(x + base);
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  uint4* orow = reinterpret_cast<uint4*>(out + base);

  // the whole row in flight: every load issued before any is used
  uint4 xv[V], sv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = j * threads + tid;
    xv[j] = sv[j] = make_uint4(0u, 0u, 0u, 0u);
    if (i < nvec) {
      xv[j] = xr[i];
      sv[j] = sr[i];
    }
  }

  // a masked vector holds zeros and adds nothing
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float v[N];
    repro::unpack16<T>(xv[j], v);
#pragma unroll
    for (int e = 0; e < N; ++e) ss = fmaf(v[e], v[e], ss);
  }
  ss = repro::warp_sum(ss);
  if ((tid & 31) == 0) partial[tid >> 5] = ss;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < threads / 32; ++w) total += partial[w];
  const float r = rsqrtf(total / static_cast<float>(d) + eps);

#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int i = j * threads + tid;
    if (i < nvec) {
      float v[N], s[N];
      repro::unpack16<T>(xv[j], v);
      repro::unpack16<T>(sv[j], s);
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] = (v[e] * r) * s[e];
      orow[i] = repro::pack16<T>(v);
    }
  }
}

struct Args {
  const void* x;
  const void* scale;
  void* out;
  int rows, d;
  float eps;
  int threads;
  cudaStream_t stream;
};

template <typename T, int V>
cudaError_t launch_v(const Args& a) {
  rmsnorm_kernel<T, V><<<a.rows, a.threads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.scale),
      static_cast<T*>(a.out), a.d, a.eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, int vecs) {
  constexpr int N = Vec<T>::N;
  if (a.rows < 1 || a.d < N || a.d % N || a.threads < 32 ||
      a.threads % 32 || a.threads > kMaxThreads || vecs < 1 ||
      vecs > kMaxVecs || a.threads * vecs < a.d / N)
    return cudaErrorInvalidValue;
  switch (vecs) {
    case 1: return launch_v<T, 1>(a);
    case 2: return launch_v<T, 2>(a);
    case 3: return launch_v<T, 3>(a);
    case 4: return launch_v<T, 4>(a);
    case 5: return launch_v<T, 5>(a);
    case 6: return launch_v<T, 6>(a);
    case 7: return launch_v<T, 7>(a);
    default: return launch_v<T, 8>(a);
  }
}

}  // namespace

// x, out: [rows, d] contiguous; scale: [d]; all of one dtype, pointers
// 16-byte aligned.  `threads` and `vecs` are the plan of
// kernels/rmsnorm.py:launch_plan for (d, dtype); a plan that does not
// cover the row, or a d that is not whole 16-byte vectors, returns
// cudaErrorInvalidValue without launching.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out,
                             int rows, int d, float eps, int dtype,
                             int threads, int vecs, void* stream) {
  const Args a{x, scale, out, rows, d, eps, threads,
               static_cast<cudaStream_t>(stream)};
  if (dtype == repro::kBF16) return launch<__nv_bfloat16>(a, vecs);
  return launch<float>(a, vecs);
}
