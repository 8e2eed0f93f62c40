// K4 — split-K fused flash-decode (decode tick / speculative verify
// window) on Hopper.
//
// Replaces the JAX package's kernels/flash_decode.py:
// fused_flash_decode_kernel with split_k=True (body
// _fused_splitk_kernel): K2's contract — RoPE on q and the new K, the
// window scattered into the [NB,bs,KV,hd] arenas in place, query s of
// the window attending keys idx <= pos + s of its row through the block
// table — with the row's keys split across CTAs.
//
// The TPU body walks a row's pages in order on one core and carries
// (m, l, acc) in scratch from page to page, skipping the math of pages
// past the row.  Hopper blocks run in no order, so the partials are
// made in parallel and combined in a second pass; the two launches are
// one K4 call:
//
//   1. the partial kernel, grid (kv head x 16-row tile, row, split):
//      split j owns the keys of absolute positions [256 j, 256 j + 256)
//      — a span fixed in key positions, never derived from the batch,
//      the page size, the table width or the SM count, so a row's bits
//      depend on its own keys only.  A CTA whose span starts past
//      pos + S' - 1 exits at once: the work follows the row's length.
//      Each active CTA rotates the window itself, writes back the window
//      positions inside its span (first row tile only), folds its span
//      and stores its f32 partials (m, l, acc) per query row.  bf16
//      runs the tensor-core span body of decode_mma.cuh (cp.async ring,
//      window overlay, mma.sync with Q and P as bf16 pairs hi + lo, f32
//      base-2 softmax); f32 the exact-f32 scalar loop of
//      decode_attend.cuh (tensor cores would compute f32 as TF32).
//   2. splitk_combine_kernel, grid (kv head, row, 128 outputs), one
//      thread per output element: the active splits' max first, then
//      their rescaled partials summed in ascending split order, so the
//      loads of the second pass do not wait on a running max.
//
// Bound on the H100: bytes, as K2 — each key and value of the row is
// read once, ~4 operations per key and query row; the partials add
// B x KV x splits x R x (hd + 2) f32 written and read once.
#include "decode_attend.cuh"
#include "decode_mma.cuh"

namespace {

using repro::bf16;
using repro::DecodeSmem;

constexpr int kSpan = repro::kDecodeSpan;   // keys of one split
static_assert(kSpan % repro::kTK == 0, "split span must be whole chunks");

// ---------------------------------------------------------------------------
// bf16: the tensor-core span body
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(repro::kDecodeMmaThreads)
splitk_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kn,
                  const bf16* __restrict__ vn, bf16* __restrict__ kp,
                  bf16* __restrict__ vp, const int* __restrict__ tables,
                  const int* __restrict__ positions,
                  const float* __restrict__ freqs, float* __restrict__ part,
                  int Sq, int H, int KV, int bs, int P, int NS,
                  float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV, R = Sq * G;
  const int tiles = (R + repro::kDecodeRows - 1) / repro::kDecodeRows;
  const int kvh = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * repro::kDecodeRows;
  const int b = blockIdx.y, sp = blockIdx.z;
  const int pos = positions[b], T_len = P * bs;
  const int n_keys = min(T_len, pos + Sq);
  if (sp * kSpan >= n_keys) return;      // span past the row: no work
  const repro::DecodeMmaSmem<HD> sm(smem, Sq);
  const int* tbl = tables + static_cast<size_t>(b) * P;

  // span sp alone: the walk's next span, sp + NS, is past the row
  const repro::SpanWalk<HD> walk(sm, kp, vp, tbl, bs, KV, kvh, sp, NS, n_keys,
                                 pos);
  walk.prologue();                       // copies in flight while staging
  repro::stage_window_mma<HD>(sm, q, kn, vn, freqs, b, kvh, r0, pos, Sq, H,
                              KV);
  __syncthreads();
  if (r0 == 0)
    repro::write_window_mma<HD>(sm, kp, vp, tbl, pos, Sq, bs, KV, kvh,
                                [&](int g) {
                                  return g < T_len && g / kSpan == sp;
                                });
  repro::MmaState<HD> st;
  st.init();
  int lim[2];
  repro::row_limits(lim, r0, G, pos, n_keys);
  walk.run(st, lim, scale_log2);

  // partials of (row b, kv head, split): m[R], l[R], acc[R][hd]
  float* dst = part + ((static_cast<size_t>(b) * KV + kvh) * NS + sp)
                      * R * (HD + 2);
  repro::fold_warps_mma<HD>(sm, st, min(repro::kDecodeRows, R - r0),
                            [&](int r, int d, float m, float l, float a) {
                              const int row = r0 + r;
                              if (d == 0) {
                                dst[row] = m;
                                dst[R + row] = l;
                              }
                              dst[2 * R + row * HD + d] = a;
                            });
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* kn, const void* vn,
                       void* kp, void* vp, const void* tables,
                       const void* positions, const void* freqs, void* part,
                       int B, int Sq, int H, int KV, int bs, int P, int NS,
                       cudaStream_t stream) {
  const size_t smem = repro::DecodeMmaSmem<HD>::bytes(Sq);
  auto kern = splitk_mma_kernel<HD>;
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int R = Sq * (H / KV);
  const int tiles = (R + repro::kDecodeRows - 1) / repro::kDecodeRows;
  const float scale_log2 = repro::kLog2e / sqrtf(static_cast<float>(HD));
  kern<<<dim3(KV * tiles, B, NS), repro::kDecodeMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kn),
      static_cast<const bf16*>(vn), static_cast<bf16*>(kp),
      static_cast<bf16*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<const float*>(freqs),
      static_cast<float*>(part), Sq, H, KV, bs, P, NS, scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the scalar body, exact f32 arithmetic
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(repro::kDecodeThreads)
splitk_partial_kernel(const float* __restrict__ q,
                      const float* __restrict__ kn,
                      const float* __restrict__ vn, float* __restrict__ kp,
                      float* __restrict__ vp, const int* __restrict__ tables,
                      const int* __restrict__ positions,
                      const float* __restrict__ freqs,
                      float* __restrict__ part, int Sq, int H, int KV,
                      int hd, int bs, int P, int NS) {
  extern __shared__ float fsmem[];
  const int G = H / KV, R = Sq * G, T_len = P * bs;
  const int kvh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int pos = positions[b];
  const int n_keys = min(T_len, pos + Sq);
  const int lo = sp * kSpan, hi = min(lo + kSpan, n_keys);
  if (lo >= n_keys) return;              // span past the row: no work
  const DecodeSmem sm(fsmem, hd, R, Sq);
  const int* tbl = tables + static_cast<size_t>(b) * P;

  repro::stage_window<float>(sm, q, kn, vn, freqs, b, kvh, pos, Sq, H, KV,
                             hd);
  repro::init_state(sm, R, hd);
  __syncthreads();
  repro::write_window<float>(sm, kp, vp, tbl, pos, Sq, lo,
                             min(lo + kSpan, T_len), bs, KV, kvh, hd);
  repro::attend_keys<float>(sm, kp, vp, tbl, bs, KV, kvh, hd, lo, hi, pos,
                            R, G, pos, 1.0f / sqrtf(static_cast<float>(hd)));

  // partials of (row b, kv head, split): m[R], l[R], acc[R][hd]
  float* dst = part + ((static_cast<size_t>(b) * KV + kvh) * NS + sp)
                      * R * (hd + 2);
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    dst[r] = sm.ms[r];
    dst[R + r] = sm.ls[r];
  }
  for (int idx = threadIdx.x; idx < R * hd; idx += blockDim.x)
    dst[2 * R + idx] = sm.acc[idx];
}

cudaError_t launch_partials_f32(const void* q, const void* kn,
                                const void* vn, void* kp, void* vp,
                                const void* tables, const void* positions,
                                const void* freqs, void* part, int B, int Sq,
                                int H, int KV, int hd, int bs, int P, int NS,
                                cudaStream_t stream) {
  const size_t smem = DecodeSmem::bytes(hd, Sq * (H / KV), Sq);
  cudaError_t err = repro::allow_smem(splitk_partial_kernel, smem);
  if (err != cudaSuccess) return err;
  splitk_partial_kernel<<<dim3(KV, B, NS), repro::kDecodeThreads, smem,
                          stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kn),
      static_cast<const float*>(vn), static_cast<float*>(kp),
      static_cast<float*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<const float*>(freqs),
      static_cast<float*>(part), Sq, H, KV, hd, bs, P, NS);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the combine, both dtypes
// ---------------------------------------------------------------------------

// Combine the active splits' partials of (kv head, row), one output
// element (query row r, dim d) per thread: the splits' max first, then
// their rescaled (l, acc) summed in ascending split order.  The bf16
// partials hold base-2 maxima (scores pre-scaled by log2 e), the f32
// ones natural-log maxima.
template <typename T, bool kBase2>
__global__ void __launch_bounds__(repro::kDecodeMmaThreads)
splitk_combine_kernel(const float* __restrict__ part,
                      const int* __restrict__ positions, T* __restrict__ out,
                      int Sq, int H, int KV, int hd, int T_len, int NS) {
  const int G = H / KV, R = Sq * G, kvh = blockIdx.x, b = blockIdx.y;
  const int idx = blockIdx.z * blockDim.x + threadIdx.x;    // r * hd + d
  if (idx >= R * hd) return;
  const int r = idx / hd, d = idx % hd, s = r / G, g = r % G;
  const int n_keys = min(T_len, positions[b] + Sq);
  const int n_split = (n_keys + kSpan - 1) / kSpan;
  const size_t stride = static_cast<size_t>(R) * (hd + 2);
  const float* src = part + (static_cast<size_t>(b) * KV + kvh) * NS * stride;
  float m = repro::NEG_INF;
  for (int sp = 0; sp < n_split; ++sp) m = fmaxf(m, src[sp * stride + r]);
  float l = 0.f, a = 0.f;
#pragma unroll 4
  for (int sp = 0; sp < n_split; ++sp) {
    const float* ps = src + sp * stride;
    const float w = kBase2 ? exp2f(ps[r] - m) : expf(ps[r] - m);
    l += ps[R + r] * w;
    a += ps[2 * R + idx] * w;
  }
  out[((static_cast<size_t>(b) * Sq + s) * H + kvh * G + g) * hd + d] =
      repro::from_f<T>(a / l);
}

template <typename T, bool kBase2>
cudaError_t launch_combine(const void* part, const void* positions,
                           void* out, int B, int Sq, int H, int KV, int hd,
                           int T_len, int NS, cudaStream_t stream) {
  constexpr int kThreads = repro::kDecodeMmaThreads;
  const int outs = Sq * (H / KV) * hd;
  splitk_combine_kernel<T, kBase2>
      <<<dim3(KV, B, (outs + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>(static_cast<const float*>(part),
                   static_cast<const int*>(positions), static_cast<T*>(out),
                   Sq, H, KV, hd, T_len, NS);
  return cudaGetLastError();
}

}  // namespace

// The split span, for the wrapper's partials buffer.
extern "C" int repro_splitk_span() { return kSpan; }

// q, out: [B,S',H,hd]; k_new, v_new: [B,S',KV,hd]; k_pages, v_pages:
// [NB,bs,KV,hd] (updated in place); tables: [B,P] int32; positions: [B]
// int32; freqs: [hd/2] f32; part: f32 scratch of B*KV*NS*R*(hd+2) with
// NS = ceil(P*bs / span), R = S'*H/KV.  One dtype for q/k/v/arenas;
// bf16 needs hd a multiple of 16 up to 160.
extern "C" int repro_fused_flash_decode_splitk(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* tables, const void* positions,
    const void* freqs, void* part, void* out, int B, int Sq, int H, int KV,
    int hd, int bs, int P, int NS, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const int T_len = P * bs;
  if (dtype == repro::kBF16) {
    const cudaError_t err = repro::dispatch_head_dim(hd, [&](auto c) {
      return launch_mma<decltype(c)::value>(q, k_new, v_new, k_pages,
                                            v_pages, tables, positions,
                                            freqs, part, B, Sq, H, KV, bs, P,
                                            NS, st);
    });
    if (err != cudaSuccess) return err;
    return launch_combine<bf16, true>(part, positions, out, B, Sq, H, KV,
                                      hd, T_len, NS, st);
  }
  const cudaError_t err = launch_partials_f32(
      q, k_new, v_new, k_pages, v_pages, tables, positions, freqs, part, B,
      Sq, H, KV, hd, bs, P, NS, st);
  if (err != cudaSuccess) return err;
  return launch_combine<float, false>(part, positions, out, B, Sq, H, KV, hd,
                                      T_len, NS, st);
}
