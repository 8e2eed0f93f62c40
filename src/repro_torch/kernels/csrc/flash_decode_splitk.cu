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
// made in parallel and combined in a second pass:
//
//   1. splitk_partial_kernel, grid (kv head, row, split): split j owns
//      the keys of absolute positions [256 j, 256 j + 256) — a span
//      fixed in key positions, never derived from the batch, the page
//      size or the SM count, so a row's bits depend on its own keys
//      only.  A CTA whose span starts past pos + S' - 1 exits at once:
//      the work follows the row's length.  Each active CTA rotates the
//      window itself, streams its span 64 keys at a time through the
//      loop shared with K2 (decode_attend.cuh, window overlaid while
//      staging), writes back only the window positions inside its span,
//      and stores its f32 partials (m, l, acc) per query row.
//   2. splitk_combine_kernel, grid (kv head, row): folds the active
//      splits' partials in ascending split order and writes the output.
//
// The two launches are one K4 call.  This matters where B x KV leaves
// SMs idle: at qwen3_32b's 8 kv heads, 4 rows give K2 32 CTAs on the
// card's 132 SMs, and K4 at 4096 keys 512.
//
// Bound on the H100: bytes, as K2 — each key and value of the row is
// read once, ~4 operations per key and query row; the partials add
// B x KV x splits x R x (hd + 2) f32 written and read once.
#include "decode_attend.cuh"

namespace {

using repro::DecodeSmem;

constexpr int kSpan = 256;    // keys of one split (a multiple of kTK)
static_assert(kSpan % repro::kTK == 0, "split span must be whole chunks");

template <typename T>
__global__ void __launch_bounds__(repro::kDecodeThreads)
splitk_partial_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                      const T* __restrict__ vn, T* __restrict__ kp,
                      T* __restrict__ vp, const int* __restrict__ tables,
                      const int* __restrict__ positions,
                      const float* __restrict__ freqs,
                      float* __restrict__ part, int Sq, int H, int KV,
                      int hd, int bs, int P, int NS) {
  extern __shared__ float smem[];
  const int G = H / KV, R = Sq * G, T_len = P * bs;
  const int kvh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int pos = positions[b];
  const int n_keys = min(T_len, pos + Sq);
  const int lo = sp * kSpan, hi = min(lo + kSpan, n_keys);
  if (lo >= n_keys) return;              // span past the row: no work
  const DecodeSmem sm(smem, hd, R, Sq);
  const int* tbl = tables + static_cast<size_t>(b) * P;

  repro::stage_window<T>(sm, q, kn, vn, freqs, b, kvh, pos, Sq, H, KV, hd);
  repro::init_state(sm, R, hd);
  __syncthreads();
  repro::write_window<T>(sm, kp, vp, tbl, pos, Sq, lo,
                         min(lo + kSpan, T_len), bs, KV, kvh, hd);
  repro::attend_keys<T>(sm, kp, vp, tbl, bs, KV, kvh, hd, lo, hi, pos, R,
                        G, pos, 1.0f / sqrtf(static_cast<float>(hd)));

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

template <typename T>
__global__ void __launch_bounds__(repro::kDecodeThreads)
splitk_combine_kernel(const float* __restrict__ part,
                      const int* __restrict__ positions, T* __restrict__ out,
                      int Sq, int H, int KV, int hd, int T_len, int NS) {
  const int G = H / KV, R = Sq * G;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int n_keys = min(T_len, positions[b] + Sq);
  const int n_split = (n_keys + kSpan - 1) / kSpan;
  const size_t stride = static_cast<size_t>(R) * (hd + 2);
  const float* src = part + (static_cast<size_t>(b) * KV + kvh) * NS * stride;
  for (int idx = threadIdx.x; idx < R * hd; idx += blockDim.x) {
    const int r = idx / hd, d = idx % hd, s = r / G, g = r % G;
    float m = repro::NEG_INF, l = 0.f, a = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const float* ps = src + sp * stride;
      const float m_sp = ps[r];
      const float m_new = fmaxf(m, m_sp);
      const float c_old = expf(m - m_new), c_sp = expf(m_sp - m_new);
      l = l * c_old + ps[R + r] * c_sp;
      a = a * c_old + ps[2 * R + idx] * c_sp;
      m = m_new;
    }
    out[((static_cast<size_t>(b) * Sq + s) * H + kvh * G + g) * hd + d] =
        repro::from_f<T>(a / l);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kn, const void* vn, void* kp,
                   void* vp, const void* tables, const void* positions,
                   const void* freqs, void* part, void* out, int B, int Sq,
                   int H, int KV, int hd, int bs, int P, int NS,
                   cudaStream_t stream) {
  const size_t smem = DecodeSmem::bytes(hd, Sq * (H / KV), Sq);
  auto kern = splitk_partial_kernel<T>;
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(KV, B, NS), repro::kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<T*>(kp), static_cast<T*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(positions),
      static_cast<const float*>(freqs), static_cast<float*>(part), Sq, H, KV,
      hd, bs, P, NS);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  splitk_combine_kernel<T><<<dim3(KV, B), repro::kDecodeThreads, 0,
                             stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(positions),
      static_cast<T*>(out), Sq, H, KV, hd, P * bs, NS);
  return cudaGetLastError();
}

}  // namespace

// The split span, for the wrapper's partials buffer.
extern "C" int repro_splitk_span() { return kSpan; }

// q, out: [B,S',H,hd]; k_new, v_new: [B,S',KV,hd]; k_pages, v_pages:
// [NB,bs,KV,hd] (updated in place); tables: [B,P] int32; positions: [B]
// int32; freqs: [hd/2] f32; part: f32 scratch of B*KV*NS*R*(hd+2) with
// NS = ceil(P*bs / span), R = S'*H/KV.  One dtype for q/k/v/arenas.
extern "C" int repro_fused_flash_decode_splitk(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* tables, const void* positions,
    const void* freqs, void* part, void* out, int B, int Sq, int H, int KV,
    int hd, int bs, int P, int NS, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(q, k_new, v_new, k_pages, v_pages, tables,
                                 positions, freqs, part, out, B, Sq, H, KV,
                                 hd, bs, P, NS, st);
  return launch<float>(q, k_new, v_new, k_pages, v_pages, tables, positions,
                       freqs, part, out, B, Sq, H, KV, hd, bs, P, NS, st);
}
