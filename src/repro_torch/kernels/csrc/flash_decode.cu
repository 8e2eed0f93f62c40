// K2 — fused flash-decode (decode tick / speculative verify window) on
// Hopper.
//
// Replaces the JAX package's kernels/flash_decode.py:
// fused_flash_decode_kernel with split_k=False (body
// _fused_gather_kernel, with _stage_page, _rope_window and rope_freqs).
// In one launch per layer and step it
//   1. rotates q [B,S',H,hd] and the new K [B,S',KV,hd] at absolute
//      positions pos..pos+S'-1 (the layers.apply_rope f32 expression,
//      frequencies from the precomputed `freqs` operand);
//   2. writes the rotated K window and the V window, rounded to the
//      arena dtype, into the row's tail page(s) of the [NB,bs,KV,hd]
//      arenas, in place (the TPU kernel's aliased outputs);
//   3. attends query s of the window over keys idx <= pos + s of the
//      row, reached through its block table, GQA h -> h / G, scale
//      1/sqrt(f32(hd)).
//
// The TPU body stages the whole row [T,KV,hd] in VMEM; at minicpm_2b's
// width (KV=36, hd=64) and max_len 512 that is 4.7 MB in bf16, beyond
// the 227 KB of shared memory of an SM.  So one CTA owns one
// (row b, kv head): the G query heads of the group times the S' window
// queries, and it streams the row's keys through shared memory 64 at a
// time with an online softmax (m, l, acc kept per query row in shared
// memory).  Keys past pos+S'-1 are masked for every query and are not
// read at all, so the work follows the row's length.
//
// The streaming softmax sums in another order than the fully gathered
// plain version (fused_flash_decode_ref): the two agree to f32
// reduction-order tolerance, not bitwise (the JAX split-K variant's
// 2e-5 against the gathered one is the precedent).  Each CTA's result
// depends on its own row only, so a row's bits do not depend on the
// batch.
//
// The window tokens are overlaid while the keys are staged, as
// _stage_page does: a key at a window position is taken from the
// rotated, rounded window in shared memory, never from the arena, so
// the reads never depend on the order of the in-place writes.  Each
// CTA writes back only the S' window entries of its own kv head; on the
// slot layout no two CTAs write the same entry.  Trash block 0 and
// inactive rows follow the JAX contract: a row whose window pages
// resolve to block 0 gets finite but unspecified output, block 0's
// content is unspecified afterwards, and window positions at or past
// P*bs are not written.
//
// Bound on the H100: bytes.  Per (row, kv head) it reads the row's K and
// V once (pos+S' keys x hd) and does ~4 operations per key and query
// row; at S' <= 8 queries per kv head that is far below the card's
// operations-per-byte balance.  The keys are read as 16-byte vectors.
#include "common.cuh"

namespace {

using repro::Vec;

constexpr int kTK = 64;          // keys per streamed chunk
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_decode_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                    const T* __restrict__ vn, T* __restrict__ kp,
                    T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ positions,
                    const float* __restrict__ freqs, T* __restrict__ out,
                    int Sq, int H, int KV, int hd, int bs, int P) {
  constexpr int N = Vec<T>::N;
  extern __shared__ float smem[];
  const int G = H / KV, R = Sq * G, half = hd / 2, T_len = P * bs;
  float* kT = smem;                       // [hd][kTK + 1]
  float* vs = kT + hd * (kTK + 1);        // [kTK][hd]
  float* qr = vs + kTK * hd;              // [R][hd] rotated q, f32
  float* kw = qr + R * hd;                // [Sq][hd] window K, rounded
  float* vw = kw + Sq * hd;               // [Sq][hd] window V, rounded
  float* ps = vw + Sq * hd;               // [kWarps][kTK] probabilities
  float* ms = ps + kWarps * kTK;          // [R] running max
  float* ls = ms + R;                     // [R] running normaliser
  float* acc = ls + R;                    // [R][hd] running output

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pos = positions[b];
  const int* tbl = tables + static_cast<size_t>(b) * P;
  const size_t tok = static_cast<size_t>(KV) * hd;   // arena token stride

  // 1. rotate the window: q rows r = s*G + g (head kvh*G + g) stay f32;
  //    K is rounded to the arena dtype before it enters any score
  for (int idx = tid; idx < R * half; idx += kThreads) {
    const int r = idx / half, i = idx % half, s = r / G, g = r % G;
    const float ang = static_cast<float>(pos + s) * freqs[i];
    const float c = cosf(ang), sn = sinf(ang);
    const T* src = q + ((static_cast<size_t>(b) * Sq + s) * H
                        + kvh * G + g) * hd;
    const float x1 = repro::to_f(src[i]), x2 = repro::to_f(src[i + half]);
    qr[r * hd + i] = x1 * c - x2 * sn;
    qr[r * hd + i + half] = x2 * c + x1 * sn;
  }
  for (int idx = tid; idx < Sq * half; idx += kThreads) {
    const int s = idx / half, i = idx % half;
    const float ang = static_cast<float>(pos + s) * freqs[i];
    const float c = cosf(ang), sn = sinf(ang);
    const size_t off = (static_cast<size_t>(b) * Sq + s) * tok + kvh * hd;
    const float x1 = repro::to_f(kn[off + i]);
    const float x2 = repro::to_f(kn[off + i + half]);
    kw[s * hd + i] = repro::to_f(repro::from_f<T>(x1 * c - x2 * sn));
    kw[s * hd + i + half] = repro::to_f(repro::from_f<T>(x2 * c + x1 * sn));
  }
  for (int idx = tid; idx < Sq * hd; idx += kThreads) {
    const int s = idx / hd, d = idx % hd;
    vw[idx] = repro::to_f(
        vn[(static_cast<size_t>(b) * Sq + s) * tok + kvh * hd + d]);
  }
  for (int r = tid; r < R; r += kThreads) {
    ms[r] = repro::NEG_INF;
    ls[r] = 0.f;
  }
  for (int idx = tid; idx < R * hd; idx += kThreads) acc[idx] = 0.f;
  __syncthreads();

  // 2. in-place write-back of this kv head's window entries
  for (int idx = tid; idx < Sq * hd; idx += kThreads) {
    const int s = idx / hd, d = idx % hd, g = pos + s;
    if (g >= T_len) continue;
    const size_t dst = (static_cast<size_t>(tbl[g / bs]) * bs + g % bs) * tok
                       + kvh * hd + d;
    kp[dst] = repro::from_f<T>(kw[idx]);
    vp[dst] = repro::from_f<T>(vw[idx]);
  }

  // 3. stream keys 0 .. pos+S'-1 with an online softmax
  const int n_keys = min(T_len, pos + Sq);
  const int nvec = hd / N;
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  for (int k0 = 0; k0 < n_keys; k0 += kTK) {
    for (int idx = tid; idx < kTK * nvec; idx += kThreads) {
      const int j = idx / nvec, dv = idx % nvec, t = k0 + j;
      float kv[N], vv[N];
      if (t >= n_keys) {
#pragma unroll
        for (int e = 0; e < N; ++e) kv[e] = vv[e] = 0.f;
      } else if (t >= pos) {            // window overlay
#pragma unroll
        for (int e = 0; e < N; ++e) {
          kv[e] = kw[(t - pos) * hd + dv * N + e];
          vv[e] = vw[(t - pos) * hd + dv * N + e];
        }
      } else {
        const size_t src = (static_cast<size_t>(tbl[t / bs]) * bs + t % bs)
                           * tok + kvh * hd + dv * N;
        repro::load16(kp + src, kv);
        repro::load16(vp + src, vv);
      }
#pragma unroll
      for (int e = 0; e < N; ++e) {
        kT[(dv * N + e) * (kTK + 1) + j] = kv[e];
        vs[j * hd + dv * N + e] = vv[e];
      }
    }
    __syncthreads();

    float* pw = ps + warp * kTK;
    for (int r = warp; r < R; r += kWarps) {
      const int limit = pos + r / G;    // query s = r / G sees idx <= pos+s
      const float* qrow = qr + r * hd;
      float s0 = 0.f, s1 = 0.f;
      for (int d = 0; d < hd; ++d) {
        const float qv = qrow[d];
        s0 += qv * kT[d * (kTK + 1) + lane];
        s1 += qv * kT[d * (kTK + 1) + lane + 32];
      }
      const int t0 = k0 + lane, t1 = k0 + lane + 32;
      s0 = (t0 <= limit && t0 < n_keys) ? s0 * scale : repro::NEG_INF;
      s1 = (t1 <= limit && t1 < n_keys) ? s1 * scale : repro::NEG_INF;
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, repro::warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      pw[lane] = p0;
      pw[lane + 32] = p1;
      const float psum = repro::warp_sum(p0 + p1);
      const float corr = expf(m_old - m_new);
      __syncwarp();
      for (int d = lane; d < hd; d += 32) {
        float a = acc[r * hd + d] * corr;
        for (int j = 0; j < kTK; ++j) a += pw[j] * vs[j * hd + d];
        acc[r * hd + d] = a;
      }
      if (lane == 0) {
        ls[r] = ls[r] * corr + psum;
        ms[r] = m_new;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  for (int idx = tid; idx < R * hd; idx += kThreads) {
    const int r = idx / hd, d = idx % hd, s = r / G, g = r % G;
    out[((static_cast<size_t>(b) * Sq + s) * H + kvh * G + g) * hd + d] =
        repro::from_f<T>(acc[idx] / ls[r]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kn, const void* vn, void* kp,
                   void* vp, const void* tables, const void* positions,
                   const void* freqs, void* out, int B, int Sq, int H,
                   int KV, int hd, int bs, int P, cudaStream_t stream) {
  const int R = Sq * (H / KV);
  const size_t smem = sizeof(float) *
      (hd * (kTK + 1) + kTK * hd + R * hd + 2 * Sq * hd + kWarps * kTK
       + 2 * R + R * hd);
  auto kern = fused_decode_kernel<T>;
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(KV, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<T*>(kp), static_cast<T*>(vp),
      static_cast<const int*>(tables), static_cast<const int*>(positions),
      static_cast<const float*>(freqs), static_cast<T*>(out), Sq, H, KV, hd,
      bs, P);
  return cudaGetLastError();
}

}  // namespace

// q, out: [B,S',H,hd]; k_new, v_new: [B,S',KV,hd]; k_pages, v_pages:
// [NB,bs,KV,hd] (updated in place); tables: [B,P] int32; positions: [B]
// int32; freqs: [hd/2] f32.  Contiguous, one dtype for q/k/v/arenas.
extern "C" int repro_fused_flash_decode(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* tables, const void* positions,
    const void* freqs, void* out, int B, int Sq, int H, int KV, int hd,
    int bs, int P, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(q, k_new, v_new, k_pages, v_pages, tables,
                                 positions, freqs, out, B, Sq, H, KV, hd, bs,
                                 P, st);
  return launch<float>(q, k_new, v_new, k_pages, v_pages, tables, positions,
                       freqs, out, B, Sq, H, KV, hd, bs, P, st);
}
