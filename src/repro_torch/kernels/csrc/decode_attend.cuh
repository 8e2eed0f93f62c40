// The exact-f32 streaming loop of the decode-attention kernels: the f32
// bodies of K2 fused flash decode (flash_decode.cu), K4 its split-K
// variant (flash_decode_splitk.cu) and K5 paged attention
// (paged_attention.cu).  Their bf16 bodies run on tensor cores instead
// (decode_mma.cuh, paged_attention.cu), which would compute f32 as TF32.
//
// A decode CTA owns one (row b, kv head): the R = S' x G query rows of
// the head group (row r = s * G + g is window query s of query head
// kvh * G + g).  It streams a range of the row's keys, reached through
// the row's block table, through shared memory kTK at a time, and folds
// them into an online softmax whose state (m, l, acc per query row) it
// keeps in shared memory.  Query row r sees keys idx <= limit0 + r / G.
// Keys are visited in ascending absolute position, 64 at a time from a
// multiple of 64, so a row's arithmetic depends on its own keys only:
// not on the batch, the arena's page size or the table's width.
#pragma once

#include <climits>

#include "common.cuh"

namespace repro {

constexpr int kTK = 64;               // keys per streamed chunk
constexpr int kDecodeThreads = 128;
constexpr int kDecodeWarps = kDecodeThreads / 32;

// Shared-memory layout of a decode CTA, all f32.
struct DecodeSmem {
  float* kT;    // [hd][kTK + 1] staged keys, transposed (padded rows)
  float* vs;    // [kTK][hd] staged values
  float* qr;    // [R][hd] query rows
  float* kw;    // [Sq][hd] window K, rotated and rounded to the arena dtype
  float* vw;    // [Sq][hd] window V, rounded
  float* ps;    // [kDecodeWarps][kTK] probabilities of one row
  float* ms;    // [R] running max
  float* ls;    // [R] running normaliser
  float* acc;   // [R][hd] running output

  __device__ DecodeSmem(float* base, int hd, int R, int Sq) {
    kT = base;
    vs = kT + hd * (kTK + 1);
    qr = vs + kTK * hd;
    kw = qr + R * hd;
    vw = kw + Sq * hd;
    ps = vw + Sq * hd;
    ms = ps + kDecodeWarps * kTK;
    ls = ms + R;
    acc = ls + R;
  }

  static size_t bytes(int hd, int R, int Sq) {
    return sizeof(float) * (hd * (kTK + 1) + kTK * hd + R * hd + 2 * Sq * hd
                            + kDecodeWarps * kTK + 2 * R + R * hd);
  }
};

// Rotate the window into shared memory: q rows (head kvh * G + g, kept
// f32) and the new K of kv head kvh (rounded to the arena dtype T before
// it enters any score), and copy the new V, rounded.  The
// layers.apply_rope f32 expression at positions pos .. pos + Sq - 1.
template <typename T>
__device__ void stage_window(const DecodeSmem& sm, const T* q, const T* kn,
                             const T* vn, const float* freqs, int b,
                             int kvh, int pos, int Sq, int H, int KV,
                             int hd) {
  const int G = H / KV, R = Sq * G, half = hd / 2;
  const size_t tok = static_cast<size_t>(KV) * hd;
  for (int idx = threadIdx.x; idx < R * half; idx += blockDim.x) {
    const int r = idx / half, i = idx % half, s = r / G, g = r % G;
    const float ang = static_cast<float>(pos + s) * freqs[i];
    const float c = cosf(ang), sn = sinf(ang);
    const T* src = q + ((static_cast<size_t>(b) * Sq + s) * H
                        + kvh * G + g) * hd;
    const float x1 = to_f(src[i]), x2 = to_f(src[i + half]);
    sm.qr[r * hd + i] = x1 * c - x2 * sn;
    sm.qr[r * hd + i + half] = x2 * c + x1 * sn;
  }
  for (int idx = threadIdx.x; idx < Sq * half; idx += blockDim.x) {
    const int s = idx / half, i = idx % half;
    const float ang = static_cast<float>(pos + s) * freqs[i];
    const float c = cosf(ang), sn = sinf(ang);
    const size_t off = (static_cast<size_t>(b) * Sq + s) * tok + kvh * hd;
    const float x1 = to_f(kn[off + i]), x2 = to_f(kn[off + i + half]);
    sm.kw[s * hd + i] = to_f(from_f<T>(x1 * c - x2 * sn));
    sm.kw[s * hd + i + half] = to_f(from_f<T>(x2 * c + x1 * sn));
  }
  for (int idx = threadIdx.x; idx < Sq * hd; idx += blockDim.x) {
    const int s = idx / hd, d = idx % hd;
    sm.vw[idx] = to_f(vn[(static_cast<size_t>(b) * Sq + s) * tok
                         + kvh * hd + d]);
  }
}

// Write this kv head's window entries at positions [lo, hi) back into
// the arenas, in place (positions at or past P * bs are dropped by the
// caller's bounds).
template <typename T>
__device__ void write_window(const DecodeSmem& sm, T* kp, T* vp,
                             const int* tbl, int pos, int Sq, int lo,
                             int hi, int bs, int KV, int kvh, int hd) {
  const size_t tok = static_cast<size_t>(KV) * hd;
  for (int idx = threadIdx.x; idx < Sq * hd; idx += blockDim.x) {
    const int s = idx / hd, d = idx % hd, g = pos + s;
    if (g < lo || g >= hi) continue;
    const size_t dst = (static_cast<size_t>(tbl[g / bs]) * bs + g % bs) * tok
                       + kvh * hd + d;
    kp[dst] = from_f<T>(sm.kw[idx]);
    vp[dst] = from_f<T>(sm.vw[idx]);
  }
}

__device__ inline void init_state(const DecodeSmem& sm, int R, int hd) {
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    sm.ms[r] = NEG_INF;
    sm.ls[r] = 0.f;
  }
  for (int idx = threadIdx.x; idx < R * hd; idx += blockDim.x)
    sm.acc[idx] = 0.f;
}

// Fold keys [k_begin, k_end) of the row into the softmax state; k_begin
// is a multiple of kTK.  Keys at positions >= wpos come from the window
// overlay (sm.kw / sm.vw, window position t - wpos), never from the
// arena, so the reads never depend on the order of the in-place window
// writes; pass INT_MAX for no window.  A masked key's probability is an
// exact 0, so a span with no visible key leaves (l, acc) at 0.  Needs a
// __syncthreads() between the callers' shared-memory writes and this
// call; ends with one.
template <typename T>
__device__ void attend_keys(const DecodeSmem& sm, const T* kp, const T* vp,
                            const int* tbl, int bs, int KV, int kvh, int hd,
                            int k_begin, int k_end, int wpos, int R, int G,
                            int limit0, float scale) {
  constexpr int N = Vec<T>::N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t tok = static_cast<size_t>(KV) * hd;   // arena token stride
  const int nvec = hd / N;
  for (int k0 = k_begin; k0 < k_end; k0 += kTK) {
    for (int idx = tid; idx < kTK * nvec; idx += kDecodeThreads) {
      const int j = idx / nvec, dv = idx % nvec, t = k0 + j;
      float kv[N], vv[N];
      if (t >= k_end) {
#pragma unroll
        for (int e = 0; e < N; ++e) kv[e] = vv[e] = 0.f;
      } else if (t >= wpos) {             // window overlay
#pragma unroll
        for (int e = 0; e < N; ++e) {
          kv[e] = sm.kw[(t - wpos) * hd + dv * N + e];
          vv[e] = sm.vw[(t - wpos) * hd + dv * N + e];
        }
      } else {
        const size_t src = (static_cast<size_t>(tbl[t / bs]) * bs + t % bs)
                           * tok + kvh * hd + dv * N;
        load16(kp + src, kv);
        load16(vp + src, vv);
      }
#pragma unroll
      for (int e = 0; e < N; ++e) {
        sm.kT[(dv * N + e) * (kTK + 1) + j] = kv[e];
        sm.vs[j * hd + dv * N + e] = vv[e];
      }
    }
    __syncthreads();

    float* pw = sm.ps + warp * kTK;
    for (int r = warp; r < R; r += kDecodeWarps) {
      const int limit = limit0 + r / G;
      const float* qrow = sm.qr + r * hd;
      float s0 = 0.f, s1 = 0.f;
      for (int d = 0; d < hd; ++d) {
        const float qv = qrow[d];
        s0 += qv * sm.kT[d * (kTK + 1) + lane];
        s1 += qv * sm.kT[d * (kTK + 1) + lane + 32];
      }
      const int t0 = k0 + lane, t1 = k0 + lane + 32;
      const bool ok0 = t0 <= limit && t0 < k_end;
      const bool ok1 = t1 <= limit && t1 < k_end;
      s0 = ok0 ? s0 * scale : NEG_INF;
      s1 = ok1 ? s1 * scale : NEG_INF;
      const float m_old = sm.ms[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      pw[lane] = p0;
      pw[lane + 32] = p1;
      const float psum = warp_sum(p0 + p1);
      const float corr = expf(m_old - m_new);
      __syncwarp();
      for (int d = lane; d < hd; d += 32) {
        float a = sm.acc[r * hd + d] * corr;
        for (int j = 0; j < kTK; ++j) a += pw[j] * sm.vs[j * hd + d];
        sm.acc[r * hd + d] = a;
      }
      if (lane == 0) {
        sm.ls[r] = sm.ls[r] * corr + psum;
        sm.ms[r] = m_new;
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

}  // namespace repro
