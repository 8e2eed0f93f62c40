// The bf16 span body shared by K2 fused flash decode (flash_decode.cu)
// and K4 its split-K variant (flash_decode_splitk.cu), on tensor cores.
//
// A CTA owns 16 query rows of one (row b, kv head): rows r0 .. r0 + 15
// of the R = S' x G rows of the head group (row r = s * G + g is window
// query s of query head kvh * G + g; rows past R are zero).  Query row
// r sees keys idx <= pos + r / G.  The CTA walks spans of 256 absolute
// key positions (span j holds keys [256 j, 256 j + 256)), each as four
// 64-key chunks from a multiple of 64, and folds them into an online
// softmax.  The walk, the masks and the order of every sum depend on
// the row's own keys only: not on the batch, the arena's page size, the
// table's width or the card.
//
//   Loads.  Chunk c + kStages - 1 is copied as bf16 by 16-byte cp.async
//   into a ring of kStages stages while chunk c is computed, each key's
//   page found through the row's block table.  Keys past the row read
//   as zeros.
//   Window overlay.  Keys at positions >= pos come from the rotated,
//   bf16-rounded window the CTA holds in shared memory, never from the
//   arena: their copies are not issued, and the window rows are written
//   into the stage after the wait, before the barrier that comes before
//   ldmatrix.  So the reads never depend on the order of the in-place
//   window writes.
//   Products.  Warp w takes keys 16 w .. 16 w + 15 of every chunk.
//   S = Q K^T and O += P V run on mma.sync m16n8k16 with ldmatrix
//   operands, V transposed.  Q enters as the bf16 pair hi + lo of the
//   f32 rotated query (mma.cuh split_bf16), P as the pair hi + lo of the
//   f32 probabilities: two products each, 16 of f32's 24 bits, so the
//   scores and the weighted sum stay close to f32 (the kernel is bound
//   by bytes; the extra products use tensor-core cycles that wait on
//   the copies anyway).
//   Softmax.  Scores (pre-scaled by log2 e), the base-2 online softmax
//   and the accumulators stay f32 in registers.  A masked key gets p = 0
//   exactly and leaves the correction at exp2f(0) == 1 where the max
//   did not move, so a key fully masked for a row leaves its state
//   exactly, and a warp may skip 16 keys that no row sees.  Every row
//   runs the same instruction sequence.
//
// After the walk the four warps' states are folded in warp order (K4
// stores them as a span's partials, K2 combines them across a cluster).
#pragma once

#include "mma.cuh"

namespace repro {

constexpr int kDecodeSpan = 256;     // keys of one span
constexpr int kDecodeChunk = 64;     // keys of one ring stage
// Ring depth: 3 and 4 stages were slower at minicpm_2b's and qwen3_32b's
// decode shapes (tools/time_decode_variants.py), their larger rings
// leaving fewer CTAs on an SM where a CTA walks only one to four chunks.
constexpr int kDecodeStages = 2;
constexpr int kDecodeRows = 16;      // query rows of one CTA: the mma's M
constexpr int kDecodeMmaThreads = 128;
constexpr int kDecodeMmaWarps = kDecodeMmaThreads / 32;
static_assert(kDecodeSpan % kDecodeChunk == 0, "a span is whole chunks");
static_assert(kDecodeChunk == 16 * kDecodeMmaWarps, "a warp takes 16 keys");
static_assert(kDecodeStages >= 2, "the ring needs two stages");

// Shared memory of a CTA.  During the walk: q hi/lo [16][kLd], the K
// and V rings [kStages][64][kLd] and the window K/V [S'][kLd], all
// bf16, and the window's cos/sin [S'][HD/2] f32.  After it the f32
// states overlay the same bytes: the warps' (m, l, acc) [4][16](HD) and
// their fold [16](HD).
template <int HD>
struct DecodeMmaSmem {
  static constexpr int kLd = padded_ld<HD>();
  static constexpr int kStage = kDecodeChunk * kLd;   // bf16 elements

  bf16 *qh, *ql, *ks, *vs, *kw, *vw;
  float *cs, *sn, *wm, *wl, *wa, *fm, *fl, *fa;

  __device__ DecodeMmaSmem(unsigned char* base, int Sq) {
    qh = reinterpret_cast<bf16*>(base);
    ql = qh + kDecodeRows * kLd;
    ks = ql + kDecodeRows * kLd;
    vs = ks + kDecodeStages * kStage;
    kw = vs + kDecodeStages * kStage;
    vw = kw + Sq * kLd;
    cs = reinterpret_cast<float*>(vw + Sq * kLd);
    sn = cs + Sq * HD / 2;
    wm = reinterpret_cast<float*>(base);
    wl = wm + kDecodeMmaWarps * kDecodeRows;
    wa = wl + kDecodeMmaWarps * kDecodeRows;
    fm = wa + kDecodeMmaWarps * kDecodeRows * HD;
    fl = fm + kDecodeRows;
    fa = fl + kDecodeRows;
  }

  static size_t bytes(int Sq) {
    const size_t walk = sizeof(bf16) * (2 * kDecodeRows * kLd
                                        + 2 * kDecodeStages * kStage
                                        + 2 * Sq * kLd)
                        + sizeof(float) * Sq * HD;
    const size_t fold = sizeof(float) * (kDecodeMmaWarps + 1) * kDecodeRows
                        * (HD + 2);
    return walk > fold ? walk : fold;
  }
};

// Rotate the CTA's query rows r0 .. r0 + 15 (kept f32 until they are
// split into hi + lo) and the window's new K (rounded to bf16 before it
// enters any score, as the arena holds it), and copy the new V: the
// layers.apply_rope f32 expression at positions pos .. pos + S' - 1.
// The S' x HD/2 angles' cos and sin are taken once, into a table: the
// G query heads of a window position share them with its new K.
template <int HD>
__device__ void stage_window_mma(const DecodeMmaSmem<HD>& sm, const bf16* q,
                                 const bf16* kn, const bf16* vn,
                                 const float* freqs, int b, int kvh, int r0,
                                 int pos, int Sq, int H, int KV) {
  constexpr int kLd = DecodeMmaSmem<HD>::kLd, half = HD / 2;
  const int G = H / KV, R = Sq * G;
  const size_t tok = static_cast<size_t>(KV) * HD;
  for (int idx = threadIdx.x; idx < Sq * half; idx += blockDim.x) {
    const float ang = static_cast<float>(pos + idx / half)
                      * freqs[idx % half];
    sincosf(ang, &sm.sn[idx], &sm.cs[idx]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kDecodeRows * half; idx += blockDim.x) {
    const int r = idx / half, i = idx % half, row = r0 + r;
    float y1 = 0.f, y2 = 0.f;
    if (row < R) {
      const int s = row / G, g = row % G;
      const float c = sm.cs[s * half + i], sn = sm.sn[s * half + i];
      const bf16* src = q + ((static_cast<size_t>(b) * Sq + s) * H
                             + kvh * G + g) * HD;
      const float x1 = to_f(src[i]), x2 = to_f(src[i + half]);
      y1 = x1 * c - x2 * sn;
      y2 = x2 * c + x1 * sn;
    }
    const bf16 h1 = __float2bfloat16_rn(y1), h2 = __float2bfloat16_rn(y2);
    sm.qh[r * kLd + i] = h1;
    sm.qh[r * kLd + i + half] = h2;
    sm.ql[r * kLd + i] = __float2bfloat16_rn(y1 - __bfloat162float(h1));
    sm.ql[r * kLd + i + half] = __float2bfloat16_rn(y2 - __bfloat162float(h2));
  }
  for (int idx = threadIdx.x; idx < Sq * half; idx += blockDim.x) {
    const int s = idx / half, i = idx % half;
    const float c = sm.cs[idx], sn = sm.sn[idx];
    const size_t off = (static_cast<size_t>(b) * Sq + s) * tok + kvh * HD;
    const float x1 = to_f(kn[off + i]), x2 = to_f(kn[off + i + half]);
    sm.kw[s * kLd + i] = __float2bfloat16_rn(x1 * c - x2 * sn);
    sm.kw[s * kLd + i + half] = __float2bfloat16_rn(x2 * c + x1 * sn);
  }
  constexpr int kVecs = HD / 8;
  for (int idx = threadIdx.x; idx < Sq * kVecs; idx += blockDim.x) {
    const int s = idx / kVecs, c = idx % kVecs;
    *reinterpret_cast<uint4*>(sm.vw + s * kLd + c * 8) =
        *reinterpret_cast<const uint4*>(
            vn + (static_cast<size_t>(b) * Sq + s) * tok + kvh * HD + c * 8);
  }
}

// Write the window entries g = pos + s with owns(g) back into the
// arenas, in place, 16 bytes at a time.  Needs a __syncthreads() after
// stage_window_mma.
template <int HD, typename Owns>
__device__ void write_window_mma(const DecodeMmaSmem<HD>& sm, bf16* kp,
                                 bf16* vp, const int* tbl, int pos, int Sq,
                                 int bs, int KV, int kvh, Owns owns) {
  constexpr int kLd = DecodeMmaSmem<HD>::kLd, kVecs = HD / 8;
  const size_t tok = static_cast<size_t>(KV) * HD;
  for (int idx = threadIdx.x; idx < Sq * kVecs; idx += blockDim.x) {
    const int s = idx / kVecs, c = idx % kVecs, g = pos + s;
    if (!owns(g)) continue;
    const size_t dst = (static_cast<size_t>(tbl[g / bs]) * bs + g % bs) * tok
                       + kvh * HD + c * 8;
    *reinterpret_cast<uint4*>(kp + dst) =
        *reinterpret_cast<const uint4*>(sm.kw + s * kLd + c * 8);
    *reinterpret_cast<uint4*>(vp + dst) =
        *reinterpret_cast<const uint4*>(sm.vw + s * kLd + c * 8);
  }
}

// One warp's online-softmax state over its keys: rows gid and gid + 8
// of the CTA's 16, the accumulator in the mma's C fragment layout.
template <int HD>
struct MmaState {
  float m[2], l[2], acc[HD / 8][4];

  __device__ void init() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = NEG_INF;
      l[r] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  }
};

// The walk over the chunks of the row's spans first, first + step, ...
// (keys below n_keys), in ascending key order.  prologue() puts the
// ring's first copies in flight, and may come before stage_window_mma
// (the copies skip the window's keys and touch only the rings); run()
// folds the chunks into st, and needs a __syncthreads() after
// stage_window_mma.  lim[i] is the last key that this thread's row
// gid + 8 i sees (at most n_keys - 1).  run() ends with a barrier, after
// which the ring may be overwritten.
template <int HD>
struct SpanWalk {
  static constexpr int kLd = DecodeMmaSmem<HD>::kLd;
  static constexpr int kStage = DecodeMmaSmem<HD>::kStage;
  static constexpr int kVecs = HD / 8, kKs = HD / 16;
  static constexpr int kPer = kDecodeSpan / kDecodeChunk, S = kDecodeStages;

  const DecodeMmaSmem<HD>& sm;
  const bf16 *kp, *vp;
  const int* tbl;
  int bs, kvh, first, step, n_keys, pos, nc;
  size_t tok;                               // arena token stride

  __device__ SpanWalk(const DecodeMmaSmem<HD>& sm_, const bf16* kp_,
                      const bf16* vp_, const int* tbl_, int bs_, int KV,
                      int kvh_, int first_, int step_, int n_keys_, int pos_)
      : sm(sm_), kp(kp_), vp(vp_), tbl(tbl_), bs(bs_), kvh(kvh_),
        first(first_), step(step_), n_keys(n_keys_), pos(pos_), nc(0),
        tok(static_cast<size_t>(KV) * HD) {
    // only the row's last span can be partial
    const int n_span = (n_keys + kDecodeSpan - 1) / kDecodeSpan;
    for (int sp = first; sp < n_span; sp += step)
      nc += min(kPer, (n_keys - sp * kDecodeSpan + kDecodeChunk - 1)
                          / kDecodeChunk);
  }

  __device__ int chunk_key(int c) const {
    return (first + (c / kPer) * step) * kDecodeSpan
           + (c % kPer) * kDecodeChunk;
  }

  __device__ void load(int c) const {
    const int k0 = chunk_key(c);
    bf16* kd = sm.ks + (c % S) * kStage;
    bf16* vd = sm.vs + (c % S) * kStage;
    for (int i = threadIdx.x; i < kDecodeChunk * kVecs;
         i += kDecodeMmaThreads) {
      const int j = i / kVecs, cc = i % kVecs, t = k0 + j;
      if (t >= pos && t < n_keys) continue;       // the window's: overlaid
      const bool ok = t < n_keys;
      const size_t src = ok ? (static_cast<size_t>(tbl[t / bs]) * bs
                               + t % bs) * tok + kvh * HD + cc * 8 : 0;
      cp_async16(kd + j * kLd + cc * 8, kp + src, ok);
      cp_async16(vd + j * kLd + cc * 8, vp + src, ok);
    }
  }

  __device__ void prologue() const {
#pragma unroll
    for (int c = 0; c < S - 1; ++c) {
      if (c < nc) load(c);
      cp_async_commit();
    }
  }

  __device__ void run(MmaState<HD>& st, const int (&lim)[2],
                      float scale_log2) const {
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int tig = lane & 3;
    for (int c = 0; c < nc; ++c) {
      cp_async_wait<S - 2>();                  // chunk c has landed
      const int k0 = chunk_key(c);
      bf16* kst = sm.ks + (c % S) * kStage;
      bf16* vst = sm.vs + (c % S) * kStage;
      if (k0 + kDecodeChunk > pos) {           // the window overlay
        for (int i = tid; i < kDecodeChunk * kVecs; i += kDecodeMmaThreads) {
          const int j = i / kVecs, cc = i % kVecs, t = k0 + j;
          if (t < pos || t >= n_keys) continue;
          *reinterpret_cast<uint4*>(kst + j * kLd + cc * 8) =
              *reinterpret_cast<const uint4*>(sm.kw + (t - pos) * kLd
                                              + cc * 8);
          *reinterpret_cast<uint4*>(vst + j * kLd + cc * 8) =
              *reinterpret_cast<const uint4*>(sm.vw + (t - pos) * kLd
                                              + cc * 8);
        }
      }
      __syncthreads();
      // chunk c + S - 1 goes into the stage chunk c - 1 left, which every
      // warp has finished with at the barrier above (an empty group past
      // the last chunk keeps the count of groups uniform)
      if (c + S - 1 < nc) load(c + S - 1);
      cp_async_commit();

      const int kw0 = k0 + warp * 16;          // this warp's first key
      if (kw0 >= n_keys) continue;             // no row sees these keys
      const bf16* kt = kst + warp * 16 * kLd;
      const bf16* vt = vst + warp * 16 * kLd;
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        uint32_t kb[4], ah[4], al[4];
        ldmatrix_x4(kb, kt + ((lane & 7) + (lane >> 4) * 8) * kLd + kk * 16
                            + ((lane >> 3) & 1) * 8);
        ldmatrix_x4(ah, sm.qh + (lane & 15) * kLd + kk * 16
                            + (lane >> 4) * 8);
        ldmatrix_x4(al, sm.ql + (lane & 15) * kLd + kk * 16
                            + (lane >> 4) * 8);
        mma_bf16(s[0], ah, kb[0], kb[1]);
        mma_bf16(s[0], al, kb[0], kb[1]);
        mma_bf16(s[1], ah, kb[2], kb[3]);
        mma_bf16(s[1], al, kb[2], kb[3]);
      }
      // row gid sees keys <= lim[0], row gid + 8 keys <= lim[1]
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = kw0 + nt * 8 + tig * 2 + (e & 1) <= lim[e >> 1];
          s[nt][e] = ok ? s[nt][e] * scale_log2 : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(st.m[r], quad_max(mx[r]));
        corr[r] = exp2f(st.m[r] - m_new);
        st.m[r] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = kw0 + nt * 8 + tig * 2 + (e & 1) <= lim[e >> 1];
          s[nt][e] = ok ? exp2f(s[nt][e] - st.m[e >> 1]) : 0.f;
          psum[e >> 1] += s[nt][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * corr[r] + psum[r];
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        st.acc[i][0] *= corr[0];
        st.acc[i][1] *= corr[0];
        st.acc[i][2] *= corr[1];
        st.acc[i][3] *= corr[1];
      }
      uint32_t ph[4], pl[4];
      split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
      split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
      split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
      split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < kKs; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd
                                  + dp * 16 + (lane >> 4) * 8);
        mma_bf16(st.acc[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(st.acc[2 * dp + 1], ph, vb[2], vb[3]);
        mma_bf16(st.acc[2 * dp], pl, vb[0], vb[1]);
        mma_bf16(st.acc[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }
};

// Fold the four warps' states in warp order and hand each of the first
// `rows` rows' (m, l, acc[d]) to emit(r, d, m, l, acc), one call per
// (row, dim).  Overwrites the ring; needs SpanWalk::run's closing
// barrier before it.
template <int HD, typename Emit>
__device__ void fold_warps_mma(const DecodeMmaSmem<HD>& sm,
                               const MmaState<HD>& st, int rows, Emit emit) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(st.l[r]);
    if (tig == 0) {
      sm.wm[warp * kDecodeRows + gid + 8 * r] = st.m[r];
      sm.wl[warp * kDecodeRows + gid + 8 * r] = lr;
    }
  }
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    float* row0 = sm.wa + (warp * kDecodeRows + gid) * HD + i * 8 + tig * 2;
    row0[0] = st.acc[i][0];
    row0[1] = st.acc[i][1];
    row0[8 * HD] = st.acc[i][2];
    row0[8 * HD + 1] = st.acc[i][3];
  }
  __syncthreads();
  for (int idx = tid; idx < rows * HD; idx += blockDim.x) {
    const int r = idx / HD, d = idx % HD;
    float mm = NEG_INF, ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeMmaWarps; ++w) {
      const float m_w = sm.wm[w * kDecodeRows + r];
      const float m_new = fmaxf(mm, m_w);
      const float c_old = exp2f(mm - m_new), c_w = exp2f(m_w - m_new);
      ll = ll * c_old + sm.wl[w * kDecodeRows + r] * c_w;
      aa = aa * c_old + sm.wa[(w * kDecodeRows + r) * HD + d] * c_w;
      mm = m_new;
    }
    emit(r, d, mm, ll, aa);
  }
}

// The last key row gid + 8 i of the CTA's tile sees: window query
// (r0 + row) / G sees keys <= pos + s, and no key at or past n_keys.
__device__ inline void row_limits(int (&lim)[2], int r0, int G, int pos,
                                  int n_keys) {
  const int gid = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    lim[i] = min(pos + (r0 + gid + 8 * i) / G, n_keys - 1);
}

}  // namespace repro
