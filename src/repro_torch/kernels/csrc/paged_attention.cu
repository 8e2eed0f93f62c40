// K5 — paged decode attention on Hopper.
//
// Replaces the JAX package's kernels/paged_attention.py:
// paged_attention_kernel (body _paged_kernel): one query per row,
// q [B,H,hd] (already rotated), attends the row's keys idx <= pos,
// reached through its block table tables [B,P] in the [NB,bs,KV,hd]
// arenas, GQA h -> h / G, scale 1/sqrt(f32(hd)), f32 softmax.  No RoPE
// and no scatter: the caller has written the new token into its tail
// block first (models/attention.py _paged_decode).
//
// Bound on the H100: bytes — each key and value of the row is read once
// and used for ~4 operations per query head.  The TPU body stages the
// whole row in VMEM and runs one gathered softmax; here the row's keys
// are split across CTAs so that every SM streams, and each CTA keeps
// its copies in flight while it computes.
//
// bf16 (paged_mma_kernel + paged_combine_kernel, one K5 call):
//   1. grid (kv head x 16-head tile, row, split), as K4: split j owns
//      the absolute key positions [256 j, 256 j + 256).  The number of
//      splits follows the table width, ceil(P * bs / 256), never
//      `positions`, so the host never waits on the device; a CTA whose
//      span starts past pos exits at once.  The span is walked 64 keys
//      at a time, each key's page found through the row's block table,
//      K and V copied as bf16 by 16-byte cp.async into a 2-stage ring
//      (chunk i + 1 in flight while chunk i is computed).  Warp w takes
//      keys 16w..16w+15 of every chunk: S = Q K^T and O += P V run on
//      tensor cores (mma.sync m16n8k16, operands by ldmatrix, V
//      transposed on the way) with the G query heads of the kv head as
//      the 16 A rows, zero-padded (G is 8 at qwen3_32b, 1 at
//      minicpm_2b: the kernel is bound by bytes, so the padded rows
//      cost tensor-core cycles that are idle anyway).  Scores, the
//      online softmax (base 2, scores pre-scaled by log2 e) and the
//      accumulators stay f32; P enters the P V product as a bf16 pair
//      hi + lo (two products on the same V fragments, 16 of P's 24
//      bits; free here, where the tensor cores wait on bytes).  The
//      four warps' states are folded in warp order and stored as the
//      split's f32 partials (m, l, acc).
//   2. paged_combine_kernel, grid (kv head, row, 128 outputs), one
//      thread per output element: the active splits' max, then their
//      rescaled partials summed in ascending split order.
//   The sequence of operations on a row depends on its own keys only:
//   each row alone is bitwise equal to its row of the batch.
//
// f32 runs a scalar body (paged_attention_kernel below): one CTA per
// (row, kv head) streaming the keys 0..pos 64 at a time through shared
// memory with an online softmax in exact f32 (decode_attend.cuh, the
// loop K2 and K4 share, here without a window overlay).  Tensor cores
// would compute f32 as TF32, so the dtype picks the kernel.
//
// Masking is by position alone, as in the JAX kernel: a row's table
// holds the trash block 0 only past its last page, so block 0 is read
// only by rows whose table is all zero (inactive slots), whose output
// is finite but unspecified.
#include "decode_attend.cuh"
#include "mma.cuh"

namespace {

using repro::bf16;
using repro::DecodeSmem;

constexpr int kSpan = 256;      // keys of one split
constexpr int kChunk = 64;      // keys of one ring stage
constexpr int kStages = 2;
constexpr int kHeads = 16;      // query heads of one CTA: the mma's M
constexpr int kThreads = 128;   // 4 warps, 16 keys of each chunk each
static_assert(kSpan % kChunk == 0, "split span must be whole chunks");
static_assert(kChunk == 16 * (kThreads / 32), "a warp takes 16 keys");

template <int HD>
struct PagedTile {
  static constexpr int kLd = repro::padded_ld<HD>();
  static constexpr int kStage = kChunk * kLd;           // bf16 elements
  // q [kHeads][kLd], K ring [kStages][kChunk][kLd], V ring the same;
  // at the end the warps' f32 states (m, l, acc) overlay it
  static constexpr size_t kRing = sizeof(bf16) * (kHeads * kLd
                                                  + 2 * kStages * kStage);
  static constexpr size_t kMerge = sizeof(float) * 4 * kHeads * (HD + 2);
  static constexpr size_t kBytes = kRing > kMerge ? kRing : kMerge;
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
paged_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                 const bf16* __restrict__ vp, const int* __restrict__ tables,
                 const int* __restrict__ positions, float* __restrict__ part,
                 int H, int KV, int bs, int P, int NS, float scale_log2) {
  using Tile = PagedTile<HD>;
  constexpr int kLd = Tile::kLd, kVecs = HD / 8, kKs = HD / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kHeads * kLd;
  bf16* vs = ks + kStages * Tile::kStage;

  const int G = H / KV, tiles = (G + kHeads - 1) / kHeads;
  const int kvh = blockIdx.x / tiles, g0 = (blockIdx.x % tiles) * kHeads;
  const int b = blockIdx.y, sp = blockIdx.z;
  const int pos = positions[b];
  const int n_keys = min(P * bs, pos + 1);
  const int lo = sp * kSpan;
  if (lo >= n_keys) return;              // span past the row: no work
  const int hi = min(lo + kSpan, n_keys);
  const int nc = (hi - lo + kChunk - 1) / kChunk;
  const int* tbl = tables + static_cast<size_t>(b) * P;
  const size_t tok = static_cast<size_t>(KV) * HD;   // arena token stride
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // the query heads g0.. of the group, zero past G
  for (int i = tid; i < kHeads * kVecs; i += kThreads) {
    const int r = i / kVecs, c = i % kVecs;
    const bool ok = g0 + r < G;
    const bf16* src = ok ? q + (static_cast<size_t>(b) * H + kvh * G + g0
                                + r) * HD + c * 8 : q;
    repro::cp_async16(qs + r * kLd + c * 8, src, ok);
  }
  auto load_chunk = [&](int c, int stage) {
    const int k0 = lo + c * kChunk;
    bf16* kd = ks + stage * Tile::kStage;
    bf16* vd = vs + stage * Tile::kStage;
    for (int i = tid; i < kChunk * kVecs; i += kThreads) {
      const int j = i / kVecs, cc = i % kVecs, t = k0 + j;
      const bool ok = t < hi;
      const size_t src = ok ? (static_cast<size_t>(tbl[t / bs]) * bs
                               + t % bs) * tok + kvh * HD + cc * 8 : 0;
      repro::cp_async16(kd + j * kLd + cc * 8, kp + src, ok);
      repro::cp_async16(vd + j * kLd + cc * 8, vp + src, ok);
    }
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {      // the ring's prologue
    if (c < nc) load_chunk(c, c);
    repro::cp_async_commit();
  }

  uint32_t qa[kKs][4];
  float m[2] = {repro::NEG_INF, repro::NEG_INF}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int c = 0; c < nc; ++c) {
    // chunk c + kStages - 1 in flight while chunk c is computed (an
    // empty group past the span keeps the count of groups uniform)
    if (c + kStages - 1 < nc)
      load_chunk(c + kStages - 1, (c + kStages - 1) % kStages);
    repro::cp_async_commit();
    repro::cp_async_wait<kStages - 1>();
    __syncthreads();
    if (c == 0) {
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk)
        repro::ldmatrix_x4(qa[kk], qs + (lane & 15) * kLd + kk * 16
                                       + (lane >> 4) * 8);
    }
    const int kw = lo + c * kChunk + warp * 16;   // this warp's first key
    if (kw < hi) {
      const bf16* kt = ks + (c % kStages) * Tile::kStage + warp * 16 * kLd;
      const bf16* vt = vs + (c % kStages) * Tile::kStage + warp * 16 * kLd;
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        uint32_t kb[4];
        repro::ldmatrix_x4(kb, kt + ((lane & 7) + (lane >> 4) * 8) * kLd
                                   + kk * 16 + ((lane >> 3) & 1) * 8);
        repro::mma_bf16(s[0], qa[kk], kb[0], kb[1]);
        repro::mma_bf16(s[1], qa[kk], kb[2], kb[3]);
      }
      // keys past the span get p = 0 exactly; rows gid, gid + 8
      float mx[2] = {repro::NEG_INF, repro::NEG_INF};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = kw + nt * 8 + tig * 2 + (e & 1) < hi;
          s[nt][e] = ok ? s[nt][e] * scale_log2 : repro::NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], repro::quad_max(mx[r]));
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = kw + nt * 8 + tig * 2 + (e & 1) < hi;
          s[nt][e] = ok ? exp2f(s[nt][e] - m[e >> 1]) : 0.f;
          psum[e >> 1] += s[nt][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        acc[i][0] *= corr[0];
        acc[i][1] *= corr[0];
        acc[i][2] *= corr[1];
        acc[i][3] *= corr[1];
      }
      uint32_t ph[4], pl[4];
      repro::split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
      repro::split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
      repro::split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
      repro::split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < kKs; ++dp) {
        uint32_t vb[4];
        repro::ldmatrix_x4_trans(vb, vt + ((lane & 7) + ((lane >> 3) & 1) * 8)
                                              * kLd + dp * 16
                                          + (lane >> 4) * 8);
        repro::mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
        repro::mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
        repro::mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
        repro::mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();                 // the stage is free for the next load
  }

  // fold the four warps' states in warp order; the ring is free
  float* wm = reinterpret_cast<float*>(smem);     // [4][kHeads]
  float* wl = wm + 4 * kHeads;                    // [4][kHeads]
  float* wa = wl + 4 * kHeads;                    // [4][kHeads][HD]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = repro::quad_sum(l[r]);
    if (tig == 0) {
      wm[warp * kHeads + gid + 8 * r] = m[r];
      wl[warp * kHeads + gid + 8 * r] = lr;
    }
  }
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    float* row0 = wa + (warp * kHeads + gid) * HD + i * 8 + tig * 2;
    row0[0] = acc[i][0];
    row0[1] = acc[i][1];
    row0[8 * HD] = acc[i][2];
    row0[8 * HD + 1] = acc[i][3];
  }
  __syncthreads();
  const int rows = min(kHeads, G - g0);
  float* dst = part + ((static_cast<size_t>(b) * KV + kvh) * NS + sp)
                      * G * (HD + 2);
  for (int idx = tid; idx < rows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    float mm = repro::NEG_INF, ll = 0.f, aa = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float m_w = wm[w * kHeads + r];
      const float m_new = fmaxf(mm, m_w);
      const float c_old = exp2f(mm - m_new), c_w = exp2f(m_w - m_new);
      ll = ll * c_old + wl[w * kHeads + r] * c_w;
      aa = aa * c_old + wa[(w * kHeads + r) * HD + d] * c_w;
      mm = m_new;
    }
    if (d == 0) {
      dst[g0 + r] = mm;
      dst[G + g0 + r] = ll;
    }
    dst[2 * G + (g0 + r) * HD + d] = aa;
  }
}

// Combine the active splits' partials of (kv head, row), one output
// element (head g, dim d) per thread: the splits' max first, then their
// rescaled (l, acc) summed in ascending split order.  The two passes
// keep the loads of the second independent of each other, so they
// overlap instead of waiting on a running max.
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part,
                     const int* __restrict__ positions, bf16* __restrict__ out,
                     int H, int KV, int hd, int T_len, int NS) {
  const int G = H / KV, kvh = blockIdx.x, b = blockIdx.y;
  const int idx = blockIdx.z * blockDim.x + threadIdx.x;    // g * hd + d
  if (idx >= G * hd) return;
  const int g = idx / hd;
  const int n_keys = min(T_len, positions[b] + 1);
  const int n_split = (n_keys + kSpan - 1) / kSpan;
  const size_t stride = static_cast<size_t>(G) * (hd + 2);
  const float* src = part + (static_cast<size_t>(b) * KV + kvh) * NS * stride;
  float m = repro::NEG_INF;
  for (int sp = 0; sp < n_split; ++sp) m = fmaxf(m, src[sp * stride + g]);
  float l = 0.f, a = 0.f;
#pragma unroll 4
  for (int sp = 0; sp < n_split; ++sp) {
    const float* ps = src + sp * stride;
    const float w = exp2f(ps[g] - m);
    l += ps[G + g] * w;
    a += ps[2 * G + idx] * w;
  }
  out[(static_cast<size_t>(b) * H + kvh * G) * hd + idx] =
      repro::from_f<bf16>(a / l);
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* kp, const void* vp,
                       const void* tables, const void* positions, void* part,
                       void* out, int B, int H, int KV, int bs, int P, int NS,
                       cudaStream_t stream) {
  const size_t smem = PagedTile<HD>::kBytes;
  auto kern = paged_mma_kernel<HD>;
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (H / KV + kHeads - 1) / kHeads;
  const float scale_log2 = repro::kLog2e / sqrtf(static_cast<float>(HD));
  kern<<<dim3(KV * tiles, B, NS), kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<float*>(part), H, KV,
      bs, P, NS, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int outs = H / KV * HD;
  paged_combine_kernel<<<dim3(KV, B, (outs + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int*>(positions),
      static_cast<bf16*>(out), H, KV, HD, P * bs, NS);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* kp, const void* vp,
                        const void* tables, const void* positions, void* part,
                        void* out, int B, int H, int KV, int hd, int bs,
                        int P, int NS, cudaStream_t st) {
  return repro::dispatch_head_dim(hd, [&](auto c) {
    return launch_mma<decltype(c)::value>(q, kp, vp, tables, positions, part,
                                          out, B, H, KV, bs, P, NS, st);
  });
}

// ---------------------------------------------------------------------------
// f32: the scalar body, exact f32 arithmetic
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(repro::kDecodeThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ kp,
                       const float* __restrict__ vp,
                       const int* __restrict__ tables,
                       const int* __restrict__ positions,
                       float* __restrict__ out, int H, int KV, int hd, int bs,
                       int P) {
  extern __shared__ float fsmem[];
  const int G = H / KV;
  const DecodeSmem sm(fsmem, hd, G, 0);
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int pos = positions[b];
  const int* tbl = tables + static_cast<size_t>(b) * P;

  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x)
    sm.qr[idx] = q[(static_cast<size_t>(b) * H + kvh * G) * hd + idx];
  repro::init_state(sm, G, hd);
  __syncthreads();
  const int n_keys = min(P * bs, pos + 1);
  repro::attend_keys<float>(sm, kp, vp, tbl, bs, KV, kvh, hd, 0, n_keys,
                            INT_MAX, G, G, pos,
                            1.0f / sqrtf(static_cast<float>(hd)));

  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x)
    out[(static_cast<size_t>(b) * H + kvh * G) * hd + idx] =
        sm.acc[idx] / sm.ls[idx / hd];
}

cudaError_t launch_f32(const void* q, const void* kp, const void* vp,
                       const void* tables, const void* positions, void* out,
                       int B, int H, int KV, int hd, int bs, int P,
                       cudaStream_t stream) {
  const size_t smem = DecodeSmem::bytes(hd, H / KV, 0);
  cudaError_t err = repro::allow_smem(paged_attention_kernel, smem);
  if (err != cudaSuccess) return err;
  paged_attention_kernel<<<dim3(KV, B), repro::kDecodeThreads, smem,
                           stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp),
      static_cast<const float*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<float*>(out), H, KV,
      hd, bs, P);
  return cudaGetLastError();
}

}  // namespace

// The split span, for the wrapper's partials buffer.
extern "C" int repro_paged_span() { return kSpan; }

// q, out: [B,H,hd]; k_pages, v_pages: [NB,bs,KV,hd]; tables: [B,P]
// int32; positions: [B] int32.  Contiguous, one dtype for q and arenas.
// bf16: part is f32 scratch of B*KV*NS*G*(hd+2) with NS = ceil(P*bs /
// span), hd a multiple of 16 up to 160.  f32: part and NS are unused.
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages, const void* tables,
                                     const void* positions, void* part,
                                     void* out, int B, int H, int KV, int hd,
                                     int bs, int P, int NS, int dtype,
                                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16)
    return launch_bf16(q, k_pages, v_pages, tables, positions, part, out, B,
                       H, KV, hd, bs, P, NS, st);
  return launch_f32(q, k_pages, v_pages, tables, positions, out, B, H, KV,
                    hd, bs, P, st);
}
