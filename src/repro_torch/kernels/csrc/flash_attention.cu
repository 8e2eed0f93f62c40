// K3 — blockwise online-softmax (flash) attention for prefill on Hopper.
//
// Replaces the JAX package's kernels/flash_attention.py:
// flash_attention_kernel (body _flash_kernel): q [B,S,H,hd] against
// k/v [B,T,KV,hd], GQA (query head h reads kv head h / G), causal and
// sliding-window masks, query row s at absolute position q_offset + s.
//
// The TPU grid carries (m, l, acc) across a sequential k-block grid
// axis; Hopper blocks run in no order.  So one CTA owns one q tile of
// (b, h) and loops over the k blocks itself, with the online-softmax
// state of its rows in registers.
//
// The k-block partition is fixed at absolute multiples of 128, as the
// JAX kernel pads K rather than shrinking the block: a query row's
// accumulation order then depends on its absolute position only, never
// on T, q_offset or the q-tile grouping.  The CTA runs the contiguous
// range of blocks that the causal and window masks leave to any of its
// rows; a block that is fully masked for a row leaves that row's state
// exactly as it was (masked keys get p = 0, the max stays, the rescale
// is exactly 1, the product adds exact zeros), so the suffix rows of a
// q_offset call are bitwise equal to the same rows of the full prefill
// — the chunk invariance chunked prefill rests on.  Every row runs the
// same instruction sequence, so a row's bits do not depend on the batch
// either.  Masked scores are repro::NEG_INF, finite, so no rescale
// meets inf - inf.
//
// bf16 (flash_mma_kernel): one CTA per (64-row q tile, h, b), 4 warps of
// 16 q rows.  The q tile and each 128-key block of K and V are copied
// as bf16 by 16-byte cp.async into shared memory (rows padded by 16
// bytes, so ldmatrix reads no bank twice), K/V through a 2-stage ring:
// block i + 1 is in flight while block i is computed.  S = Q K^T and
// O += P V run on tensor cores, mma.sync m16n8k16 with bf16 operands
// and f32 accumulators, operands by ldmatrix (V transposed on the way);
// a 128-key block is one softmax step.  Row max and row sum are taken
// over the quad of lanes that holds a row, in the same order for every
// row.  The softmax runs in f32 and base 2 on scores pre-scaled by
// log2 e, 2^x on the special-function unit; only a block that crosses
// a mask edge computes masks.  P enters the P V product as a bf16 pair
// hi + lo, two products on the same V fragments: P rounded to bf16
// alone moved the 40-layer bf16 model's logits from the plain path's
// by more than chip_smoke.py's main_vs_plain allows, and the pair
// keeps 16 of P's 24 bits for a third more tensor-core work.  Head
// dims: every multiple of 16 up to 160, one instantiation each.
// Bound on the H100: operations at long prefill, bytes at the serving
// chunk (256 rows over 768 keys at hd 64), against mma.sync's share of
// the 989 TFLOP/s bf16 tensor-core peak (no wgmma yet).  With one
// warp per scheduler the phases of a block (copy issue, Q K^T, softmax,
// P V) run one after another on each warp.

// f32 runs a scalar body (flash_kernel below): one CTA per (b, h,
// 32-row q block), K^T and V staged as f32 in shared memory, scores and
// products by f32 FMAs.  Tensor cores would compute f32 as TF32, so the
// dtype picks the kernel.
#include "common.cuh"
#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: the scalar body, exact f32 arithmetic
// ---------------------------------------------------------------------------

constexpr int kBQ = 32;          // query rows per CTA
constexpr int kRows = 8;         // query rows per warp
constexpr int kBK = 128;         // keys per k block (absolute partition)
constexpr int kKPad = kBK + 1;   // K^T row stride in shared memory
constexpr int kThreads = 128;

template <typename T, int NC>    // NC = ceil(hd / 32) output columns/lane
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
             int H, int KV, int hd, int q_offset, int causal, int window,
             float scale) {
  extern __shared__ float smem[];
  float* kT = smem;                     // [hd][kKPad]
  float* vs = kT + hd * kKPad;          // [kBK][hd]
  float* qs = vs + kBK * hd;            // [kBQ][hd]
  float* ps = qs + kBQ * hd;            // [kBQ][kBK]

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q_start = q_offset + iq * kBQ;    // absolute pos of local row 0

  for (int idx = tid; idx < kBQ * hd; idx += kThreads) {
    const int r = idx / hd, d = idx % hd, s = iq * kBQ + r;
    qs[idx] = s < S ? repro::to_f(
        q[(static_cast<size_t>(b) * S + s) * H * hd + h * hd + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = repro::NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < NC; ++e) acc[r][e] = 0.f;
  }

  const int nk = (Tk + kBK - 1) / kBK;
  for (int kb = 0; kb < nk; ++kb) {
    const int k_start = kb * kBK;
    // block-level skip, as the JAX kernel: the whole block lies in the
    // causal future or behind the window of every row of this CTA
    bool run = true;
    if (causal) run = k_start <= q_start + kBQ - 1;
    if (window) run = run && (k_start + kBK - 1 > q_start - window);
    if (!run) continue;

    __syncthreads();                  // previous tile fully consumed
    for (int idx = tid; idx < kBK * hd; idx += kThreads) {
      const int j = idx / hd, d = idx % hd, t = k_start + j;
      float kv = 0.f, vv = 0.f;
      if (t < Tk) {
        const size_t off =
            (static_cast<size_t>(b) * Tk + t) * KV * hd + kvh * hd + d;
        kv = repro::to_f(k[off]);
        vv = repro::to_f(v[off]);
      }
      kT[d * kKPad + j] = kv;
      vs[j * hd + d] = vv;
    }
    __syncthreads();

    // scores of this warp's 8 rows against keys lane + 32c
    float s[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
    const float* qw = qs + warp * kRows * hd;
    for (int d = 0; d < hd; ++d) {
      float kk[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) kk[c] = kT[d * kKPad + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = qw[r * hd + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] += qv * kk[c];
      }
    }

    float* pw = ps + warp * kRows * kBK;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q_start + warp * kRows + r;
      float mx = repro::NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k_start + lane + 32 * c;
        bool valid = kp < Tk;
        if (causal) valid = valid && kp <= qpos;
        if (window) valid = valid && kp > qpos - window;
        s[r][c] = valid ? s[r][c] * scale : repro::NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = repro::warp_max(mx);
      const float m_new = fmaxf(m[r], mx);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        pw[r * kBK + lane + 32 * c] = p;
        psum += p;
      }
      psum = repro::warp_sum(psum);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + psum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < NC; ++e) acc[r][e] *= corr;
    }
    __syncwarp();

    for (int j = 0; j < kBK; ++j) {
      float vv[NC];
#pragma unroll
      for (int e = 0; e < NC; ++e) {
        const int d = lane + 32 * e;
        vv[e] = d < hd ? vs[j * hd + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = pw[r * kBK + j];
#pragma unroll
        for (int e = 0; e < NC; ++e) acc[r][e] += p * vv[e];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s_row = iq * kBQ + warp * kRows + r;
    if (s_row >= S) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    T* o = out + (static_cast<size_t>(b) * S + s_row) * H * hd + h * hd;
#pragma unroll
    for (int e = 0; e < NC; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) o[d] = repro::from_f<T>(acc[r][e] / l_safe);
    }
  }
}

template <typename T, int NC>
cudaError_t launch_nc(const void* q, const void* k, const void* v,
                      void* out, int B, int S, int Tk, int H, int KV,
                      int hd, int q_offset, int causal, int window,
                      float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (hd * kKPad + kBK * hd + kBQ * hd + kBQ * kBK);
  auto kern = flash_kernel<T, NC>;
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tk, H, KV, hd,
      q_offset, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Tk, int H, int KV, int hd,
                   int q_offset, int causal, int window, float scale,
                   cudaStream_t st) {
  switch ((hd + 31) / 32) {
    case 1: return launch_nc<T, 1>(q, k, v, out, B, S, Tk, H, KV, hd,
                                   q_offset, causal, window, scale, st);
    case 2: return launch_nc<T, 2>(q, k, v, out, B, S, Tk, H, KV, hd,
                                   q_offset, causal, window, scale, st);
    case 3: return launch_nc<T, 3>(q, k, v, out, B, S, Tk, H, KV, hd,
                                   q_offset, causal, window, scale, st);
    case 4: return launch_nc<T, 4>(q, k, v, out, B, S, Tk, H, KV, hd,
                                   q_offset, causal, window, scale, st);
    case 5: return launch_nc<T, 5>(q, k, v, out, B, S, Tk, H, KV, hd,
                                   q_offset, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using repro::bf16;

constexpr int kWarps = 4;
constexpr int kTileQ = 16 * kWarps;   // q rows of a CTA, 16 per warp
constexpr int kStages = 2;            // K/V ring depth, in 128-key blocks
constexpr int kNt = kBK / 8;          // 8-key column tiles of S

template <int HD>
struct FlashTile {
  static constexpr int kLd = repro::padded_ld<HD>();
  // q [kTileQ][kLd], K ring [kStages][kBK][kLd], V ring the same
  static constexpr size_t kBytes =
      sizeof(bf16) * kLd * (kTileQ + 2 * kStages * kBK);
};

// One 128-key block's scores -> probabilities, in place, for the rows
// gid and gid + 8 of a warp: scale to base 2, mask (kMask: the block
// crosses a mask edge of the tile; masked keys get p = 0), fold the
// block's max into m and return the rescale of the old state in corr
// (exactly 1 where the max did not move) and the block's row sums in
// psum (this lane's keys only).
template <bool kMask>
__device__ __forceinline__ void softmax_block(
    float (&s)[kNt][4], float (&m)[2], float (&corr)[2], float (&psum)[2],
    int k_start, const int (&qpos)[2], int Tk, int causal, int window,
    int tig, float scale_log2) {
  float mx[2] = {repro::NEG_INF, repro::NEG_INF};
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool valid = true;
      if (kMask) {
        const int kp = k_start + nt * 8 + tig * 2 + (e & 1);
        const int qp = qpos[e >> 1];
        valid = kp < Tk;
        if (causal) valid = valid && kp <= qp;
        if (window) valid = valid && kp > qp - window;
      }
      s[nt][e] = valid ? s[nt][e] * scale_log2 : repro::NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], repro::quad_max(mx[r]));
    corr[r] = m_new == m[r] ? 1.f : repro::fast_exp2(m[r] - m_new);
    m[r] = m_new;
    psum[r] = 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = repro::fast_exp2(s[nt][e] - m[e >> 1]);
      s[nt][e] = kMask && s[nt][e] == repro::NEG_INF ? 0.f : p;
      psum[e >> 1] += s[nt][e];
    }
}

template <int HD>
__global__ void __launch_bounds__(32 * kWarps)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                 int Tk, int H, int KV, int q_offset, int causal, int window,
                 float scale_log2) {
  constexpr int kLd = FlashTile<HD>::kLd;
  constexpr int kVecs = HD / 8, kKs = HD / 16, kThr = 32 * kWarps;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);
  bf16* ks = qs + kTileQ * kLd;
  bf16* vs = ks + kStages * kBK * kLd;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q_start = q_offset + iq * kTileQ;  // absolute pos of row 0
  const int q_last = q_start + kTileQ - 1;
  const size_t tok = static_cast<size_t>(KV) * HD;

  // the contiguous k blocks some row of the tile sees, as the JAX
  // kernel's block skip: not wholly in the causal future of the tile's
  // last row, not wholly behind the window of its first
  int kb_hi = (Tk + kBK - 1) / kBK - 1;
  if (causal) kb_hi = min(kb_hi, q_last / kBK);
  int kb_lo = 0;
  if (window)
    while (kb_lo <= kb_hi && kb_lo * kBK + kBK - 1 <= q_start - window)
      ++kb_lo;
  const int n_blocks = kb_hi - kb_lo + 1;

  for (int i = tid; i < kTileQ * kVecs; i += kThr) {
    const int r = i / kVecs, c = i % kVecs, s = iq * kTileQ + r;
    const bool ok = s < S;
    const bf16* src = ok ? q + ((static_cast<size_t>(b) * S + s) * H + h)
                               * HD + c * 8 : q;
    repro::cp_async16(qs + r * kLd + c * 8, src, ok);
  }
  auto load_block = [&](int kb, int stage) {
    bf16* kd = ks + stage * kBK * kLd;
    bf16* vd = vs + stage * kBK * kLd;
    for (int i = tid; i < kBK * kVecs; i += kThr) {
      const int j = i / kVecs, c = i % kVecs, t = kb * kBK + j;
      const bool ok = t < Tk;
      const size_t src = ok ? (static_cast<size_t>(b) * Tk + t) * tok
                              + kvh * HD + c * 8 : 0;
      repro::cp_async16(kd + j * kLd + c * 8, k + src, ok);
      repro::cp_async16(vd + j * kLd + c * 8, v + src, ok);
    }
  };
  if (n_blocks > 0) load_block(kb_lo, 0);
  repro::cp_async_commit();

  // rows gid and gid + 8 of this warp's 16
  const int qpos[2] = {q_start + warp * 16 + gid,
                       q_start + warp * 16 + gid + 8};
  float m[2] = {repro::NEG_INF, repro::NEG_INF}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  uint32_t qa[kKs][4];                 // the warp's q rows, A fragments

  for (int i = 0; i < n_blocks; ++i) {
    const int kb = kb_lo + i, stage = i % kStages;
    if (i + 1 < n_blocks) {
      load_block(kb + 1, (i + 1) % kStages);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk)
        repro::ldmatrix_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * kLd
                                       + kk * 16 + (lane >> 4) * 8);
    }
    const bf16* kt = ks + stage * kBK * kLd;
    const bf16* vt = vs + stage * kBK * kLd;

    // S = Q K^T: 16 rows x 128 keys
    float s[kNt][4];
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk)
#pragma unroll
      for (int np = 0; np < kNt / 2; ++np) {
        uint32_t kf[4];
        repro::ldmatrix_x4(kf, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8)
                                   * kLd + kk * 16 + ((lane >> 3) & 1) * 8);
        repro::mma_bf16(s[2 * np], qa[kk], kf[0], kf[1]);
        repro::mma_bf16(s[2 * np + 1], qa[kk], kf[2], kf[3]);
      }

    // masks by absolute position, only where the block crosses an edge:
    // inside, every key is visible to every row of the tile
    const int k_start = kb * kBK;
    const bool inside = k_start + kBK <= Tk
                        && (!causal || k_start + kBK - 1 <= q_start)
                        && (!window || k_start > q_last - window);
    float corr[2], psum[2];
    if (inside)
      softmax_block<false>(s, m, corr, psum, k_start, qpos, Tk, causal,
                           window, tig, scale_log2);
    else
      softmax_block<true>(s, m, corr, psum, k_start, qpos, Tk, causal,
                          window, tig, scale_log2);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      acc[d][0] *= corr[0];
      acc[d][1] *= corr[0];
      acc[d][2] *= corr[1];
      acc[d][3] *= corr[1];
    }

    // O += P V, 16 keys per step; P's A fragment is two S tiles, as a
    // bf16 pair hi + lo (two products on the same V fragments)
#pragma unroll
    for (int kk = 0; kk < kNt / 2; ++kk) {
      uint32_t ph[4], pl[4];
      repro::split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      repro::split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      repro::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      repro::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < kKs; ++dp) {
        uint32_t vf[4];
        repro::ldmatrix_x4_trans(
            vf, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd
                    + dp * 16 + (lane >> 4) * 8);
        repro::mma_bf16(acc[2 * dp], ph, vf[0], vf[1]);
        repro::mma_bf16(acc[2 * dp + 1], ph, vf[2], vf[3]);
        repro::mma_bf16(acc[2 * dp], pl, vf[0], vf[1]);
        repro::mma_bf16(acc[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();                 // the stage is free for block i + 2
  }
  repro::cp_async_wait<0>();         // the q copies, when no block ran

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s_row = iq * kTileQ + warp * 16 + gid + 8 * r;
    const float l_safe = fmaxf(repro::quad_sum(l[r]), 1e-30f);
    if (s_row >= S) continue;
    bf16* o = out + ((static_cast<size_t>(b) * S + s_row) * H + h) * HD;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d)
      *reinterpret_cast<uint32_t*>(o + d * 8 + tig * 2) = repro::pack_bf16(
          acc[d][2 * r] / l_safe, acc[d][2 * r + 1] / l_safe);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, int B, int S, int Tk, int H, int KV,
                       int q_offset, int causal, int window,
                       cudaStream_t stream) {
  const size_t smem = FlashTile<HD>::kBytes;
  auto kern = flash_mma_kernel<HD>;
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kTileQ - 1) / kTileQ, H, B);
  kern<<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, Tk, H, KV,
      q_offset, causal, window,
      repro::kLog2e / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int Tk, int H, int KV,
                        int hd, int q_offset, int causal, int window,
                        cudaStream_t st) {
  return repro::dispatch_head_dim(hd, [&](auto c) {
    return launch_mma<decltype(c)::value>(q, k, v, out, B, S, Tk, H, KV,
                                          q_offset, causal, window, st);
  });
}

}  // namespace

// q, out: [B, S, H, hd]; k, v: [B, T, KV, hd]; contiguous, one dtype;
// hd <= 160, and in bf16 a multiple of 16.  `scale` is the f32 body's;
// the bf16 kernel scales by the same 1/sqrt(hd), in base 2.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int T, int H, int KV, int hd,
                                     int q_offset, int causal, int window,
                                     float scale, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16)
    return launch_bf16(q, k, v, out, B, S, T, H, KV, hd, q_offset, causal,
                       window, st);
  return launch<float>(q, k, v, out, B, S, T, H, KV, hd, q_offset, causal,
                       window, scale, st);
}
