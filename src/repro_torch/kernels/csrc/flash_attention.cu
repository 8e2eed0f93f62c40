// K3 — blockwise online-softmax (flash) attention for prefill on Hopper.
//
// Replaces the JAX package's kernels/flash_attention.py:
// flash_attention_kernel (body _flash_kernel): q [B,S,H,hd] against
// k/v [B,T,KV,hd], GQA (query head h reads kv head h / G), causal and
// sliding-window masks, query row s at absolute position q_offset + s.
//
// The TPU grid carries (m, l, acc) across a sequential k-block grid
// axis; Hopper blocks run in no order.  So one CTA owns one
// (b, h, 32-row q block) and loops over the k blocks itself, with the
// online-softmax state of its rows in registers (4 warps x 8 rows).
// Each k block stages K^T (padded rows: conflict-free column reads)
// and V in shared memory as f32.
//
// The k-block partition is fixed at absolute multiples of 128, as the
// JAX kernel pads K rather than shrinking the block: a query row's
// accumulation order then depends on its absolute position only, never
// on T, q_offset or the q-block grouping.  A block that is fully masked
// for a row adds exact zeros (exp(NEG_INF - m) == 0, rescale by
// exp(0) == 1), and one skipped for the whole CTA adds nothing, so the
// suffix rows of a q_offset call are bitwise equal to the same rows of
// the full prefill — the chunk invariance chunked prefill rests on.
// Every row runs the same instruction sequence, so a row's bits do not
// depend on the batch either.
//
// Bound on the H100: at prefill lengths (S = T <= a few thousand,
// hd = 64) attention is a small share of the layer, and this first
// kernel computes with f32 FMAs from shared memory (no mma/wgmma yet):
// it is bound by its own issue rate, far above the card's bound.
#include "common.cuh"

namespace {

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

}  // namespace

// q, out: [B, S, H, hd]; k, v: [B, T, KV, hd]; contiguous, one dtype;
// hd <= 160.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int S,
                                     int T, int H, int KV, int hd,
                                     int q_offset, int causal, int window,
                                     float scale, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(q, k, v, out, B, S, T, H, KV, hd, q_offset,
                                 causal, window, scale, st);
  return launch<float>(q, k, v, out, B, S, T, H, KV, hd, q_offset, causal,
                       window, scale, st);
}
