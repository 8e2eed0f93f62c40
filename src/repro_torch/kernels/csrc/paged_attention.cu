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
// The TPU body stages the whole row [P*bs, KV, hd] in VMEM and runs one
// gathered softmax on the last page.  As K2, one CTA owns one (row,
// kv head) — the G query heads of the group — and streams the row's
// keys 0..pos 64 at a time through shared memory with an online softmax
// (decode_attend.cuh, the loop K2 and K4 share, here without a window
// overlay).  Keys past pos are neither read nor computed.  Masking is
// by position alone, as in the JAX kernel: a row's table holds the
// trash block 0 only past its last page, so block 0 is read only by
// rows whose table is all zero (inactive slots), whose output is finite
// but unspecified.  The streaming softmax agrees with the gathered plain
// version (paged_attention_ref) to f32 reduction-order tolerance.
//
// Bound on the H100: bytes — each key and value of the row is read once
// and used for ~4 operations per query head.
#include "decode_attend.cuh"

namespace {

using repro::DecodeSmem;

template <typename T>
__global__ void __launch_bounds__(repro::kDecodeThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ tables,
                       const int* __restrict__ positions, T* __restrict__ out,
                       int H, int KV, int hd, int bs, int P) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const DecodeSmem sm(smem, hd, G, 0);
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int pos = positions[b];
  const int* tbl = tables + static_cast<size_t>(b) * P;

  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x)
    sm.qr[idx] = repro::to_f(
        q[(static_cast<size_t>(b) * H + kvh * G) * hd + idx]);
  repro::init_state(sm, G, hd);
  __syncthreads();
  const int n_keys = min(P * bs, pos + 1);
  repro::attend_keys<T>(sm, kp, vp, tbl, bs, KV, kvh, hd, 0, n_keys, INT_MAX,
                        G, G, pos, 1.0f / sqrtf(static_cast<float>(hd)));

  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x)
    out[(static_cast<size_t>(b) * H + kvh * G) * hd + idx] =
        repro::from_f<T>(sm.acc[idx] / sm.ls[idx / hd]);
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tables, const void* positions, void* out,
                   int B, int H, int KV, int hd, int bs, int P,
                   cudaStream_t stream) {
  const size_t smem = DecodeSmem::bytes(hd, H / KV, 0);
  auto kern = paged_attention_kernel<T>;
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(KV, B), repro::kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<T*>(out), H, KV, hd,
      bs, P);
  return cudaGetLastError();
}

}  // namespace

// q, out: [B,H,hd]; k_pages, v_pages: [NB,bs,KV,hd]; tables: [B,P]
// int32; positions: [B] int32.  Contiguous, one dtype for q and arenas.
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages, const void* tables,
                                     const void* positions, void* out, int B,
                                     int H, int KV, int hd, int bs, int P,
                                     int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, tables, positions, out,
                                 B, H, KV, hd, bs, P, st);
  return launch<float>(q, k_pages, v_pages, tables, positions, out, B, H, KV,
                       hd, bs, P, st);
}
