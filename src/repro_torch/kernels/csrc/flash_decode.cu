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
// read at all, so the work follows the row's length.  The streaming
// loop is decode_attend.cuh's, shared with K4 and K5.
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
#include "decode_attend.cuh"

namespace {

using repro::DecodeSmem;

template <typename T>
__global__ void __launch_bounds__(repro::kDecodeThreads)
fused_decode_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                    const T* __restrict__ vn, T* __restrict__ kp,
                    T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ positions,
                    const float* __restrict__ freqs, T* __restrict__ out,
                    int Sq, int H, int KV, int hd, int bs, int P) {
  extern __shared__ float smem[];
  const int G = H / KV, R = Sq * G, T_len = P * bs;
  const DecodeSmem sm(smem, hd, R, Sq);
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int pos = positions[b];
  const int* tbl = tables + static_cast<size_t>(b) * P;

  // 1. rotate the window; 2. write this kv head's window entries back
  repro::stage_window<T>(sm, q, kn, vn, freqs, b, kvh, pos, Sq, H, KV, hd);
  repro::init_state(sm, R, hd);
  __syncthreads();
  repro::write_window<T>(sm, kp, vp, tbl, pos, Sq, 0, T_len, bs, KV, kvh,
                         hd);

  // 3. stream keys 0 .. pos+S'-1 with an online softmax
  const int n_keys = min(T_len, pos + Sq);
  repro::attend_keys<T>(sm, kp, vp, tbl, bs, KV, kvh, hd, 0, n_keys, pos, R,
                        G, pos, 1.0f / sqrtf(static_cast<float>(hd)));

  for (int idx = threadIdx.x; idx < R * hd; idx += blockDim.x) {
    const int r = idx / hd, d = idx % hd, s = r / G, g = r % G;
    out[((static_cast<size_t>(b) * Sq + s) * H + kvh * G + g) * hd + d] =
        repro::from_f<T>(sm.acc[idx] / sm.ls[r]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kn, const void* vn, void* kp,
                   void* vp, const void* tables, const void* positions,
                   const void* freqs, void* out, int B, int Sq, int H,
                   int KV, int hd, int bs, int P, cudaStream_t stream) {
  const size_t smem = DecodeSmem::bytes(hd, Sq * (H / KV), Sq);
  auto kern = fused_decode_kernel<T>;
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(KV, B);
  kern<<<grid, repro::kDecodeThreads, smem, stream>>>(
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
