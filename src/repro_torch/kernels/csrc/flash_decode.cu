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
// Bound on the H100: bytes.  Each key and value of the row is read once
// and used for ~4 operations per query row; at S' <= 8 window queries
// per kv head that is far below the card's operations-per-byte balance.
// The TPU body stages the whole row [T,KV,hd] in VMEM (4.7 MB at
// minicpm_2b's width and max_len 512, beyond an SM's 227 KB), and one
// CTA per (row, kv head) streaming the row leaves most SMs idle at few
// kv heads (32 CTAs at qwen3_32b's 8 kv heads and 4 rows).
//
// bf16 (fused_decode_mma_kernel): one launch, no partials in device
// memory, a row's keys spread over the SMs by a thread-block cluster.
// A cluster of kCluster CTAs owns (kv head, 16-row tile of the R = S'G
// query rows, row b).  CTA rank c folds the 256-key spans c, c + N,
// c + 2N, ... of the row (N = kCluster) with the span body of
// decode_mma.cuh (cp.async ring, window overlay, mma.sync with Q and P
// as bf16 pairs hi + lo, f32 base-2 softmax), folds its four warps in
// warp order, and after cluster.sync() the ranks read each other's
// (m, l, acc) through distributed shared memory: the max over the ranks
// first, then their rescaled sums in ascending rank order, each rank
// writing a share of the tile's outputs.  A second cluster.sync() keeps
// every CTA's shared memory alive until the reads end.  A rank with no
// span takes part in both barriers and the writes, but its state (the
// neutral m = NEG_INF, l = 0, which would add exact zeros) is not read.
// A row of one span skips the exchange: rank 0 writes the output, with
// the bits the exchange would give.  The cluster size is a constant
// (4: 8 and 2 were slower at minicpm_2b's and qwen3_32b's decode shapes,
// tools/time_decode_variants.py), never chosen from the batch, the table
// or the card, so a row alone is bitwise equal to its row of the batch.
//
// Rows past 16 go to further tiles (further clusters), which read the
// row's K/V again, mostly from L2.  One CTA holding every tile would read
// K/V once but needs an accumulator per tile: 64 f32 registers a thread
// per tile at hd 128, 192 for qwen3_32b's verify window of 40 rows.
//
// f32 (fused_decode_kernel): the exact-f32 scalar body, one CTA per
// (row, kv head) streaming the keys 64 at a time through shared memory
// (decode_attend.cuh).  Tensor cores would compute f32 as TF32, so the
// dtype picks the kernel.
//
// Window write-back.  Each window position is written once, by the
// rank whose span holds it, of the first row tile.  Keys at window
// positions are taken from the rotated, rounded window in shared
// memory, never from the arena, so the reads never depend on the order
// of the in-place writes.  Trash block 0 and inactive rows follow the
// JAX contract: a row whose window pages resolve to block 0 gets finite
// but unspecified output, block 0's content is unspecified afterwards,
// and window positions at or past P*bs are not written.
//
// The online softmax sums in another order than the fully gathered
// plain version (fused_flash_decode_ref): the two agree to tolerance,
// not bitwise.
#include <cooperative_groups.h>

#include "decode_attend.cuh"
#include "decode_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using repro::bf16;
using repro::DecodeSmem;

// CTAs of one cluster (tools/time_decode_variants.py compares others)
constexpr int kCluster = 4;
static_assert(kCluster >= 1 && kCluster <= 8, "a portable cluster size");

template <int HD>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(repro::kDecodeMmaThreads)
fused_decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kn,
                        const bf16* __restrict__ vn, bf16* __restrict__ kp,
                        bf16* __restrict__ vp, const int* __restrict__ tables,
                        const int* __restrict__ positions,
                        const float* __restrict__ freqs, bf16* __restrict__ out,
                        int Sq, int H, int KV, int bs, int P,
                        float scale_log2) {
  using Smem = repro::DecodeMmaSmem<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm(smem, Sq);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int G = H / KV, R = Sq * G;
  const int tiles = (R + repro::kDecodeRows - 1) / repro::kDecodeRows;
  const int ht = blockIdx.x / kCluster, kvh = ht / tiles;
  const int r0 = (ht % tiles) * repro::kDecodeRows, b = blockIdx.y;
  const int pos = positions[b], T_len = P * bs;
  const int n_keys = min(T_len, pos + Sq);
  const int n_span = (n_keys + repro::kDecodeSpan - 1) / repro::kDecodeSpan;
  const int* tbl = tables + static_cast<size_t>(b) * P;

  repro::MmaState<HD> st;
  st.init();
  if (rank < n_span) {                 // this rank owns at least one span
    const repro::SpanWalk<HD> walk(sm, kp, vp, tbl, bs, KV, kvh, rank,
                                   kCluster, n_keys, pos);
    walk.prologue();                   // copies in flight while staging
    repro::stage_window_mma<HD>(sm, q, kn, vn, freqs, b, kvh, r0, pos, Sq,
                                H, KV);
    __syncthreads();
    if (r0 == 0)
      repro::write_window_mma<HD>(
          sm, kp, vp, tbl, pos, Sq, bs, KV, kvh, [&](int g) {
            return g < T_len && (g / repro::kDecodeSpan) % kCluster == rank;
          });
    int lim[2];
    repro::row_limits(lim, r0, G, pos, n_keys);
    walk.run(st, lim, scale_log2);
  }
  const int rows = min(repro::kDecodeRows, R - r0);
  auto out_at = [&](int r, int d) {
    const int row = r0 + r, s = row / G, g = row % G;
    return out + ((static_cast<size_t>(b) * Sq + s) * H + kvh * G + g) * HD
           + d;
  };
  if (n_span == 1) {
    // rank 0 alone holds keys and writes the output: the exchange would
    // give it the same bits (weight exp2f(0) == 1, the others' 0)
    if (rank == 0)
      repro::fold_warps_mma<HD>(sm, st, rows,
                                [&](int r, int d, float, float l, float a) {
                                  *out_at(r, d) = __float2bfloat16_rn(a / l);
                                });
    return;                            // no rank reads another's memory
  }
  if (rank < n_span)
    repro::fold_warps_mma<HD>(sm, st, rows,
                              [&](int r, int d, float m, float l, float a) {
                                if (d == 0) {
                                  sm.fm[r] = m;
                                  sm.fl[r] = l;
                                }
                                sm.fa[r * HD + d] = a;
                              });
  cluster.sync();

  // the tile's outputs, shared out over the ranks; a rank with no span
  // would add exact zeros, so only the first n_span ranks are read
  const int ranks = min(kCluster, n_span);
  for (int idx = rank * blockDim.x + threadIdx.x; idx < rows * HD;
       idx += kCluster * blockDim.x) {
    const int r = idx / HD;
    float m = repro::NEG_INF;
    for (int c = 0; c < ranks; ++c)
      m = fmaxf(m, cluster.map_shared_rank(sm.fm, c)[r]);
    float l = 0.f, a = 0.f;
    for (int c = 0; c < ranks; ++c) {
      const float w = exp2f(cluster.map_shared_rank(sm.fm, c)[r] - m);
      l += cluster.map_shared_rank(sm.fl, c)[r] * w;
      a += cluster.map_shared_rank(sm.fa, c)[idx] * w;
    }
    *out_at(r, idx % HD) = __float2bfloat16_rn(a / l);
  }
  cluster.sync();                      // the ranks' reads are done
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* kn, const void* vn,
                       void* kp, void* vp, const void* tables,
                       const void* positions, const void* freqs, void* out,
                       int B, int Sq, int H, int KV, int bs, int P,
                       cudaStream_t stream) {
  const size_t smem = repro::DecodeMmaSmem<HD>::bytes(Sq);
  auto kern = fused_decode_mma_kernel<HD>;
  cudaError_t err = repro::allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int R = Sq * (H / KV);
  const int tiles = (R + repro::kDecodeRows - 1) / repro::kDecodeRows;
  const float scale_log2 = repro::kLog2e / sqrtf(static_cast<float>(HD));
  kern<<<dim3(kCluster * KV * tiles, B), repro::kDecodeMmaThreads, smem,
         stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kn),
      static_cast<const bf16*>(vn), static_cast<bf16*>(kp),
      static_cast<bf16*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<const float*>(freqs),
      static_cast<bf16*>(out), Sq, H, KV, bs, P, scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the scalar body, exact f32 arithmetic
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(repro::kDecodeThreads)
fused_decode_kernel(const float* __restrict__ q, const float* __restrict__ kn,
                    const float* __restrict__ vn, float* __restrict__ kp,
                    float* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ positions,
                    const float* __restrict__ freqs, float* __restrict__ out,
                    int Sq, int H, int KV, int hd, int bs, int P) {
  extern __shared__ float fsmem[];
  const int G = H / KV, R = Sq * G, T_len = P * bs;
  const DecodeSmem sm(fsmem, hd, R, Sq);
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int pos = positions[b];
  const int* tbl = tables + static_cast<size_t>(b) * P;

  // 1. rotate the window; 2. write this kv head's window entries back
  repro::stage_window<float>(sm, q, kn, vn, freqs, b, kvh, pos, Sq, H, KV,
                             hd);
  repro::init_state(sm, R, hd);
  __syncthreads();
  repro::write_window<float>(sm, kp, vp, tbl, pos, Sq, 0, T_len, bs, KV, kvh,
                             hd);

  // 3. stream keys 0 .. pos+S'-1 with an online softmax
  const int n_keys = min(T_len, pos + Sq);
  repro::attend_keys<float>(sm, kp, vp, tbl, bs, KV, kvh, hd, 0, n_keys, pos,
                            R, G, pos, 1.0f / sqrtf(static_cast<float>(hd)));

  for (int idx = threadIdx.x; idx < R * hd; idx += blockDim.x) {
    const int r = idx / hd, d = idx % hd, s = r / G, g = r % G;
    out[((static_cast<size_t>(b) * Sq + s) * H + kvh * G + g) * hd + d] =
        sm.acc[idx] / sm.ls[r];
  }
}

cudaError_t launch_f32(const void* q, const void* kn, const void* vn,
                       void* kp, void* vp, const void* tables,
                       const void* positions, const void* freqs, void* out,
                       int B, int Sq, int H, int KV, int hd, int bs, int P,
                       cudaStream_t stream) {
  const size_t smem = DecodeSmem::bytes(hd, Sq * (H / KV), Sq);
  cudaError_t err = repro::allow_smem(fused_decode_kernel, smem);
  if (err != cudaSuccess) return err;
  fused_decode_kernel<<<dim3(KV, B), repro::kDecodeThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kn),
      static_cast<const float*>(vn), static_cast<float*>(kp),
      static_cast<float*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<const float*>(freqs),
      static_cast<float*>(out), Sq, H, KV, hd, bs, P);
  return cudaGetLastError();
}

}  // namespace

// q, out: [B,S',H,hd]; k_new, v_new: [B,S',KV,hd]; k_pages, v_pages:
// [NB,bs,KV,hd] (updated in place); tables: [B,P] int32; positions: [B]
// int32; freqs: [hd/2] f32.  Contiguous, one dtype for q/k/v/arenas;
// bf16 needs hd a multiple of 16 up to 160.
extern "C" int repro_fused_flash_decode(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* tables, const void* positions,
    const void* freqs, void* out, int B, int Sq, int H, int KV, int hd,
    int bs, int P, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16)
    return repro::dispatch_head_dim(hd, [&](auto c) {
      return launch_mma<decltype(c)::value>(q, k_new, v_new, k_pages,
                                            v_pages, tables, positions,
                                            freqs, out, B, Sq, H, KV, bs, P,
                                            st);
    });
  return launch_f32(q, k_new, v_new, k_pages, v_pages, tables, positions,
                    freqs, out, B, Sq, H, KV, hd, bs, P, st);
}
