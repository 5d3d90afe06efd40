// The VFA forward's two passes on Hopper's tensor cores (sm_90a, `wgmma`),
// for bf16 and for f32 (3xTF32), in plain CUDA C++ with inline PTX.
//
// Replaces: dalle_pytorch_tpu/kernels/flash_attention.py `_max_kernel_compact`
// (pass 1, gmax) and `_fwd_kernel_compact_vfa` (pass 2, accumulation against
// gmax), launched by `_flash_fwd_compact` with vfa=True.  flash_compact.cu's
// `flash_max_compact_kernel` calls max_block_tc for __nv_bfloat16 and
// max_block_tf32 for float, `flash_fwd_compact_vfa_kernel` vfa_block_tc and
// vfa_block_tf32; the dtype alone picks the body.
//
// Computes, for the 64 query rows a block owns, over the live key tiles of
// its CSR row list (the online compacted forward's list):
//   pass 1  gmax = max over the row's keys of s = scale q.k, -1e30 for a
//           masked key and -inf past n; exactly -1e30 for a row that sees
//           no key.  Written (bh, n) f32, in natural units, as the JAX max
//           pass and `vfa_max_reference` have it.
//   pass 2  p = 2^((s - gmax) log2 e), no running maximum and no rescale;
//           l = sum p; out = P V / max(l, 1e-30) in the input dtype, lse =
//           gmax + log(max(l, 1e-30)).  A row whose gmax is -1e30 saw no key
//           and takes store_dead_rows, as every forward body does.
//
// What bounds it on this card: pass 1 is one matrix product over the live
// tiles (2 * T * 64 * BK * d operations a (batch, head)), pass 2 two (the
// online forward's count).  In bf16, against 989 TFLOP/s, the bytes (q, k
// and gmax for pass 1; q, k, v, gmax, out and lse for pass 2) take longer
// than the products at the flagship's masks (n 1280, d 128, axial_row: 210
// of 420 tiles), so both are bound by bytes; in f32 every product is three
// TF32 ones (165 TFLOP/s, the 1e-4 tolerance), and both are bound by
// operations.
//
// What the design does about it: both passes are the online forward's walk
// (fwd_block_tc, flash_fwd_tc.cuh; fwd_block_tf32, flash_fwd_tf32.cuh) in
// another mode (tc::Walk), so they share its layout: one warpgroup owns the
// 64 query rows, Q is staged once in the swizzled layout (in f32 as hi and
// lo TF32 tiles), the next key tile loads while this one is in the products,
// S = Q K^T is wgmma from shared memory, K-major on both sides, and the mask
// is applied in registers (key_allow, mask_scores, the plain_tile fast
// path).
//   - Pass 1 stages no V (bf16: tc::Sizes<D, false>, Q, the K ring and the
//     pattern's; f32: tc::Tf32Sizes<D, false>, Q's and K's hi and lo tiles
//     and the pattern's ring, so two blocks share an SM at d 128, where
//     pass 2 has one) and runs no exp and no second product; each thread
//     keeps the maximum over its own columns, and the row's four threads
//     join once, at the end.
//   - Both passes compute S in the same function (scores_tc; in f32
//     scores_tf32, the same split and the same three products in the same
//     order) with the same scale after the product, and mask in natural
//     units (-1e30, not -1e30 * log2 e), so a row that sees no key gets
//     gmax = -1e30 exactly and the row's largest score gives s - gmax = 0
//     exactly in pass 2 (__fsub_rn and __fmul_rn: no fused multiply-add
//     rounds it otherwise): p = 1 there and l >= 1 on every live row.  A
//     max pass of one TF32 product would be a third of the work but lose
//     both: its gmax would no longer be pass 2's largest score, and would
//     miss the max pass's 1e-4.
//   - Pass 2 is the online tile with the rescale taken out (walk_step): p in
//     f32, l sums the f32 p; P is rounded to bf16 in place as the A fragment
//     of O += P V (V read MN-major), or in f32 split into TF32 hi and lo in
//     registers against V^T's permuted keys (KvRegs).
//
// What remains: the pattern test runs in both passes (the masked bodies
// spend about what the dead tiles save on it), the two passes are two
// launches that read q and k twice (in f32 each also splits K twice), and no
// warp specialisation or TMA.
#pragma once

#include "flash_fwd_tf32.cuh"

namespace flash {

// The block's tiles in dynamic shared memory for the max pass: Q, K and the
// pattern's, no V; the bf16 body's (tc::Sizes) or the f32 body's
// (tc::Tf32Sizes).  The fixed-max pass takes the forward's (FwdSizes).
template <typename T, int D>
using MaxSizes = std::conditional_t<std::is_same<T, float>::value, tc::Tf32Sizes<D, false>, tc::Sizes<D, false>>;

// VFA pass 1 for the block's 64 query rows over `tiles`: writes gmax (bh,
// n) f32.  Launched with tc::kThreads threads and MaxSizes<bf16, D>::kSmem
// bytes of dynamic shared memory, kSmemMasked with a pattern.
template <int D>
__device__ __forceinline__ void max_block_tc(const __nv_bfloat16* __restrict__ q,
                                             const __nv_bfloat16* __restrict__ k, float* __restrict__ gmax,
                                             const Problem& p, const TileList& tiles) {
  fwd_block_tc<D, tc::Walk::kMax>(q, k, nullptr, nullptr, gmax, p, tiles);
}

// the same for f32, 3xTF32: MaxSizes<float, D>
template <int D>
__device__ __forceinline__ void max_block_tf32(const float* __restrict__ q, const float* __restrict__ k,
                                               float* __restrict__ gmax, const Problem& p, const TileList& tiles) {
  fwd_block_tf32<D, tc::Walk::kMax>(q, k, nullptr, nullptr, gmax, p, tiles);
}

// VFA pass 2 for the block's 64 query rows over `tiles`, gmax read from
// p.lse: writes out (bf16) and lse.  Launched with tc::kThreads threads and
// FwdSizes<bf16, D>::kSmem bytes of dynamic shared memory, kSmemMasked with
// a pattern.
template <int D>
__device__ __forceinline__ void vfa_block_tc(const __nv_bfloat16* __restrict__ q,
                                             const __nv_bfloat16* __restrict__ k,
                                             const __nv_bfloat16* __restrict__ v,
                                             __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                                             const Problem& p, const TileList& tiles) {
  fwd_block_tc<D, tc::Walk::kFixed>(q, k, v, out, lse, p, tiles);
}

// the same for f32, 3xTF32: out in f32, FwdSizes<float, D>
template <int D>
__device__ __forceinline__ void vfa_block_tf32(const float* __restrict__ q, const float* __restrict__ k,
                                               const float* __restrict__ v, float* __restrict__ out,
                                               float* __restrict__ lse, const Problem& p, const TileList& tiles) {
  fwd_block_tf32<D, tc::Walk::kFixed>(q, k, v, out, lse, p, tiles);
}

}  // namespace flash
