// The flash-attention forward body for bf16 on Hopper's tensor cores
// (sm_90a, `wgmma`), in plain CUDA C++ with inline PTX.
//
// Replaces, for bf16 inputs: dalle_pytorch_tpu/kernels/flash_attention.py
// `_fwd_kernel` (dense grid, flash_fwd.cu) and `_fwd_kernel_compact`
// (compacted grid, flash_compact.cu).  Both entries call fwd_block_tc for
// __nv_bfloat16 and fwd_block (flash_tiles.cuh, f32 FMA units) for float;
// the dtype alone picks the body.  fwd_block_tc walks the same TileList as
// fwd_block, so the compacted grid still equals the dense grid with the same
// mask bit for bit.
//
// What bounds it on this card: the two matrix products, 4 * n * n * d
// operations per (batch, head), halved by causality and cut further by a
// pattern, against 989 TFLOP/s of bf16 tensor cores; the bytes (q, k, v and
// out once, lse) are two orders of magnitude smaller.  Beside the products,
// one exp per score on the SFU (16 a clock per SM) costs about as much as
// the products at d 64.
//
// What the design does about it:
//   - One warpgroup (128 threads) owns the block's 64 query rows, wgmma's M.
//     S = Q K^T is wgmma m64n{BK}k16 with A = Q and B = the K tile, both
//     from shared memory, K-major.  O += P V is wgmma m64n{64|32}k16 with A
//     = P in registers (the S accumulator fragment converted to bf16 in
//     place: it has the A fragment's layout) and B = the V tile, MN-major
//     (the transpose bit).
//   - Q, K and V are staged as bf16, never widened, in one shared-memory
//     layout: the channels in rows of 128 bytes (64 at d 32) under the
//     matching swizzle, so the same tile serves as a K-major operand (Q, K)
//     and as an MN-major one (V).  The next key tile's K and V load
//     (cp.async, zero-filled past n) while this one is in the products: a
//     ring of two stages.
//   - The S accumulator is masked in registers with fwd_tile's rule (-1e30
//     for a causal-future, padded or pattern-forbidden key, -inf past n),
//     branch-free per score; a tile wholly below the diagonal with no
//     pattern and no key padding skips the test.  The pattern's bytes for
//     the tile travel with K and V (cp.async into a ring beside theirs); the
//     key-padding flags are loaded before the product, which hides them.
//   - The online softmax runs once per key tile, in base 2: S is multiplied
//     by scale * log2(e) in f32 after the product (q is never rounded to
//     bf16 with the scale in it, which would move lse by ~2^-9 relative at
//     d 128), p = 2^(s - m) in f32, l sums the f32 p, and only the PV
//     product sees p rounded to bf16.  Each thread keeps l over its own
//     columns; the row's four threads join at the end.
//   - Rows that see no key go to store_dead_rows, as in every forward body.
//
// The layout, descriptor, wgmma, staging and masking helpers are
// flash_tc.cuh's, shared with the dq body (flash_dq_tc.cuh, which masks in
// this orientation too) and the dk/dv body (flash_bwd_tc.cuh).
//
// What remains: no warp specialisation (the one warpgroup issues the loads,
// both products and the softmax in turn; other blocks on the SM fill its
// gaps), no persistent blocks, no TMA, and the 64 x 32 tile at d 128, whose
// QK^T product is a small N = 32 (kernels/flash_attention.py's tables and
// the f32 body share the tile constants).
#pragma once

#include "flash_tc.cuh"

namespace flash {
namespace tc {

template <int D>
struct Sizes {
  static constexpr int BK = inner_tile<D>();
  static constexpr uint32_t kQ = kTileRows * D * 2;  // bytes of the Q tile
  static constexpr uint32_t kKV = BK * D * 2;        // bytes of one K or V tile
  static constexpr uint32_t kMaskRow = mask_row<BK>();  // a staged pattern row
  static constexpr uint32_t kMask = kTileRows * kMaskRow;
  // the dynamic shared memory a block asks for: Q, the K and V rings, and
  // with a pattern its ring
  static constexpr int kTiles = kQ + 2 * kStages * kKV;
  static constexpr int kSmem = kTiles;
  static constexpr int kSmemMasked = kTiles + kStages * kMask;
};

// One key tile (stage `stage` of the ring) of the online softmax for the
// block's 64 query rows: S = Q K^T, mask, rescale, O += P V.  `ms` is the
// tile's staged pattern (null without one).
template <int D>
__device__ __forceinline__ void fwd_tile_tc(const Problem& p, int q0, int k0, uint32_t q_tile,
                                            uint32_t k_tile, uint32_t v_tile, const uint8_t* ms,
                                            const Frag& f,
                                            float (&o)[D <= 64 ? 1 : D / 64][D <= 64 ? D / 2 : 32],
                                            float (&m)[2], float (&l)[2]) {
  constexpr int BK = inner_tile<D>();
  constexpr int NB = D <= 64 ? 1 : D / 64;  // PV products per key step (64 channels each)

  // read before the product, which hides them
  uint32_t allow[2];
  key_allow<BK>(p, ms, f, k0, allow);

  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    mma_ss(s, kmajor_desc<D, kTileRows>(q_tile, ks), kmajor_desc<D, BK>(k_tile, ks), ks > 0);
  wgmma_commit();
  wgmma_wait();
  hold(s);

  const float sc = p.scale * kLog2e;
  if (plain_tile<BK>(p, q0, k0))
    mask_scores<BK, true>(s, f, p, q0, k0, sc, kNeg, allow);
  else
    mask_scores<BK, false>(s, f, p, q0, k0, sc, kNeg, allow);

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float mx = m[rr];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * rr], s[4 * j + 2 * rr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // a row at -1e30 so far has alpha = 1 while its scores stay -1e30, and
    // 0 at its first real score, which clears what the masked keys added
    const float alpha = ex2(m[rr] - mx);
    l[rr] *= alpha;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < (D <= 64 ? D : 64) / 8; ++j) {
        o[nb][4 * j + 2 * rr] *= alpha;
        o[nb][4 * j + 2 * rr + 1] *= alpha;
      }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pr = ex2(s[4 * j + 2 * rr + e] - mx);
        l[rr] += pr;
        s[4 * j + 2 * rr + e] = pr;
      }
    m[rr] = mx;
  }

  // P as the A fragments of the PV product: k-step ks holds columns
  // 16ks .. 16ks + 15, the S fragment's groups 2ks and 2ks + 1
  uint32_t a[BK / 16][4];
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
    for (int t = 0; t < 4; ++t) a[ks][t] = pack_bf16(s[8 * ks + 2 * t], s[8 * ks + 2 * t + 1]);

  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_rs(o[nb], a[ks], mnmajor_desc<D, BK>(v_tile, ks, nb));
  wgmma_commit();
  wgmma_wait();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) hold(o[nb]);
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) hold(a[ks]);
}

}  // namespace tc

// The bf16 forward for the block's 64 query rows over `tiles`, on the tensor
// cores; writes out (bf16) and lse = m + log(max(l, 1e-30)), rows that saw
// no key through store_dead_rows.  Launched with tc::kThreads threads and
// tc::Sizes<D>::kTiles bytes of dynamic shared memory, kSmemMasked with a
// pattern.
template <int D>
__device__ __forceinline__ void fwd_block_tc(const __nv_bfloat16* __restrict__ q,
                                             const __nv_bfloat16* __restrict__ k,
                                             const __nv_bfloat16* __restrict__ v,
                                             __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                                             const Problem& p, const TileList& tiles) {
  using namespace tc;
  constexpr int BK = inner_tile<D>();
  constexpr int NB = D <= 64 ? 1 : D / 64;
  constexpr int NO = D <= 64 ? D : 64;  // channels of one PV product
  using S = Sizes<D>;
  // the swizzled tiles need 1024-byte alignment
  extern __shared__ __align__(1024) uint8_t dynamic_smem[];
  const uint32_t q_tile = static_cast<uint32_t>(__cvta_generic_to_shared(dynamic_smem));
  if (q_tile & 1023u) __trap();
  const uint32_t k_ring = q_tile + S::kQ;
  const uint32_t v_ring = k_ring + kStages * S::kKV;
  const uint32_t mask_ring = q_tile + S::kTiles;
  const bool use_mask = p.mask != nullptr;

  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kTileRows;
  Frag f = frag();
  mask_shifts(p, q0, f);

  const __nv_bfloat16* kb = k + p.base;
  const __nv_bfloat16* vb = v + p.base;
  // K, V and the pattern of key tile t into stage s of their rings
  auto stage_tile = [&](int t, int s) {
    stage_rows<D, BK>(kb, t * BK, p.n, k_ring + s * S::kKV);
    stage_rows<D, BK>(vb, t * BK, p.n, v_ring + s * S::kKV);
    if (use_mask) stage_mask<kTileRows, BK>(p.mask, p.n, q0, t * BK, mask_ring + s * S::kMask);
  };
  stage_rows<D, kTileRows>(q + p.base, q0, p.n, q_tile);
  int cur = tiles.begin, jt = 0;
  bool have = tiles.next(cur, jt);
  if (have) stage_tile(jt, 0);
  cp_async_commit();

  float o[NB][NO / 2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) o[nb][i] = 0.f;
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};

  int stage = 0;
  while (have) {
    int jn = 0;
    const bool more = tiles.next(cur, jn);
    if (more) stage_tile(jn, stage ^ 1);  // into the other stage, freed by the last barrier
    cp_async_commit();
    cp_async_wait_prev();  // all but the group just committed: this tile (and Q)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();
    fwd_tile_tc<D>(p, q0, jt * BK, q_tile, k_ring + stage * S::kKV, v_ring + stage * S::kKV,
                   dynamic_smem + S::kTiles + stage * S::kMask, f, o, m, l);
    __syncthreads();  // this stage is no longer read
    jt = jn;
    have = more;
    stage ^= 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // Q alone was staged when the list is empty

  __shared__ uint8_t dead_rows[kTileRows];
  bool any_dead = false;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    const int row = q0 + f.rows[rr];
    const bool live_row = row < p.n;
    const bool dead = live_row && m[rr] == kNeg;
    if (lane % 4 == 0) dead_rows[f.rows[rr]] = dead;
    any_dead |= dead;
    if (live_row && !dead) {
      const float lc = fmaxf(l[rr], 1e-30f);
      __nv_bfloat16* o_row = out + p.base + static_cast<size_t>(row) * D;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int j = 0; j < NO / 8; ++j)
          *reinterpret_cast<uint32_t*>(o_row + nb * NO + 8 * j + f.col) =
              pack_bf16(o[nb][4 * j + 2 * rr] / lc, o[nb][4 * j + 2 * rr + 1] / lc);
      if (lane % 4 == 0) lse[p.base / D + row] = m[rr] * kLn2 + logf(lc);
    }
  }
  if (__syncthreads_or(any_dead)) store_dead_rows<__nv_bfloat16, D>(v, out, lse, p, q0, dead_rows);
}

}  // namespace flash
