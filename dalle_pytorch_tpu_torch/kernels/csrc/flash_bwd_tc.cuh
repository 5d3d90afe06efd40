// The flash-attention dk/dv body for bf16 on Hopper's tensor cores
// (sm_90a, `wgmma`), in plain CUDA C++ with inline PTX.
//
// Replaces, for bf16 inputs: dalle_pytorch_tpu/kernels/flash_attention.py
// `_dkv_kernel` (dense grid, flash_bwd.cu) and `_dkv_kernel_compact`
// (compacted grid, flash_compact.cu).  Both entries call dkv_block_tc for
// __nv_bfloat16 and dkv_block (flash_tiles.cuh, f32 FMA units) for float;
// the dtype alone picks the body.  dkv_block_tc visits the query tiles
// dkv_block visits, in the same order (the block's TileList and, when a row
// of the (batch, head) sees no key, the tiles off the list that hold one), so
// the compacted grid still equals the dense grid with the same mask bit for
// bit.
//
// Computes, for the 64 keys a block owns, over its query tiles:
//   s^T = scale k q^T, masked as the forward masks it;  p = exp(s - lse);
//   dp^T = v do^T;  ds = p (dp - delta);
//   dv = sum p^T do,  dk = scale sum ds^T q.
//
// What bounds it on this card: four matrix products, 8 * n * n * d
// operations per (batch, head), halved by causality and cut further by a
// pattern, against 989 TFLOP/s of bf16 tensor cores; the bytes (q, k, v, do,
// dk and dv once, lse and delta) are two orders of magnitude smaller.  Beside
// the products, one exp per score on the SFU.
//
// What the design does about it:
//   - One warpgroup (128 threads) owns the block's 64 keys, wgmma's M.
//     S^T = K Q^T and dP^T = V dO^T are wgmma m64n{BQ}k16 with A = the
//     block's K or V tile and B = the query tile's Q or dO, all from shared
//     memory, K-major.  dV += P^T dO and dK += dS^T Q are wgmma
//     m64n{64|32}k16 with A in registers (the S^T and dP^T accumulator
//     fragments, turned into p and ds and converted to bf16 in place: an
//     m64 x n(BQ) accumulator has the layout of the m64 x k(BQ) A fragment)
//     and B = the same dO and Q tiles read MN-major (the transpose bit).  So
//     each query tile is staged once, in flash_tc.cuh's swizzled layout, and
//     serves as both operands.
//   - Registers: a block of 128 threads lets each hold 255.  The dK and dV
//     accumulators take D of them (128 at d 128), S^T and dP^T BQ / 2 each;
//     chip_smoke.py's environment phase fails if an instantiation spills.
//   - K and V are staged once per block.  A ring of two stages holds the
//     next query tile's Q, dO, lse and delta (and, with a pattern, its
//     bytes) while this one is in the products (cp.async, zero-filled past
//     n: a query row past n has zero q and do, so its p (1 or 0) meets zero
//     do and a zero ds, and adds exact zeros).
//   - Precision: q is staged raw, never as q * scale rounded to bf16; scale
//     * log2(e) multiplies the f32 S^T after the product, p = 2^(s - lse
//     log2(e)) and ds are f32, only the dV and dK products see them rounded
//     to bf16, both accumulators are f32, and dk takes the scale once, at the
//     store.
//   - The mask in registers, branch-free, with dkv_tile's rule: -1e30 for a
//     causal-future query (query < key), a padded key (a property of the
//     accumulator's row) or a pair the pattern forbids, -inf for a key past
//     n.  The pattern is staged as its rows (the queries): element (key r,
//     query c) reads byte r of staged row c.  A tile wholly below the
//     diagonal with no pattern, no key padding and no key past n skips the
//     test.
//   - Rows that see no key have lse = -1e30 and take p = 1 for each of their
//     keys, as `_dense_recompute_grads` has it: a masked score is the f32
//     product -1e30 * log2(e), the same product lse * log2(e) gives
//     (__fmul_rn: no fused multiply-add rounds either otherwise), so their
//     difference is exactly 0.
//
// What remains: no warp specialisation (the one warpgroup issues the loads,
// the four products and the exps in turn), no TMA, the products S^T and dP^T
// of N = 32 at d 128 (the tile shape the tables and the other bodies share),
// and delta still a torch op before the launch.
#pragma once

#include "flash_tc.cuh"

namespace flash {
namespace tc {

template <int D>
struct DkvSizes {
  static constexpr int BQ = inner_tile<D>();
  static constexpr uint32_t kKV = kTileRows * D * 2;  // bytes of the K or the V tile
  static constexpr uint32_t kQ = BQ * D * 2;          // bytes of one Q or dO tile
  static constexpr uint32_t kRows = 2 * BQ * 4;       // one stage's lse and delta
  static constexpr uint32_t kMaskRow = mask_row<kTileRows>();  // a staged pattern row (a query)
  static constexpr uint32_t kMask = BQ * kMaskRow;
  // offsets in the dynamic shared memory: K, V, the Q ring, the dO ring, the
  // lse/delta ring, and with a pattern its ring
  static constexpr uint32_t kQRing = 2 * kKV;
  static constexpr uint32_t kDoRing = kQRing + kStages * kQ;
  static constexpr uint32_t kRowRing = kDoRing + kStages * kQ;
  static constexpr int kSmem = kRowRing + kStages * kRows;
  static constexpr int kSmemMasked = kSmem + kStages * kMask;
};

// Masks S^T (scaled into base 2) in registers, as dkv_tile does: for key row
// rr and query column 8j + col + e, `neg` (-1e30 * log2(e)) for a
// causal-future query or a pair `allow` does not have (bit 2j + e: the
// pattern allows it and the key is not padded), -inf for a key past n.
template <int BQ, bool kPlain>
__device__ __forceinline__ void mask_scores_t(float (&s)[BQ / 2], const Frag& f, const Problem& p, int i0,
                                              int k0, float sc, float neg, const uint32_t (&allow)[2]) {
  const bool causal = p.causal != 0;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = k0 + f.rows[rr];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * rr + e;
        const float x = s[i] * sc;
        if constexpr (kPlain) {
          s[i] = x;
        } else {
          const int query = i0 + 8 * j + f.col + e;
          const bool masked = (((allow[rr] >> (2 * j + e)) & 1u) == 0u) | (causal & (query < key));
          s[i] = key >= p.n ? -INFINITY : (masked ? neg : x);
        }
      }
    }
  }
}

// One query tile (stage of the ring at q_tile, do_tile, rows: lse then
// delta, ms: its pattern bytes or null) for the block's 64 keys: S^T, dP^T,
// mask, p and ds, then dV += P^T dO and dK += dS^T Q.  `keep[rr]` is 0 for a
// padded key, all ones otherwise.
template <int D>
__device__ __forceinline__ void dkv_tile_tc(const Problem& p, int i0, int k0, uint32_t k_tile, uint32_t v_tile,
                                            uint32_t q_tile, uint32_t do_tile, const float* rows,
                                            const uint8_t* ms, const Frag& f, const uint32_t (&keep)[2],
                                            float (&dk)[D <= 64 ? 1 : D / 64][D <= 64 ? D / 2 : 32],
                                            float (&dv)[D <= 64 ? 1 : D / 64][D <= 64 ? D / 2 : 32]) {
  constexpr int BQ = inner_tile<D>();
  constexpr int NB = D <= 64 ? 1 : D / 64;  // dV and dK products per query step (64 channels each)

  // the pattern bytes of this thread's pairs, read before the products so
  // that they hide them: staged row c (a query) starts at its own shift
  uint32_t allow[2] = {keep[0], keep[1]};
  const bool use_mask = p.mask != nullptr;
  if (use_mask) {
    const uint32_t mask_lo = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p.mask));
    uint32_t bits[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + f.col + e;
        const uint8_t* mrow =
            ms + c * DkvSizes<D>::kMaskRow + ((mask_lo + static_cast<uint32_t>((i0 + c) * p.n)) & 15u);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) bits[rr] |= static_cast<uint32_t>(mrow[f.rows[rr]] != 0) << (2 * j + e);
      }
    allow[0] &= bits[0];
    allow[1] &= bits[1];
  }

  float s[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    mma_ss(s, kmajor_desc<D, kTileRows>(k_tile, ks), kmajor_desc<D, BQ>(q_tile, ks), ks > 0);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    mma_ss(dp, kmajor_desc<D, kTileRows>(v_tile, ks), kmajor_desc<D, BQ>(do_tile, ks), ks > 0);
  wgmma_commit();
  wgmma_wait();
  hold(s);
  hold(dp);

  const float sc = p.scale * kLog2e;
  const float neg = __fmul_rn(kNeg, kLog2e);
  const bool plain = !(use_mask | (p.kmask != nullptr)) & (k0 + kTileRows <= p.n) &
                     ((p.causal == 0) | (i0 >= k0 + kTileRows - 1));
  if (plain)
    mask_scores_t<BQ, true>(s, f, p, i0, k0, sc, neg, allow);
  else
    mask_scores_t<BQ, false>(s, f, p, i0, k0, sc, neg, allow);

  // p = 2^(s - lse log2 e), ds = p (dp - delta), in place
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + f.col + e;
      const float lse2 = __fmul_rn(rows[c], kLog2e);
      const float delta = rows[BQ + c];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = 4 * j + 2 * rr + e;
        const float pr = ex2(s[i] - lse2);
        dp[i] = pr * (dp[i] - delta);
        s[i] = pr;
      }
    }

  // P^T and dS^T as the A fragments of the dV and dK products: k-step ks
  // holds query columns 16ks .. 16ks + 15, the accumulator's groups 2ks and
  // 2ks + 1
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
  for (int ks = 0; ks < BQ / 16; ++ks)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      pa[ks][t] = pack_bf16(s[8 * ks + 2 * t], s[8 * ks + 2 * t + 1]);
      da[ks][t] = pack_bf16(dp[8 * ks + 2 * t], dp[8 * ks + 2 * t + 1]);
    }

  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BQ / 16; ++ks)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      mma_rs(dv[nb], pa[ks], mnmajor_desc<D, BQ>(do_tile, ks, nb));
      mma_rs(dk[nb], da[ks], mnmajor_desc<D, BQ>(q_tile, ks, nb));
    }
  wgmma_commit();
  wgmma_wait();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    hold(dv[nb]);
    hold(dk[nb]);
  }
#pragma unroll
  for (int ks = 0; ks < BQ / 16; ++ks) {
    hold(pa[ks]);
    hold(da[ks]);
  }
}

}  // namespace tc

// dk and dv (bf16) for the block's 64 keys over `tiles` (query tiles) on the
// tensor cores; when a row of this (batch, head) sees no key, also over the
// query tiles off the list that hold such a row, as dkv_block does.
// Launched with tc::kThreads threads and tc::DkvSizes<D>::kSmem bytes of
// dynamic shared memory, kSmemMasked with a pattern.
template <int D>
__device__ __forceinline__ void dkv_block_tc(const __nv_bfloat16* __restrict__ q,
                                             const __nv_bfloat16* __restrict__ k,
                                             const __nv_bfloat16* __restrict__ v,
                                             const __nv_bfloat16* __restrict__ dout,
                                             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                                             const Problem& p, const TileList& tiles, int ntiles) {
  using namespace tc;
  constexpr int BQ = inner_tile<D>();
  constexpr int NB = D <= 64 ? 1 : D / 64;
  constexpr int NO = D <= 64 ? D : 64;  // channels of one dV or dK product
  using S = DkvSizes<D>;
  // the swizzled tiles need 1024-byte alignment
  extern __shared__ __align__(1024) uint8_t dynamic_smem[];
  const uint32_t k_tile = static_cast<uint32_t>(__cvta_generic_to_shared(dynamic_smem));
  if (k_tile & 1023u) __trap();
  const uint32_t v_tile = k_tile + S::kKV;
  const bool use_mask = p.mask != nullptr;

  const int k0 = blockIdx.x * kTileRows;
  const Frag f = frag();
  uint32_t keep[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = k0 + f.rows[rr];
    keep[rr] = (key < p.n && p.kmask != nullptr && p.kmask[key] <= 0) ? 0u : ~0u;
  }

  const __nv_bfloat16* qb = q + p.base;
  const __nv_bfloat16* dob = dout + p.base;
  // Q, dO, lse, delta and the pattern of query tile t into stage s of their
  // rings (lse and delta are 0 past n)
  auto stage_tile = [&](int t, int s) {
    const int i0 = t * BQ;
    stage_rows<D, BQ>(qb, i0, p.n, k_tile + S::kQRing + s * S::kQ);
    stage_rows<D, BQ>(dob, i0, p.n, k_tile + S::kDoRing + s * S::kQ);
    for (int idx = threadIdx.x; idx < 2 * BQ; idx += tc::kThreads) {
      const int row = i0 + idx % BQ;
      cp_async4(k_tile + S::kRowRing + s * S::kRows + 4 * idx,
                (idx < BQ ? p.lse : p.delta) + min(row, p.n - 1), row < p.n);
    }
    if (use_mask) stage_mask<BQ, kTileRows>(p.mask, p.n, i0, k0, k_tile + S::kSmem + s * S::kMask);
  };
  stage_rows<D, kTileRows>(k + p.base, k0, p.n, k_tile);
  stage_rows<D, kTileRows>(v + p.base, k0, p.n, v_tile);

  bool dead = false;
  for (int t = threadIdx.x; t < p.n; t += tc::kThreads) dead = dead || p.lse[t] <= kDeadLse;
  const bool dead_rows = __syncthreads_or(dead);
  // the next query tile: the list's; with a row that sees no key every tile
  // in order, those off the list only where they hold one
  int cur = tiles.begin, scan = -1;
  auto next = [&](int& tile) -> bool {
    if (!dead_rows) return tiles.next(cur, tile);
    while (++scan < ntiles) {
      if (!tiles.take(cur, scan)) {
        bool holds = false;
        for (int t = threadIdx.x; t < BQ; t += tc::kThreads) {
          const int qrow = scan * BQ + t;
          holds = holds || (qrow < p.n && p.lse[qrow] <= kDeadLse);
        }
        if (!__syncthreads_or(holds)) continue;
      }
      tile = scan;
      return true;
    }
    return false;
  };

  int it = 0;
  bool have = next(it);
  if (have) stage_tile(it, 0);
  cp_async_commit();

  float dk_acc[NB][NO / 2], dv_acc[NB][NO / 2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) dk_acc[nb][i] = dv_acc[nb][i] = 0.f;

  int stage = 0;
  while (have) {
    int nt = 0;
    const bool more = next(nt);
    if (more) stage_tile(nt, stage ^ 1);  // into the other stage, freed by the last barrier
    cp_async_commit();
    cp_async_wait_prev();  // all but the group just committed: this tile (and K, V)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();
    dkv_tile_tc<D>(p, it * BQ, k0, k_tile, v_tile, k_tile + S::kQRing + stage * S::kQ,
                   k_tile + S::kDoRing + stage * S::kQ,
                   reinterpret_cast<const float*>(dynamic_smem + S::kRowRing + stage * S::kRows),
                   dynamic_smem + S::kSmem + stage * S::kMask, f, keep, dk_acc, dv_acc);
    __syncthreads();  // this stage is no longer read
    it = nt;
    have = more;
    stage ^= 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // K and V alone were staged when the list is empty

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = k0 + f.rows[rr];
    if (key >= p.n) continue;
    __nv_bfloat16* dk_row = dk + p.base + static_cast<size_t>(key) * D;
    __nv_bfloat16* dv_row = dv + p.base + static_cast<size_t>(key) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < NO / 8; ++j) {
        const int i = 4 * j + 2 * rr;
        *reinterpret_cast<uint32_t*>(dk_row + nb * NO + 8 * j + f.col) =
            pack_bf16(dk_acc[nb][i] * p.scale, dk_acc[nb][i + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dv_row + nb * NO + 8 * j + f.col) = pack_bf16(dv_acc[nb][i], dv_acc[nb][i + 1]);
      }
  }
}

}  // namespace flash
