// The flash-attention dq body for bf16 on Hopper's tensor cores (sm_90a,
// `wgmma`), in plain CUDA C++ with inline PTX, with the backward's delta
// computed in it.
//
// Replaces, for bf16 inputs: dalle_pytorch_tpu/kernels/flash_attention.py
// `_dq_kernel` (dense grid, flash_bwd.cu) and `_dq_kernel_compact`
// (compacted grid, flash_compact.cu), and the delta = rowsum(do * out) that
// `_flash_bwd` and `_flash_bwd_compact` compute in XLA before them.  Both
// entries call dq_block_tc for __nv_bfloat16 and dq_block (flash_tiles.cuh,
// f32 FMA units, the same delta prologue) for float; the dtype alone picks
// the body.  dq_block_tc visits the key tiles dq_block visits, in the same
// order (the block's TileList, or every key tile when a row of the block
// sees no key), so the compacted grid still equals the dense grid with the
// same mask bit for bit.
//
// Computes, for the 64 query rows a block owns:
//   delta = rowsum(do * out), or do . sum_j v_j for a row that sees no key
//           (`_dense_recompute_grads`), written for the dk/dv pass;
//   over its key tiles:  s = scale q k^T, masked as the forward masks it;
//   p = exp(s - lse);  dp = do v^T;  ds = p (dp - delta);  dq = scale sum ds k.
//
// What bounds it on this card: three matrix products, 6 * n * n * d
// operations per (batch, head), halved by causality and cut further by a
// pattern, against 989 TFLOP/s of bf16 tensor cores; the bytes (q, k, v, do,
// out and dq once, lse and delta) are two orders of magnitude smaller.
// Beside the products, one exp per score on the SFU.
//
// What the design does about it:
//   - One warpgroup (128 threads) owns the block's 64 query rows, wgmma's M,
//     as the forward body does.  S = Q K^T and dP = dO V^T are wgmma
//     m64n{BK}k16 with A = the block's Q or dO tile and B = the key tile's K
//     or V, all from shared memory, K-major.  dQ += dS K is wgmma
//     m64n{64|32}k16 with A in registers (the dP accumulator fragment turned
//     into ds and converted to bf16 in place: an m64 x n(BK) accumulator has
//     the layout of the m64 x k(BK) A fragment) and B = the same K tile read
//     MN-major (the transpose bit).  So each key tile is staged once, in
//     flash_tc.cuh's swizzled layout, and its K serves as both operands.
//   - Registers: the dQ accumulator takes D / 2 of them (64 at d 128, two
//     64-channel products), S and dP BK / 2 each; chip_smoke.py's
//     environment phase fails if an instantiation spills.
//   - Q and dO are staged once per block.  A ring of two stages holds the
//     next key tile's K and V (and, with a pattern, its bytes) while this
//     one is in the products (cp.async, zero-filled past n).  lse and delta
//     of the thread's two accumulator rows stay in registers.
//   - delta before the walk: two threads a row read the staged dO tile and
//     the row's out (once, from device memory), f32 products summed in f32.
//     Only a block that holds a row that sees no key sums v over n
//     (column_sums, as store_dead_rows does), so DALL-E's path, which never
//     meets such a row, pays nothing for it.
//   - Precision, as the forward and dk/dv bodies have it: q is staged raw,
//     never as q * scale rounded to bf16; scale * log2(e) multiplies the f32
//     S after the product; p = 2^(s - lse log2(e)) and ds are f32; only the
//     dQ product sees ds rounded to bf16; the accumulator is f32, and dq
//     takes the scale once, at the store.
//   - The mask in registers, in the forward's orientation (flash_tc.cuh's
//     key_allow and mask_scores): a causal-future key, a padded key or a
//     pair the pattern forbids score the f32 product -1e30 * log2(e), a key
//     past n -inf; branch-free; a tile wholly below the diagonal with no
//     pattern and no key padding skips the test.
//   - Rows that see no key have lse = -1e30 and take p = 1 for each of
//     their keys: a masked score and lse * log2(e) are the same product
//     (__fmul_rn: no fused multiply-add rounds either otherwise), so their
//     difference is exactly 0.  Rows past n have zero q and do and delta 0,
//     so their ds is 0; keys past n have p = 0 and zero k.
//
// What remains: no warp specialisation (the one warpgroup issues the loads,
// the three products and the exps in turn), no TMA, and the products S and
// dP of N = 32 at d 128 (the tile shape the tables and the other bodies
// share).
#pragma once

#include "flash_tc.cuh"

namespace flash {
namespace tc {

template <int D>
struct DqSizes {
  static constexpr int BK = inner_tile<D>();
  static constexpr uint32_t kQ = kTileRows * D * 2;     // bytes of the Q or the dO tile
  static constexpr uint32_t kKV = BK * D * 2;           // bytes of one K or V tile
  static constexpr uint32_t kMask = kTileRows * mask_row<BK>();
  // offsets in the dynamic shared memory: Q, dO, the K ring, the V ring, the
  // rows' delta (64 f32) and v's column sums (D f32), and with a pattern its
  // ring
  static constexpr uint32_t kDo = kQ;
  static constexpr uint32_t kKRing = 2 * kQ;
  static constexpr uint32_t kVRing = kKRing + kStages * kKV;
  static constexpr uint32_t kRows = kVRing + kStages * kKV;
  static constexpr int kSmem = kRows + (kTileRows + D) * 4;
  static constexpr int kSmemMasked = kSmem + kStages * kMask;
};

// One key tile (stage of the ring at k_tile, v_tile; ms: its pattern bytes
// or null) for the block's 64 query rows: S and dP, mask, p and ds, then
// dQ += dS K.  lse2 and delta are the thread's two rows' lse * log2(e) and
// delta.
template <int D>
__device__ __forceinline__ void dq_tile_tc(const Problem& p, int q0, int k0, uint32_t q_tile,
                                           uint32_t do_tile, uint32_t k_tile, uint32_t v_tile,
                                           const uint8_t* ms, const Frag& f, const float (&lse2)[2],
                                           const float (&delta)[2],
                                           float (&dq)[D <= 64 ? 1 : D / 64][D <= 64 ? D / 2 : 32]) {
  constexpr int BK = inner_tile<D>();
  constexpr int NB = D <= 64 ? 1 : D / 64;  // dQ products per key step (64 channels each)

  // read before the products, which hide them
  uint32_t allow[2];
  key_allow<BK>(p, ms, f, k0, allow);

  float s[BK / 2], dp[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    mma_ss(s, kmajor_desc<D, kTileRows>(q_tile, ks), kmajor_desc<D, BK>(k_tile, ks), ks > 0);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    mma_ss(dp, kmajor_desc<D, kTileRows>(do_tile, ks), kmajor_desc<D, BK>(v_tile, ks), ks > 0);
  wgmma_commit();
  wgmma_wait();
  hold(s);
  hold(dp);

  const float sc = p.scale * kLog2e;
  const float neg = __fmul_rn(kNeg, kLog2e);
  if (plain_tile<BK>(p, q0, k0))
    mask_scores<BK, true>(s, f, p, q0, k0, sc, neg, allow);
  else
    mask_scores<BK, false>(s, f, p, q0, k0, sc, neg, allow);

  // ds = p (dp - delta), p = 2^(s - lse log2 e), in place
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * rr + e;
        dp[i] = ex2(s[i] - lse2[rr]) * (dp[i] - delta[rr]);
      }

  // dS as the A fragments of the dQ product: k-step ks holds key columns
  // 16ks .. 16ks + 15, the accumulator's groups 2ks and 2ks + 1
  uint32_t da[BK / 16][4];
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
    for (int t = 0; t < 4; ++t) da[ks][t] = pack_bf16(dp[8 * ks + 2 * t], dp[8 * ks + 2 * t + 1]);

  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_rs(dq[nb], da[ks], mnmajor_desc<D, BK>(k_tile, ks, nb));
  wgmma_commit();
  wgmma_wait();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) hold(dq[nb]);
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) hold(da[ks]);
}

}  // namespace tc

// dq (bf16) for the block's 64 query rows over `tiles` (key tiles) on the
// tensor cores, or over all `ntiles` key tiles when a row of the block sees
// no key, as dq_block does; first the rows' delta, written to `delta` (this
// (batch, head)'s row).  Launched with tc::kThreads threads and
// tc::DqSizes<D>::kSmem bytes of dynamic shared memory, kSmemMasked with a
// pattern.
template <int D>
__device__ __forceinline__ void dq_block_tc(const __nv_bfloat16* __restrict__ q,
                                            const __nv_bfloat16* __restrict__ k,
                                            const __nv_bfloat16* __restrict__ v,
                                            const __nv_bfloat16* __restrict__ dout,
                                            const __nv_bfloat16* __restrict__ out,
                                            __nv_bfloat16* __restrict__ dq, float* __restrict__ delta,
                                            const Problem& p, const TileList& tiles, int ntiles) {
  using namespace tc;
  constexpr int BK = inner_tile<D>();
  constexpr int NB = D <= 64 ? 1 : D / 64;
  constexpr int NO = D <= 64 ? D : 64;  // channels of one dQ product
  constexpr int C = D / 8;              // 16-byte chunks in a row
  using S = DqSizes<D>;
  // the swizzled tiles need 1024-byte alignment
  extern __shared__ __align__(1024) uint8_t dynamic_smem[];
  const uint32_t q_tile = static_cast<uint32_t>(__cvta_generic_to_shared(dynamic_smem));
  if (q_tile & 1023u) __trap();
  const uint32_t do_tile = q_tile + S::kDo;
  const uint32_t k_ring = q_tile + S::kKRing;
  const uint32_t v_ring = q_tile + S::kVRing;
  float* rows_delta = reinterpret_cast<float*>(dynamic_smem + S::kRows);
  float* vsum = rows_delta + kTileRows;
  const bool use_mask = p.mask != nullptr;

  const int q0 = blockIdx.x * kTileRows;
  Frag f = frag();
  mask_shifts(p, q0, f);

  const __nv_bfloat16* kb = k + p.base;
  const __nv_bfloat16* vb = v + p.base;
  // K, V and the pattern of key tile t into stage s of their rings
  auto stage_tile = [&](int t, int s) {
    stage_rows<D, BK>(kb, t * BK, p.n, k_ring + s * S::kKV);
    stage_rows<D, BK>(vb, t * BK, p.n, v_ring + s * S::kKV);
    if (use_mask) stage_mask<kTileRows, BK>(p.mask, p.n, q0, t * BK, q_tile + S::kSmem + s * S::kMask);
  };
  stage_rows<D, kTileRows>(q + p.base, q0, p.n, q_tile);
  stage_rows<D, kTileRows>(dout + p.base, q0, p.n, do_tile);
  cp_async_commit();

  // the thread's two rows' lse (0 past n, where ds is 0 whatever p is)
  float lse2[2];
  bool dead = false;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + f.rows[rr];
    const float lse = row < p.n ? p.lse[row] : 0.f;
    dead |= (row < p.n) & (lse <= kDeadLse);
    lse2[rr] = __fmul_rn(lse, kLog2e);
  }
  const bool every_tile = __syncthreads_or(dead);
  // the next key tile: the list's, or with a row that sees no key every one
  int cur = tiles.begin, scan = -1;
  auto next = [&](int& tile) -> bool {
    if (!every_tile) return tiles.next(cur, tile);
    if (++scan >= ntiles) return false;
    tile = scan;
    return true;
  };
  int jt = 0;
  bool have = next(jt);
  if (have) stage_tile(jt, 0);
  cp_async_commit();

  // delta, two threads a row, each over half the row's chunks: the staged
  // dO against out, or against v's column sums for a row that sees no key
  if (every_tile) column_sums<__nv_bfloat16, D>(v, p, vsum);
  cp_async_wait_prev();  // Q and dO (the first key tile may still be in flight)
  __syncthreads();
  {
    const int r = threadIdx.x / 2;
    const int row = q0 + r;
    float part = 0.f;
    if (row < p.n) {
      const bool row_dead = p.lse[row] <= kDeadLse;
      const __nv_bfloat16* orow = out + p.base + static_cast<size_t>(row) * D;
#pragma unroll
      for (int cc = 0; cc < C / 2; ++cc) {
        const int c = (threadIdx.x % 2) * (C / 2) + cc;
        const uint4 dchunk =
            *reinterpret_cast<const uint4*>(dynamic_smem + S::kDo + Layout<D>::template chunk<kTileRows>(r, c));
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dchunk);
        if (row_dead) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = __bfloat1622float2(d2[e]);
            part = fmaf(x.x, vsum[8 * c + 2 * e], part);
            part = fmaf(x.y, vsum[8 * c + 2 * e + 1], part);
          }
        } else {
          const uint4 ochunk = *reinterpret_cast<const uint4*>(orow + 8 * c);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ochunk);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 x = __bfloat1622float2(d2[e]);
            const float2 y = __bfloat1622float2(o2[e]);
            part = fmaf(x.x, y.x, part);
            part = fmaf(x.y, y.y, part);
          }
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (threadIdx.x % 2 == 0) {
      rows_delta[r] = part;  // 0 past n
      if (row < p.n) delta[row] = part;
    }
  }
  __syncthreads();
  const float row_delta[2] = {rows_delta[f.rows[0]], rows_delta[f.rows[1]]};

  float dq_acc[NB][NO / 2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) dq_acc[nb][i] = 0.f;

  int stage = 0;
  while (have) {
    int jn = 0;
    const bool more = next(jn);
    if (more) stage_tile(jn, stage ^ 1);  // into the other stage, freed by the last barrier
    cp_async_commit();
    cp_async_wait_prev();  // all but the group just committed: this tile (and Q, dO)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();
    dq_tile_tc<D>(p, q0, jt * BK, q_tile, do_tile, k_ring + stage * S::kKV, v_ring + stage * S::kKV,
                  dynamic_smem + S::kSmem + stage * S::kMask, f, lse2, row_delta, dq_acc);
    __syncthreads();  // this stage is no longer read
    jt = jn;
    have = more;
    stage ^= 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // Q and dO alone were staged when the list is empty

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + f.rows[rr];
    if (row >= p.n) continue;
    __nv_bfloat16* dq_row = dq + p.base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < NO / 8; ++j) {
        const int i = 4 * j + 2 * rr;
        *reinterpret_cast<uint32_t*>(dq_row + nb * NO + 8 * j + f.col) =
            pack_bf16(dq_acc[nb][i] * p.scale, dq_acc[nb][i + 1] * p.scale);
      }
  }
}

}  // namespace flash
