// The flash-attention forward body for bf16 on Hopper's tensor cores
// (sm_90a, `wgmma`), in plain CUDA C++ with inline PTX.
//
// Replaces, for bf16 inputs: dalle_pytorch_tpu/kernels/flash_attention.py
// `_fwd_kernel` (dense grid, flash_fwd.cu) and `_fwd_kernel_compact`
// (compacted grid, flash_compact.cu).  Both entries call fwd_block_tc for
// __nv_bfloat16 and fwd_block_tf32 (flash_fwd_tf32.cuh, 3xTF32 on the same
// tensor cores) for float; the dtype alone picks the body.  Each body walks
// the entry's TileList, so the compacted grid still equals the dense grid
// with the same mask bit for bit.
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
//   - The S accumulator is masked in registers with the TPU kernel's rule
//     (-1e30 for a causal-future, padded or pattern-forbidden key, -inf past n),
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
// The same walk, in another mode (tc::Walk), is the bf16 VFA pair's two
// passes (flash_vfa_tc.cuh): the max pass (no V, no exp, no second product)
// and the fixed-max pass (this tile with the rescale taken out).  Their
// instantiations are separate; the forward's compiles as before.
//
// The layout, descriptor, wgmma, staging and masking helpers are
// flash_tc.cuh's, shared with the dq body (flash_dq_tc.cuh, which masks in
// this orientation too) and the dk/dv body (flash_bwd_tc.cuh).  A walk's
// step between S and P V (walk_step, online_softmax), its rows' start
// (start_rows) and its epilogue (finish_rows) are shared with the f32 body
// (flash_fwd_tf32.cuh), whose walks have the same three modes.
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

// What a walk over the block's key tiles computes: the online softmax (the
// forward), each row's score maximum (the VFA max pass), or accumulation
// against that fixed maximum with no rescale (the VFA fixed-max pass).
enum class Walk { kOnline, kMax, kFixed };

// The dynamic shared memory of a walk: Q, the K ring and (kValues) the V
// ring, and with a pattern its ring.
template <int D, bool kValues = true>
struct Sizes {
  static constexpr int BK = inner_tile<D>();
  static constexpr uint32_t kQ = kTileRows * D * 2;  // bytes of the Q tile
  static constexpr uint32_t kKV = BK * D * 2;        // bytes of one K or V tile
  static constexpr uint32_t kMaskRow = mask_row<BK>();  // a staged pattern row
  static constexpr uint32_t kMask = kTileRows * kMaskRow;
  static constexpr int kTiles = kQ + (kValues ? 2 : 1) * kStages * kKV;
  static constexpr int kSmem = kTiles;
  static constexpr int kSmemMasked = kTiles + kStages * kMask;
};

// S = Q K^T for the block's 64 query rows and the key tile at k0 (stage
// k_tile of the ring; ms: its pattern bytes or null), times `sc`, masked in
// registers: `neg` for a causal-future, padded or pattern-forbidden key,
// -inf past n.  Every walk computes its scores here, so the VFA pair's two
// passes compute the same S bit for bit.
template <int D>
__device__ __forceinline__ void scores_tc(const Problem& p, int q0, int k0, uint32_t q_tile, uint32_t k_tile,
                                          const uint8_t* ms, const Frag& f, float sc, float neg,
                                          float (&s)[inner_tile<D>() / 2]) {
  constexpr int BK = inner_tile<D>();

  // read before the product, which hides them
  uint32_t allow[2];
  key_allow<BK>(p, ms, f, k0, allow);

#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    mma_ss(s, kmajor_desc<D, kTileRows>(q_tile, ks), kmajor_desc<D, BK>(k_tile, ks), ks > 0);
  wgmma_commit();
  wgmma_wait();
  hold(s);

  if (plain_tile<BK>(p, q0, k0))
    mask_scores<BK, true>(s, f, p, q0, k0, sc, neg, allow);
  else
    mask_scores<BK, false>(s, f, p, q0, k0, sc, neg, allow);
}

// The online softmax's step over one key tile: s holds this thread's base-2
// scores of its two rows (the S accumulator fragment); the running maximum m
// takes the tile's, l and o are rescaled by alpha = 2^(m_old - m_new), s
// becomes p = 2^(s - m) in f32 and l adds it.  Each thread keeps l over its
// own columns; the row's four threads join at the end (finish_rows).
template <int D>
__device__ __forceinline__ void online_softmax(float (&s)[inner_tile<D>() / 2],
                                               float (&o)[D <= 64 ? 1 : D / 64][D <= 64 ? D / 2 : 32],
                                               float (&m)[2], float (&l)[2]) {
  constexpr int BK = inner_tile<D>();
  constexpr int NB = D <= 64 ? 1 : D / 64;
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
}

// The step of walk W over one key tile's masked scores s (this thread's two
// rows, the S accumulator fragment).  kMax: s (natural units) into each
// thread's maximum m over its own columns; the row's four threads join at
// the end (finish_rows).  kFixed: s (natural units) becomes p = 2^((s - m)
// log2 e) against the row's fixed maximum m (gmax), l adds it, no rescale.
// kOnline: online_softmax (s in base 2).  Every body's walks take this step,
// between S and O += P V.
template <int D, Walk W>
__device__ __forceinline__ void walk_step(float (&s)[inner_tile<D>() / 2],
                                          float (&o)[D <= 64 ? 1 : D / 64][D <= 64 ? D / 2 : 32],
                                          float (&m)[2], float (&l)[2]) {
  constexpr int BK = inner_tile<D>();
  if constexpr (W == Walk::kMax) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) m[rr] = fmaxf(m[rr], fmaxf(s[4 * j + 2 * rr], s[4 * j + 2 * rr + 1]));
  } else if constexpr (W == Walk::kFixed) {
    // s - gmax is exactly 0 at the row's largest score (no fused
    // multiply-add: the intrinsics are never contracted), so p = 1 there
    // and l >= 1 on every live row; a masked key (-1e30) or one past n
    // (-inf) gives p = 0 exactly
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pr = ex2(__fmul_rn(__fsub_rn(s[4 * j + 2 * rr + e], m[rr]), kLog2e));
          l[rr] += pr;
          s[4 * j + 2 * rr + e] = pr;
        }
  } else {
    online_softmax<D>(s, o, m, l);
  }
}

// The thread's two rows' maximum before walk W: -1e30, or for kFixed the
// rows' gmax read from p.lse (0 past n, where nothing is stored).
template <Walk W>
__device__ __forceinline__ void start_rows(const Problem& p, int q0, const Frag& f, float (&m)[2]) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + f.rows[rr];
    m[rr] = W == Walk::kFixed ? (row < p.n ? p.lse[row] : 0.f) : kNeg;
  }
}

// One key tile (stage `stage` of the ring) of a walk for the block's 64
// query rows: S = Q K^T (scores_tc; times scale * log2 e for kOnline, in
// natural units for the VFA pair, which keeps gmax so, as the JAX max pass
// writes it: a row that sees no key gets exactly -1e30), the walk's step,
// and but for kMax O += P V.  `ms` is the tile's staged pattern (null
// without one).
template <int D, Walk W = Walk::kOnline>
__device__ __forceinline__ void fwd_tile_tc(const Problem& p, int q0, int k0, uint32_t q_tile,
                                            uint32_t k_tile, uint32_t v_tile, const uint8_t* ms,
                                            const Frag& f,
                                            float (&o)[D <= 64 ? 1 : D / 64][D <= 64 ? D / 2 : 32],
                                            float (&m)[2], float (&l)[2]) {
  constexpr int BK = inner_tile<D>();
  constexpr int NB = D <= 64 ? 1 : D / 64;  // PV products per key step (64 channels each)

  float s[BK / 2];
  scores_tc<D>(p, q0, k0, q_tile, k_tile, ms, f, W == Walk::kOnline ? p.scale * kLog2e : p.scale, kNeg, s);
  walk_step<D, W>(s, o, m, l);
  if constexpr (W == Walk::kMax) return;

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

__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = tc::pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// The end of a walk for the block's 64 query rows.  kMax: the row's four
// threads join their maxima and rows below n write gmax to `lse` (-1e30 for
// a row that sees no key; v and out unused).  kOnline, kFixed: the row's
// four threads join l, live rows write out = o / max(l, 1e-30) in T and lse
// (kOnline: m ln 2 + log(max(l, 1e-30)) from the base-2 maximum; kFixed:
// gmax + log(max(l, 1e-30))), and rows that saw no key (kOnline: m still
// -1e30; kFixed: gmax at or below kDeadLse) go to store_dead_rows.  Called
// by the whole block.
template <typename T, int D, tc::Walk W>
__device__ __forceinline__ void finish_rows(const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                                            const Problem& p, int q0, const tc::Frag& f,
                                            float (&o)[D <= 64 ? 1 : D / 64][D <= 64 ? D / 2 : 32],
                                            const float (&m)[2], float (&l)[2]) {
  using namespace tc;
  constexpr int NB = D <= 64 ? 1 : D / 64;
  constexpr int NO = D <= 64 ? D : 64;  // channels of one PV product
  const int lane = threadIdx.x % 32;
  if constexpr (W == Walk::kMax) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = m[rr];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const int row = q0 + f.rows[rr];
      if (row < p.n && lane % 4 == 0) lse[p.base / D + row] = mx;
    }
  } else {
    __shared__ uint8_t dead_rows[kTileRows];
    bool any_dead = false;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
      l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
      const int row = q0 + f.rows[rr];
      const bool live_row = row < p.n;
      const bool dead = live_row && (W == Walk::kFixed ? m[rr] <= kDeadLse : m[rr] == kNeg);
      if (lane % 4 == 0) dead_rows[f.rows[rr]] = dead;
      any_dead |= dead;
      if (live_row && !dead) {
        const float lc = fmaxf(l[rr], 1e-30f);
        T* o_row = out + p.base + static_cast<size_t>(row) * D;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int j = 0; j < NO / 8; ++j)
            store_pair(o_row + nb * NO + 8 * j + f.col, o[nb][4 * j + 2 * rr] / lc, o[nb][4 * j + 2 * rr + 1] / lc);
        if (lane % 4 == 0) lse[p.base / D + row] = W == Walk::kFixed ? m[rr] + logf(lc) : m[rr] * kLn2 + logf(lc);
      }
    }
    if (__syncthreads_or(any_dead)) store_dead_rows<T, D>(v, out, lse, p, q0, dead_rows);
  }
}

// The bf16 walk for the block's 64 query rows over `tiles`, on the tensor
// cores.  kOnline, the forward: writes out (bf16) and lse = m + log(max(l,
// 1e-30)).  kMax, the VFA max pass: writes each row's maximum of its masked
// scores to `lse` as gmax (v and out unused, null).  kFixed, the VFA
// fixed-max pass: reads gmax from p.lse, writes out and lse = gmax +
// log(max(l, 1e-30)).  The forward and the fixed-max pass hand rows that saw
// no key to store_dead_rows.  Launched with tc::kThreads threads and
// tc::Sizes<D, W != Walk::kMax>::kSmem bytes of dynamic shared memory,
// kSmemMasked with a pattern.
template <int D, tc::Walk W = tc::Walk::kOnline>
__device__ __forceinline__ void fwd_block_tc(const __nv_bfloat16* __restrict__ q,
                                             const __nv_bfloat16* __restrict__ k,
                                             const __nv_bfloat16* __restrict__ v,
                                             __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                                             const Problem& p, const TileList& tiles) {
  using namespace tc;
  constexpr int BK = inner_tile<D>();
  constexpr int NB = D <= 64 ? 1 : D / 64;
  constexpr int NO = D <= 64 ? D : 64;  // channels of one PV product
  using S = Sizes<D, W != Walk::kMax>;
  // the swizzled tiles need 1024-byte alignment
  extern __shared__ __align__(1024) uint8_t dynamic_smem[];
  const uint32_t q_tile = static_cast<uint32_t>(__cvta_generic_to_shared(dynamic_smem));
  if (q_tile & 1023u) __trap();
  const uint32_t k_ring = q_tile + S::kQ;
  const uint32_t v_ring = k_ring + kStages * S::kKV;
  const uint32_t mask_ring = q_tile + S::kTiles;
  const bool use_mask = p.mask != nullptr;

  const int q0 = blockIdx.x * kTileRows;
  Frag f = frag();
  mask_shifts(p, q0, f);

  const __nv_bfloat16* kb = k + p.base;
  // K, V (not in the max pass) and the pattern of key tile t into stage s of
  // their rings
  auto stage_tile = [&](int t, int s) {
    stage_rows<D, BK>(kb, t * BK, p.n, k_ring + s * S::kKV);
    if constexpr (W != Walk::kMax) stage_rows<D, BK>(v + p.base, t * BK, p.n, v_ring + s * S::kKV);
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
  float m[2], l[2] = {0.f, 0.f};
  start_rows<W>(p, q0, f, m);

  int stage = 0;
  while (have) {
    int jn = 0;
    const bool more = tiles.next(cur, jn);
    if (more) stage_tile(jn, stage ^ 1);  // into the other stage, freed by the last barrier
    cp_async_commit();
    cp_async_wait_prev();  // all but the group just committed: this tile (and Q)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();
    fwd_tile_tc<D, W>(p, q0, jt * BK, q_tile, k_ring + stage * S::kKV, v_ring + stage * S::kKV,
                      dynamic_smem + S::kTiles + stage * S::kMask, f, o, m, l);
    __syncthreads();  // this stage is no longer read
    jt = jn;
    have = more;
    stage ^= 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // Q alone was staged when the list is empty
  finish_rows<__nv_bfloat16, D, W>(v, out, lse, p, q0, f, o, m, l);
}

}  // namespace flash
