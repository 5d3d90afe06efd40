// The flash-attention backward bodies for f32 on Hopper's tensor cores
// (sm_90a, `wgmma` on TF32 operands, three products for one), in plain CUDA
// C++ with inline PTX: dq, with the backward's delta computed in it, and
// dk/dv.
//
// Replaces, for f32 inputs: dalle_pytorch_tpu/kernels/flash_attention.py
// `_dq_kernel` and `_dkv_kernel` (dense grid, flash_bwd.cu) and
// `_dq_kernel_compact` and `_dkv_kernel_compact` (compacted grid,
// flash_compact.cu).  The dq entries call dq_block_tf32 for float and
// dq_block_tc (flash_dq_tc.cuh) for __nv_bfloat16, the dk/dv entries
// dkv_block_tf32 and dkv_block_tc (flash_bwd_tc.cuh); the dtype alone picks
// the body.  Each f32 body visits the tiles its bf16 twin visits, in the
// same order (the block's TileList, with the extra tiles that rows seeing no
// key need), so the compacted grid still equals the dense grid with the same
// mask bit for bit.
//
// Computes what the bf16 bodies compute, in f32: for the 64 query rows a dq
// block owns, delta = rowsum(do * out) (do . sum_j v_j for a row that sees
// no key), written for the dk/dv pass, then over its key tiles s = scale q
// k^T masked as the forward masks it, p = exp(s - lse), dp = do v^T, ds = p
// (dp - delta), dq = scale sum ds k; for the 64 keys a dk/dv block owns,
// over its query tiles, the transposed s and dp, dv = sum p^T do and dk =
// scale sum ds^T q.  q is staged raw and scale * log2 e multiplies the f32
// S after the product; p = 2^(s - lse log2 e), a masked score the f32
// product -1e30 log2 e (__fmul_rn), so a row that sees no key takes p = 1
// exactly; a key past n scores -inf; dq and dk take the scale once, at the
// store.
//
// What bounds it on this card: dq's three and dk/dv's four n x n x d
// products a (batch, head), halved by causality and cut further by a
// pattern.  The repo holds f32 to 1e-4, which one TF32 product misses, so
// every product runs as three (3xTF32, as in the forward,
// flash_fwd_tf32.cuh): each operand split x = hi + lo in TF32, a b = (a_lo
// b_hi + a_hi b_lo) + a_hi b_hi, at a third of the 494.7 TFLOP/s TF32 rate.
// The bytes (six (bh, n, d) tensors, lse and delta) are two orders of
// magnitude smaller.
//
// What the design does about it:
//   - One warpgroup (128 threads) owns 64 rows, wgmma's M: query rows for
//     dq, keys for dk/dv.  dq: S = Q K^T and dP = dO V^T from shared memory,
//     then dQ += dS K with dS in registers.  dk/dv: S^T = K Q^T and dP^T = V
//     dO^T from shared memory, then dV += P^T dO and dK += dS^T Q with P^T
//     and dS^T in registers.  Each product is its three passes into one
//     accumulator; P and dS are split in registers.
//   - A TF32 operand in shared memory must be K-major (flash_fwd_tf32.cuh),
//     so the last products cannot read the staged K (dq) or Q and dO (dk/dv)
//     through the transpose bit as the bf16 bodies do: those tiles are staged
//     a second time, transposed (channels as rows), with their keys or
//     queries in the order in which the dS (P^T, dS^T) accumulator fragment
//     holds its columns as the TF32 A fragment reads them, so no lane
//     shuffles (StepRegs, as KvRegs stores V^T in P's order).  cp.async can
//     neither split nor transpose, so these tiles pass through registers:
//     the next step's are loaded from device memory while this one is in
//     the products, then split and stored both ways.
//   - Shared memory, every operand as a hi and a lo tile (8 bytes an
//     element), one stage of the other side.  The tables' tiles (64 rows,
//     the other side 64 at d <= 64 and 32 at d 128) would need 224 KB for dq
//     and 256 KB for dk/dv at d 128, over the 227 KB a block may have; so at
//     d 128 each 32-row tile of the other side is walked as two 16-row
//     halves (dq_step, dkv_step: k-steps of 8 over 16 rows for the
//     accumulating products, the transposed tiles in rows of 64 bytes under
//     the 64-byte swizzle).  The tables and the CSR lists stay at the tile;
//     only the staging is finer.  A half's K and V (dq) or Q and dO (dk/dv) are
//     stored stacked, lo rows then hi rows, so that S, dP, S^T and dP^T are
//     A_lo B_hi at n16 and A_hi [B_lo; B_hi] at n32 (scores3_tf32): at N 16
//     wgmma is bound by its reads of A from shared memory, and the stacking
//     reads A_hi once for two products (dq 0.728 -> 0.606 ms, dk/dv 0.884
//     -> 0.810 ms at bh 32, n 1280 on an H100, kernels/time_backward.py).
//     Bytes, without / with a pattern's two-stage ring:
//       dq     d 32: 82,304 / 92,544 (two blocks an SM)  d 64: 164,352 /
//              174,592  d 128: 180,992 / 187,136
//       dk/dv  d 32: 99,328 / 109,568 (two blocks an SM)  d 64 (32-row
//              steps): 132,096 / 142,336  d 128: 197,120 / 202,240
//   - Registers: the dK and dV accumulators take 128 a thread at d 128, as
//     in the bf16 body, the next step's rows in flight D * step / 64, P^T
//     and dS^T split 2 * step / 2 each.  In dk/dv the next step's loads are
//     issued after dV += P^T dO has been waited for, so the rows in flight
//     and the split P^T are never live together; at d 64 its steps are 32
//     rows (dkv_step).  chip_smoke.py's environment phase fails if an f32
//     dq or dk/dv instantiation spills.
//   - Masking and rows that see no key are the bf16 bodies': key_allow,
//     mask_scores and plain_tile for dq, the pattern's rows and
//     mask_scores_t for dk/dv, branch-free; the lse and delta of dk/dv's
//     query tiles travel in a cp.async ring beside the pattern's.
//
// What remains: the splits and the stores of the next step run between the
// products, not under them (no warp specialisation, no TMA); at d 128 S and
// dP (dq) and S^T and dP^T (dk/dv) are wgmma at N = 16, which reads its A
// tile from shared memory for a quarter of the work an N = 64 read does.
#pragma once

#include "flash_bwd_tc.cuh"
#include "flash_dq_tc.cuh"
#include "flash_fwd_tf32.cuh"

namespace flash {
namespace tc {

// d (+)= A B, m64n16k8 TF32, A and B from shared memory, both K-major;
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void mma_tf32(float (&d)[8], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// Rows of the other side a backward step stages: dq's, the table's whole
// tile at d <= 64 and a 16-row half of its 32-row tile at d 128; dk/dv's
// the same but at d 64 a 32-row half, where the dK and dV accumulators
// leave no room for a 64-row step (it spilled 40 bytes; the halves spill
// nothing and ran 0.616 against 0.574 ms at bh 64, n 1280 on an H100,
// kernels/time_backward.py).
template <int D>
__host__ __device__ constexpr int dq_step() { return D <= 64 ? inner_tile<D>() : 16; }
template <int D>
__host__ __device__ constexpr int dkv_step() { return D == 64 ? 32 : dq_step<D>(); }

// A transposed f32 tile, channels as rows and C floats (a step's keys or
// queries, the product's K) in each: the bytes of a bf16 tile of 2C
// channels, Layout<2C> (rows of 128 bytes, or of 64 under the 64-byte
// swizzle at C = 16).  Every tile starts on 1024 bytes.
template <int C>
using TLayout = Layout<2 * C>;

// k-step ks (8 floats) of the transposed tile of R rows at `base`, as a
// K-major B; rows 64 nb .. 64 nb + 63 start at base + 64 nb * W
template <int C, int R>
__device__ __forceinline__ uint64_t t_desc(uint32_t base, int nb, int ks) {
  return kmajor_desc<2 * C, R>(base + nb * 64 * TLayout<C>::kRowBytes, ks);
}

// R rows of one (batch, head)'s (n, D) f32 matrix, from row r0, in
// registers between their load from device memory and their split into
// shared memory: as an R-row tile (the rows a product's N, the channels its
// K; f32_chunk<R>) and, with kT, also transposed (D rows of R floats,
// TLayout<R>), with the rows in each group of 8 permuted as the P and dS
// accumulator fragments hold their columns for the TF32 A fragment: row 2t
// at position t, row 2t + 1 at t + 4.  A 16-row tile is stored as one
// stacked 32-row tile, its lo rows then its hi rows (f32_chunk<32>), so that
// A_hi times both is one n32 product (scores3_tf32).  Without kT a thread
// carries float4 idx % C of row idx / C (idx = tid + i * kThreads), so a
// warp's loads and stores cover whole rows.  With kT it carries 4 x 4
// blocks, the rows of chunk a of a transposed row (8(a/2) + a % 2 + 2kk, kk
// = 0..3) by channels 4b .. 4b + 3, splits each block once and stores it
// both ways; at R >= 32, a % 8 = idx % 8 and b = ((idx / 8) % C) ^ (a & 6),
// so that eight neighbouring threads store to eight distinct 16-byte bank
// groups in both tiles.
template <int D, int R, bool kT>
struct StepRegs {
  static constexpr int C = D / 4;              // float4s in a row
  static constexpr int A = R / 4;              // 16-byte chunks in a transposed row
  static constexpr int kN = R * C / kThreads;  // float4s a thread carries
  static constexpr bool kStack = R == 16;
  static_assert(kN % 4 == 0 || !kT, "4 x 4 blocks");
  float4 x[kN];

  // the hi part of chunk c of row r of the R-row tile at `base`, and its lo
  // part's offset from it
  static __device__ __forceinline__ uint32_t row_hi(uint32_t base, int r, int c) {
    return base + (kStack ? f32_chunk<2 * R>(r + R, c) : f32_chunk<R>(r, c));
  }
  static __device__ __forceinline__ uint32_t row_lo_off(uint32_t lo_off) {
    return kStack ? 0u - R * 128u : lo_off;
  }

  // chunk a and channel block b of this thread's block i
  static __device__ __forceinline__ void block(int i, int& a, int& b) {
    const int idx = threadIdx.x + i * kThreads;
    if constexpr (A % 8 == 0) {
      a = idx % 8 + 8 * (idx / (8 * C));
      b = ((idx / 8) % C) ^ (a & 6);
    } else {
      a = idx % A;
      b = idx / A;
    }
  }
  static __device__ __forceinline__ int block_row(int a, int kk) { return 8 * (a / 2) + a % 2 + 2 * kk; }

  // zeros past n
  __device__ __forceinline__ void load(const float* __restrict__ src, int r0, int n) {
    if constexpr (kT) {
#pragma unroll
      for (int i = 0; i < kN / 4; ++i) {
        int a, b;
        block(i, a, b);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) x[4 * i + kk] = load_row4<D>(src, r0 + block_row(a, kk), n, b);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        x[i] = load_row4<D>(src, r0 + idx / C, n, idx % C);
      }
    }
  }

  // split into the R-row tile at `hi` and (kT) the transposed tile at
  // `t_hi`, each lo tile `lo_off` bytes past its hi tile (a stacked tile
  // holds both at `hi`)
  __device__ __forceinline__ void store(uint32_t hi, uint32_t t_hi, uint32_t lo_off) const {
    if constexpr (kT) {
#pragma unroll
      for (int i = 0; i < kN / 4; ++i) {
        int a, b;
        block(i, a, b);
        // the block split once, h[kk][e] and l[kk][e] for row kk, channel
        // 4b + e, then stored both ways
        uint32_t h[4][4], l[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 y = x[4 * i + kk];
          split(y.x, h[kk][0], l[kk][0]);
          split(y.y, h[kk][1], l[kk][1]);
          split(y.z, h[kk][2], l[kk][2]);
          split(y.w, h[kk][3], l[kk][3]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t at = row_hi(hi, block_row(a, kk), b);
          st_shared4(at, h[kk][0], h[kk][1], h[kk][2], h[kk][3]);
          st_shared4(at + row_lo_off(lo_off), l[kk][0], l[kk][1], l[kk][2], l[kk][3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t at = t_hi + TLayout<R>::template chunk<D>(4 * b + e, a);
          st_shared4(at, h[0][e], h[1][e], h[2][e], h[3][e]);
          st_shared4(at + lo_off, l[0][e], l[1][e], l[2][e], l[3][e]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        store_split(row_hi(hi, idx / C, idx % C), row_lo_off(lo_off), x[i]);
      }
    }
  }
};

// A B^T in 3xTF32 for a step of N rows, both from shared memory, K-major,
// over D channels (k-steps of 8): A the 64-row tile at a_hi (its lo tile
// a_lo bytes past it), B the step's N-row tile at b_hi (its lo tile b_lo
// bytes past it; at N = 16 the stacked 32-row tile, StepRegs).  N = 64: the
// two cross terms, then hi hi, into one accumulator.  N = 16: A_lo B_hi
// into `x`, and A_hi times B's stacked lo and hi rows as one n32 product
// into `y`, which reads A_hi once for two products (at N = 16 wgmma is bound
// by its reads of A from shared memory); finish3 adds them.  Issued, not
// waited for.
template <int N>
struct Acc3 {
  float x[N / 2];
  float y[N == 16 ? 16 : 1];
};

template <int D, int N>
__device__ __forceinline__ void scores3_tf32(Acc3<N>& d, uint32_t a_hi, uint32_t a_lo, uint32_t b_hi,
                                             uint32_t b_lo) {
  auto A = [&](int ks, uint32_t off) { return f32_desc<kTileRows>(a_hi + off, ks); };
  auto B = [&](int ks, uint32_t off) { return f32_desc<N == 16 ? 32 : N>(b_hi + off, ks); };
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d.x[i] = 0.f;
  if constexpr (N == 16) {
#pragma unroll
    for (int i = 0; i < 16; ++i) d.y[i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) mma_tf32(d.x, A(ks, a_lo), B(ks, 16 * 128), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) mma_tf32(d.y, A(ks, 0), B(ks, 0), ks > 0);
  } else {
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) mma_tf32(d.x, A(ks, a_lo), B(ks, 0), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) mma_tf32(d.x, A(ks, 0), B(ks, b_lo), 1);
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) mma_tf32(d.x, A(ks, 0), B(ks, 0), 1);
  }
}

// After the wait: the product's fragment in d.x, (lo hi + hi lo) + hi hi at
// N = 16 (element i of the n32 y is column i's hi lo, element i + 8 its hi
// hi).
template <int N>
__device__ __forceinline__ void finish3(Acc3<N>& d) {
  hold(d.x);
  if constexpr (N == 16) {
    hold(d.y);
#pragma unroll
    for (int i = 0; i < 8; ++i) d.x[i] = (d.x[i] + d.y[i]) + d.y[i + 8];
  }
}

// d += X B in 3xTF32 over KS columns: X the f32 accumulator fragment of P
// or dS, split here into the TF32 A fragments (k-step ks is the fragment's
// group ks, A's column t its column 2t, A's column t + 4 its column 2t + 1,
// as the transposed tiles order their rows; registers (row g, t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4); p and ds are finite, so split<true>); B
// the transposed tile of D rows at b_hi (its lo tile b_lo bytes past it),
// in 64-channel products; the two cross terms, then hi hi.  Issued and
// waited for.
template <int D, int KS>
__device__ __forceinline__ void mma3_rs(float (&d)[D <= 64 ? 1 : D / 64][D <= 64 ? D / 2 : 32],
                                        const float (&x)[KS / 2], uint32_t b_hi, uint32_t b_lo) {
  constexpr int NB = D <= 64 ? 1 : D / 64;
  uint32_t hi[KS / 8][4], lo[KS / 8][4];
#pragma unroll
  for (int ks = 0; ks < KS / 8; ++ks)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      split<true>(x[4 * ks + 2 * rr], hi[ks][rr], lo[ks][rr]);
      split<true>(x[4 * ks + 2 * rr + 1], hi[ks][2 + rr], lo[ks][2 + rr]);
    }
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS / 8; ++ks)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(d[nb], lo[ks], t_desc<KS, D>(b_hi, nb, ks));
#pragma unroll
  for (int ks = 0; ks < KS / 8; ++ks)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(d[nb], hi[ks], t_desc<KS, D>(b_hi + b_lo, nb, ks));
#pragma unroll
  for (int ks = 0; ks < KS / 8; ++ks)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(d[nb], hi[ks], t_desc<KS, D>(b_hi, nb, ks));
  wgmma_commit();
  wgmma_wait();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) hold(d[nb]);
#pragma unroll
  for (int ks = 0; ks < KS / 8; ++ks) {
    hold(hi[ks]);
    hold(lo[ks]);
  }
}

// The dynamic shared memory of the f32 dq body: Q's and dO's hi and lo tiles
// (the block's 64 rows), the step's K, V and K^T hi and lo tiles, the rows'
// delta and v's column sums, and with a pattern its two-stage ring (a tile's
// bytes, read by both its steps).
template <int D>
struct DqTf32Sizes {
  static constexpr int BK = inner_tile<D>();
  static constexpr int KS = dq_step<D>();
  static constexpr uint32_t kQ = kTileRows * D * 4;  // one of Q's (or dO's) two tiles
  static constexpr uint32_t kK = KS * D * 4;         // one of K's, V's or K^T's two tiles
  static constexpr uint32_t kMask = kTileRows * mask_row<BK>();
  // offsets
  static constexpr uint32_t kDo = 2 * kQ;
  static constexpr uint32_t kKey = 4 * kQ;
  static constexpr uint32_t kVal = kKey + 2 * kK;
  static constexpr uint32_t kKeyT = kVal + 2 * kK;
  static constexpr uint32_t kRows = kKeyT + 2 * kK;
  static constexpr int kTiles = kRows + (kTileRows + D) * 4;
  static constexpr int kSmem = kTiles;
  static constexpr int kSmemMasked = kTiles + kStages * kMask;
};

// The dynamic shared memory of the f32 dk/dv body: K's and V's hi and lo
// tiles (the block's 64 keys), the step's Q, dO, Q^T and dO^T hi and lo
// tiles, and rings of two stages for a query tile's lse and delta and (with
// a pattern) its bytes.
template <int D>
struct DkvTf32Sizes {
  static constexpr int BQ = inner_tile<D>();
  static constexpr int QS = dkv_step<D>();
  static constexpr uint32_t kK = kTileRows * D * 4;  // one of K's (or V's) two tiles
  static constexpr uint32_t kQ = QS * D * 4;         // one of Q's, dO's, Q^T's or dO^T's two tiles
  static constexpr uint32_t kRows = 2 * BQ * 4;      // one stage's lse and delta
  static constexpr uint32_t kMaskRow = mask_row<kTileRows>();  // a staged pattern row (a query)
  static constexpr uint32_t kMask = BQ * kMaskRow;
  // offsets
  static constexpr uint32_t kVal = 2 * kK;
  static constexpr uint32_t kQry = 4 * kK;
  static constexpr uint32_t kDo = kQry + 2 * kQ;
  static constexpr uint32_t kQryT = kDo + 2 * kQ;
  static constexpr uint32_t kDoT = kQryT + 2 * kQ;
  static constexpr uint32_t kRowRing = kDoT + 2 * kQ;
  static constexpr int kSmem = kRowRing + kStages * kRows;
  static constexpr int kSmemMasked = kSmem + kStages * kMask;
};

// One step (KS keys at k0) of dq for the block's 64 query rows: S and dP,
// mask, p and ds, then dQ += dS K.  q_hi, do_hi, k_hi, v_hi, kt_hi: the hi
// tiles (each lo tile beside its hi tile); ms: the step's first column in
// its tile's staged pattern (unread without one); lse2 and delta: the
// thread's two rows' lse * log2(e) and delta.
template <int D>
__device__ __forceinline__ void dq_step_tf32(const Problem& p, int q0, int k0, uint32_t q_hi, uint32_t do_hi,
                                             uint32_t k_hi, uint32_t v_hi, uint32_t kt_hi, const uint8_t* ms,
                                             const Frag& f, const float (&lse2)[2], const float (&delta)[2],
                                             float (&dq)[D <= 64 ? 1 : D / 64][D <= 64 ? D / 2 : 32]) {
  using S = DqTf32Sizes<D>;
  constexpr int KS = S::KS;

  // read before the products, which hide them
  uint32_t allow[2];
  key_allow<KS, S::BK>(p, ms, f, k0, allow);

  Acc3<KS> sa, pa;
  wgmma_fence();
  scores3_tf32<D, KS>(sa, q_hi, S::kQ, k_hi, S::kK);
  scores3_tf32<D, KS>(pa, do_hi, S::kQ, v_hi, S::kK);
  wgmma_commit();
  wgmma_wait();
  finish3(sa);
  finish3(pa);
  float(&s)[KS / 2] = sa.x;
  float(&dp)[KS / 2] = pa.x;

  const float sc = p.scale * kLog2e;
  const float neg = __fmul_rn(kNeg, kLog2e);
  if (plain_tile<KS>(p, q0, k0))
    mask_scores<KS, true>(s, f, p, q0, k0, sc, neg, allow);
  else
    mask_scores<KS, false>(s, f, p, q0, k0, sc, neg, allow);

  // ds = p (dp - delta), p = 2^(s - lse log2 e), in place
#pragma unroll
  for (int j = 0; j < KS / 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * rr + e;
        dp[i] = ex2(s[i] - lse2[rr]) * (dp[i] - delta[rr]);
      }

  mma3_rs<D, KS>(dq, dp, kt_hi, S::kK);
}

// One step (QS query rows at i0) of dk/dv for the block's 64 keys: S^T and
// dP^T, mask, p and ds, then dV += P^T dO, `between()` (the next step's
// loads: registers in flight only under dK, beside the fewest others) and
// dK += dS^T Q.  k_hi, v_hi, q_hi, do_hi, qt_hi, dot_hi: the hi tiles (each
// lo tile beside its hi tile); lse, delta: the step's rows of its tile's
// staged lse and delta; ms: the step's first row of its tile's staged
// pattern (unread without one); `keep[rr]` is 0 for a padded key, all ones
// otherwise.
template <int D, typename F>
__device__ __forceinline__ void dkv_step_tf32(const Problem& p, int i0, int k0, uint32_t k_hi, uint32_t v_hi,
                                              uint32_t q_hi, uint32_t do_hi, uint32_t qt_hi, uint32_t dot_hi,
                                              const float* lse, const float* delta, const uint8_t* ms,
                                              const Frag& f, const uint32_t (&keep)[2],
                                              float (&dk)[D <= 64 ? 1 : D / 64][D <= 64 ? D / 2 : 32],
                                              float (&dv)[D <= 64 ? 1 : D / 64][D <= 64 ? D / 2 : 32],
                                              F&& between) {
  using S = DkvTf32Sizes<D>;
  constexpr int QS = S::QS;

  // the pattern bytes of this thread's pairs, read before the products so
  // that they hide them: staged row c (a query) starts at its own shift
  uint32_t allow[2] = {keep[0], keep[1]};
  const bool use_mask = p.mask != nullptr;
  if (use_mask) {
    const uint32_t mask_lo = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p.mask));
    uint32_t bits[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < QS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + f.col + e;
        const uint8_t* mrow = ms + c * S::kMaskRow + ((mask_lo + static_cast<uint32_t>((i0 + c) * p.n)) & 15u);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) bits[rr] |= static_cast<uint32_t>(mrow[f.rows[rr]] != 0) << (2 * j + e);
      }
    allow[0] &= bits[0];
    allow[1] &= bits[1];
  }

  Acc3<QS> sa, pa;
  wgmma_fence();
  scores3_tf32<D, QS>(sa, k_hi, S::kK, q_hi, S::kQ);
  scores3_tf32<D, QS>(pa, v_hi, S::kK, do_hi, S::kQ);
  wgmma_commit();
  wgmma_wait();
  finish3(sa);
  finish3(pa);
  float(&s)[QS / 2] = sa.x;
  float(&dp)[QS / 2] = pa.x;

  const float sc = p.scale * kLog2e;
  const float neg = __fmul_rn(kNeg, kLog2e);
  const bool plain = !(use_mask | (p.kmask != nullptr)) & (k0 + kTileRows <= p.n) &
                     ((p.causal == 0) | (i0 >= k0 + kTileRows - 1));
  if (plain)
    mask_scores_t<QS, true>(s, f, p, i0, k0, sc, neg, allow);
  else
    mask_scores_t<QS, false>(s, f, p, i0, k0, sc, neg, allow);

  // p = 2^(s - lse log2 e), ds = p (dp - delta), in place
#pragma unroll
  for (int j = 0; j < QS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + f.col + e;
      const float lse2 = __fmul_rn(lse[c], kLog2e);
      const float dl = delta[c];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = 4 * j + 2 * rr + e;
        const float pr = ex2(s[i] - lse2);
        dp[i] = pr * (dp[i] - dl);
        s[i] = pr;
      }
    }

  // dV += P^T dO, then dK += dS^T Q, one product waited for before the next
  // split
  mma3_rs<D, QS>(dv, s, dot_hi, S::kQ);
  between();
  mma3_rs<D, QS>(dk, dp, qt_hi, S::kQ);
}

}  // namespace tc

// dq (f32) for the block's 64 query rows over `tiles` (key tiles) on the
// tensor cores in 3xTF32, or over all `ntiles` key tiles when a row of the
// block sees no key, as dq_block_tc does; first the rows' delta, written to
// `delta` (this (batch, head)'s row).  Launched with tc::kThreads threads
// and tc::DqTf32Sizes<D>::kSmem bytes of dynamic shared memory, kSmemMasked
// with a pattern.
template <int D>
__device__ __forceinline__ void dq_block_tf32(const float* __restrict__ q, const float* __restrict__ k,
                                              const float* __restrict__ v, const float* __restrict__ dout,
                                              const float* __restrict__ out, float* __restrict__ dq,
                                              float* __restrict__ delta, const Problem& p, const TileList& tiles,
                                              int ntiles) {
  using namespace tc;
  using S = DqTf32Sizes<D>;
  constexpr int BK = S::BK;
  constexpr int KS = S::KS;
  constexpr int NB = D <= 64 ? 1 : D / 64;
  constexpr int NO = D <= 64 ? D : 64;  // channels of one dQ product
  // the swizzled tiles need 1024-byte alignment
  extern __shared__ __align__(1024) uint8_t dynamic_smem[];
  const uint32_t q_hi = static_cast<uint32_t>(__cvta_generic_to_shared(dynamic_smem));
  if (q_hi & 1023u) __trap();
  const uint32_t do_hi = q_hi + S::kDo;
  const uint32_t k_hi = q_hi + S::kKey;
  const uint32_t v_hi = q_hi + S::kVal;
  const uint32_t kt_hi = q_hi + S::kKeyT;
  const uint32_t mask_ring = q_hi + S::kTiles;
  float* rows_delta = reinterpret_cast<float*>(dynamic_smem + S::kRows);
  float* vsum = rows_delta + kTileRows;
  const bool use_mask = p.mask != nullptr;

  const int q0 = blockIdx.x * kTileRows;
  Frag f = frag();
  mask_shifts(p, q0, f);

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

  const float* kb = k + p.base;
  const float* vb = v + p.base;
  StepRegs<D, KS, true> kr;
  StepRegs<D, KS, false> vr;
  // K and V of step h of key tile t into registers; at a tile's first step
  // its pattern bytes into stage st of their ring
  auto load_step = [&](int t, int h, int st) {
    kr.load(kb, t * BK + h * KS, p.n);
    vr.load(vb, t * BK + h * KS, p.n);
    if (use_mask & (h == 0)) stage_mask<kTileRows, BK>(p.mask, p.n, q0, t * BK, mask_ring + st * S::kMask);
  };

  stage_q<D>(q + p.base, q0, p.n, q_hi);
  stage_q<D>(dout + p.base, q0, p.n, do_hi);
  int jt = 0;
  bool have = next(jt);
  if (have) load_step(jt, 0, 0);
  cp_async_commit();

  // delta, two threads a row, each over half the row's channels: do against
  // out, or against v's column sums for a row that sees no key
  if (every_tile) {
    column_sums<float, D>(v, p, vsum);
    __syncthreads();
  }
  {
    const int r = threadIdx.x / 2;
    const int row = q0 + r;
    float part = 0.f;
    if (row < p.n) {
      const bool row_dead = p.lse[row] <= kDeadLse;
      const float* drow = dout + p.base + static_cast<size_t>(row) * D;
      const float* orow = out + p.base + static_cast<size_t>(row) * D;
#pragma unroll
      for (int cc = 0; cc < D / 8; ++cc) {
        const int c = (threadIdx.x % 2) * (D / 8) + cc;
        const float4 x = __ldg(reinterpret_cast<const float4*>(drow) + c);
        const float4 y = row_dead ? reinterpret_cast<const float4*>(vsum)[c]
                                  : __ldg(reinterpret_cast<const float4*>(orow) + c);
        part = fmaf(x.x, y.x, part);
        part = fmaf(x.y, y.y, part);
        part = fmaf(x.z, y.z, part);
        part = fmaf(x.w, y.w, part);
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

  int h = 0, st = 0;  // the step in its tile, the tile's stage of the pattern's ring
  while (have) {
    __syncthreads();  // the last step's K, V and K^T are no longer read
    kr.store(k_hi, kt_hi, S::kK);
    vr.store(v_hi, 0, S::kK);
    asm volatile("cp.async.wait_all;\n" ::: "memory");              // this tile's pattern bytes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the stores visible to wgmma
    __syncthreads();
    // the next step loads under this one's products; a tile's first step
    // stages its pattern bytes into the other stage (free since the last
    // barrier)
    int jn = jt, hn = h + 1, sn = st;
    bool more = true;
    if (hn == BK / KS) {
      hn = 0;
      sn = st ^ 1;
      more = next(jn);
    }
    if (more) load_step(jn, hn, sn);
    cp_async_commit();
    dq_step_tf32<D>(p, q0, jt * BK + h * KS, q_hi, do_hi, k_hi, v_hi, kt_hi,
                    dynamic_smem + S::kTiles + st * S::kMask + h * KS, f, lse2, row_delta, dq_acc);
    jt = jn;
    h = hn;
    st = sn;
    have = more;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + f.rows[rr];
    if (row >= p.n) continue;
    float* dq_row = dq + p.base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < NO / 8; ++j) {
        const int i = 4 * j + 2 * rr;
        store_pair(dq_row + nb * NO + 8 * j + f.col, dq_acc[nb][i] * p.scale, dq_acc[nb][i + 1] * p.scale);
      }
  }
}

// dk and dv (f32) for the block's 64 keys over `tiles` (query tiles) on the
// tensor cores in 3xTF32; when a row of this (batch, head) sees no key, also
// over the query tiles off the list that hold such a row, as dkv_block_tc
// does.  Launched with tc::kThreads threads and tc::DkvTf32Sizes<D>::kSmem
// bytes of dynamic shared memory, kSmemMasked with a pattern.
template <int D>
__device__ __forceinline__ void dkv_block_tf32(const float* __restrict__ q, const float* __restrict__ k,
                                               const float* __restrict__ v, const float* __restrict__ dout,
                                               float* __restrict__ dk, float* __restrict__ dv, const Problem& p,
                                               const TileList& tiles, int ntiles) {
  using namespace tc;
  using S = DkvTf32Sizes<D>;
  constexpr int BQ = S::BQ;
  constexpr int QS = S::QS;
  constexpr int NB = D <= 64 ? 1 : D / 64;
  constexpr int NO = D <= 64 ? D : 64;  // channels of one dV or dK product
  // the swizzled tiles need 1024-byte alignment
  extern __shared__ __align__(1024) uint8_t dynamic_smem[];
  const uint32_t k_hi = static_cast<uint32_t>(__cvta_generic_to_shared(dynamic_smem));
  if (k_hi & 1023u) __trap();
  const uint32_t v_hi = k_hi + S::kVal;
  const uint32_t q_hi = k_hi + S::kQry;
  const uint32_t do_hi = k_hi + S::kDo;
  const uint32_t qt_hi = k_hi + S::kQryT;
  const uint32_t dot_hi = k_hi + S::kDoT;
  const uint32_t row_ring = k_hi + S::kRowRing;
  const uint32_t mask_ring = k_hi + S::kSmem;
  const bool use_mask = p.mask != nullptr;

  const int k0 = blockIdx.x * kTileRows;
  const Frag f = frag();
  uint32_t keep[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = k0 + f.rows[rr];
    keep[rr] = (key < p.n && p.kmask != nullptr && p.kmask[key] <= 0) ? 0u : ~0u;
  }

  stage_q<D>(k + p.base, k0, p.n, k_hi);
  stage_q<D>(v + p.base, k0, p.n, v_hi);

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

  const float* qb = q + p.base;
  const float* dob = dout + p.base;
  StepRegs<D, QS, true> qr, dr;
  // Q and dO of step h of query tile t into registers; at a tile's first
  // step its lse, delta (0 past n) and pattern bytes into stage st of their
  // rings
  auto load_step = [&](int t, int h, int st) {
    const int i0 = t * BQ;
    qr.load(qb, i0 + h * QS, p.n);
    dr.load(dob, i0 + h * QS, p.n);
    if (h == 0) {
      for (int idx = threadIdx.x; idx < 2 * BQ; idx += tc::kThreads) {
        const int row = i0 + idx % BQ;
        cp_async4(row_ring + st * S::kRows + 4 * idx, (idx < BQ ? p.lse : p.delta) + min(row, p.n - 1), row < p.n);
      }
      if (use_mask) stage_mask<BQ, kTileRows>(p.mask, p.n, i0, k0, mask_ring + st * S::kMask);
    }
  };

  int it = 0;
  bool have = next(it);
  if (have) load_step(it, 0, 0);
  cp_async_commit();

  float dk_acc[NB][NO / 2], dv_acc[NB][NO / 2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) dk_acc[nb][i] = dv_acc[nb][i] = 0.f;

  int h = 0, st = 0;  // the step in its tile, the tile's stage of the rings
  while (have) {
    __syncthreads();  // the last step's Q, dO, Q^T and dO^T are no longer read
    qr.store(q_hi, qt_hi, S::kQ);
    dr.store(do_hi, dot_hi, S::kQ);
    asm volatile("cp.async.wait_all;\n" ::: "memory");              // this tile's lse, delta and pattern
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the stores visible to wgmma
    __syncthreads();
    // the next step loads under this one's dK product; a tile's first step
    // stages its rows and pattern into the other stage (free since the last
    // barrier)
    int nt = it, hn = h + 1, sn = st;
    bool more = true;
    if (hn == BQ / QS) {
      hn = 0;
      sn = st ^ 1;
      more = next(nt);
    }
    const float* rows = reinterpret_cast<const float*>(dynamic_smem + S::kRowRing + st * S::kRows);
    dkv_step_tf32<D>(p, it * BQ + h * QS, k0, k_hi, v_hi, q_hi, do_hi, qt_hi, dot_hi, rows + h * QS,
                     rows + BQ + h * QS, dynamic_smem + S::kSmem + st * S::kMask + h * QS * S::kMaskRow, f, keep,
                     dk_acc, dv_acc, [&] {
                       if (more) load_step(nt, hn, sn);
                       cp_async_commit();
                     });
    it = nt;
    h = hn;
    st = sn;
    have = more;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = k0 + f.rows[rr];
    if (key >= p.n) continue;
    float* dk_row = dk + p.base + static_cast<size_t>(key) * D;
    float* dv_row = dv + p.base + static_cast<size_t>(key) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < NO / 8; ++j) {
        const int i = 4 * j + 2 * rr;
        store_pair(dk_row + nb * NO + 8 * j + f.col, dk_acc[nb][i] * p.scale, dk_acc[nb][i + 1] * p.scale);
        store_pair(dv_row + nb * NO + 8 * j + f.col, dv_acc[nb][i], dv_acc[nb][i + 1]);
      }
  }
}

// The block's tiles in dynamic shared memory for a dq or a dk/dv entry: the
// bf16 body's (tc::DqSizes, tc::DkvSizes) or the f32 body's
// (tc::DqTf32Sizes, tc::DkvTf32Sizes); both are launched by launch_wg, one
// warpgroup a block.
template <typename T, int D>
using DqBlockSizes = std::conditional_t<std::is_same<T, float>::value, tc::DqTf32Sizes<D>, tc::DqSizes<D>>;
template <typename T, int D>
using DkvBlockSizes = std::conditional_t<std::is_same<T, float>::value, tc::DkvTf32Sizes<D>, tc::DkvSizes<D>>;

}  // namespace flash
