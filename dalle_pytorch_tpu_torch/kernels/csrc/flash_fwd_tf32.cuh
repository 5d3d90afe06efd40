// The flash-attention forward body for f32 on Hopper's tensor cores
// (sm_90a, `wgmma` on TF32 operands, three products for one), in plain
// CUDA C++ with inline PTX.
//
// Replaces, for f32 inputs: dalle_pytorch_tpu/kernels/flash_attention.py
// `_fwd_kernel` (dense grid, flash_fwd.cu) and `_fwd_kernel_compact`
// (compacted grid, flash_compact.cu).  Both entries call fwd_block_tf32 for
// float and fwd_block_tc (flash_fwd_tc.cuh) for __nv_bfloat16; the dtype
// alone picks the body, and both entries walk their TileList through it, so
// the compacted grid still equals the dense grid with the same mask bit for
// bit.
//
// Computes what fwd_block_tc computes, in f32: S = Q K^T times scale *
// log2 e after the product, masked (-1e30 for a causal-future, padded or
// pattern-forbidden key, -inf past n), the online softmax once per key tile
// in base 2, out = P V / l in f32 and lse = m ln 2 + log(max(l, 1e-30));
// rows that see no key go to store_dead_rows.  The same walk in two more
// modes (tc::Walk, as the bf16 body has them) is the f32 VFA pair
// (flash_vfa_tc.cuh; `_max_kernel_compact` and `_fwd_kernel_compact_vfa`):
// kMax keeps each row's maximum of S in natural units and stages no V
// (Tf32Sizes<D, false>, KvRegs<D, false>), kFixed accumulates p = 2^((s -
// gmax) log2 e) against it with no rescale.  All three walks compute S in
// scores_tf32, so the VFA pair's two passes compute it bit for bit alike.
// The walks' instantiations are separate; the forward's compiles as before.
//
// What bounds it on this card: the two matrix products, 4 * n * n * d
// operations per (batch, head), halved by causality and cut further by a
// pattern.  The repo holds f32 to 1e-4, which one TF32 product (11
// significant bits) misses, so every product runs as three (3xTF32): each
// operand is split x = hi + lo, hi = x rounded to TF32 (cvt.rna) and lo =
// the remainder (exact in f32) rounded to TF32 again, and a b = (a_lo b_hi
// + a_hi b_lo) + a_hi b_hi, the two small cross terms first; the dropped
// a_lo b_lo is about 2^-22 of the product.  That is three times the TF32
// work: 494.7 / 3 = 165 TFLOP/s against the FMA units' 67.
//
// What the design does about it:
//   - One warpgroup (128 threads) owns the block's 64 query rows, wgmma's M.
//     S = Q K^T is wgmma m64n{BK}k8 .tf32, A = Q and B = the K tile from
//     shared memory; O += P V is wgmma m64n{64|32}k8 with A = P in
//     registers and B = V^T from shared memory.  Each product is its three
//     passes into one accumulator in one commit group.
//   - A TF32 operand in shared memory must be K-major (the transpose bit is
//     for f16 and bf16 only), so V is staged transposed: channels as rows,
//     keys contiguous.  cp.async can neither split nor transpose, so K and V
//     pass through registers: the next key tile is loaded from device
//     memory while this one is in the products, then split and stored (V in
//     4 x 4 blocks transposed in registers, every store 16 bytes).
//   - Every f32 tile has rows of 128 bytes (32 floats) under wgmma's
//     128-byte swizzle, its hi and lo tiles side by side: Q once, K and V^T
//     one stage each, the pattern's bytes in a two-stage cp.async ring.  At
//     d 64 that is 96 KB (106 KB with a pattern), so two blocks share an SM
//     and one's products run under the other's softmax and stores; at d 128
//     128 KB (134 KB), one block.  A second K/V stage at d 128, whose stores
//     ran under QK^T, measured slower on an H100 (0.375 against 0.347 ms at
//     bh 32, n 1280): QK^T at N = 32 is already bound by shared-memory
//     reads, and the stores share them.
//   - P leaves the softmax in the S accumulator's layout, columns 2t and
//     2t + 1 of each 8-column group (t = lane % 4); the TF32 A fragment
//     holds columns t and t + 4.  Rather than move P between lanes, V^T's
//     keys are stored in that order (KvRegs), so the accumulator's two
//     elements are A's two columns as they lie; P is split in registers.  l
//     sums the f32 p before the split, and the row's largest score gives p
//     = 2^0 = 1 exactly (hi 1, lo 0), so l >= 1 on live rows.
//   - The split rounds hi with cvt.rna and the lo parts and p with the same
//     rounding in two integer operations (to_tf32_finite).
//   - Masking (key_allow, mask_scores, the plain_tile fast path), the
//     online softmax (online_softmax) and the epilogue (finish_rows) are the
//     bf16 body's.
//
// What remains: the split and the stores of the next tile run between the
// products, not under them (no warp specialisation, no TMA); the 64 x 32
// tile at d 128 keeps QK^T at N = 32 (kernels/flash_attention.py's tables
// and the other f32 bodies share the tile constants).
#pragma once

#include "flash_fwd_tc.cuh"

namespace flash {
namespace tc {

// The shared-memory layout of an f32 tile of R rows: each row's floats in
// rows of 128 bytes (32 floats), one block of R such rows after another,
// the 16-byte chunk c of a 128-byte row stored at c ^ (address bits 7..9) as
// wgmma's 128-byte swizzle reads it (an f32 row of 32 floats has the bytes
// of a bf16 row of 64, Layout<64>).  Every tile starts on 1024 bytes.
// Byte offset of chunk c (floats 4c .. 4c + 3) of row r:
template <int R>
__device__ __forceinline__ uint32_t f32_chunk(int r, int c) {
  const uint32_t off = (c / 8) * (R * 128) + r * 128 + (c % 8) * 16;
  return off ^ (((off >> 7) & 7) << 4);
}

// A K-major TF32 operand of the R-row f32 tile at `base`: the 8 floats (32
// bytes) of k-step ks.  Eight-row groups lie 1024 bytes apart.
template <int R>
__device__ __forceinline__ uint64_t f32_desc(uint32_t base, int ks) {
  const int c = 2 * ks;
  return make_desc(base + (c / 8) * (R * 128) + (c % 8) * 16, 16, 1024, 1);
}

// The dynamic shared memory of an f32 walk: Q's hi and lo tiles, K's and
// (kValues) V^T's, one stage each, and with a pattern its two-stage ring.
template <int D, bool kValues = true>
struct Tf32Sizes {
  static constexpr int BK = inner_tile<D>();
  static constexpr uint32_t kQ = kTileRows * D * 4;  // one of Q's two tiles
  static constexpr uint32_t kKV = BK * D * 4;        // one of K's, or of V^T's, two tiles
  static constexpr uint32_t kMask = kTileRows * mask_row<BK>();
  static constexpr int kTiles = 2 * kQ + (kValues ? 4 : 2) * kKV;
  static constexpr int kSmem = kTiles;
  static constexpr int kSmemMasked = kTiles + kStages * kMask;
};

#define FLASH_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FLASH_F16(i) FLASH_F4(i), FLASH_F4(i + 4), FLASH_F4(i + 8), FLASH_F4(i + 12)

// d (+)= A B, m64n64k8 TF32, A and B from shared memory, both K-major;
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void mma_tf32(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : FLASH_F16(0), FLASH_F16(16)
      : "l"(a), "l"(b), "r"(accumulate));
}

// the same at m64n32k8
__device__ __forceinline__ void mma_tf32(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : FLASH_F16(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k8 TF32, A (four TF32 registers: rows g and g + 8,
// columns t and t + 4, g = lane / 4) from registers, B from shared memory,
// K-major
__device__ __forceinline__ void mma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : FLASH_F16(0), FLASH_F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// the same at m64n32k8
__device__ __forceinline__ void mma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : FLASH_F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef FLASH_F16
#undef FLASH_F4

// x rounded to TF32 (to nearest, ties away from zero): the f32 bits with
// the low 13 cleared (inf and NaN kept)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// The same for a finite x, in two integer operations (cvt.rna takes four
// here, the other two for inf and NaN): half a TF32 step added to the bits
// rounds the magnitude, carrying into the exponent where it must.  For the
// lo parts (finite wherever hi is) and for p (a NaN p makes l, and so out,
// NaN whatever P V adds).
__device__ __forceinline__ uint32_t to_tf32_finite(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }

// x = hi + lo: hi is x in TF32, lo the remainder x - hi (exact in f32) in
// TF32; `Finite` takes to_tf32_finite for hi too.
template <bool Finite = false>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = Finite ? to_tf32_finite(x) : to_tf32(x);
  lo = to_tf32_finite(__fsub_rn(x, __uint_as_float(hi)));
}

// four words to shared address `at` (16-byte aligned)
__device__ __forceinline__ void st_shared4(uint32_t at, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}

// The four floats of x split: the hi parts to shared address `hi`, the lo
// parts to `hi + lo_off` (the lo tile lies beside the hi tile, same layout).
__device__ __forceinline__ void store_split(uint32_t hi, uint32_t lo_off, float4 x) {
  uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
  split(x.x, h0, l0);
  split(x.y, h1, l1);
  split(x.z, h2, l2);
  split(x.w, h3, l3);
  st_shared4(hi, h0, h1, h2, h3);
  st_shared4(hi + lo_off, l0, l1, l2, l3);
}

// floats 4c .. 4c + 3 of row `row` of one (batch, head)'s (n, D) matrix;
// zeros past n
template <int D>
__device__ __forceinline__ float4 load_row4(const float* __restrict__ src, int row, int n, int c) {
  return row < n ? __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(row) * D) + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
}

// The 64 query rows at q0 split into Q's hi tile at `q_hi` and its lo tile
// beside it: all loads first, then the stores (float4 idx % C of row idx /
// C, idx = tid + i * kThreads).
template <int D>
__device__ __forceinline__ void stage_q(const float* __restrict__ q, int q0, int n, uint32_t q_hi) {
  constexpr int C = D / 4;  // float4s in a row
  constexpr int N = kTileRows * C / kThreads;
  float4 x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    x[i] = load_row4<D>(q, q0 + idx / C, n, idx % C);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    store_split(q_hi + f32_chunk<kTileRows>(idx / C, idx % C), Tf32Sizes<D>::kQ, x[i]);
  }
}

// One key tile's K and V in registers, between their load from device
// memory and their split into shared memory.  K by rows (float4 idx % C of
// row idx / C, idx = tid + i * kThreads), so a warp's loads and stores cover
// whole 128-byte rows.  V^T is K-major with its keys in a
// permuted order: in each group of 8 keys, key 2t lies at position t and
// key 2t + 1 at position t + 4 (t = 0..3), the order in which P's
// accumulator fragment already holds its columns as the TF32 A fragment
// reads them (fwd_tile_tf32), so P needs no shuffle.  A thread carries V
// in blocks of 4 channels by the 4 keys of one 16-byte chunk a = idx % A of
// V^T's rows (keys 8c + e + 2kk of chunk 2c + e), transposed in registers,
// channels 4b .. 4b + 3 for b = idx / A; the chunks vary fastest across a
// warp, so its stores fill whole rows of V^T.  (The same offsets written as
// tid / C + i * (kThreads / C) compiled to 216 registers instead of 252 and
// ran 0.402 against 0.354 ms at bh 32, n 1280, d 128 on an H100.)  Without
// kValues (the max pass) K alone.
template <int D, bool kValues = true>
struct KvRegs {
  static constexpr int BK = inner_tile<D>();
  static constexpr int C = D / 4;                     // float4s in a row of K or V
  static constexpr int A = BK / 4;                    // 16-byte chunks in a row of V^T
  static constexpr int kK = BK * C / kThreads;        // K's float4s a thread carries
  static constexpr int kV = A * (D / 4) / kThreads;   // V's 4 x 4 blocks a thread carries
  float4 k[kK];
  float4 v[kValues ? kV : 1][4];  // v[i][kk]: key 8(a / 2) + a % 2 + 2kk, channels 4b .. 4b + 3

  // the key tile at k0 of this (batch, head)'s K and V (kb, vb; vb unused
  // without kValues); zeros past n
  __device__ __forceinline__ void load(const float* __restrict__ kb, const float* __restrict__ vb, int k0,
                                       int n) {
#pragma unroll
    for (int i = 0; i < kK; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      k[i] = load_row4<D>(kb, k0 + idx / C, n, idx % C);
    }
    if constexpr (kValues) {
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int a = idx % A;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) v[i][kk] = load_row4<D>(vb, k0 + 8 * (a / 2) + a % 2 + 2 * kk, n, idx / A);
      }
    }
  }

  // split into K's tiles at k_hi (BK rows of D floats) and V^T's at v_hi (D
  // rows of BK floats; unused without kValues), each lo tile `lo_off` bytes
  // past its hi tile
  __device__ __forceinline__ void store(uint32_t k_hi, uint32_t v_hi, uint32_t lo_off) const {
#pragma unroll
    for (int i = 0; i < kK; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      store_split(k_hi + f32_chunk<BK>(idx / C, idx % C), lo_off, k[i]);
    }
    if constexpr (kValues) {
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int a = idx % A;
        const int ch = 4 * (idx / A);
        store_split(v_hi + f32_chunk<D>(ch, a), lo_off, make_float4(v[i][0].x, v[i][1].x, v[i][2].x, v[i][3].x));
        store_split(v_hi + f32_chunk<D>(ch + 1, a), lo_off,
                    make_float4(v[i][0].y, v[i][1].y, v[i][2].y, v[i][3].y));
        store_split(v_hi + f32_chunk<D>(ch + 2, a), lo_off,
                    make_float4(v[i][0].z, v[i][1].z, v[i][2].z, v[i][3].z));
        store_split(v_hi + f32_chunk<D>(ch + 3, a), lo_off,
                    make_float4(v[i][0].w, v[i][1].w, v[i][2].w, v[i][3].w));
      }
    }
  }
};

// S = Q K^T in 3xTF32 for the block's 64 query rows and the key tile at k0
// (ms: its staged pattern or null): the two cross terms, then hi hi, into
// one accumulator; times `sc` after the product and masked in registers,
// `neg` for a causal-future, padded or pattern-forbidden key, -inf past n.
// Every f32 walk computes its scores here, so the VFA pair's two passes
// compute the same S bit for bit.  q_hi, k_hi: the hi tiles, each lo tile
// beside its hi tile.
template <int D>
__device__ __forceinline__ void scores_tf32(const Problem& p, int q0, int k0, uint32_t q_hi, uint32_t k_hi,
                                            const uint8_t* ms, const Frag& f, float sc, float neg,
                                            float (&s)[inner_tile<D>() / 2]) {
  using S = Tf32Sizes<D>;
  constexpr int BK = S::BK;
  const uint32_t q_lo = q_hi + S::kQ, k_lo = k_hi + S::kKV;

  // read before the product, which hides them
  uint32_t allow[2];
  key_allow<BK>(p, ms, f, k0, allow);

#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks)
    mma_tf32(s, f32_desc<kTileRows>(q_lo, ks), f32_desc<BK>(k_hi, ks), ks > 0);
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) mma_tf32(s, f32_desc<kTileRows>(q_hi, ks), f32_desc<BK>(k_lo, ks), 1);
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) mma_tf32(s, f32_desc<kTileRows>(q_hi, ks), f32_desc<BK>(k_hi, ks), 1);
  wgmma_commit();
  wgmma_wait();
  hold(s);

  if (plain_tile<BK>(p, q0, k0))
    mask_scores<BK, true>(s, f, p, q0, k0, sc, neg, allow);
  else
    mask_scores<BK, false>(s, f, p, q0, k0, sc, neg, allow);
}

// One key tile of a walk for the block's 64 query rows: S (scores_tf32;
// times scale * log2 e for kOnline, in natural units for the VFA pair), the
// walk's step (walk_step: the online softmax, the row maxima, or p against
// the fixed maximum), and but for kMax O += P V in 3xTF32 (P from
// registers).  q_hi, k_hi, v_hi: the hi tiles, each lo tile beside its hi
// tile; ms: the tile's staged pattern (null without one).
template <int D, Walk W = Walk::kOnline>
__device__ __forceinline__ void fwd_tile_tf32(const Problem& p, int q0, int k0, uint32_t q_hi, uint32_t k_hi,
                                              uint32_t v_hi, const uint8_t* ms, const Frag& f,
                                              float (&o)[D <= 64 ? 1 : D / 64][D <= 64 ? D / 2 : 32],
                                              float (&m)[2], float (&l)[2]) {
  using S = Tf32Sizes<D>;
  constexpr int BK = S::BK;
  constexpr int NB = D <= 64 ? 1 : D / 64;  // PV products per k-step (64 channels each)
  const uint32_t v_lo = v_hi + S::kKV;

  float s[BK / 2];
  scores_tf32<D>(p, q0, k0, q_hi, k_hi, ms, f, W == Walk::kOnline ? p.scale * kLog2e : p.scale, kNeg, s);
  walk_step<D, W>(s, o, m, l);
  if constexpr (W == Walk::kMax) return;

  // P as the A fragments of the PV product, split (p lies in [0, 1], so
  // split<true>): k-step ks is the S fragment's group ks; A's column t is
  // key 2t (the fragment's first element of the row), column t + 4 key 2t +
  // 1 (its second), as V^T's keys are stored (KvRegs); registers (row g,
  // t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      split<true>(s[4 * ks + 2 * rr], ph[ks][rr], pl[ks][rr]);
      split<true>(s[4 * ks + 2 * rr + 1], ph[ks][2 + rr], pl[ks][2 + rr]);
    }

  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(o[nb], pl[ks], f32_desc<D>(v_hi + nb * 64 * 128, ks));
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(o[nb], ph[ks], f32_desc<D>(v_lo + nb * 64 * 128, ks));
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma_tf32(o[nb], ph[ks], f32_desc<D>(v_hi + nb * 64 * 128, ks));
  wgmma_commit();
  wgmma_wait();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) hold(o[nb]);
#pragma unroll
  for (int ks = 0; ks < BK / 8; ++ks) {
    hold(ph[ks]);
    hold(pl[ks]);
  }
}

}  // namespace tc

// The f32 walk for the block's 64 query rows over `tiles`, on the tensor
// cores in 3xTF32.  kOnline, the forward: writes out (f32) and lse = m ln 2
// + log(max(l, 1e-30)) (m the base-2 running maximum).  kMax, the VFA max
// pass: stages no V and writes each row's maximum of its masked scores to
// `lse` as gmax (v and out unused, null).  kFixed, the VFA fixed-max pass:
// reads gmax from p.lse, writes out and lse = gmax + log(max(l, 1e-30)).
// The forward and the fixed-max pass hand rows that saw no key to
// store_dead_rows.  Launched with tc::kThreads threads and tc::Tf32Sizes<D,
// W != Walk::kMax>::kSmem bytes of dynamic shared memory, kSmemMasked with a
// pattern.
template <int D, tc::Walk W = tc::Walk::kOnline>
__device__ __forceinline__ void fwd_block_tf32(const float* __restrict__ q, const float* __restrict__ k,
                                               const float* __restrict__ v, float* __restrict__ out,
                                               float* __restrict__ lse, const Problem& p, const TileList& tiles) {
  using namespace tc;
  constexpr bool kValues = W != Walk::kMax;
  using S = Tf32Sizes<D, kValues>;
  constexpr int BK = S::BK;
  constexpr int NB = D <= 64 ? 1 : D / 64;
  constexpr int NO = D <= 64 ? D : 64;  // channels of one PV product
  // the swizzled tiles need 1024-byte alignment
  extern __shared__ __align__(1024) uint8_t dynamic_smem[];
  const uint32_t q_hi = static_cast<uint32_t>(__cvta_generic_to_shared(dynamic_smem));
  if (q_hi & 1023u) __trap();
  const uint32_t k_hi = q_hi + 2 * S::kQ;
  const uint32_t v_hi = k_hi + 2 * S::kKV;  // past the tiles in the max pass, never used
  const uint32_t mask_ring = q_hi + S::kTiles;
  const bool use_mask = p.mask != nullptr;

  const int q0 = blockIdx.x * kTileRows;
  Frag f = frag();
  mask_shifts(p, q0, f);

  const float* kb = k + p.base;
  const float* vb = nullptr;
  if constexpr (kValues) vb = v + p.base;
  KvRegs<D, kValues> kv;
  // K and V (not in the max pass) of key tile t into registers, its pattern
  // bytes into stage st of their ring
  auto load_tile = [&](int t, int st) {
    kv.load(kb, vb, t * BK, p.n);
    if (use_mask) stage_mask<kTileRows, BK>(p.mask, p.n, q0, t * BK, mask_ring + st * S::kMask);
  };

  stage_q<D>(q + p.base, q0, p.n, q_hi);
  int cur = tiles.begin, jt = 0;
  bool have = tiles.next(cur, jt);
  if (have) load_tile(jt, 0);
  cp_async_commit();

  float o[NB][NO / 2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) o[nb][i] = 0.f;
  float m[2], l[2] = {0.f, 0.f};
  start_rows<W>(p, q0, f, m);

  int st = 0;  // stage of the pattern's ring
  while (have) {
    __syncthreads();  // the last tile's K and V^T are no longer read
    kv.store(k_hi, v_hi, S::kKV);
    asm volatile("cp.async.wait_all;\n" ::: "memory");              // this tile's pattern bytes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the stores visible to wgmma
    __syncthreads();
    // the next tile loads under this tile's products, its pattern bytes
    // into the other stage of their ring (free since the last barrier)
    int jn = 0;
    const bool more = tiles.next(cur, jn);
    if (more) load_tile(jn, st ^ 1);
    cp_async_commit();
    fwd_tile_tf32<D, W>(p, q0, jt * BK, q_hi, k_hi, v_hi, dynamic_smem + S::kTiles + st * S::kMask, f, o, m,
                        l);
    jt = jn;
    have = more;
    st ^= 1;
  }
  finish_rows<float, D, W>(v, out, lse, p, q0, f, o, m, l);
}

// The block's tiles in dynamic shared memory for a forward entry: the bf16
// body's (tc::Sizes) or the f32 body's (tc::Tf32Sizes); both are launched by
// launch_wg, one warpgroup a block.
template <typename T, int D>
using FwdSizes = std::conditional_t<std::is_same<T, float>::value, tc::Tf32Sizes<D>, tc::Sizes<D>>;

}  // namespace flash
