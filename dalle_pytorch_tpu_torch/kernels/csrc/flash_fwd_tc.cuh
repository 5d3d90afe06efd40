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
// What remains: no warp specialisation (the one warpgroup issues the loads,
// both products and the softmax in turn; other blocks on the SM fill its
// gaps), no persistent blocks, no TMA, and the 64 x 32 tile at d 128, whose
// QK^T product is a small N = 32 (kernels/flash_attention.py's tables and
// the f32 body share the tile constants).
#pragma once

#include <type_traits>

#include "flash_tiles.cuh"

namespace flash {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // one warpgroup: wgmma's 64 rows
constexpr int kStages = 2;     // K/V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The shared-memory layout of a tile of R rows by D bf16 channels: the
// channels in rows of W = min(128, 2D) bytes, D * 2 / W blocks of R such rows
// one after the other, the 16-byte chunk c of a row stored at c ^ (address
// bits 7..9) as wgmma's 128-byte swizzle (64-byte at d 32: bits 7..8) reads
// it.  Every tile starts on 1024 bytes.
template <int D>
struct Layout {
  static constexpr int kRowBytes = 2 * D < 128 ? 2 * D : 128;
  static constexpr int kChunks = kRowBytes / 16;                   // 16-byte chunks in a row
  static constexpr uint64_t kSwizzle = kRowBytes == 128 ? 1 : 2;  // descriptor: 128B, 64B

  // byte offset of chunk c (of D / 8) of row r, in a tile of R rows
  template <int R>
  static __device__ __forceinline__ uint32_t chunk(int r, int c) {
    const uint32_t off = (c / kChunks) * (R * kRowBytes) + r * kRowBytes + (c % kChunks) * 16;
    return off ^ (((off >> 7) & (kChunks - 1)) << 4);
  }
};

template <int D>
struct Sizes {
  static constexpr int BK = inner_tile<D>();
  static constexpr uint32_t kQ = kTileRows * D * 2;  // bytes of the Q tile
  static constexpr uint32_t kKV = BK * D * 2;        // bytes of one K or V tile
  // a staged pattern row: the 16-byte chunks that hold the row's BK bytes,
  // which start up to 15 bytes into the first (a stride that also keeps the
  // eight rows a warp reads on distinct banks)
  static constexpr uint32_t kMaskRow = BK + 16;
  static constexpr uint32_t kMask = kTileRows * kMaskRow;
  // the dynamic shared memory a block asks for: Q, the K and V rings, and
  // with a pattern its ring
  static constexpr int kTiles = kQ + 2 * kStages * kKV;
  static constexpr int kSmemMasked = kTiles + kStages * kMask;
};

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (all in 16-byte units), swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}

// A K-major operand (Q as A, the K tile as B) of an R-row tile at `base`:
// the 16 channels of k-step ks.  Eight-row groups lie 8 * W bytes apart; the
// leading offset is unused under a swizzle.
template <int D, int R>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int ks) {
  using L = Layout<D>;
  const int c = 2 * ks;
  const uint32_t start = base + (c / L::kChunks) * (R * L::kRowBytes) + (c % L::kChunks) * 16;
  return make_desc(start, 16, 8 * L::kRowBytes, L::kSwizzle);
}

// The V tile as an MN-major B (transposed): keys 16 * ks .. + 15, channel
// block nb (64 channels; all 32 at d 32).
template <int D, int R>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t base, int ks, int nb) {
  using L = Layout<D>;
  const uint32_t start = base + nb * (R * L::kRowBytes) + ks * 16 * L::kRowBytes;
  return make_desc(start, R * L::kRowBytes, 8 * L::kRowBytes, L::kSwizzle);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence, wait or issue.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define FLASH_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FLASH_F16(i) FLASH_F4(i), FLASH_F4(i + 4), FLASH_F4(i + 8), FLASH_F4(i + 12)

// d (+)= A B, m64n64k16, A and B from shared memory, both K-major;
// `accumulate` 0 overwrites d.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : FLASH_F16(0), FLASH_F16(16)
      : "l"(a), "l"(b), "r"(accumulate));
}

// the same at m64n32k16
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : FLASH_F16(0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k16, A (four registers of bf16 pairs) from registers, B
// from shared memory MN-major (transposed)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FLASH_F16(0), FLASH_F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// the same at m64n32k16
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : FLASH_F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef FLASH_F16
#undef FLASH_F4

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// cp.async the rows [r0, r0 + R) of one (batch, head)'s (n, D) matrix `src`
// into an R-row tile at `dst`; rows past n are zero-filled.
template <int D, int R>
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ src, int r0, int n, uint32_t dst) {
  constexpr int C = D / 8;
#pragma unroll
  for (int i = 0; i < R * C / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / C;
    const int c = idx % C;
    const bool valid = r0 + r < n;
    cp_async16(dst + Layout<D>::template chunk<R>(r, c),
               src + static_cast<size_t>(valid ? r0 + r : 0) * D + c * 8, valid);
  }
}

// cp.async the pattern's bytes for the 64 query rows at q0 and the BK keys
// at k0 into a mask tile: row r's bytes start `shift` = (address of the
// row's first byte) & 15 bytes into its kMaskRow-byte row, as the mask's
// 16-byte chunks that hold them are copied whole (the neighbouring rows'
// bytes in them are never read).  Rows past n and chunks wholly past the
// row's last key are zero-filled.
template <int D>
__device__ __forceinline__ void stage_mask(const uint8_t* __restrict__ mask, int n, int q0, int k0,
                                           uint32_t dst) {
  constexpr int BK = inner_tile<D>();
  constexpr int C = BK / 16 + 1;  // chunks per row
  for (int idx = threadIdx.x; idx < kTileRows * C; idx += kThreads) {
    const int r = idx / C;
    const int c = idx % C;
    const int row = q0 + r;
    const uint8_t* first = mask + static_cast<size_t>(row) * n + k0;
    const uint8_t* end = mask + static_cast<size_t>(row) * n + min(k0 + BK, n);
    const uint8_t* at =
        reinterpret_cast<const uint8_t*>(reinterpret_cast<uintptr_t>(first) & ~uintptr_t{15}) + 16 * c;
    const bool valid = (row < n) & (at < end);
    cp_async16(dst + r * Sizes<D>::kMaskRow + 16 * c, valid ? at : mask, valid);
  }
}

// One thread's place in the accumulator fragments: rows w*16 + lane/4 and
// +8 of the block, columns 8j + 2*(lane%4) + {0, 1} of each 8-column group j.
// Element 4j + 2*rr + e of a fragment is (row rr, column 8j + col + e).
struct Frag {
  int rows[2];   // block-relative
  int col;
  int shift[2];  // where each row's bytes start in a staged mask row
};

// Masks S (scaled into base 2) in registers, as fwd_tile does: -1e30 for a
// causal-future key, a key the pattern forbids or whose padding flag is 0,
// -inf past n.  `allow` bit 2j + e: the key of column 8j + col + e passes
// the pattern and the key padding for the row.
template <int BK, bool kPlain>
__device__ __forceinline__ void mask_scores(float (&s)[BK / 2], const Frag& f, const Problem& p, int q0,
                                            int k0, float sc, const uint32_t (&allow)[2]) {
  const bool causal = p.causal != 0;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + f.rows[rr];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * rr + e;
        const float x = s[i] * sc;
        if constexpr (kPlain) {
          s[i] = x;
        } else {
          const int col = k0 + 8 * j + f.col + e;
          const bool masked = (((allow[rr] >> (2 * j + e)) & 1u) == 0u) | (causal & (col > row));
          s[i] = col >= p.n ? -INFINITY : (masked ? kNeg : x);
        }
      }
    }
  }
}

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

  // the pattern bytes and padding flags of this thread's scores, read
  // before the product so that it hides them; padding indices clamped into
  // the array (a key past n scores -inf)
  uint32_t allow[2] = {~0u, ~0u};
  const bool use_mask = p.mask != nullptr;
  const bool use_kmask = p.kmask != nullptr;
  if (use_kmask) {
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bits |= static_cast<uint32_t>(p.kmask[min(k0 + 8 * j + f.col + e, p.n - 1)] > 0) << (2 * j + e);
    allow[0] = allow[1] = bits;
  }
  if (use_mask) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const uint8_t* mrow = ms + f.rows[rr] * Sizes<D>::kMaskRow + f.shift[rr];
      uint32_t bits = 0;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) bits |= static_cast<uint32_t>(mrow[8 * j + f.col + e] != 0) << (2 * j + e);
      allow[rr] &= bits;
    }
  }

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
  const bool plain = !(use_mask | use_kmask) & (k0 + BK <= p.n) & ((p.causal == 0) | (k0 + BK - 1 <= q0));
  if (plain)
    mask_scores<BK, true>(s, f, p, q0, k0, sc, allow);
  else
    mask_scores<BK, false>(s, f, p, q0, k0, sc, allow);

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
  Frag f;
  f.rows[0] = (threadIdx.x / 32) * 16 + lane / 4;
  f.rows[1] = f.rows[0] + 8;
  f.col = (lane % 4) * 2;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    f.shift[rr] = use_mask ? static_cast<int>(reinterpret_cast<uintptr_t>(
                                 p.mask + static_cast<size_t>(q0 + f.rows[rr]) * p.n) & 15)
                           : 0;

  const __nv_bfloat16* kb = k + p.base;
  const __nv_bfloat16* vb = v + p.base;
  // K, V and the pattern of key tile t into stage s of their rings
  auto stage_tile = [&](int t, int s) {
    stage_rows<D, BK>(kb, t * BK, p.n, k_ring + s * S::kKV);
    stage_rows<D, BK>(vb, t * BK, p.n, v_ring + s * S::kKV);
    if (use_mask) stage_mask<D>(p.mask, p.n, q0, t * BK, mask_ring + s * S::kMask);
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

// The forward entries' block size: one warpgroup for the bf16 body, 256
// threads for the f32 one.
template <typename T>
__host__ __device__ constexpr int fwd_threads() {
  return std::is_same<T, __nv_bfloat16>::value ? tc::kThreads : kThreads;
}

// Launches a forward entry with its body's block: for bf16 one warpgroup and
// the tiles (and the pattern's ring, with a pattern) in dynamic shared
// memory, its limit raised on every launch (a cheap host call, and right on
// any device) and a failure to raise it left as the error run() returns; for
// f32 256 threads and static shared memory.
template <typename T, int D, void (*Kernel)(Args)>
void launch_fwd(dim3 grid, const Args& a) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using S = tc::Sizes<D>;
    const int smem = a.mask != nullptr ? S::kSmemMasked : S::kTiles;
    if (cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess) return;
    Kernel<<<grid, tc::kThreads, smem, a.stream>>>(a);
  } else {
    Kernel<<<grid, kThreads, 0, a.stream>>>(a);
  }
}

}  // namespace flash
