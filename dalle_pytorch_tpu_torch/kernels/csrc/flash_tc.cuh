// The pieces the bf16 tensor-core tile bodies share (sm_90a, `wgmma`, in
// plain CUDA C++ with inline PTX): the swizzled shared-memory layout of a
// bf16 tile and its wgmma descriptors, the wgmma products, cp.async staging
// of tiles and pattern bytes, the accumulator fragment's coordinates, the
// masking of a query-row-owned score fragment, and the launch with dynamic
// shared memory.
//
// Used by the forward body (flash_fwd_tc.cuh, fwd_block_tc), the dq body
// (flash_dq_tc.cuh, dq_block_tc) and the dk/dv body (flash_bwd_tc.cuh,
// dkv_block_tc).  Every body is one warpgroup of 128
// threads whose 64 rows are wgmma's M; the tiles of the other side are
// staged once in one layout that serves both as a K-major operand and, read
// through the transpose bit, as an MN-major one.
#pragma once

#include <type_traits>

#include "flash_tiles.cuh"

namespace flash {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // one warpgroup: wgmma's 64 rows
constexpr int kStages = 2;     // tiles of the other side in flight
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

// The bytes of a staged pattern row of W columns: the 16-byte chunks that
// hold the row's W bytes, which start up to 15 bytes into the first (a
// stride that also keeps the eight rows a warp reads on distinct banks).
template <int W>
__host__ __device__ constexpr uint32_t mask_row() { return W + 16; }

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (all in 16-byte units), swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}

// A K-major operand (a tile whose rows are the product's M or N, channels
// its K) of an R-row tile at `base`: the 16 channels of k-step ks.  Eight-row
// groups lie 8 * W bytes apart; the leading offset is unused under a swizzle.
template <int D, int R>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int ks) {
  using L = Layout<D>;
  const int c = 2 * ks;
  const uint32_t start = base + (c / L::kChunks) * (R * L::kRowBytes) + (c % L::kChunks) * 16;
  return make_desc(start, 16, 8 * L::kRowBytes, L::kSwizzle);
}

// An R-row tile as an MN-major B (transposed: its rows are the product's K,
// its channels N): rows 16 * ks .. + 15, channel block nb (64 channels; all
// 32 at d 32).
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
// one f32, 0 where not `valid` (rows of a (bh, n) array start 4-byte aligned
// only)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
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

// cp.async the pattern's bytes for the R rows at r0 and the W columns at c0
// (a multiple of 16) into a mask tile of mask_row<W>()-byte rows: row r's
// bytes start `shift` = (address of the row's first byte) & 15 bytes into its
// row, as the mask's 16-byte chunks that hold them are copied whole (the
// neighbouring rows' bytes in them are never read).  Rows past n and chunks
// wholly past the row's last column are zero-filled.  The last chunk of the
// last row may reach up to 15 bytes past the (n, n) or (h, n, n) mask: the
// wrappers hand the kernels a mask whose storage runs on at least 16 bytes
// (`_device_mask`, kernels/flash_attention.py).
template <int R, int W>
__device__ __forceinline__ void stage_mask(const uint8_t* __restrict__ mask, int n, int r0, int c0,
                                           uint32_t dst) {
  constexpr int C = W / 16 + 1;  // chunks per row
  for (int idx = threadIdx.x; idx < R * C; idx += kThreads) {
    const int r = idx / C;
    const int c = idx % C;
    const int row = r0 + r;
    const uint8_t* first = mask + static_cast<size_t>(row) * n + c0;
    const uint8_t* end = mask + static_cast<size_t>(row) * n + min(c0 + W, n);
    const uint8_t* at =
        reinterpret_cast<const uint8_t*>(reinterpret_cast<uintptr_t>(first) & ~uintptr_t{15}) + 16 * c;
    const bool valid = (row < n) & (at < end);
    cp_async16(dst + r * mask_row<W>() + 16 * c, valid ? at : mask, valid);
  }
}

// One thread's place in the accumulator fragments: rows w*16 + lane/4 and
// +8 of the block, columns 8j + 2*(lane%4) + {0, 1} of each 8-column group j.
// Element 4j + 2*rr + e of a fragment is (row rr, column 8j + col + e).
struct Frag {
  int rows[2];   // block-relative
  int col;
  int shift[2];  // forward: where each row's bytes start in a staged mask row
};

__device__ __forceinline__ Frag frag() {
  const int lane = threadIdx.x % 32;
  Frag f;
  f.rows[0] = (threadIdx.x / 32) * 16 + lane / 4;
  f.rows[1] = f.rows[0] + 8;
  f.col = (lane % 4) * 2;
  f.shift[0] = f.shift[1] = 0;
  return f;
}

// The bodies that own query rows (the forward, dq) mask their m64 x n(BK)
// score fragment with the helpers below, in that orientation.

// Which of this thread's scores in the key tile at k0 pass the pattern and
// the key padding: bit 2j + e of allow[rr] for the key of column 8j + col +
// e.  `ms` is the tile's staged pattern (mask_row<BK>()-byte rows, row rr's
// bytes from f.shift[rr]); padding indices are clamped into the array (a key
// past n scores -inf anyway).
template <int BK>
__device__ __forceinline__ void key_allow(const Problem& p, const uint8_t* ms, const Frag& f, int k0,
                                          uint32_t (&allow)[2]) {
  allow[0] = allow[1] = ~0u;
  if (p.kmask != nullptr) {
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bits |= static_cast<uint32_t>(p.kmask[min(k0 + 8 * j + f.col + e, p.n - 1)] > 0) << (2 * j + e);
    allow[0] = allow[1] = bits;
  }
  if (p.mask != nullptr) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const uint8_t* mrow = ms + f.rows[rr] * mask_row<BK>() + f.shift[rr];
      uint32_t bits = 0;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) bits |= static_cast<uint32_t>(mrow[8 * j + f.col + e] != 0) << (2 * j + e);
      allow[rr] &= bits;
    }
  }
}

// A key tile that needs no mask for the 64 rows at q0: no pattern, no key
// padding, no key past n and, under causality, wholly at or below the
// diagonal.
template <int BK>
__device__ __forceinline__ bool plain_tile(const Problem& p, int q0, int k0) {
  return !((p.mask != nullptr) | (p.kmask != nullptr)) & (k0 + BK <= p.n) &
         ((p.causal == 0) | (k0 + BK - 1 <= q0));
}

// Scales S into base 2 (sc = scale * log2 e) and masks it in registers, as
// fwd_tile does, branch-free: `neg` for a causal-future key or one `allow`
// does not have, -inf past n.  kPlain (plain_tile) skips the test.
template <int BK, bool kPlain>
__device__ __forceinline__ void mask_scores(float (&s)[BK / 2], const Frag& f, const Problem& p, int q0,
                                            int k0, float sc, float neg, const uint32_t (&allow)[2]) {
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
          s[i] = col >= p.n ? -INFINITY : (masked ? neg : x);
        }
      }
    }
  }
}

// The shift of each of this thread's two rows (block rows at q0) in a
// staged pattern row: where the row's first byte lies in its 16-byte chunk.
__device__ __forceinline__ void mask_shifts(const Problem& p, int q0, Frag& f) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    f.shift[rr] = p.mask != nullptr ? static_cast<int>(reinterpret_cast<uintptr_t>(
                                          p.mask + static_cast<size_t>(q0 + f.rows[rr]) * p.n) & 15)
                                    : 0;
}

}  // namespace tc

// The block size of an entry whose body the dtype picks: one warpgroup for a
// bf16 tensor-core body, 256 threads for an f32 FMA body.
template <typename T>
__host__ __device__ constexpr int block_threads() {
  return std::is_same<T, __nv_bfloat16>::value ? tc::kThreads : kThreads;
}

// Launches an entry with its body's block: for bf16 one warpgroup and the
// tiles (and the pattern's ring, with a pattern) in the dynamic shared memory
// that `Smem` (kSmem, kSmemMasked) sizes, its limit raised on every launch
// (a cheap host call, and right on any device) and a failure to raise it left
// as the error run() returns; for f32 256 threads and static shared memory.
template <typename T, typename Smem, void (*Kernel)(Args)>
void launch_tc(dim3 grid, const Args& a) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int smem = a.mask != nullptr ? Smem::kSmemMasked : Smem::kSmem;
    if (cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess) return;
    Kernel<<<grid, tc::kThreads, smem, a.stream>>>(a);
  } else {
    Kernel<<<grid, kThreads, 0, a.stream>>>(a);
  }
}

}  // namespace flash
