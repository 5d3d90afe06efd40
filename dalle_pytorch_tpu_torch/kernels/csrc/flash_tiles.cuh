// Shared device code of the flash-attention kernels for Hopper (sm_90a), in
// plain CUDA C++: the tile shape, the tile lists, the rows that see no key,
// and the C entry points' arguments and dispatch.  The tile bodies, every
// one on the tensor cores, are flash_fwd_tc.cuh and flash_fwd_tf32.cuh (the
// forward in bf16 and f32), flash_vfa_tc.cuh (the VFA pair), flash_dq_tc.cuh
// and flash_bwd_tc.cuh (bf16 dq and dk/dv) and flash_bwd_tf32.cuh (f32 dq
// and dk/dv).
//
// Each pass has two `__global__` entries, built from the same block loop:
//   dense grid     every tile up to the causal diagonal, skipping those whose
//                  byte in a tile-liveness table is 0 (flash_fwd.cu,
//                  flash_bwd.cu; `_fwd_kernel`, `_dq_kernel`, `_dkv_kernel`);
//   compacted grid the block's own ascending list of live tiles, read from a
//                  per-head CSR table (flash_compact.cu; `_fwd_kernel_compact`,
//                  `_dq_kernel_compact`, `_dkv_kernel_compact`).
// The compacted grid also has the VFA forward: a max pass over the block's
// list (`_max_kernel_compact`), then accumulation against that fixed maximum
// with no rescale (`_fwd_kernel_compact_vfa`).
// Both visit the same tiles in the same order with the same arithmetic, so
// the compacted kernels equal the dense kernels given the same mask bit for
// bit.  The TPU runs a sequential (bh, T) grid with first/last/valid flags
// instead; on this card blocks run in parallel, so each block loops over its
// list itself and nothing is carried between blocks.
//
// Masking, as the TPU kernels' `_masked_scores`: causal-future keys, keys
// whose per-batch key-padding flag (kmask (b, n), row bh / h) is 0, and keys
// the per-element pattern mask (uint8 (n, n), or (h, n, n) indexed by bh % h)
// forbids score -1e30; keys past n do not exist.
//
// Rows that see no key.  A query row whose keys are all masked follows the
// plain PyTorch version (the dense softmax): its output averages v over all n
// keys and its lse is -1e30, and in the backward p = exp(s - lse) = 1 for
// each of its n keys.  Every forward body (the online forward's f32 and bf16
// tensor-core bodies, and the VFA pair's) finds such rows after its walk and
// hands them to one routine, store_dead_rows, so the bodies agree on them bit
// for bit; dq visits every key tile for a block holding one, dk/dv the query
// tiles off its list that hold one.  Tiles off the list add exact zeros to
// the other rows (their p underflows to 0), so the rule keeps compacted and
// dense results equal bit for bit on every row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

// The tile shape.  kernels/flash_attention.py reads these three lines to
// build its tables at the kernels' tiles: keep the form `constexpr int NAME =
// VALUE;`.
constexpr int kTileRows = 64;         // rows a block owns: query rows (forward, dq), key rows (dk/dv)
constexpr int kTileInnerNarrow = 64;  // rows of the other side's tile at d <= 64
constexpr int kTileInnerWide = 32;    // the same at d = 128: the two staged tiles stay at 32 KB

template <int D>
__host__ __device__ constexpr int inner_tile() { return D <= 64 ? kTileInnerNarrow : kTileInnerWide; }

constexpr float kNeg = -1e30f;           // the TPU kernel's fill (_NEG)
constexpr float kDeadLse = 0.5f * kNeg;  // lse at or below: the row sees no key

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// What every tile of one (batch, head) shares.
struct Problem {
  int n;
  float scale;
  int causal;
  size_t base;           // offset of this (batch, head) in q, k, v, out: bh * n * d
  const float* lse;      // this (batch, head)'s lse row (backward), or null
  const float* delta;    // its delta row (backward), or null
  const int32_t* kmask;  // this batch's key-padding row (n), or null
  const uint8_t* mask;   // this head's (n, n) pattern, or null
};

__device__ __forceinline__ Problem make_problem(int n, int h, float scale, int causal, int d,
                                                const float* lse, const float* delta,
                                                const int32_t* kmask, const uint8_t* mask,
                                                int mask_heads) {
  const int bh = blockIdx.y;
  Problem p;
  p.n = n;
  p.scale = scale;
  p.causal = causal;
  p.base = static_cast<size_t>(bh) * n * d;
  p.lse = lse ? lse + static_cast<size_t>(bh) * n : nullptr;
  p.delta = delta ? delta + static_cast<size_t>(bh) * n : nullptr;
  p.kmask = kmask ? kmask + static_cast<size_t>(bh / h) * n : nullptr;
  p.mask = mask ? mask + static_cast<size_t>(mask_heads > 1 ? bh % h : 0) * n * n : nullptr;
  return p;
}

// The tiles a block visits along the other side, ascending: on the dense grid
// the tiles [begin, end) whose liveness byte is set (every one without a
// table), on the compacted grid the entries [begin, end) of a CSR list.
struct TileList {
  const int32_t* idx;   // compacted: the CSR column (or row) list; dense: null
  const uint8_t* live;  // dense: the block's liveness row, or null
  int begin, end;

  // the next tile of the list, from cursor `cur`; false at its end
  __device__ __forceinline__ bool next(int& cur, int& tile) const {
    if (idx != nullptr) {
      if (cur >= end) return false;
      tile = idx[cur++];
      return true;
    }
    while (cur < end) {
      const int t = cur++;
      if (live == nullptr || live[t]) {
        tile = t;
        return true;
      }
    }
    return false;
  }

  // whether `tile` is on the list, for tiles asked in ascending order from
  // cursor `cur` (set to `begin` first)
  __device__ __forceinline__ bool take(int& cur, int tile) const {
    if (idx != nullptr) {
      if (cur < end && idx[cur] == tile) {
        ++cur;
        return true;
      }
      return false;
    }
    return tile >= begin && tile < end && (live == nullptr || live[tile]);
  }
};

__device__ __forceinline__ TileList dense_list(const uint8_t* live, int begin, int end) {
  return TileList{nullptr, live, begin, end};
}

__device__ __forceinline__ TileList csr_list(const int32_t* ptr, const int32_t* idx, int major) {
  return TileList{idx, nullptr, ptr[major], ptr[major + 1]};
}

// ---------------------------------------------------------------------------
// rows that see no key
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* y) { *y = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* y) { *y = __float2bfloat16_rn(x); }

// The sum of v over this (batch, head)'s n keys, per channel, into sum[D]
// (shared memory): j = 0..n-1 in ascending order with fmaf(1, v_j, acc), in
// an order that depends on no thread layout (any block size).  Called by the
// whole block; the caller syncs before reading it.
template <typename T, int D>
__device__ __forceinline__ void column_sums(const T* __restrict__ v, const Problem& p, float* sum) {
  const T* vb = v + p.base;
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < p.n; ++j) acc = fmaf(1.f, to_f32(vb[static_cast<size_t>(j) * D + c]), acc);
    sum[c] = acc;
  }
}

// The rows of the block (q0..q0+63) with `dead[r]` set saw no key: each gets
// the sum of v over all n keys (column_sums) divided by max(l, 1e-30), l =
// n, and lse = -1e30 + log(max(l, 1e-30)).  That is the online softmax's
// answer when every key scores -1e30 (alpha = 1 and p = 1 for each key), in
// the same operations, so every forward body that calls this writes the
// same bits on such rows, whatever its block size.  Called by the whole
// block, after the caller's walk, when __syncthreads_or found such a row
// (`dead` is in shared memory).
template <typename T, int D>
__device__ __noinline__ void store_dead_rows(const T* __restrict__ v, T* __restrict__ out,
                                             float* __restrict__ lse, const Problem& p, int q0,
                                             const uint8_t* dead) {
  __shared__ float sum[D];
  column_sums<T, D>(v, p, sum);
  __syncthreads();
  const float lc = fmaxf(static_cast<float>(p.n), 1e-30f);
  for (int idx = threadIdx.x; idx < kTileRows * D; idx += blockDim.x) {
    const int r = idx / D;
    if (dead[r]) from_f32(sum[idx % D] / lc, out + p.base + static_cast<size_t>(q0 + r) * D + idx % D);
  }
  for (int r = threadIdx.x; r < kTileRows; r += blockDim.x)
    if (dead[r]) lse[p.base / D + q0 + r] = kNeg + logf(lc);
}

// ---------------------------------------------------------------------------
// the C entry points' arguments and their dispatch
// ---------------------------------------------------------------------------

// Every entry takes its pointers, then (bh, n, d, h, mask_heads, tab_heads,
// tab_len, tile_q, tile_k, scale, causal, dtype, stream): mask_heads and
// tab_heads are 1 (shared) or h (per head); tab_len is a CSR list's length;
// (tile_q, tile_k) is the tile the caller built its tables at, checked
// against the kernel's.
struct Args {
  const void *q, *k, *v, *dout;
  const void* out;  // the forward's out, read by the dq entries for delta
  const float *lse, *delta;
  const int32_t* kmask;
  const uint8_t* mask;
  const uint8_t* live;       // dense grid: tile liveness, or null
  const int32_t *ptr, *idx;  // compacted grid: CSR table
  void *out0, *out1;         // out, dq, or dk and dv
  float* lse_out;            // the (bh, n) f32 output: lse, gmax or (dq entries) delta
  int bh, n, h, mask_heads, tab_heads, tab_len;
  float scale;
  int causal;
  cudaStream_t stream;
};

// The Args of a C entry point; the pointers it does not take are null (the
// dq entries set Args::out after).
inline Args make_args(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* kmask, const void* mask,
                      const void* live, const void* ptr, const void* idx, void* out0, void* out1,
                      void* lse_out, int bh, int n, int h, int mask_heads, int tab_heads,
                      int tab_len, float scale, int causal, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.kmask = static_cast<const int32_t*>(kmask);
  a.mask = static_cast<const uint8_t*>(mask);
  a.live = static_cast<const uint8_t*>(live);
  a.ptr = static_cast<const int32_t*>(ptr);
  a.idx = static_cast<const int32_t*>(idx);
  a.out0 = out0;
  a.out1 = out1;
  a.lse_out = static_cast<float*>(lse_out);
  a.bh = bh;
  a.n = n;
  a.h = h;
  a.mask_heads = mask_heads;
  a.tab_heads = tab_heads;
  a.tab_len = tab_len;
  a.scale = scale;
  a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

template <typename T, int D>
struct Tag {
  using type = T;
  static constexpr int dim = D;
};

// Calls f(Tag<T, D>{}) for the dtype (0 float32, 1 bfloat16) and head dim;
// returns 0, or -1 for a dtype or head dim the kernels do not take.
template <typename F>
int dispatch(int dtype, int d, F&& f) {
  auto by_dim = [&](auto t) {
    using T = typename decltype(t)::type;
    switch (d) {
      case 32: f(Tag<T, 32>{}); return 0;
      case 64: f(Tag<T, 64>{}); return 0;
      case 128: f(Tag<T, 128>{}); return 0;
      default: return -1;
    }
  };
  if (dtype == 0) return by_dim(Tag<float, 0>{});
  if (dtype == 1) return by_dim(Tag<__nv_bfloat16, 0>{});
  return -1;
}

// The tile (rows, columns) of a pass at head dim d: the forward and dq pass
// tiles 64 query rows by inner_tile keys, the dk/dv pass inner_tile query
// rows by 64 keys.
inline int tile_inner(int d) { return d <= 64 ? kTileInnerNarrow : kTileInnerWide; }

// Runs `launch` (which launches one kernel) after checking the common
// arguments and the tables' tile; returns 0, -1 for arguments the kernels do
// not take, -2 for tables built at another tile, or the launch's CUDA error.
template <typename F>
int run(const Args& a, int d, int dtype, bool dkv_pass, int tile_q, int tile_k, bool need_tiles,
        F&& launch) {
  if (a.bh <= 0 || a.bh > 65535 || a.n <= 0 || a.h <= 0 || a.bh % a.h != 0) return -1;
  if ((a.mask_heads != 1 && a.mask_heads != a.h) || (a.tab_heads != 1 && a.tab_heads != a.h)) return -1;
  if (need_tiles || tile_q != 0 || tile_k != 0) {
    const int want_q = dkv_pass ? tile_inner(d) : kTileRows;
    const int want_k = dkv_pass ? kTileRows : tile_inner(d);
    if (tile_q != want_q || tile_k != want_k) return -2;
  }
  cudaGetLastError();  // report this launch's error, not an earlier one
  const int rc = dispatch(dtype, d, launch);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
