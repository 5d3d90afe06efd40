// Shared device code of the flash-attention kernels for Hopper (sm_90a), in
// plain CUDA C++: the tile shape, the tile lists, the f32 FMA bodies of the
// dq and dk/dv passes (the forward's and the VFA pair's bodies, f32 and
// bf16, and the bf16 bodies of dq and dk/dv run on the tensor cores:
// flash_fwd_tf32.cuh, flash_fwd_tc.cuh, flash_vfa_tc.cuh, flash_dq_tc.cuh,
// flash_bwd_tc.cuh), the rows that see no key, and the C entry points'
// arguments and dispatch.
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
constexpr int kRowThreads = 4;           // threads sharing one row
constexpr int kThreads = kTileRows * kRowThreads;
constexpr int kChunk = 16;               // scores computed between shuffles

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(x.x, x.y);
  p2[1] = __floats2bfloat162_rn(x.z, x.w);
}

__device__ __forceinline__ float4 scale4(float4 x, float a) {
  return make_float4(x.x * a, x.y * a, x.z * a, x.w * a);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float p, float4 x, float4& y) {
  y.x = fmaf(p, x.x, y.x);
  y.y = fmaf(p, x.y, y.y);
  y.z = fmaf(p, x.z, y.z);
  y.w = fmaf(p, x.w, y.w);
}

// the sum over the four threads of a row (neighbouring lanes)
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

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

// Stage a (rows x cols) block of the pattern at (r0, c0) into shared memory;
// 0 past n.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_mask_tile(const Problem& p, int r0, int c0,
                                               uint8_t (&ms)[ROWS][COLS]) {
  for (int idx = threadIdx.x; idx < ROWS * COLS; idx += kThreads) {
    const int r = idx / COLS;
    const int c = idx % COLS;
    const int qr = r0 + r;
    const int kc = c0 + c;
    ms[r][c] = (qr < p.n && kc < p.n) ? p.mask[static_cast<size_t>(qr) * p.n + kc] : 0;
  }
}

// Stage the key tile at k0 and its values as f32, each key's flag (1
// attend, 0 masked, -1 past the end) and, with `use_mask`, the pattern's (64
// x BK) block at (q0, k0).
template <typename T, int D, typename S>
__device__ __forceinline__ void stage_key_tile(const T* __restrict__ k, const T* __restrict__ v,
                                               const Problem& p, int q0, int k0, bool use_mask,
                                               S& sm) {
  constexpr int BK = S::BK;
  constexpr int V4 = D / 4;
  for (int idx = threadIdx.x; idx < BK * V4; idx += kThreads) {
    const int j = idx / V4;
    const int c4 = idx % V4;
    const int kp = k0 + j;
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 vx = kx;
    if (kp < p.n) {
      const size_t off = p.base + static_cast<size_t>(kp) * D + c4 * 4;
      kx = load4(k + off);
      vx = load4(v + off);
    }
    sm.ks[j][c4] = kx;
    sm.vs[j][c4] = vx;
  }
  for (int j = threadIdx.x; j < BK; j += kThreads) {
    const int kp = k0 + j;
    sm.kflag[j] = kp >= p.n ? -1 : ((p.kmask != nullptr && p.kmask[kp] <= 0) ? 0 : 1);
  }
  if (use_mask) load_mask_tile(p, q0, k0, sm.ms);
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
// backward: dq
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int BK = inner_tile<D>();
  float4 ks[BK][D / 4];
  float4 vs[BK][D / 4];
  int kflag[BK];
  uint8_t ms[kTileRows][BK];
};

// dq keeps q, do and its accumulator in registers: a shorter chunk for wider
// heads keeps it from spilling
template <int D>
__host__ __device__ constexpr int dq_chunk() { return D <= 32 ? kChunk : (D <= 64 ? kChunk / 2 : kChunk / 4); }

template <typename T, int D>
__device__ __forceinline__ void dq_tile(const T* __restrict__ k, const T* __restrict__ v,
                                        const Problem& p, int q0, int k0, int r, int row, int g,
                                        DqSmem<D>& sm, const float4* qr, const float4* dor,
                                        float4* acc, float row_lse, float row_delta) {
  constexpr int BK = DqSmem<D>::BK;
  constexpr int NV = D / 16;
  constexpr int CH = dq_chunk<D>();
  __syncthreads();  // the previous tile is no longer read
  const bool use_mask = p.mask != nullptr;
  const bool causal = p.causal != 0;
  stage_key_tile<T, D>(k, v, p, q0, k0, use_mask, sm);
  __syncthreads();

#pragma unroll 1
  for (int j0 = 0; j0 < BK; j0 += CH) {
    float s[CH], dp[CH];
#pragma unroll
    for (int jj = 0; jj < CH; ++jj) {
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        sp = dot4(qr[i], sm.ks[j0 + jj][i * 4 + g], sp);
        dpp = dot4(dor[i], sm.vs[j0 + jj][i * 4 + g], dpp);
      }
      s[jj] = row_sum(sp);
      dp[jj] = row_sum(dpp);
    }
#pragma unroll
    for (int jj = 0; jj < CH; ++jj) {
      const int f = sm.kflag[j0 + jj];
      const bool masked = (f == 0) | (causal & (k0 + j0 + jj > row)) | (use_mask & (sm.ms[r][j0 + jj] == 0));
      const float e = expf((masked ? kNeg : s[jj]) - row_lse);
      const float pr = f < 0 ? 0.f : e;
      const float ds = pr * (dp[jj] - row_delta);
#pragma unroll
      for (int i = 0; i < NV; ++i) axpy4(ds, sm.ks[j0 + jj][i * 4 + g], acc[i]);
    }
  }
}

// dq for the block's 64 query rows: over `tiles`, or over all `ntiles` key
// tiles when a row of the block sees no key.  First the rows' delta =
// rowsum(do * out) in f32, written to `delta` (this (batch, head)'s row) for
// the dk/dv pass; a row that sees no key takes do . sum_j v_j instead, as
// `_dense_recompute_grads` has it (column_sums, only in a block that holds
// such a row).
template <typename T, int D>
__device__ __forceinline__ void dq_block(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, const T* __restrict__ dout,
                                         const T* __restrict__ out, T* __restrict__ dq,
                                         float* __restrict__ delta, const Problem& p,
                                         const TileList& tiles, int ntiles) {
  constexpr int BK = DqSmem<D>::BK;
  constexpr int NV = D / 16;
  __shared__ DqSmem<D> sm;
  const int q0 = blockIdx.x * kTileRows;
  const int g = threadIdx.x % kRowThreads;
  const int r = threadIdx.x / kRowThreads;
  const int row = q0 + r;
  const bool live_row = row < p.n;

  float4 qr[NV], dor[NV], acc[NV];
  float part = 0.f;  // this thread's share of do . out
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const size_t off = p.base + static_cast<size_t>(row) * D + i * 16 + g * 4;
    qr[i] = live_row ? scale4(load4(q + off), p.scale) : zero;
    dor[i] = live_row ? load4(dout + off) : zero;
    part = dot4(dor[i], live_row ? load4(out + off) : zero, part);
    acc[i] = zero;
  }
  // a row past the end has zero q and do, so its ds is 0 whatever p is
  const float row_lse = live_row ? p.lse[row] : 0.f;
  const bool dead = live_row && row_lse <= kDeadLse;

  // one call site of the tile body: a second inlined copy costs registers
  const bool every_tile = __syncthreads_or(dead);
  if (every_tile) {
    __shared__ float4 vsum[D / 4];
    column_sums<T, D>(v, p, reinterpret_cast<float*>(vsum));
    __syncthreads();
    if (dead) {
      part = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) part = dot4(dor[i], vsum[i * 4 + g], part);
    }
  }
  const float row_delta = row_sum(part);
  if (live_row && g == 0) delta[row] = row_delta;

  int cur = tiles.begin, jt = -1;
  while (every_tile ? ++jt < ntiles : tiles.next(cur, jt))
    dq_tile<T, D>(k, v, p, q0, jt * BK, r, row, g, sm, qr, dor, acc, row_lse, row_delta);

  if (live_row) {
    T* o = dq + p.base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int i = 0; i < NV; ++i) store4(o + i * 16 + g * 4, scale4(acc[i], p.scale));
  }
}

// ---------------------------------------------------------------------------
// backward: dk and dv
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int BQ = inner_tile<D>();
  float4 qs[BQ][D / 4];  // q * scale
  float4 dos[BQ][D / 4];
  float ls[BQ];  // lse; +inf past the end, so p = 0 there
  float dls[BQ];
  uint8_t ms[BQ][kTileRows];
};

// scores per shuffle round in dk/dv
template <int D>
__host__ __device__ constexpr int dkv_chunk() { return D <= 32 ? kChunk : (D <= 64 ? kChunk / 2 : kChunk / 4); }

template <typename T, int D>
__device__ __forceinline__ void dkv_tile(const T* __restrict__ q, const T* __restrict__ dout,
                                         const Problem& p, int i0, int k0, int r, int key, int g,
                                         bool live_key, bool padded_key, DkvSmem<D>& sm,
                                         const float4* kr, const float4* vr, float4* dk_acc,
                                         float4* dv_acc) {
  constexpr int BQ = DkvSmem<D>::BQ;
  constexpr int V4 = D / 4;
  constexpr int NV = D / 16;
  __syncthreads();  // the previous tile is no longer read
  for (int idx = threadIdx.x; idx < BQ * V4; idx += kThreads) {
    const int j = idx / V4;
    const int c4 = idx % V4;
    const int qrow = i0 + j;
    float4 qx = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 dx = qx;
    if (qrow < p.n) {
      const size_t off = p.base + static_cast<size_t>(qrow) * D + c4 * 4;
      qx = scale4(load4(q + off), p.scale);
      dx = load4(dout + off);
    }
    sm.qs[j][c4] = qx;
    sm.dos[j][c4] = dx;
  }
  for (int j = threadIdx.x; j < BQ; j += kThreads) {
    const int qrow = i0 + j;
    sm.ls[j] = qrow < p.n ? p.lse[qrow] : INFINITY;
    sm.dls[j] = qrow < p.n ? p.delta[qrow] : 0.f;
  }
  const bool use_mask = p.mask != nullptr;
  const bool causal = p.causal != 0;
  if (use_mask) load_mask_tile(p, i0, k0, sm.ms);
  __syncthreads();

  constexpr int CH = dkv_chunk<D>();
#pragma unroll 1
  for (int j0 = 0; j0 < BQ; j0 += CH) {
    float s[CH], dp[CH];
#pragma unroll
    for (int jj = 0; jj < CH; ++jj) {
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        sp = dot4(kr[i], sm.qs[j0 + jj][i * 4 + g], sp);
        dpp = dot4(vr[i], sm.dos[j0 + jj][i * 4 + g], dpp);
      }
      s[jj] = row_sum(sp);
      dp[jj] = row_sum(dpp);
    }
#pragma unroll
    for (int jj = 0; jj < CH; ++jj) {
      const bool masked = padded_key | (causal & (key > i0 + j0 + jj)) | (use_mask & (sm.ms[j0 + jj][r] == 0));
      const float sc = !live_key ? -INFINITY : (masked ? kNeg : s[jj]);
      const float pr = expf(sc - sm.ls[j0 + jj]);
      const float ds = pr * (dp[jj] - sm.dls[j0 + jj]);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        axpy4(pr, sm.dos[j0 + jj][i * 4 + g], dv_acc[i]);
        axpy4(ds, sm.qs[j0 + jj][i * 4 + g], dk_acc[i]);
      }
    }
  }
}

// dk and dv for the block's 64 key rows over `tiles` (query tiles); when a
// row of this (batch, head) sees no key, also over the query tiles off the
// list that hold such a row.
template <typename T, int D>
__device__ __forceinline__ void dkv_block(const T* __restrict__ q, const T* __restrict__ k,
                                          const T* __restrict__ v, const T* __restrict__ dout,
                                          T* __restrict__ dk, T* __restrict__ dv,
                                          const Problem& p, const TileList& tiles, int ntiles) {
  constexpr int BQ = DkvSmem<D>::BQ;
  constexpr int NV = D / 16;
  __shared__ DkvSmem<D> sm;
  const int k0 = blockIdx.x * kTileRows;
  const int g = threadIdx.x % kRowThreads;
  const int r = threadIdx.x / kRowThreads;
  const int key = k0 + r;
  const bool live_key = key < p.n;
  const bool padded_key = live_key && p.kmask != nullptr && p.kmask[key] <= 0;

  float4 kr[NV], vr[NV], dk_acc[NV], dv_acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const size_t off = p.base + static_cast<size_t>(key) * D + i * 16 + g * 4;
    kr[i] = live_key ? load4(k + off) : zero;
    vr[i] = live_key ? load4(v + off) : zero;
    dk_acc[i] = zero;
    dv_acc[i] = zero;
  }

  bool dead = false;
  for (int t = threadIdx.x; t < p.n; t += kThreads) dead = dead || p.lse[t] <= kDeadLse;
  // with such a row: every query tile in order, those off the list only
  // where they hold one; one call site of the tile body, as in dq_block
  const bool dead_rows = __syncthreads_or(dead);
  int cur = tiles.begin, it = -1;
  while (dead_rows ? ++it < ntiles : tiles.next(cur, it)) {
    if (dead_rows && !tiles.take(cur, it)) {
      bool holds = false;
      for (int t = threadIdx.x; t < BQ; t += kThreads) {
        const int qrow = it * BQ + t;
        holds = holds || (qrow < p.n && p.lse[qrow] <= kDeadLse);
      }
      if (!__syncthreads_or(holds)) continue;
    }
    dkv_tile<T, D>(q, dout, p, it * BQ, k0, r, key, g, live_key, padded_key, sm, kr, vr, dk_acc, dv_acc);
  }

  if (live_key) {
    const size_t off = p.base + static_cast<size_t>(key) * D;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      store4(dk + off + i * 16 + g * 4, dk_acc[i]);
      store4(dv + off + i * 16 + g * 4, dv_acc[i]);
    }
  }
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
