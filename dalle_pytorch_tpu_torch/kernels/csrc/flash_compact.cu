// Block-sparse flash attention for Hopper (sm_90a), compacted grid, in plain
// CUDA C++: the forward, the VFA forward's two passes, dq and dk/dv over live
// tiles only.
//
// Replaces: dalle_pytorch_tpu/kernels/flash_attention.py
// `_fwd_kernel_compact`, `_max_kernel_compact` and `_fwd_kernel_compact_vfa`
// (launched by `_flash_fwd_compact`), `_dq_kernel_compact` and
// `_dkv_kernel_compact` (launched by `_flash_bwd_compact`).
//
// Computes what the dense-grid kernels of flash_fwd.cu and flash_bwd.cu
// compute for a static pattern (the same tile bodies: flash_tiles.cuh, and
// flash_fwd_tc.cuh, flash_dq_tc.cuh and flash_bwd_tc.cuh for the bf16 online
// forward, dq and dk/dv), but each block reads the tiles it visits from a
// per-head CSR table instead of scanning every tile below the causal
// diagonal: the forward and dq blocks
// (one per 64 query rows) walk ptr/idx = row_ptr (H, ceil(n/64) + 1) and the
// ascending key tiles col (H, T); the dk/dv block (one per 64 keys) walks
// col_ptr (H, ceil(n/64) + 1) and the ascending query tiles row (H, T2).
// H is 1 for tables shared by every head or h, indexed by bh % h.  The
// tables fold causality in at tile granularity; the kernels still mask each
// element (causal, key padding, the pattern).  A row or column with no live
// tile has an empty list.  Same tiles in the same order as the dense kernels
// with the liveness table the tables came from, so the results are equal bit
// for bit.  The VFA pair walks the forward's row lists twice: the max pass
// writes each row's score maximum gmax (bh, n) f32, the fixed-max pass
// accumulates exp(s - gmax) with no rescale; it agrees with the online
// forward to rounding (the sums run in another order, and in bf16 the online
// forward runs on the tensor cores), not bit for bit, except on rows that see
// no key, which every forward body hands to store_dead_rows.
//
// What bounds it on this card: the dense kernels' operations, counted over
// live tiles only: 4 * bh * T * 64 * BK * d for the forward (2x for dq, 3x
// for dk/dv; the VFA pair 2 * bh * T * 64 * BK * d for the max pass and the
// forward's count for the fixed-max pass), against q, k, v, out and lse each
// moved once.  In f32 it is bound by operations on the FMA units, and a
// pattern that kills half the causal tiles halves the work; in bf16 the
// tensor cores' products over the live tiles take less time than moving the
// tensors once (axial_row, n 1280, d 64: 0.008 against 0.013 ms), so there
// it is bound by bytes.
//
// What the design does about it: no grid slot, no load and no liveness test
// for a dead tile.  The TPU's flat (bh, T) grid with first/last/valid flags
// is sequential; here blocks run in parallel, so each block loops over its
// own list and writes its rows (or keys) at the end.  The max pass stages K
// alone and computes no exp; the fixed-max pass drops the per-chunk alpha
// and the rescale of the accumulator.
#include "flash_bwd_tc.cuh"
#include "flash_dq_tc.cuh"
#include "flash_fwd_tc.cuh"

namespace {

using namespace flash;

// The block's list of tiles: entry blockIdx.x of its head's CSR table.
__device__ __forceinline__ TileList block_csr(const Args& a) {
  const int head = a.tab_heads > 1 ? blockIdx.y % a.h : 0;
  const int32_t* ptr = a.ptr + static_cast<size_t>(head) * (ceil_div(a.n, kTileRows) + 1);
  return csr_list(ptr, a.idx + static_cast<size_t>(head) * a.tab_len, blockIdx.x);
}

// the online forward: the tensor-core body for bf16, the FMA body for f32,
// as in flash_fwd.cu
template <typename T, int D>
__global__ void __launch_bounds__(block_threads<T>())
flash_fwd_compact_kernel(Args a) {
  const Problem p = make_problem(a.n, a.h, a.scale, a.causal, D, nullptr, nullptr, a.kmask,
                                 a.mask, a.mask_heads);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    fwd_block_tc<D>(q, k, v, static_cast<T*>(a.out0), a.lse_out, p, block_csr(a));
  else
    fwd_block<T, D>(q, k, v, static_cast<T*>(a.out0), a.lse_out, p, block_csr(a));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_max_compact_kernel(Args a) {
  const Problem p = make_problem(a.n, a.h, a.scale, a.causal, D, nullptr, nullptr, a.kmask,
                                 a.mask, a.mask_heads);
  max_block<T, D>(static_cast<const T*>(a.q), static_cast<const T*>(a.k), a.lse_out, p,
                  block_csr(a));
}

// gmax comes in as Args::lse
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_compact_vfa_kernel(Args a) {
  const Problem p = make_problem(a.n, a.h, a.scale, a.causal, D, a.lse, nullptr, a.kmask,
                                 a.mask, a.mask_heads);
  vfa_block<T, D>(static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                  static_cast<const T*>(a.v), static_cast<T*>(a.out0), a.lse_out, p, block_csr(a));
}

// dq and delta: the tensor-core body for bf16, the FMA body for f32, as in
// flash_bwd.cu
template <typename T, int D>
__global__ void __launch_bounds__(block_threads<T>())
flash_dq_compact_kernel(Args a) {
  const Problem p = make_problem(a.n, a.h, a.scale, a.causal, D, a.lse, nullptr, a.kmask,
                                 a.mask, a.mask_heads);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const T* out = static_cast<const T*>(a.out);
  float* delta = a.lse_out + static_cast<size_t>(blockIdx.y) * a.n;
  const int nk = ceil_div(a.n, inner_tile<D>());
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    dq_block_tc<D>(q, k, v, dout, out, static_cast<T*>(a.out0), delta, p, block_csr(a), nk);
  else
    dq_block<T, D>(q, k, v, dout, out, static_cast<T*>(a.out0), delta, p, block_csr(a), nk);
}

// dk/dv: the tensor-core body for bf16, the FMA body for f32, as in
// flash_bwd.cu
template <typename T, int D>
__global__ void __launch_bounds__(block_threads<T>())
flash_dkv_compact_kernel(Args a) {
  const Problem p = make_problem(a.n, a.h, a.scale, a.causal, D, a.lse, a.delta, a.kmask,
                                 a.mask, a.mask_heads);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int nq = ceil_div(a.n, inner_tile<D>());
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    dkv_block_tc<D>(q, k, v, dout, static_cast<T*>(a.out0), static_cast<T*>(a.out1), p, block_csr(a), nq);
  else
    dkv_block<T, D>(q, k, v, dout, static_cast<T*>(a.out0), static_cast<T*>(a.out1), p, block_csr(a), nq);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// kmask and mask may be null; ptr and idx may not.  Each returns 0, -1 for a
// shape or dtype the kernels do not take, -2 for tables built at another
// tile, or the CUDA error code of the launch.
extern "C" int flash_fwd_compact(const void* q, const void* k, const void* v, const void* kmask,
                                 const void* mask, const void* row_ptr, const void* col,
                                 void* out, void* lse, int bh, int n, int d, int h,
                                 int mask_heads, int tab_heads, int tab_len, int tile_q,
                                 int tile_k, float scale, int causal, int dtype, void* stream) {
  if (row_ptr == nullptr || col == nullptr || tab_len <= 0) return -1;
  const Args a = make_args(q, k, v, nullptr, nullptr, nullptr, kmask, mask, nullptr, row_ptr, col,
                           out, nullptr, lse, bh, n, h, mask_heads, tab_heads, tab_len, scale,
                           causal, stream);
  return run(a, d, dtype, false, tile_q, tile_k, true, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int D = decltype(tag)::dim;
    launch_tc<T, tc::Sizes<D>, flash_fwd_compact_kernel<T, D>>(dim3(ceil_div(a.n, kTileRows), a.bh), a);
  });
}

extern "C" int flash_max_compact(const void* q, const void* k, const void* kmask, const void* mask,
                                 const void* row_ptr, const void* col, void* gmax, int bh, int n,
                                 int d, int h, int mask_heads, int tab_heads, int tab_len,
                                 int tile_q, int tile_k, float scale, int causal, int dtype,
                                 void* stream) {
  if (row_ptr == nullptr || col == nullptr || tab_len <= 0) return -1;
  const Args a = make_args(q, k, nullptr, nullptr, nullptr, nullptr, kmask, mask, nullptr, row_ptr,
                           col, nullptr, nullptr, gmax, bh, n, h, mask_heads, tab_heads, tab_len,
                           scale, causal, stream);
  return run(a, d, dtype, false, tile_q, tile_k, true, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int D = decltype(tag)::dim;
    const dim3 grid(ceil_div(a.n, kTileRows), a.bh);
    flash_max_compact_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(a);
  });
}

extern "C" int flash_fwd_compact_vfa(const void* q, const void* k, const void* v,
                                     const void* kmask, const void* mask, const void* row_ptr,
                                     const void* col, const void* gmax, void* out, void* lse,
                                     int bh, int n, int d, int h, int mask_heads, int tab_heads,
                                     int tab_len, int tile_q, int tile_k, float scale, int causal,
                                     int dtype, void* stream) {
  if (row_ptr == nullptr || col == nullptr || gmax == nullptr || tab_len <= 0) return -1;
  const Args a = make_args(q, k, v, nullptr, gmax, nullptr, kmask, mask, nullptr, row_ptr, col, out,
                           nullptr, lse, bh, n, h, mask_heads, tab_heads, tab_len, scale, causal,
                           stream);
  return run(a, d, dtype, false, tile_q, tile_k, true, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int D = decltype(tag)::dim;
    const dim3 grid(ceil_div(a.n, kTileRows), a.bh);
    flash_fwd_compact_vfa_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(a);
  });
}

// writes dq and delta (bh, n) f32, which flash_dkv_compact reads
extern "C" int flash_dq_compact(const void* q, const void* k, const void* v, const void* dout,
                                const void* out, const void* lse, const void* kmask,
                                const void* mask, const void* row_ptr, const void* col, void* dq,
                                void* delta, int bh, int n, int d, int h, int mask_heads,
                                int tab_heads, int tab_len, int tile_q, int tile_k, float scale,
                                int causal, int dtype, void* stream) {
  if (row_ptr == nullptr || col == nullptr || tab_len <= 0 || out == nullptr || delta == nullptr) return -1;
  Args a = make_args(q, k, v, dout, lse, nullptr, kmask, mask, nullptr, row_ptr, col, dq, nullptr,
                     delta, bh, n, h, mask_heads, tab_heads, tab_len, scale, causal, stream);
  a.out = out;
  return run(a, d, dtype, false, tile_q, tile_k, true, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int D = decltype(tag)::dim;
    launch_tc<T, tc::DqSizes<D>, flash_dq_compact_kernel<T, D>>(dim3(ceil_div(a.n, kTileRows), a.bh), a);
  });
}

extern "C" int flash_dkv_compact(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, const void* kmask,
                                 const void* mask, const void* col_ptr, const void* row,
                                 void* dk, void* dv, int bh, int n, int d, int h, int mask_heads,
                                 int tab_heads, int tab_len, int tile_q, int tile_k, float scale,
                                 int causal, int dtype, void* stream) {
  if (col_ptr == nullptr || row == nullptr || tab_len <= 0) return -1;
  const Args a = make_args(q, k, v, dout, lse, delta, kmask, mask, nullptr, col_ptr, row, dk, dv,
                           nullptr, bh, n, h, mask_heads, tab_heads, tab_len, scale, causal, stream);
  return run(a, d, dtype, true, tile_q, tile_k, true, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int D = decltype(tag)::dim;
    launch_tc<T, tc::DkvSizes<D>, flash_dkv_compact_kernel<T, D>>(dim3(ceil_div(a.n, kTileRows), a.bh), a);
  });
}
