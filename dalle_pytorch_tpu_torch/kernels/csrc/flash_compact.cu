// Block-sparse flash attention for Hopper (sm_90a), compacted grid, in plain
// CUDA C++: the forward, dq and dk/dv kernels over live tiles only.
//
// Replaces: dalle_pytorch_tpu/kernels/flash_attention.py
// `_fwd_kernel_compact` (launched by `_flash_fwd_compact`),
// `_dq_kernel_compact` and `_dkv_kernel_compact` (launched by
// `_flash_bwd_compact`).
//
// Computes what the dense-grid kernels of flash_fwd.cu and flash_bwd.cu
// compute for a static pattern (the same tile bodies, flash_tiles.cuh), but
// each block reads the tiles it visits from a per-head CSR table instead of
// scanning every tile below the causal diagonal: the forward and dq blocks
// (one per 64 query rows) walk ptr/idx = row_ptr (H, ceil(n/64) + 1) and the
// ascending key tiles col (H, T); the dk/dv block (one per 64 keys) walks
// col_ptr (H, ceil(n/64) + 1) and the ascending query tiles row (H, T2).
// H is 1 for tables shared by every head or h, indexed by bh % h.  The
// tables fold causality in at tile granularity; the kernels still mask each
// element (causal, key padding, the pattern).  A row or column with no live
// tile has an empty list.  Same tiles in the same order as the dense kernels
// with the liveness table the tables came from, so the results are equal bit
// for bit.
//
// What bounds it on this card: the dense kernels' operations, counted over
// live tiles only: 4 * bh * T * 64 * BK * d for the forward (2x for dq, 3x
// for dk/dv), against q, out, lse once per row and K, V once per live tile.
// On the FMA units it is bound by operations; a pattern that kills half the
// causal tiles halves the work.
//
// What the design does about it: no grid slot, no load and no liveness test
// for a dead tile.  The TPU's flat (bh, T) grid with first/last/valid flags
// is sequential; here blocks run in parallel, so each block loops over its
// own list and writes its rows (or keys) at the end.
#include "flash_tiles.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_compact_kernel(Args a) {
  const int nk = ceil_div(a.n, inner_tile<D>());
  const int head = a.tab_heads > 1 ? blockIdx.y % a.h : 0;
  const int32_t* ptr = a.ptr + static_cast<size_t>(head) * (ceil_div(a.n, kTileRows) + 1);
  const int32_t* idx = a.idx + static_cast<size_t>(head) * a.tab_len;
  const Problem p = make_problem(a.n, a.h, a.scale, a.causal, D, nullptr, nullptr, a.kmask,
                                 a.mask, a.mask_heads);
  fwd_block<T, D>(static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                  static_cast<const T*>(a.v), static_cast<T*>(a.out0), a.lse_out, p,
                  csr_list(ptr, idx, blockIdx.x), nk);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_compact_kernel(Args a) {
  const int nk = ceil_div(a.n, inner_tile<D>());
  const int head = a.tab_heads > 1 ? blockIdx.y % a.h : 0;
  const int32_t* ptr = a.ptr + static_cast<size_t>(head) * (ceil_div(a.n, kTileRows) + 1);
  const int32_t* idx = a.idx + static_cast<size_t>(head) * a.tab_len;
  const Problem p = make_problem(a.n, a.h, a.scale, a.causal, D, a.lse, a.delta, a.kmask,
                                 a.mask, a.mask_heads);
  dq_block<T, D>(static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                 static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
                 static_cast<T*>(a.out0), p, csr_list(ptr, idx, blockIdx.x), nk);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_compact_kernel(Args a) {
  const int nq = ceil_div(a.n, inner_tile<D>());
  const int head = a.tab_heads > 1 ? blockIdx.y % a.h : 0;
  const int32_t* ptr = a.ptr + static_cast<size_t>(head) * (ceil_div(a.n, kTileRows) + 1);
  const int32_t* idx = a.idx + static_cast<size_t>(head) * a.tab_len;
  const Problem p = make_problem(a.n, a.h, a.scale, a.causal, D, a.lse, a.delta, a.kmask,
                                 a.mask, a.mask_heads);
  dkv_block<T, D>(static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                  static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
                  static_cast<T*>(a.out0), static_cast<T*>(a.out1), p,
                  csr_list(ptr, idx, blockIdx.x), nq);
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
    const dim3 grid(ceil_div(a.n, kTileRows), a.bh);
    flash_fwd_compact_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(a);
  });
}

extern "C" int flash_dq_compact(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, const void* kmask,
                                const void* mask, const void* row_ptr, const void* col, void* dq,
                                int bh, int n, int d, int h, int mask_heads, int tab_heads,
                                int tab_len, int tile_q, int tile_k, float scale, int causal,
                                int dtype, void* stream) {
  if (row_ptr == nullptr || col == nullptr || tab_len <= 0) return -1;
  const Args a = make_args(q, k, v, dout, lse, delta, kmask, mask, nullptr, row_ptr, col, dq,
                           nullptr, nullptr, bh, n, h, mask_heads, tab_heads, tab_len, scale, causal,
                           stream);
  return run(a, d, dtype, false, tile_q, tile_k, true, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int D = decltype(tag)::dim;
    const dim3 grid(ceil_div(a.n, kTileRows), a.bh);
    flash_dq_compact_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(a);
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
    const dim3 grid(ceil_div(a.n, kTileRows), a.bh);
    flash_dkv_compact_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(a);
  });
}
