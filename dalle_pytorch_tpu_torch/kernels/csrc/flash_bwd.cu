// Flash-attention backward for Hopper (sm_90a), dense grid, in plain CUDA
// C++: two kernels.
//
// Replaces: dalle_pytorch_tpu/kernels/flash_attention.py `_dq_kernel` and
// `_dkv_kernel` (both launched by `_flash_bwd`), the dense-grid two-pass
// backward.
//
// Computes, for q, k, v, do of shape (bh, n, d), contiguous, f32 or bf16, the
// forward's lse and delta = rowsum(do * out), both (bh, n) f32:
//   s  = (q * scale) k^T in f32, masked as the forward masks it
//        (flash_tiles.cuh);
//   p  = exp(s - lse),  dp = do v^T,  ds = p * (dp - delta);
//   dq = scale * (ds k)                          kernel flash_bwd_dq_kernel
//   dk = ds^T (q * scale),  dv = p^T do          kernel flash_bwd_dkv_kernel
// stored in the input dtype; p, ds and the accumulators stay f32.  Two passes
// and no atomics: every output row is written by one block, so the result is
// the same from run to run.  With a pattern, the dq pass skips the key tiles
// its liveness table (at the forward's tile) leaves empty, and the dk/dv pass
// the query tiles its transposed table (uint8 (H, ceil(n/64), ceil(n/BQ)), at
// its own tile) leaves empty.  Rows that see no key take p = 1 for each of
// their n keys, as the JAX package's `_dense_recompute_grads` has it
// (flash_tiles.cuh says how).  Any n works; ragged last tiles are masked here.
//
// What bounds it on this card: dq does three n x n x d products and dk/dv
// four (halved under causality), against five and six (bh, n, d) tensors
// moved, so at the training shape (n = 1280, d = 64) both are bound by
// operations.  This first version runs those operations on the f32 FMA units
// (67 TFLOP/s), as the forward does, not on the tensor cores; wgmma and TMA
// are later work.
//
// What the design does about it: the forward's layout.  One block owns 64 rows
// of one (batch, head), query rows for dq and key rows for dk/dv, and loops
// over the other side's tiles, each staged once in shared memory as f32 and
// read by all 64 rows.  Four threads share a row, each holding d/4
// interleaved channels of the row's operands and accumulators in registers;
// a dot product is four partial sums joined by two warp shuffles.
#include "flash_tiles.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(Args a) {
  constexpr int BK = inner_tile<D>();
  const int nk = ceil_div(a.n, BK);
  const int i = blockIdx.x;
  const Problem p = make_problem(a.n, a.h, a.scale, a.causal, D, a.lse, a.delta, a.kmask,
                                 a.mask, a.mask_heads);
  const int end = a.causal ? ceil_div(min((i + 1) * kTileRows, a.n), BK) : nk;
  const uint8_t* live = nullptr;
  if (a.live != nullptr) {
    const int head = a.tab_heads > 1 ? blockIdx.y % a.h : 0;
    live = a.live + (static_cast<size_t>(head) * ceil_div(a.n, kTileRows) + i) * nk;
  }
  dq_block<T, D>(static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                 static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
                 static_cast<T*>(a.out0), p, dense_list(live, 0, end), nk);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(Args a) {
  constexpr int BQ = inner_tile<D>();
  const int nq = ceil_div(a.n, BQ);
  const int j = blockIdx.x;
  const Problem p = make_problem(a.n, a.h, a.scale, a.causal, D, a.lse, a.delta, a.kmask,
                                 a.mask, a.mask_heads);
  // the first query tile whose last row reaches this block's first key
  const int begin = a.causal ? (j * kTileRows) / BQ : 0;
  const uint8_t* live = nullptr;
  if (a.live != nullptr) {
    const int head = a.tab_heads > 1 ? blockIdx.y % a.h : 0;
    live = a.live + (static_cast<size_t>(head) * ceil_div(a.n, kTileRows) + j) * nq;
  }
  dkv_block<T, D>(static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                  static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
                  static_cast<T*>(a.out0), static_cast<T*>(a.out1), p,
                  dense_list(live, begin, nq), nq);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// kmask, mask and live may be null.  Each returns 0, -1 for a shape or dtype
// the kernels do not take, -2 for a liveness table built at another tile, or
// the CUDA error code of the launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* kmask,
                            const void* mask, const void* live, void* dq, int bh, int n,
                            int d, int h, int mask_heads, int tab_heads, int tab_len,
                            int tile_q, int tile_k, float scale, int causal, int dtype,
                            void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, kmask, mask, live, nullptr, nullptr, dq,
                           nullptr, nullptr, bh, n, h, mask_heads, tab_heads, tab_len, scale, causal,
                           stream);
  return run(a, d, dtype, false, tile_q, tile_k, live != nullptr, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int D = decltype(tag)::dim;
    const dim3 grid(ceil_div(a.n, kTileRows), a.bh);
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(a);
  });
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* kmask,
                             const void* mask, const void* live, void* dk, void* dv, int bh,
                             int n, int d, int h, int mask_heads, int tab_heads, int tab_len,
                             int tile_q, int tile_k, float scale, int causal, int dtype,
                             void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, kmask, mask, live, nullptr, nullptr, dk, dv,
                           nullptr, bh, n, h, mask_heads, tab_heads, tab_len, scale, causal, stream);
  return run(a, d, dtype, true, tile_q, tile_k, live != nullptr, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int D = decltype(tag)::dim;
    const dim3 grid(ceil_div(a.n, kTileRows), a.bh);
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(a);
  });
}
