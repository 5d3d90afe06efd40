// Flash-attention forward for Hopper (sm_90a), dense grid, in plain CUDA C++.
//
// Replaces: dalle_pytorch_tpu/kernels/flash_attention.py `_fwd_kernel`
// (launched by `_flash_fwd`), the dense-grid online-softmax forward.
//
// Computes, for q, k, v of shape (bh, n, d), contiguous, f32 or bf16:
//   s   = (q * scale) k^T in f32, masked as flash_tiles.cuh says (causal,
//         per-batch key padding, an optional (n, n) or (h, n, n) pattern);
//   out = softmax(s) v, stored in the input dtype;
//   lse = m + log(max(l, 1e-30)), f32, shape (bh, n).
// With a pattern, a tile-liveness table (uint8 (H, ceil(n/64), ceil(n/BK)),
// built by the caller at this kernel's tile) lets the block skip the key
// tiles the pattern leaves empty, as `_tile_live` does on the TPU.  Any n
// works; the ragged last tile is masked here, not padded by the caller.
//
// What bounds it on this card: at the shapes the port runs (n = 257 to 1280,
// d = 64) the two matrix products are 4*n*n*d operations (halved under
// causality, cut further by a pattern) against 4*n*d elements moved, so the
// work is bound by operations, not bytes.  This first version runs those
// operations on the f32 FMA units (67 TFLOP/s), not on the tensor cores, so
// it cannot reach the bf16 tensor-core bound; wgmma and TMA are later work.
//
// What the design does about it: one block owns 64 query rows of one (batch,
// head) and loops over key tiles itself.  Each K/V tile is staged once in
// shared memory, converted to f32, and read by all 64 rows, so device memory
// sees each key once per query tile.  Four threads share a query row, each
// holding d/4 interleaved channels of q and of the accumulator in registers;
// a score is four partial dot products joined by two warp shuffles.  Dead key
// tiles (causal or pattern) are never loaded.
#include "flash_tiles.cuh"

namespace {

using namespace flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Args a) {
  constexpr int BK = inner_tile<D>();
  const int nk = ceil_div(a.n, BK);
  const int i = blockIdx.x;
  const Problem p = make_problem(a.n, a.h, a.scale, a.causal, D, nullptr, nullptr, a.kmask,
                                 a.mask, a.mask_heads);
  const int end = a.causal ? ceil_div(min((i + 1) * kTileRows, a.n), BK) : nk;
  const uint8_t* live = nullptr;
  if (a.live != nullptr) {
    const int head = a.tab_heads > 1 ? blockIdx.y % a.h : 0;
    live = a.live + (static_cast<size_t>(head) * ceil_div(a.n, kTileRows) + i) * nk;
  }
  fwd_block<T, D>(static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                  static_cast<const T*>(a.v), static_cast<T*>(a.out0), a.lse_out, p,
                  dense_list(live, 0, end), nk);
}

}  // namespace

// Plain C entry point, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// kmask, mask and live may be null.  Returns 0, -1 for a shape or dtype the
// kernel does not take, -2 for a liveness table built at another tile, or
// the CUDA error code of the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* kmask,
                         const void* mask, const void* live, void* out, void* lse, int bh,
                         int n, int d, int h, int mask_heads, int tab_heads, int tab_len,
                         int tile_q, int tile_k, float scale, int causal, int dtype,
                         void* stream) {
  const Args a = make_args(q, k, v, nullptr, nullptr, nullptr, kmask, mask, live, nullptr, nullptr,
                           out, nullptr, lse, bh, n, h, mask_heads, tab_heads, tab_len, scale,
                           causal, stream);
  return run(a, d, dtype, false, tile_q, tile_k, live != nullptr, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int D = decltype(tag)::dim;
    const dim3 grid(ceil_div(a.n, kTileRows), a.bh);
    flash_fwd_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(a);
  });
}
