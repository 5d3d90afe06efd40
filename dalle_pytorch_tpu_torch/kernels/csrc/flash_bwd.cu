// Flash-attention backward for Hopper (sm_90a), dense grid, in plain CUDA
// C++: two kernels.
//
// Replaces: dalle_pytorch_tpu/kernels/flash_attention.py `_dq_kernel` and
// `_dkv_kernel` (both launched by `_flash_bwd`), the dense-grid two-pass
// backward.
//
// Computes, for q, k, v, do and the forward's out of shape (bh, n, d),
// contiguous, f32 or bf16, and the forward's lse (bh, n) f32:
//   delta = rowsum(do * out) (bh, n) f32         kernel flash_bwd_dq_kernel
//   s  = (q * scale) k^T in f32, masked as the forward masks it
//        (flash_tiles.cuh);
//   p  = exp(s - lse),  dp = do v^T,  ds = p * (dp - delta);
//   dq = scale * (ds k)                          kernel flash_bwd_dq_kernel
//   dk = ds^T (q * scale),  dv = p^T do          kernel flash_bwd_dkv_kernel
// stored in the input dtype; p, ds and the accumulators stay f32.  The dq
// kernel writes delta, which the dk/dv kernel reads: the wrapper launches
// them in that order on one stream.  Two passes and no atomics: every output
// row is written by one block, so the result is the same from run to run.
// With a pattern, the dq pass skips the key tiles its liveness table (at the
// forward's tile) leaves empty, and the dk/dv pass the query tiles its
// transposed table (uint8 (H, ceil(n/64), ceil(n/BQ)), at its own tile)
// leaves empty.  Rows that see no key take p = 1 for each of their n keys,
// as the JAX package's `_dense_recompute_grads` has it (flash_tiles.cuh says
// how), and delta = do . sum_j v_j.  Any n works; ragged last tiles are
// masked here.
//
// What bounds it on this card: dq does three n x n x d products and dk/dv
// four (halved under causality), against six (bh, n, d) tensors moved each,
// so at the training shape (n = 1280, d = 64) both are bound by operations:
// 989 TFLOP/s on the bf16 tensor cores; in f32, 3xTF32 on the same tensor
// cores (three TF32 products for one, the f32 tolerance kept), 165 TFLOP/s.
//
// What the design does about it: one block of one warpgroup owns 64 rows of
// one (batch, head), query rows for dq and key rows for dk/dv, and loops
// over the other side's tiles, each staged once in shared memory and read by
// all 64 rows; the products run on wgmma, p and ds stay in registers.  The
// dtype picks the tile bodies:
//   bf16  dq_block_tc (flash_dq_tc.cuh) and dkv_block_tc (flash_bwd_tc.cuh):
//         bf16 tiles in a two-stage cp.async ring, each read both K-major
//         and, through the transpose bit, MN-major;
//   f32   dq_block_tf32 and dkv_block_tf32 (flash_bwd_tf32.cuh): every
//         product in 3xTF32, the tiles split into TF32 hi and lo through
//         registers, the ones the last products read staged a second time
//         transposed (a TF32 operand in shared memory is K-major only), the
//         other side walked in 16-row halves at d 128.
// Both dq bodies compute their rows' delta before their walk.
#include "flash_bwd_tf32.cuh"

namespace {

using namespace flash;

// dq and delta: the bf16 or the f32 (3xTF32) tensor-core body
template <typename T, int D>
__global__ void __launch_bounds__(tc::kThreads)
flash_bwd_dq_kernel(Args a) {
  constexpr int BK = inner_tile<D>();
  const int nk = ceil_div(a.n, BK);
  const int i = blockIdx.x;
  const Problem p = make_problem(a.n, a.h, a.scale, a.causal, D, a.lse, nullptr, a.kmask,
                                 a.mask, a.mask_heads);
  const int end = a.causal ? ceil_div(min((i + 1) * kTileRows, a.n), BK) : nk;
  const uint8_t* live = nullptr;
  if (a.live != nullptr) {
    const int head = a.tab_heads > 1 ? blockIdx.y % a.h : 0;
    live = a.live + (static_cast<size_t>(head) * ceil_div(a.n, kTileRows) + i) * nk;
  }
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const T* out = static_cast<const T*>(a.out);
  float* delta = a.lse_out + static_cast<size_t>(blockIdx.y) * a.n;
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    dq_block_tc<D>(q, k, v, dout, out, static_cast<T*>(a.out0), delta, p, dense_list(live, 0, end), nk);
  else
    dq_block_tf32<D>(q, k, v, dout, out, static_cast<T*>(a.out0), delta, p, dense_list(live, 0, end), nk);
}

// dk/dv: the bf16 or the f32 (3xTF32) tensor-core body
template <typename T, int D>
__global__ void __launch_bounds__(tc::kThreads)
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
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    dkv_block_tc<D>(q, k, v, dout, static_cast<T*>(a.out0), static_cast<T*>(a.out1), p,
                    dense_list(live, begin, nq), nq);
  else
    dkv_block_tf32<D>(q, k, v, dout, static_cast<T*>(a.out0), static_cast<T*>(a.out1), p,
                      dense_list(live, begin, nq), nq);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// kmask, mask and live may be null.  Each returns 0, -1 for a shape or dtype
// the kernels do not take, -2 for a liveness table built at another tile, or
// the CUDA error code of the launch.  flash_bwd_dq writes dq and delta (bh, n)
// f32, which flash_bwd_dkv reads.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* out, const void* lse, const void* kmask,
                            const void* mask, const void* live, void* dq, void* delta, int bh,
                            int n, int d, int h, int mask_heads, int tab_heads, int tab_len,
                            int tile_q, int tile_k, float scale, int causal, int dtype,
                            void* stream) {
  if (out == nullptr || delta == nullptr) return -1;
  Args a = make_args(q, k, v, dout, lse, nullptr, kmask, mask, live, nullptr, nullptr, dq, nullptr,
                     delta, bh, n, h, mask_heads, tab_heads, tab_len, scale, causal, stream);
  a.out = out;
  return run(a, d, dtype, false, tile_q, tile_k, live != nullptr, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int D = decltype(tag)::dim;
    launch_wg<DqBlockSizes<T, D>, flash_bwd_dq_kernel<T, D>>(dim3(ceil_div(a.n, kTileRows), a.bh), a);
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
    launch_wg<DkvBlockSizes<T, D>, flash_bwd_dkv_kernel<T, D>>(dim3(ceil_div(a.n, kTileRows), a.bh), a);
  });
}
