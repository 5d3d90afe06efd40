// Flash-attention backward for Hopper (sm_90a), in plain CUDA C++: two kernels.
//
// Replaces: dalle_pytorch_tpu/kernels/flash_attention.py `_dq_kernel` and
// `_dkv_kernel` (both launched by `_flash_bwd`), the dense-grid two-pass
// backward.
//
// Computes, for q, k, v, do of shape (bh, n, d), contiguous, f32 or bf16, the
// forward's lse and delta = rowsum(do * out), both (bh, n) f32:
//   s  = (q * scale) k^T in f32, masked as the forward masks it: causal-future
//        keys and keys whose per-batch key-padding flag (kmask (b, n), row
//        bh / h) is 0 score -1e30; keys past n do not exist;
//   p  = exp(s - lse),  dp = do v^T,  ds = p * (dp - delta);
//   dq = scale * (ds k)                          kernel flash_bwd_dq_kernel
//   dk = ds^T (q * scale),  dv = p^T do          kernel flash_bwd_dkv_kernel
// stored in the input dtype; p, ds and the accumulators stay f32.  Two passes
// and no atomics: every output row is written by one block, so the result is
// the same from run to run.
//
// Rows that see no key: a query row whose keys are all masked has lse = -1e30
// (the forward's -1e30 + log n rounds back to it), so p = 1 for each of its n
// keys, the causally dead ones included, as the JAX package's dense recompute
// (`_dense_recompute_grads`) has it.  So both kernels visit causally dead
// tiles where such a row is in them: dq goes on past the diagonal for a query
// tile that holds one, and dk/dv visits the query tiles above the diagonal
// that hold one.  Any n works; ragged last tiles are masked here.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;           // the TPU kernel's fill (_NEG)
constexpr float kDeadLse = 0.5f * kNeg;  // lse at or below: the row sees no key
constexpr int kBlockRows = 64;           // rows a block owns
constexpr int kRowThreads = 4;           // threads sharing one row
constexpr int kThreads = kBlockRows * kRowThreads;
constexpr int kChunk = 16;               // scores computed between shuffles

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

// dq for 64 query rows: loop over key tiles up to the causal diagonal (to the
// end for a tile holding a row that sees no key).
template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int32_t* __restrict__ kmask, T* __restrict__ dq, int n,
                    int h, float scale, int causal) {
  constexpr int V4 = D / 4;   // float4 columns of one row
  constexpr int NV = D / 16;  // float4 columns one thread holds
  // dq keeps q, do and its accumulator in registers: a shorter chunk for
  // wider heads keeps it from spilling
  constexpr int CH = D <= 32 ? kChunk : (D <= 64 ? kChunk / 2 : kChunk / 4);
  __shared__ float4 ks[BK][V4];
  __shared__ float4 vs[BK][V4];
  __shared__ int kflag[BK];  // 1 attend, 0 masked (-1e30), -1 past the end

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockRows;
  const int g = threadIdx.x % kRowThreads;
  const int row = q0 + threadIdx.x / kRowThreads;
  const bool live_row = row < n;
  const size_t base = static_cast<size_t>(bh) * n * D;
  const int32_t* km = kmask ? kmask + static_cast<size_t>(bh / h) * n : nullptr;

  // thread g of a row holds channels i*16 + g*4 .. +3: the four threads of a
  // row read 64 contiguous bytes of a shared-memory row, conflict-free
  float4 qr[NV], dor[NV], acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const size_t off = base + static_cast<size_t>(row) * D + i * 16 + g * 4;
    qr[i] = live_row ? scale4(load4(q + off), scale) : zero;
    dor[i] = live_row ? load4(dout + off) : zero;
    acc[i] = zero;
  }
  // a row past the end has zero q and do, so its ds is 0 whatever p is
  const float row_lse = live_row ? lse[static_cast<size_t>(bh) * n + row] : 0.f;
  const float row_delta = live_row ? delta[static_cast<size_t>(bh) * n + row] : 0.f;

  int kend = causal ? min(q0 + kBlockRows, n) : n;
  if (causal && __syncthreads_or(live_row && row_lse <= kDeadLse)) kend = n;

  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < BK * V4; idx += kThreads) {
      const int j = idx / V4;
      const int c4 = idx % V4;
      const int kp = k0 + j;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (kp < n) {
        const size_t off = base + static_cast<size_t>(kp) * D + c4 * 4;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      ks[j][c4] = kx;
      vs[j][c4] = vx;
    }
    for (int j = threadIdx.x; j < BK; j += kThreads) {
      const int kp = k0 + j;
      kflag[j] = kp >= n ? -1 : ((km != nullptr && km[kp] <= 0) ? 0 : 1);
    }
    __syncthreads();

#pragma unroll 1
    for (int j0 = 0; j0 < BK; j0 += CH) {
      float s[CH], dp[CH];
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        float sp = 0.f, dpp = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          sp = dot4(qr[i], ks[j0 + jj][i * 4 + g], sp);
          dpp = dot4(dor[i], vs[j0 + jj][i * 4 + g], dpp);
        }
        s[jj] = row_sum(sp);
        dp[jj] = row_sum(dpp);
      }
#pragma unroll
      for (int jj = 0; jj < CH; ++jj) {
        const int f = kflag[j0 + jj];
        float p = 0.f;
        if (f >= 0) {
          const bool masked = f == 0 || (causal && k0 + j0 + jj > row);
          p = expf((masked ? kNeg : s[jj]) - row_lse);
        }
        const float ds = p * (dp[jj] - row_delta);
#pragma unroll
        for (int i = 0; i < NV; ++i) axpy4(ds, ks[j0 + jj][i * 4 + g], acc[i]);
      }
    }
  }

  if (live_row) {
    T* o = dq + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int i = 0; i < NV; ++i) store4(o + i * 16 + g * 4, scale4(acc[i], scale));
  }
}

// dk and dv for 64 key rows: loop over query tiles from the causal diagonal
// to the end, and over the tiles above it that hold a row seeing no key.
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int32_t* __restrict__ kmask, T* __restrict__ dk,
                     T* __restrict__ dv, int n, int h, float scale, int causal) {
  constexpr int V4 = D / 4;
  constexpr int NV = D / 16;
  __shared__ float4 qs[BQ][V4];  // q * scale
  __shared__ float4 dos[BQ][V4];
  __shared__ float ls[BQ];  // lse; +inf past the end, so p = 0 there
  __shared__ float dls[BQ];

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockRows;
  const int g = threadIdx.x % kRowThreads;
  const int key = k0 + threadIdx.x / kRowThreads;
  const bool live_key = key < n;
  const size_t base = static_cast<size_t>(bh) * n * D;
  const int32_t* km = kmask ? kmask + static_cast<size_t>(bh / h) * n : nullptr;
  const bool padded_key = live_key && km != nullptr && km[key] <= 0;

  float4 kr[NV], vr[NV], dk_acc[NV], dv_acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const size_t off = base + static_cast<size_t>(key) * D + i * 16 + g * 4;
    kr[i] = live_key ? load4(k + off) : zero;
    vr[i] = live_key ? load4(v + off) : zero;
    dk_acc[i] = zero;
    dv_acc[i] = zero;
  }

  for (int i0 = 0; i0 < n; i0 += BQ) {
    // every key of this block is in the causal future of a tile whose last
    // row comes before the block's first key: such a tile counts only for a
    // row that sees no key (the condition is the same for the whole block)
    if (causal && i0 + BQ <= k0) {
      bool dead = false;
      for (int t = threadIdx.x; t < BQ; t += kThreads) {
        const int r = i0 + t;
        dead = dead || (r < n && lse[static_cast<size_t>(bh) * n + r] <= kDeadLse);
      }
      if (!__syncthreads_or(dead)) continue;
    }
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < BQ * V4; idx += kThreads) {
      const int j = idx / V4;
      const int c4 = idx % V4;
      const int r = i0 + j;
      float4 qx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 dx = qx;
      if (r < n) {
        const size_t off = base + static_cast<size_t>(r) * D + c4 * 4;
        qx = scale4(load4(q + off), scale);
        dx = load4(dout + off);
      }
      qs[j][c4] = qx;
      dos[j][c4] = dx;
    }
    for (int j = threadIdx.x; j < BQ; j += kThreads) {
      const int r = i0 + j;
      ls[j] = r < n ? lse[static_cast<size_t>(bh) * n + r] : INFINITY;
      dls[j] = r < n ? delta[static_cast<size_t>(bh) * n + r] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int j0 = 0; j0 < BQ; j0 += kChunk) {
      float s[kChunk], dp[kChunk];
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float sp = 0.f, dpp = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          sp = dot4(kr[i], qs[j0 + jj][i * 4 + g], sp);
          dpp = dot4(vr[i], dos[j0 + jj][i * 4 + g], dpp);
        }
        s[jj] = row_sum(sp);
        dp[jj] = row_sum(dpp);
      }
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float sc = s[jj];
        if (!live_key) {
          sc = -INFINITY;
        } else if (padded_key || (causal && key > i0 + j0 + jj)) {
          sc = kNeg;
        }
        const float p = expf(sc - ls[j0 + jj]);
        const float ds = p * (dp[jj] - dls[j0 + jj]);
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          axpy4(p, dos[j0 + jj][i * 4 + g], dv_acc[i]);
          axpy4(ds, qs[j0 + jj][i * 4 + g], dk_acc[i]);
        }
      }
    }
  }

  if (live_key) {
    const size_t off = base + static_cast<size_t>(key) * D;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      store4(dk + off + i * 16 + g * 4, dk_acc[i]);
      store4(dv + off + i * 16 + g * 4, dv_acc[i]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *kmask;
  void *out0, *out1;  // dq, or dk and dv
  int bh, n, h;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D>
void launch_dq(const Args& a) {
  constexpr int BK = D <= 64 ? 64 : 32;  // K+V tiles stay at 32 KB of shared memory
  const dim3 grid((a.n + kBlockRows - 1) / kBlockRows, a.bh);
  flash_bwd_dq_kernel<T, D, BK><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int32_t*>(a.kmask),
      static_cast<T*>(a.out0), a.n, a.h, a.scale, a.causal);
}

template <typename T, int D>
void launch_dkv(const Args& a) {
  constexpr int BQ = D <= 64 ? 64 : 32;  // q+do tiles stay at 32 KB of shared memory
  const dim3 grid((a.n + kBlockRows - 1) / kBlockRows, a.bh);
  flash_bwd_dkv_kernel<T, D, BQ><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int32_t*>(a.kmask),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.n, a.h, a.scale, a.causal);
}

template <typename T, bool DQ>
int dispatch_dim(const Args& a, int d) {
  switch (d) {
    case 32: DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a); return 0;
    case 64: DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a); return 0;
    case 128: DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a); return 0;
    default: return -1;
  }
}

template <bool DQ>
int run(const Args& a, int d, int dtype) {
  if (a.bh <= 0 || a.bh > 65535 || a.n <= 0 || a.h <= 0) return -1;
  cudaGetLastError();  // report this launch's error, not an earlier one
  int rc;
  if (dtype == 0) {
    rc = dispatch_dim<float, DQ>(a, d);
  } else if (dtype == 1) {
    rc = dispatch_dim<__nv_bfloat16, DQ>(a, d);
  } else {
    rc = -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// kmask may be null.  Each returns 0, -1 for a shape or dtype the kernels do
// not take, or the CUDA error code of the launch.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* delta,
                            const void* kmask, void* dq, int bh, int n, int d,
                            int h, float scale, int causal, int dtype,
                            void* stream) {
  const Args a{q, k, v, dout, lse, delta, kmask, dq, nullptr, bh, n, h, scale,
               causal, static_cast<cudaStream_t>(stream)};
  return run<true>(a, d, dtype);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             const void* kmask, void* dk, void* dv, int bh, int n,
                             int d, int h, float scale, int causal, int dtype,
                             void* stream) {
  const Args a{q, k, v, dout, lse, delta, kmask, dk, dv, bh, n, h, scale,
               causal, static_cast<cudaStream_t>(stream)};
  return run<false>(a, d, dtype);
}
