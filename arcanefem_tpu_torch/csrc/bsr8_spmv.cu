// Supernode SpMV over 8x8 blocks (BSR-8) for Hopper (sm_90a), bound
// through a plain C interface and loaded with ctypes
// (arcanefem_tpu_torch/utils/kernels.py).
//
//   afem_bsr8_spmv_{f32,f64}:  y[8i + r] = sum_{e = bptr[i]}^{bptr[i+1]-1}
//                                sum_j blocks[e, r, j] * x[8 bcol[e] + j]
//   afem_bsr8_spmv_bf16_f32:   the same with bf16 blocks and f32 x and y;
//                              x is rounded to bf16 first, as the JAX einsum
//                              does (xg.astype(blocks.dtype))
//
// for 8 n_sup >= n > 8 (n_sup - 1); columns at or past n read 0, rows at or
// past n are not written.
//
// What it replaces.  The three steps of arcanefem_tpu/sparse/supernode.py
// SupernodeSpmv.__call__: the K3a column gather pg_cols.call_batched
// (arcanefem_tpu/sparse/pallas_spmv.py::_products_b_unit, pallas_call at
// :488), the einsum of the 8x8 block products, and the K3a row reduce
// pg_rows.call_batched.  The TPU needed the gathers as window kernels and
// ran the products as an XLA einsum; the port's first version kept that
// shape (two K3a launches around a PyTorch product that wrote and read an
// (nnzb, 8, 8) temporary).  Here one kernel reads each block once and
// writes y: no padded x, no (nnzb, 8) or (n_sup, 8) buffers.
//
// What bounds it.  Bytes: the blocks (256 B each in f32, 128 in bf16, 512 in
// f64) and their 4-byte block columns, plus per block row its bptr entry,
// x's 8 values and y's 8.  At the 1.9M-DoF sphere (5,281,291 blocks) that is
// 1.39 GB in f32, 0.415 ms at 3.35 TB/s.  The arithmetic is 64 FMAs per
// block, in f64 (see below): 0.02 ms of the card's f64 rate, and the f32 to
// f64 conversions (16 per lane and block) about 0.16 ms of its conversion
// rate, both under the byte bound.
//
// Design: one warp per block row, 8 warps per 256-thread block.  Lane 8q + r
// takes row r of block bptr[i] + 4s + q at step s, so a warp's block loads at
// one step are 4 whole consecutive blocks, 1 KB contiguous, as 16-byte
// vector loads (two float4 per lane in f32, one uint4 in bf16, four double2
// in f64) that stream past L1 (__ldcs: every block is read once).  The 8
// values of x that a block multiplies are one 32-byte segment, the same for
// the 8 lanes of a group, so the group's loads are one broadcast served
// from L1/L2 (x is 7.6 MB at 1.9M).  Two steps are issued per loop trip to
// keep more loads in flight.  Each lane sums its products in f64 registers:
// a product of two f32 values (or of two bf16 values) is exact in f64, as
// K1 and K3a sum.  The four groups meet through __shfl_xor (offsets 8 and
// 16) and lanes 0-7 write y.  A block row without blocks writes 0.
//
// Staging the blocks through shared memory with cp.async.bulk (TMA) was not
// tried: each block is read once by the warp that uses it, so a copy to
// shared memory adds a pass without saving a byte, and this design already
// runs at the byte bound (f32 at 1.9M: 0.397-0.420 ms of device time per
// call against 0.415 ms, bf16 0.267-0.283 against 0.213, on an H100 80GB
// HBM3 at 700 W; the f32 figure dips below the bound where the tail of
// the previous call's blocks is still in L2).
//
// The kernel allocates nothing, launches on the caller's stream and never
// synchronises; each C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBs = 8;

// Row r of one block as 8 values widened to f64, and x's 8 values.
template <typename A>
struct Row;

template <>
struct Row<float> {
  static __device__ __forceinline__ void load(const float* p, double (&a)[kBs]) {
    const float4 u = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
    a[4] = v.x; a[5] = v.y; a[6] = v.z; a[7] = v.w;
  }
};

template <>
struct Row<double> {
  static __device__ __forceinline__ void load(const double* p, double (&a)[kBs]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const double2 u = __ldcs(reinterpret_cast<const double2*>(p) + k);
      a[2 * k] = u.x;
      a[2 * k + 1] = u.y;
    }
  }
};

template <>
struct Row<__nv_bfloat16> {
  // a bf16 value is the high half of the f32 with the same bits
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              double (&a)[kBs]) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[2 * k] = __uint_as_float(w[k] << 16);
      a[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};

// x's value as the block's products see it: bf16 blocks take x rounded to
// bf16 (round to nearest even), the others x as it is
template <typename A, typename V>
__device__ __forceinline__ double xval(V v) {
  if constexpr (sizeof(A) == 2) {
    return __bfloat162float(__float2bfloat16_rn(static_cast<float>(v)));
  } else {
    return static_cast<double>(v);
  }
}

// x[8c .. 8c+7], zeros at or past n; one or two 16-byte loads per 8 values
// where x is 16-byte aligned and the segment lies inside x
template <typename A, typename V>
__device__ __forceinline__ void load_x(const V* __restrict__ x, int64_t c,
                                       int64_t n, bool vec, double (&xv)[kBs]) {
  const int64_t c8 = c * kBs;
  if (vec && c8 + kBs <= n) {
    if constexpr (sizeof(V) == 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(x + c8));
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + c8) + 1);
      xv[0] = xval<A>(u.x); xv[1] = xval<A>(u.y);
      xv[2] = xval<A>(u.z); xv[3] = xval<A>(u.w);
      xv[4] = xval<A>(v.x); xv[5] = xval<A>(v.y);
      xv[6] = xval<A>(v.z); xv[7] = xval<A>(v.w);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const double2 u = __ldg(reinterpret_cast<const double2*>(x + c8) + k);
        xv[2 * k] = xval<A>(u.x);
        xv[2 * k + 1] = xval<A>(u.y);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kBs; ++j) {
      xv[j] = c8 + j < n ? xval<A>(__ldg(x + c8 + j)) : 0.0;
    }
  }
}

template <typename A, typename V>
__device__ __forceinline__ double block_row_dot(const A* __restrict__ blocks,
                                                const int32_t* __restrict__ bcol,
                                                const V* __restrict__ x,
                                                int64_t n, bool vec,
                                                int32_t e, int r, double acc) {
  double a[kBs], xv[kBs];
  Row<A>::load(blocks + static_cast<int64_t>(e) * (kBs * kBs) + r * kBs, a);
  load_x<A>(x, __ldg(bcol + e), n, vec, xv);
#pragma unroll
  for (int j = 0; j < kBs; ++j) acc = fma(a[j], xv[j], acc);
  return acc;
}

template <typename A, typename V>
__global__ void __launch_bounds__(kThreads)
bsr8_spmv_kernel(const A* __restrict__ blocks, const int32_t* __restrict__ bcol,
                 const int32_t* __restrict__ bptr, const V* __restrict__ x,
                 V* __restrict__ y, int64_t n, int64_t n_sup, bool vec) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= n_sup) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int q = lane >> 3, r = lane & 7;
  const int32_t e1 = __ldg(bptr + i + 1);
  int32_t e = __ldg(bptr + i) + q;
  double acc0 = 0.0, acc1 = 0.0;
  for (; e + 4 < e1; e += 8) {
    acc0 = block_row_dot(blocks, bcol, x, n, vec, e, r, acc0);
    acc1 = block_row_dot(blocks, bcol, x, n, vec, e + 4, r, acc1);
  }
  if (e < e1) acc0 = block_row_dot(blocks, bcol, x, n, vec, e, r, acc0);
  double acc = acc0 + acc1;
  acc += __shfl_xor_sync(0xffffffffu, acc, 8);
  acc += __shfl_xor_sync(0xffffffffu, acc, 16);
  const int64_t row = i * kBs + r;
  if (lane < kBs && row < n) y[row] = static_cast<V>(acc);
}

template <typename A, typename V>
int launch(const A* blocks, const int32_t* bcol, const int32_t* bptr,
           const V* x, V* y, int64_t n, int64_t n_sup, void* stream) {
  if (n <= 0 || n_sup <= 0 || n > n_sup * kBs || n <= (n_sup - 1) * kBs ||
      reinterpret_cast<uintptr_t>(blocks) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t grid = (n_sup + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  bsr8_spmv_kernel<A, V><<<static_cast<unsigned int>(grid), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      blocks, bcol, bptr, x, y, n, n_sup, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int afem_bsr8_spmv_f32(const float* blocks, const int32_t* bcol,
                       const int32_t* bptr, const float* x, float* y,
                       int64_t n, int64_t n_sup, void* stream) {
  return launch<float, float>(blocks, bcol, bptr, x, y, n, n_sup, stream);
}

int afem_bsr8_spmv_f64(const double* blocks, const int32_t* bcol,
                       const int32_t* bptr, const double* x, double* y,
                       int64_t n, int64_t n_sup, void* stream) {
  return launch<double, double>(blocks, bcol, bptr, x, y, n, n_sup, stream);
}

int afem_bsr8_spmv_bf16_f32(const __nv_bfloat16* blocks, const int32_t* bcol,
                            const int32_t* bptr, const float* x, float* y,
                            int64_t n, int64_t n_sup, void* stream) {
  return launch<__nv_bfloat16, float>(blocks, bcol, bptr, x, y, n, n_sup,
                                      stream);
}

}  // extern "C"
