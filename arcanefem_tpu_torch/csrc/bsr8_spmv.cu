// BSR SpMV over b x b blocks (b = 8: the supernode SpMV; b = 4: the
// blocked scalar operator) for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (arcanefem_tpu_torch/utils/kernels.py).
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
//   afem_bsr_spmv_b4_{f32,f64,bf16_f32}: the same product over 4x4
//   blocks, y of n_rows and x of n_cols (a rectangular operator), for
//   4 n_brows >= n_rows > 4 (n_brows - 1); columns at or past n_cols read 0.
//
// The b = 4 kernel (and at b = 2 csrc/bsr2_slice_spmv.cu) replaces K3a's
// blocked role:
// arcanefem_tpu/sparse/blocked.py::BlockedGather.__call__ (the pre-gather,
// the _products_b_unit sweep, pallas_call at
// arcanefem_tpu/sparse/pallas_spmv.py:488, its channel contraction and the
// stage-3 subrow sums), which on this card is one BSR-b SpMV.  Bound:
// bytes, each block's b^2 values and its 4-byte column once, bptr, x and y.
// The b = 8 instances are the supernode kernel as it was: the template
// below gives them the same loads, the same fma order and the same
// shuffles, so their results are unchanged bit for bit.
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
// Design of the b = 8 and b = 4 kernel: one warp per block row, 8 warps per
// 256-thread block.  Lane 8q + r takes row r of block bptr[i] + 4s + q at
// step s, so a warp's block loads at one step are 4 whole consecutive
// blocks, 1 KB contiguous, as 16-byte vector loads (two float4 per lane in
// f32, one uint4 in bf16, four double2 in f64) that stream past L1 (__ldcs:
// every block is read once).  At b = 4 the same holds with 8 groups of 4
// lanes: each step reads 8 whole consecutive blocks (512 B in f32), each
// lane one row of 4 values (one float4 or uint2; double2 pairs in f64), and
// the groups meet through __shfl_xor at offsets 4, 8 and 16.  The 8
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
// Why b = 2 is not instanced here.  This template at b = 2 (16 groups of 2
// lanes) reached 0.40 of its byte bound on the 1.9M sphere's operator
// (946,345 block rows, 17.51M blocks, 18.5 per block row): 0.2723-0.2733
// ms against 0.1102 ms on an H100 80GB HBM3 at 700 W.  A warp took one
// block row, so it made one full step of 16 blocks and then a tail in
// which 2-3 of its 16 lane pairs worked; each lane loaded 8 bytes, both
// lanes of a pair the same column and the same 8 bytes of x; the x load
// waited on the column load; and four rounds of f64 shuffles summed ~37
// values before 2 of 32 lanes wrote: about 370 B in flight per warp for
// that chain.  The b = 2 kernel is csrc/bsr2_slice_spmv.cu: the blocks in
// K1's slices, one thread per block row, no shuffles.
//
// The kernel allocates nothing, launches on the caller's stream and never
// synchronises; each C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Row r of one block as BS values widened to f64.
template <typename A, int BS>
struct Row;

template <int BS>
struct Row<float, BS> {
  static __device__ __forceinline__ void load(const float* p, double (&a)[BS]) {
#pragma unroll
    for (int k = 0; k < BS / 4; ++k) {
      const float4 u = __ldcs(reinterpret_cast<const float4*>(p) + k);
      a[4 * k] = u.x; a[4 * k + 1] = u.y; a[4 * k + 2] = u.z; a[4 * k + 3] = u.w;
    }
  }
};

template <int BS>
struct Row<double, BS> {
  static __device__ __forceinline__ void load(const double* p, double (&a)[BS]) {
#pragma unroll
    for (int k = 0; k < BS / 2; ++k) {
      const double2 u = __ldcs(reinterpret_cast<const double2*>(p) + k);
      a[2 * k] = u.x;
      a[2 * k + 1] = u.y;
    }
  }
};

template <int BS>
struct Row<__nv_bfloat16, BS> {
  // a bf16 value is the high half of the f32 with the same bits
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              double (&a)[BS]) {
    uint32_t w[BS / 2];
    if constexpr (BS == 4) {
      const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
      w[0] = u.x; w[1] = u.y;
    } else {
      const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
      w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    }
#pragma unroll
    for (int k = 0; k < BS / 2; ++k) {
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

// x[BS c .. BS c + BS - 1], zeros at or past n_cols; 8- or 16-byte loads
// where x is 16-byte aligned and the segment lies inside x
template <typename A, int BS, typename V>
__device__ __forceinline__ void load_x(const V* __restrict__ x, int64_t c,
                                       int64_t n_cols, bool vec, double (&xv)[BS]) {
  const int64_t cb = c * BS;
  if (vec && cb + BS <= n_cols) {
    if constexpr (sizeof(V) == 4) {
#pragma unroll
      for (int k = 0; k < BS / 4; ++k) {
        const float4 u = __ldg(reinterpret_cast<const float4*>(x + cb) + k);
        xv[4 * k] = xval<A>(u.x); xv[4 * k + 1] = xval<A>(u.y);
        xv[4 * k + 2] = xval<A>(u.z); xv[4 * k + 3] = xval<A>(u.w);
      }
    } else {
#pragma unroll
      for (int k = 0; k < BS / 2; ++k) {
        const double2 u = __ldg(reinterpret_cast<const double2*>(x + cb) + k);
        xv[2 * k] = xval<A>(u.x);
        xv[2 * k + 1] = xval<A>(u.y);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < BS; ++j) {
      xv[j] = cb + j < n_cols ? xval<A>(__ldg(x + cb + j)) : 0.0;
    }
  }
}

template <typename A, int BS, typename V>
__device__ __forceinline__ double block_row_dot(const A* __restrict__ blocks,
                                                const int32_t* __restrict__ bcol,
                                                const V* __restrict__ x,
                                                int64_t n_cols, bool vec,
                                                int32_t e, int r, double acc) {
  double a[BS], xv[BS];
  Row<A, BS>::load(blocks + static_cast<int64_t>(e) * (BS * BS) + r * BS, a);
  load_x<A, BS>(x, __ldg(bcol + e), n_cols, vec, xv);
#pragma unroll
  for (int j = 0; j < BS; ++j) acc = fma(a[j], xv[j], acc);
  return acc;
}

template <typename A, typename V, int BS>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_kernel(const A* __restrict__ blocks, const int32_t* __restrict__ bcol,
                const int32_t* __restrict__ bptr, const V* __restrict__ x,
                V* __restrict__ y, int64_t n_rows, int64_t n_cols,
                int64_t n_brows, bool vec) {
  constexpr int kGroups = 32 / BS;  // blocks a warp reads at one step
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= n_brows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int q = lane / BS, r = lane % BS;
  const int32_t e1 = __ldg(bptr + i + 1);
  int32_t e = __ldg(bptr + i) + q;
  double acc0 = 0.0, acc1 = 0.0;
  for (; e + kGroups < e1; e += 2 * kGroups) {
    acc0 = block_row_dot<A, BS>(blocks, bcol, x, n_cols, vec, e, r, acc0);
    acc1 = block_row_dot<A, BS>(blocks, bcol, x, n_cols, vec, e + kGroups, r, acc1);
  }
  if (e < e1) acc0 = block_row_dot<A, BS>(blocks, bcol, x, n_cols, vec, e, r, acc0);
  double acc = acc0 + acc1;
#pragma unroll
  for (int off = BS; off < 32; off *= 2) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  const int64_t row = i * BS + r;
  if (lane < BS && row < n_rows) y[row] = static_cast<V>(acc);
}

template <typename A, typename V, int BS>
int launch(const A* blocks, const int32_t* bcol, const int32_t* bptr,
           const V* x, V* y, int64_t n_rows, int64_t n_cols, int64_t n_brows,
           void* stream) {
  if (n_rows <= 0 || n_cols <= 0 || n_brows <= 0 || n_rows > n_brows * BS ||
      n_rows <= (n_brows - 1) * BS ||
      reinterpret_cast<uintptr_t>(blocks) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t grid = (n_brows + kWarps - 1) / kWarps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  bsr_spmv_kernel<A, V, BS><<<static_cast<unsigned int>(grid), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      blocks, bcol, bptr, x, y, n_rows, n_cols, n_brows, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int afem_bsr8_spmv_f32(const float* blocks, const int32_t* bcol,
                       const int32_t* bptr, const float* x, float* y,
                       int64_t n, int64_t n_sup, void* stream) {
  return launch<float, float, 8>(blocks, bcol, bptr, x, y, n, n, n_sup, stream);
}

int afem_bsr8_spmv_f64(const double* blocks, const int32_t* bcol,
                       const int32_t* bptr, const double* x, double* y,
                       int64_t n, int64_t n_sup, void* stream) {
  return launch<double, double, 8>(blocks, bcol, bptr, x, y, n, n, n_sup, stream);
}

int afem_bsr8_spmv_bf16_f32(const __nv_bfloat16* blocks, const int32_t* bcol,
                            const int32_t* bptr, const float* x, float* y,
                            int64_t n, int64_t n_sup, void* stream) {
  return launch<__nv_bfloat16, float, 8>(blocks, bcol, bptr, x, y, n, n, n_sup,
                                         stream);
}

#define AFEM_BSR_ENTRY(B, NAME, A, V)                                          \
  int afem_bsr_spmv_b##B##_##NAME(const A* blocks, const int32_t* bcol,      \
                                  const int32_t* bptr, const V* x, V* y,     \
                                  int64_t n_rows, int64_t n_cols,            \
                                  int64_t n_brows, void* stream) {           \
    return launch<A, V, B>(blocks, bcol, bptr, x, y, n_rows, n_cols,         \
                           n_brows, stream);                                 \
  }

AFEM_BSR_ENTRY(4, f32, float, float)
AFEM_BSR_ENTRY(4, f64, double, double)
AFEM_BSR_ENTRY(4, bf16_f32, __nv_bfloat16, float)

#undef AFEM_BSR_ENTRY

}  // extern "C"
