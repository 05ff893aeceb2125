// BSR-2 SpMV over 2x2 blocks stored in slices (SELL-32-sigma of blocks) for
// Hopper (sm_90a), bound through a plain C interface and loaded with ctypes
// (arcanefem_tpu_torch/utils/kernels.py).
//
//   afem_bsr2_slice_spmv_{f32,f64,bf16_f32}:
//     y[2 row(p) + r] = sum_k sum_j blocks[q(p,k), r, j] * x[2 cols[q(p,k)] + j]
//     q(p,k) = slice_ptr[p / 32] + 32 k + p % 32,  k < width(p / 32)
//
// for block row positions p < ceil(n_rows / 2); row(p) = perm[p], or p
// where perm is null; columns at or past n_cols read 0, rows at or past
// n_rows are not written.  bf16 blocks take f32 x and y, x rounded to bf16
// first, as the JAX einsum does (xg.astype(blocks.dtype)).  The layout is
// built by arcanefem_tpu_torch/sparse/blocked.py::BlockSlices.
//
// What it replaces.  K3a's blocked role at b = 2:
// arcanefem_tpu/sparse/blocked.py::BlockedGather.__call__ (the pre-gather,
// the _products_b_unit sweep, pallas_call at
// arcanefem_tpu/sparse/pallas_spmv.py:488, its channel contraction and the
// stage-3 subrow sums), which on this card is one BSR-2 SpMV.  Until it, the
// port ran csrc/bsr8_spmv.cu's warp-per-block-row template at b = 2; that
// file says what held it at 0.40 of its bound.
//
// What bounds it.  Bytes: each stored 2x2 block (16 B in f32, 32 in f64, 8
// in bf16) and its 4-byte column once, the permutation's 4 bytes per block
// row, x and y.  The product itself needs 20 B per block in f32 plus x, y
// and the block pointers: at the 1.9M sphere's operator (946,345 block
// rows, 17.51M blocks) 369 MB, 0.110 ms at 3.35 TB/s; the slices add their
// padding (the stored slots over the blocks, reported by the wrapper).  x
// (7.6 MB at 1.9M) is read from L2.  The arithmetic, 8 f64 flops per block,
// is far under the byte bound.
//
// Design.  Block rows, sorted by block count inside windows of sigma where
// that saves more slot bytes than the permutation costs, are cut into
// slices of 32, each padded to its own longest block row and stored
// slot-major, as K1 stores scalars (csrc/sell_spmv.cu), and one thread takes
// one block row.  Per slot a warp reads 32 consecutive blocks (512 B in f32,
// one 16-byte float4 per lane; two double2 per lane in f64; one uint2 in
// bf16), 32 consecutive columns (128 B) and, per lane, x's two values of
// its block column (one float2 or double2, through L1/L2).  Four slots are
// issued per loop trip, their column loads first, so that four block loads
// and then four x loads are in flight per thread.  Each thread keeps its
// two rows' sums in f64 registers (each product rounded to f64, the row's
// two products added, then the sum: the plain twin's order; f32 and bf16
// products are exact in f64) and writes them as one float2 (double2)
// through perm: no shuffles, and no idle lanes but the slice padding.  A
// padding slot is a zero block with an in-range column, so it adds 0.
// Scalar paths remain for x or y not aligned to two values, for the last
// block column of an odd n_cols (its second value reads 0) and for the
// last block row of an odd n_rows (one value written).
//
// The kernel allocates nothing, launches on the caller's stream and never
// synchronises; each C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 32;   // block rows per slice: one warp
constexpr int kUnroll = 4;   // slots per loop trip

// acc + a·b with the product rounded first: no contraction into an FMA
__device__ __forceinline__ double prod_add(double acc, double a, double b) {
  return __dadd_rn(acc, __dmul_rn(a, b));
}

// One 2x2 block [a0 a1; a2 a3] as stored, read once past L1, and widened.
template <typename A>
struct Block2;

template <>
struct Block2<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = __ldcs(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void widen(double (&a)[4]) const {
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  }
};

template <>
struct Block2<double> {
  double2 v0, v1;
  __device__ __forceinline__ void load(const double* p) {
    v0 = __ldcs(reinterpret_cast<const double2*>(p));
    v1 = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  }
  __device__ __forceinline__ void widen(double (&a)[4]) const {
    a[0] = v0.x; a[1] = v0.y; a[2] = v1.x; a[3] = v1.y;
  }
};

template <>
struct Block2<__nv_bfloat16> {
  uint2 v;  // a bf16 value is the high half of the f32 with the same bits
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldcs(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void widen(double (&a)[4]) const {
    a[0] = __uint_as_float(v.x << 16); a[1] = __uint_as_float(v.x & 0xffff0000u);
    a[2] = __uint_as_float(v.y << 16); a[3] = __uint_as_float(v.y & 0xffff0000u);
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

template <typename V> struct Vec2;  // two values of V in one load or store
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

// x[2c], x[2c + 1] as the block's products see them; the second is 0 at or
// past n_cols
template <typename A, typename V>
__device__ __forceinline__ void load_x2(const V* __restrict__ x, int32_t c,
                                        int64_t n_cols, bool vec, double& x0,
                                        double& x1) {
  const int64_t cb = 2 * static_cast<int64_t>(c);
  if (vec && cb + 2 <= n_cols) {
    const typename Vec2<V>::type u =
        __ldg(reinterpret_cast<const typename Vec2<V>::type*>(x + cb));
    x0 = xval<A>(u.x);
    x1 = xval<A>(u.y);
  } else {
    x0 = xval<A>(__ldg(x + cb));
    x1 = cb + 1 < n_cols ? xval<A>(__ldg(x + cb + 1)) : 0.0;
  }
}

template <typename A, typename V>
__device__ __forceinline__ void block_products(const Block2<A>& blk, int32_t c,
                                               const V* __restrict__ x,
                                               int64_t n_cols, bool vec,
                                               double& acc0, double& acc1) {
  double a[4], x0, x1;
  blk.widen(a);
  load_x2<A>(x, c, n_cols, vec, x0, x1);
  acc0 = __dadd_rn(acc0, prod_add(__dmul_rn(a[0], x0), a[1], x1));
  acc1 = __dadd_rn(acc1, prod_add(__dmul_rn(a[2], x0), a[3], x1));
}

template <typename A, typename V>
__global__ void __launch_bounds__(kThreads)
bsr2_slice_kernel(const A* __restrict__ blocks, const int32_t* __restrict__ cols,
                  const int64_t* __restrict__ slice_ptr,
                  const int32_t* __restrict__ perm, const V* __restrict__ x,
                  V* __restrict__ y, int64_t n_rows, int64_t n_cols,
                  int64_t n_brows, int64_t n_slices, bool vec, bool yvec) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t s = i / kSlice;
  if (s >= n_slices) return;  // whole warps: n_slices * 32 rounds to warps
  const int64_t begin = slice_ptr[s] + (i % kSlice);
  const int width = static_cast<int>((slice_ptr[s + 1] - slice_ptr[s]) / kSlice);
  const A* bp = blocks + begin * 4;
  const int32_t* cp = cols + begin;
  double acc0 = 0.0, acc1 = 0.0;
  int k = 0;
  for (; k + kUnroll <= width; k += kUnroll) {
    int32_t c[kUnroll];
    Block2<A> blk[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) c[u] = __ldcs(cp + u * kSlice);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) blk[u].load(bp + u * kSlice * 4);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) block_products(blk[u], c[u], x, n_cols, vec, acc0, acc1);
    cp += kUnroll * kSlice;
    bp += kUnroll * kSlice * 4;
  }
  for (; k < width; ++k) {
    Block2<A> blk;
    blk.load(bp);
    block_products(blk, __ldcs(cp), x, n_cols, vec, acc0, acc1);
    cp += kSlice;
    bp += kSlice * 4;
  }
  if (i >= n_brows) return;
  const int64_t r0 = 2 * (perm == nullptr ? i : static_cast<int64_t>(perm[i]));
  if (yvec && r0 + 2 <= n_rows) {
    using W = typename Vec2<V>::type;
    W w;
    w.x = static_cast<V>(acc0);
    w.y = static_cast<V>(acc1);
    *reinterpret_cast<W*>(y + r0) = w;
  } else {
    y[r0] = static_cast<V>(acc0);
    if (r0 + 1 < n_rows) y[r0 + 1] = static_cast<V>(acc1);
  }
}

template <typename A, typename V>
int launch_bsr2(const A* blocks, const int32_t* cols, const int64_t* slice_ptr,
                const int32_t* perm, const V* x, V* y, int64_t n_rows,
                int64_t n_cols, int64_t n_slices, void* stream) {
  const int64_t n_brows = (n_rows + 1) / 2;
  if (n_rows <= 0 || n_cols <= 0 || n_slices != (n_brows + kSlice - 1) / kSlice ||
      reinterpret_cast<uintptr_t>(blocks) % (4 * sizeof(A) < 16 ? 4 * sizeof(A) : 16) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t grid = (n_slices * kSlice + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(x) % (2 * sizeof(V)) == 0;
  const bool yvec = reinterpret_cast<uintptr_t>(y) % (2 * sizeof(V)) == 0;
  bsr2_slice_kernel<A, V><<<static_cast<unsigned int>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      blocks, cols, slice_ptr, perm, x, y, n_rows, n_cols, n_brows, n_slices,
      vec, yvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define AFEM_BSR2_ENTRY(NAME, A, V)                                            \
  int afem_bsr2_slice_spmv_##NAME(const A* blocks, const int32_t* cols,       \
                                  const int64_t* slice_ptr,                   \
                                  const int32_t* perm, const V* x, V* y,      \
                                  int64_t n_rows, int64_t n_cols,             \
                                  int64_t n_slices, void* stream) {           \
    return launch_bsr2<A, V>(blocks, cols, slice_ptr, perm, x, y, n_rows,     \
                             n_cols, n_slices, stream);                       \
  }

AFEM_BSR2_ENTRY(f32, float, float)
AFEM_BSR2_ENTRY(f64, double, double)
AFEM_BSR2_ENTRY(bf16_f32, __nv_bfloat16, float)

#undef AFEM_BSR2_ENTRY

}  // extern "C"
