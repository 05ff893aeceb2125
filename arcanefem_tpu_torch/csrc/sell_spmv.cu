// Sliced-ELL SpMV (SELL-32-sigma) for Hopper (sm_90a), bound through a plain
// C interface and loaded with ctypes (arcanefem_tpu_torch/utils/kernels.py).
//
//   afem_sell_spmv_{f32,f64,bf16_f32}:
//     y[row(i)] = sum_k vals[p(i,k)] * x[cols[p(i,k)]]
//     p(i,k) = slice_ptr[i / 32] + 32 * k + i % 32,  k < width(i / 32)
//
// for row positions i < n_rows; row(i) = perm[i], or i where perm is null.
//
// What it replaces.  K1, the weighted window kernel
// arcanefem_tpu/sparse/pallas_spmv.py::_products (pallas_call at :412, body
// _make_kernel(unit=False)) with its row sum PlannedGather._row_sums: the
// SpMV of the CG operator, of every AMG level's smoother and residual, and
// of the transfers P and P^T.  The TPU kernel DMAs windows of x into VMEM
// and resolves each column with a lane-select sweep; on Hopper a gather is a
// load through L1/L2, and what is left to design is how the matrix is
// streamed.
//
// What bounds it.  Bytes.  Each stored slot is a 4-byte value (8 in f64, 2
// in bf16) and a 4-byte column, read once; x (7.6 MB at 1.9M rows in f32)
// stays in the 50 MB L2 under the supernode node order, and y is written
// once.  The floor of the work itself is 8 bytes per nonzero plus 12 per
// row: 246 MB, 0.073 ms at 3.35 TB/s for the 1.9M-row fine operator
// (27.9M nonzeros).
//
// Design.  The row-major (N, W) layout the port used before padded every
// row to the widest one (W = 25 at 1.9M: 47.3M slots for 27.9M nonzeros,
// 41% of the bytes padding), ran 16 threads per row with 7 of them idle in
// the second pass and a shuffle tree per row, and its 100-byte rows put a
// half-warp's loads across three 32-byte sectors.  Here the rows are cut
// into slices of 32 (one warp), each padded only to its own longest row and
// stored slot-major: slot k of the slice's 32 rows is 32 consecutive values
// and 32 consecutive columns, one aligned 128-byte line each (64 bytes in
// bf16).  Rows may first be sorted by length inside windows of sigma rows
// (sparse/sell.py picks sigma per operator: 1, no permutation, unless
// sorting saves more slot bytes than the permutation's 4 bytes per row
// cost).  At 1.9M rows the fine operator stores 30.0M slots at sigma = 1
// (1.076x its 27.9M nonzeros) and 28.15M at sigma = 1024 (1.009x), so it
// takes sigma = 1024; the slot-major reads are then 60% of the (N, W)
// layout's 47.3M slots.  One thread owns one row: no
// shuffles, no idle lanes, one store.  The slot loop is unrolled by 4 so
// that four column loads, then four x loads, are in flight per thread.
// vals and cols are streamed once, read with the evict-first hint
// (__ldcs) so they do not push x out of L1; x goes through the read-only
// path (__ldg).  Wide rows (P^T reaches W > 100) need no split: their
// slice is simply wider.  wgmma and TMA do not apply: a gather SpMV does
// 0.25 flop per byte.
//
// Every row sum accumulates in f64, in slot order, whatever the storage
// type: a Poisson row cancels to a small fraction of sum |a_ij x_j|, and an
// f32 accumulator left the f32 solve's true residual ~100x above what f64
// gives (the bytes bound the kernel, so f64 adds costs nothing).  bf16
// weights with f32 x serve the bf16 V-cycle copies.
//
// The kernel allocates nothing, launches on the caller's stream and never
// synchronises; each C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 32;
constexpr int kUnroll = 4;

__device__ __forceinline__ double stream_load(const float* p) {
  return static_cast<double>(__ldcs(p));
}
__device__ __forceinline__ double stream_load(const double* p) { return __ldcs(p); }
__device__ __forceinline__ double stream_load(const __nv_bfloat16* p) {
  const unsigned short bits = __ldcs(reinterpret_cast<const unsigned short*>(p));
  return static_cast<double>(__bfloat162float(__ushort_as_bfloat16(bits)));
}

template <typename Wt, typename V>
__global__ void __launch_bounds__(kThreads)
sell_spmv_kernel(const Wt* __restrict__ vals, const int32_t* __restrict__ cols,
                 const int64_t* __restrict__ slice_ptr,
                 const int32_t* __restrict__ perm, const V* __restrict__ x,
                 V* __restrict__ y, int64_t n_rows, int64_t n_slices) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t s = i / kSlice;
  if (s >= n_slices) return;  // whole warps: n_slices * 32 rounds to warps
  const int64_t begin = slice_ptr[s] + (i % kSlice);
  const int width = static_cast<int>((slice_ptr[s + 1] - slice_ptr[s]) / kSlice);
  const Wt* vp = vals + begin;
  const int32_t* cp = cols + begin;
  double acc = 0.0;
  int k = 0;
  for (; k + kUnroll <= width; k += kUnroll) {
    int32_t c[kUnroll];
    double v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) c[u] = __ldcs(cp + u * kSlice);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = stream_load(vp + u * kSlice);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc += v[u] * static_cast<double>(__ldg(x + c[u]));
    }
    cp += kUnroll * kSlice;
    vp += kUnroll * kSlice;
  }
  for (; k < width; ++k) {
    acc += stream_load(vp) * static_cast<double>(__ldg(x + __ldcs(cp)));
    cp += kSlice;
    vp += kSlice;
  }
  if (i < n_rows) y[perm == nullptr ? i : perm[i]] = static_cast<V>(acc);
}

template <typename Wt, typename V>
int launch(const Wt* vals, const int32_t* cols, const int64_t* slice_ptr,
           const int32_t* perm, const V* x, V* y, int64_t n_rows,
           int64_t n_slices, void* stream) {
  if (n_rows <= 0 || n_slices != (n_rows + kSlice - 1) / kSlice) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_slices * kSlice + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sell_spmv_kernel<Wt, V><<<static_cast<unsigned int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      vals, cols, slice_ptr, perm, x, y, n_rows, n_slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int afem_sell_spmv_f32(const float* vals, const int32_t* cols,
                       const int64_t* slice_ptr, const int32_t* perm,
                       const float* x, float* y, int64_t n_rows,
                       int64_t n_slices, void* stream) {
  return launch<float, float>(vals, cols, slice_ptr, perm, x, y, n_rows,
                              n_slices, stream);
}

int afem_sell_spmv_f64(const double* vals, const int32_t* cols,
                       const int64_t* slice_ptr, const int32_t* perm,
                       const double* x, double* y, int64_t n_rows,
                       int64_t n_slices, void* stream) {
  return launch<double, double>(vals, cols, slice_ptr, perm, x, y, n_rows,
                                n_slices, stream);
}

int afem_sell_spmv_bf16_f32(const __nv_bfloat16* vals, const int32_t* cols,
                            const int64_t* slice_ptr, const int32_t* perm,
                            const float* x, float* y, int64_t n_rows,
                            int64_t n_slices, void* stream) {
  return launch<__nv_bfloat16, float>(vals, cols, slice_ptr, perm, x, y,
                                      n_rows, n_slices, stream);
}

}  // extern "C"
