// ELL gather-reduce kernels for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (arcanefem_tpu_torch/utils/kernels.py).
//
//   afem_ell_spmv_{f32,f64}:       y[r] = sum_w vals[r,w] * x[cols[r,w]]
//   afem_ell_gather_sum_{f32,f64}: y[r] = sum_w x[cols[r,w]]   (cols < 0 add 0)
//
// What they replace.  ell_spmv is the weighted window kernel
// arcanefem_tpu/sparse/pallas_spmv.py::_products (pallas_call at :412, body
// _make_kernel(unit=False)) together with its row sum
// PlannedGather._row_sums; ell_gather_sum is the unit-weight form
// _products_unit (pallas_call at :453).  The TPU kernels DMA windows of x
// into VMEM and resolve each column with a lane-select sweep, because the
// TPU has no fast general gather.  On Hopper a gather is an ordinary load
// through L1/L2, so none of that planning is needed: one kernel reads the
// (n, W) row-major arrays that BellMatrix and the AMG transfers already hold.
//
// What bounds them.  Bytes.  Each stored slot costs a 4- or 8-byte value
// plus a 4-byte column, and one gathered x value that mostly hits L2 under
// the supernode node order; the arithmetic is one FMA per slot.  At 1.9M
// DoF the fine level holds 47.3M slots: about 0.38 GB per f32 SpMV, 0.11 ms
// at the H100's 3.35 TB/s.
//
// Design: a group of T threads (a power of two <= 32, chosen from W) owns
// one row, so neighbouring threads read neighbouring slots of the same row
// and a warp's loads of vals/cols are contiguous; the T partial sums meet
// in registers through warp shuffles.  Wide rows (the restriction P^T reaches
// W > 100) are one pass of the same loop, with no subrow split.
//
// Inputs and outputs keep their type (f32 on the main path, f64 for the
// parity phase; the Pallas kernels were f32-only), but every row sum
// accumulates in f64 registers.  That is free on this card (the kernels are
// byte-bound) and it matters: a Poisson row cancels to a small fraction of
// sum |a_ij x_j|, and f32 accumulation in the CG SpMV left the f32 solve's
// true residual about 100x above what f64 accumulation gives.
//
// The kernels allocate nothing, launch on the caller's stream and never
// synchronise; each C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int T>
__device__ __forceinline__ double group_sum(double v) {
#pragma unroll
  for (int off = T / 2; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off, T);
  }
  return v;
}

// T threads per row; T divides 32, so a group never straddles a warp and
// every thread of a warp reaches the shuffles (rows past n add zeros).
template <typename V, int T, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
ell_rows_kernel(const V* __restrict__ vals, const int32_t* __restrict__ cols,
                const V* __restrict__ x, V* __restrict__ y, int64_t n,
                int W) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row = tid / T;
  const int lane = static_cast<int>(tid % T);
  double acc = 0.0;
  if (row < n) {
    const int64_t base = row * static_cast<int64_t>(W);
    for (int w = lane; w < W; w += T) {
      const int32_t c = cols[base + w];
      if (kWeighted) {
        acc += static_cast<double>(vals[base + w]) * static_cast<double>(x[c]);
      } else if (c >= 0) {
        acc += static_cast<double>(x[c]);
      }
    }
  }
  if (T > 1) acc = group_sum<T>(acc);
  if (row < n && lane == 0) y[row] = static_cast<V>(acc);
}

// Threads per row: the smallest power of two >= ceil(W / 2), at most 32.
// W=1 (the assembly coordinate gather) gets one thread per row, W=25 (the
// fine Poisson level) 16, and W >= 33 a whole warp.
inline int group_width(int W) {
  const int half = (W + 1) / 2;
  int t = 1;
  while (t < half && t < 32) t *= 2;
  return t;
}

template <typename V, bool kWeighted>
int launch(const V* vals, const int32_t* cols, const V* x, V* y, int64_t n,
           int W, void* stream) {
  if (n <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int T = group_width(W);
  const int64_t blocks = (n * T + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 1:
      ell_rows_kernel<V, 1, kWeighted><<<grid, kThreads, 0, s>>>(vals, cols, x, y, n, W);
      break;
    case 2:
      ell_rows_kernel<V, 2, kWeighted><<<grid, kThreads, 0, s>>>(vals, cols, x, y, n, W);
      break;
    case 4:
      ell_rows_kernel<V, 4, kWeighted><<<grid, kThreads, 0, s>>>(vals, cols, x, y, n, W);
      break;
    case 8:
      ell_rows_kernel<V, 8, kWeighted><<<grid, kThreads, 0, s>>>(vals, cols, x, y, n, W);
      break;
    case 16:
      ell_rows_kernel<V, 16, kWeighted><<<grid, kThreads, 0, s>>>(vals, cols, x, y, n, W);
      break;
    default:
      ell_rows_kernel<V, 32, kWeighted><<<grid, kThreads, 0, s>>>(vals, cols, x, y, n, W);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int afem_ell_spmv_f32(const float* vals, const int32_t* cols, const float* x,
                      float* y, int64_t n, int W, void* stream) {
  return launch<float, true>(vals, cols, x, y, n, W, stream);
}

int afem_ell_spmv_f64(const double* vals, const int32_t* cols,
                      const double* x, double* y, int64_t n, int W,
                      void* stream) {
  return launch<double, true>(vals, cols, x, y, n, W, stream);
}

int afem_ell_gather_sum_f32(const int32_t* cols, const float* x, float* y,
                            int64_t n, int W, void* stream) {
  return launch<float, false>(nullptr, cols, x, y, n, W, stream);
}

int afem_ell_gather_sum_f64(const int32_t* cols, const double* x, double* y,
                            int64_t n, int W, void* stream) {
  return launch<double, false>(nullptr, cols, x, y, n, W, stream);
}

}  // extern "C"
