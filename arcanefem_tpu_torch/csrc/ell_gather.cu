// ELL gather-reduce kernels for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (arcanefem_tpu_torch/utils/kernels.py).
//
//   afem_ell_gather_sum_{f32,f64}:    y[r] = sum_w x[cols[r,w]]  (cols < 0 add 0)
//   afem_ell_gather_sum_batched_{f32,f64}:
//                                     Y[b,r] = sum_w T[b, cols[r,w]] (cols < 0 add 0)
//
// What they replace.  ell_gather_sum is the unit-weight window kernel
// arcanefem_tpu/sparse/pallas_spmv.py::_products_unit (K2, pallas_call at
// :453).  The batched form replaces _products_b_unit (K3a, pallas_call at
// :488): B <= 8 tables that share one index array, the TPU's (nb, B) grid
// over one window plan (PlannedGather.call_batched).  The TPU kernels DMA windows of x into VMEM
// and resolve each column with a lane-select sweep, because the TPU has no
// fast general gather.  On Hopper a gather is an ordinary load through
// L1/L2, so none of that planning is needed: one kernel reads the (n, W)
// row-major arrays the callers already hold.  The weighted forms, K1
// (_products) and K3b (_products_b), are the sliced kernels of
// csrc/sell_spmv.cu, and K3a's supernode role (a column gather and a row reduce around the 8x8
// block products) is the one kernel of csrc/bsr8_spmv.cu.
//
// What bounds them.  Bytes.  Each stored slot costs a 4-byte column, plus
// one gathered value per table that mostly hits L2 under the supernode
// node order; the arithmetic is one add per slot and table.
//
// Design: a group of T threads (a power of two <= 32, chosen from W) owns
// one row, so neighbouring threads read neighbouring slots of the same row
// and a warp's loads of cols are contiguous; the T partial sums meet
// in registers through warp shuffles.  The batched form keeps B partial
// sums per thread and reads a slot's column once for all B tables.  At
// W = 1 (the coordinate gather of the assembly routes, the compact remap
// gathers) it runs one thread per request with B a template parameter: one
// read of the column, B loads and B stores, no division, 32-bit offsets
// where they fit, copying without widening.  At the 1.9M-DoF coordinate
// shape (43.9M requests, B = 3) its bytes are 16 per request and 12 per
// node, 0.217 ms.  Tables and outputs come with a row
// stride and a table stride, so an (n, B) row-major array (the (N, 3)
// coordinates) is read and written in place.
//
// Inputs and outputs keep their type (f32 on the main path, f64 for the
// parity phase; the Pallas kernels were f32-only), but every row sum
// accumulates in f64 registers, as in K1: free on this byte-bound card.
//
// The kernels allocate nothing, launch on the caller's stream and never
// synchronise; each C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTables = 8;

__device__ __forceinline__ double f64(float v) { return static_cast<double>(v); }
__device__ __forceinline__ double f64(double v) { return v; }

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
template <typename V, int T>
__global__ void __launch_bounds__(kThreads)
ell_gather_kernel(const int32_t* __restrict__ cols, const V* __restrict__ x,
                  V* __restrict__ y, int64_t n, int W) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row = tid / T;
  const int lane = static_cast<int>(tid % T);
  double acc = 0.0;
  if (row < n) {
    const int64_t base = row * static_cast<int64_t>(W);
    for (int w = lane; w < W; w += T) {
      const int32_t c = cols[base + w];
      if (c >= 0) acc += f64(x[c]);
    }
  }
  if (T > 1) acc = group_sum<T>(acc);
  if (row < n && lane == 0) y[row] = static_cast<V>(acc);
}

// Batched, W > 1: as ell_gather_kernel with B <= kMaxTables sums per thread.
// Table b of column c is t[b * ts_b + c * ts_r], output b of row r is
// y[b * ys_b + r * ys_r].  B is the same for every thread, so the
// shuffles under `b < B` are reached by the whole warp.
template <typename V, int T>
__global__ void __launch_bounds__(kThreads)
ell_rows_batched_kernel(const int32_t* __restrict__ cols,
                        const V* __restrict__ t, V* __restrict__ y, int64_t n,
                        int W, int B, int64_t ts_r, int64_t ts_b,
                        int64_t ys_r, int64_t ys_b) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t row = tid / T;
  const int lane = static_cast<int>(tid % T);
  double acc[kMaxTables];
#pragma unroll
  for (int b = 0; b < kMaxTables; ++b) acc[b] = 0.0;
  if (row < n) {
    const int64_t base = row * static_cast<int64_t>(W);
    for (int w = lane; w < W; w += T) {
      const int32_t c = cols[base + w];
      if (c < 0) continue;
      const V* tc = t + static_cast<int64_t>(c) * ts_r;
#pragma unroll
      for (int b = 0; b < kMaxTables; ++b) {
        if (b < B) acc[b] += f64(tc[b * ts_b]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kMaxTables; ++b) {
    if (b < B && T > 1) acc[b] = group_sum<T>(acc[b]);
  }
  if (row < n && lane == 0) {
#pragma unroll
    for (int b = 0; b < kMaxTables; ++b) {
      if (b < B) y[b * ys_b + row * ys_r] = static_cast<V>(acc[b]);
    }
  }
}

// Batched, W = 1: one thread per request serves all B tables (B a
// template parameter, so no division): one read of the column, B loads
// and B stores, adjacent when a table or output stride is 1.  It copies
// values, exactly, without widening them.  I is int32_t where every offset
// the launch can form fits in 31 bits, else int64_t.
template <typename V, int B, typename I>
__global__ void __launch_bounds__(kThreads)
ell_w1_batched_kernel(const int32_t* __restrict__ cols,
                      const V* __restrict__ t, V* __restrict__ y, I n,
                      I ts_r, I ts_b, I ys_r, I ys_b) {
  const I row = static_cast<I>(blockIdx.x) * kThreads + static_cast<I>(threadIdx.x);
  if (row >= n) return;
  const int32_t c = cols[row];
  V v[B];
  if (c >= 0) {
    const V* tc = t + static_cast<I>(c) * ts_r;
#pragma unroll
    for (int b = 0; b < B; ++b) v[b] = __ldg(tc + b * ts_b);
  } else {
#pragma unroll
    for (int b = 0; b < B; ++b) v[b] = V(0);
  }
  V* yr = y + row * ys_r;
#pragma unroll
  for (int b = 0; b < B; ++b) yr[b * ys_b] = v[b];
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

inline bool grid_for(int64_t threads, dim3* grid) {
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return false;
  *grid = dim3(static_cast<unsigned int>(blocks));
  return true;
}

template <typename V>
int launch(const int32_t* cols, const V* x, V* y, int64_t n, int W,
           void* stream) {
  if (n <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int T = group_width(W);
  dim3 grid;
  if (!grid_for(n * T, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AFEM_GATHER(TT) \
  ell_gather_kernel<V, TT><<<grid, kThreads, 0, s>>>(cols, x, y, n, W)
  switch (T) {
    case 1: AFEM_GATHER(1); break;
    case 2: AFEM_GATHER(2); break;
    case 4: AFEM_GATHER(4); break;
    case 8: AFEM_GATHER(8); break;
    case 16: AFEM_GATHER(16); break;
    default: AFEM_GATHER(32); break;
  }
#undef AFEM_GATHER
  return static_cast<int>(cudaGetLastError());
}

template <typename V, int B, typename I>
void launch_w1(dim3 grid, cudaStream_t s, const int32_t* cols, const V* t, V* y,
               int64_t n, int64_t ts_r, int64_t ts_b, int64_t ys_r,
               int64_t ys_b) {
  ell_w1_batched_kernel<V, B, I><<<grid, kThreads, 0, s>>>(
      cols, t, y, static_cast<I>(n), static_cast<I>(ts_r),
      static_cast<I>(ts_b), static_cast<I>(ys_r), static_cast<I>(ys_b));
}

template <typename V, typename I>
void launch_w1_b(int B, dim3 grid, cudaStream_t s, const int32_t* cols,
                 const V* t, V* y, int64_t n, int64_t ts_r, int64_t ts_b,
                 int64_t ys_r, int64_t ys_b) {
#define AFEM_W1(BB)                                                      \
  case BB:                                                               \
    launch_w1<V, BB, I>(grid, s, cols, t, y, n, ts_r, ts_b, ys_r, ys_b); \
    break
  switch (B) {
    AFEM_W1(1); AFEM_W1(2); AFEM_W1(3); AFEM_W1(4);
    AFEM_W1(5); AFEM_W1(6); AFEM_W1(7); default: AFEM_W1(8);
  }
#undef AFEM_W1
}

template <typename V>
int launch_batched(const int32_t* cols, const V* t, V* y,
                   int64_t n, int W, int B, int64_t n_t, int64_t ts_r,
                   int64_t ts_b, int64_t ys_r, int64_t ys_b, void* stream) {
  if (n <= 0 || W <= 0 || B <= 0 || B > kMaxTables || n_t < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid;
  if (W == 1) {
    if (!grid_for(n, &grid)) return static_cast<int>(cudaErrorInvalidValue);
    // the largest offset into the tables, the output and the grid
    const int64_t reach = n_t * ts_r + (B - 1) * ts_b;
    const int64_t wreach = (n - 1) * ys_r + (B - 1) * ys_b;
    const int64_t span = static_cast<int64_t>(grid.x) * kThreads;
    if (reach < (1LL << 31) && wreach < (1LL << 31) && span < (1LL << 31)) {
      launch_w1_b<V, int32_t>(B, grid, s, cols, t, y, n, ts_r, ts_b, ys_r, ys_b);
    } else {
      launch_w1_b<V, int64_t>(B, grid, s, cols, t, y, n, ts_r, ts_b, ys_r, ys_b);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int T = group_width(W);
  if (!grid_for(n * T, &grid)) return static_cast<int>(cudaErrorInvalidValue);
#define AFEM_BATCHED(TT)                                 \
  ell_rows_batched_kernel<V, TT><<<grid, kThreads, 0, s>>>( \
      cols, t, y, n, W, B, ts_r, ts_b, ys_r, ys_b)
  switch (T) {
    case 2: AFEM_BATCHED(2); break;
    case 4: AFEM_BATCHED(4); break;
    case 8: AFEM_BATCHED(8); break;
    case 16: AFEM_BATCHED(16); break;
    default: AFEM_BATCHED(32); break;
  }
#undef AFEM_BATCHED
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int afem_ell_gather_sum_f32(const int32_t* cols, const float* x, float* y,
                            int64_t n, int W, void* stream) {
  return launch<float>(cols, x, y, n, W, stream);
}

int afem_ell_gather_sum_f64(const int32_t* cols, const double* x, double* y,
                            int64_t n, int W, void* stream) {
  return launch<double>(cols, x, y, n, W, stream);
}

int afem_ell_gather_sum_batched_f32(const int32_t* cols, const float* t,
                                    float* y, int64_t n, int W, int B,
                                    int64_t n_t, int64_t ts_r, int64_t ts_b,
                                    int64_t ys_r, int64_t ys_b, void* stream) {
  return launch_batched<float>(cols, t, y, n, W, B, n_t, ts_r, ts_b, ys_r,
                               ys_b, stream);
}

int afem_ell_gather_sum_batched_f64(const int32_t* cols, const double* t,
                                    double* y, int64_t n, int W, int B,
                                    int64_t n_t, int64_t ts_r, int64_t ts_b,
                                    int64_t ys_r, int64_t ys_b, void* stream) {
  return launch_batched<double>(cols, t, y, n, W, B, n_t, ts_r, ts_b, ys_r,
                                ys_b, stream);
}

}  // extern "C"
