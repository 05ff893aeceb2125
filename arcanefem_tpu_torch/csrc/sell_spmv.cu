// Sliced-ELL SpMV (SELL-32-sigma) for Hopper (sm_90a), bound through a plain
// C interface and loaded with ctypes (arcanefem_tpu_torch/utils/kernels.py).
//
//   afem_sell_spmv_{f32,f64,bf16_f32}:
//     y[row(i)] = sum_k vals[p(i,k)] * x[cols[p(i,k)]]
//     p(i,k) = slice_ptr[i / 32] + 32 * k + i % 32,  k < width(i / 32)
//
// for row positions i < n_rows; row(i) = perm[i], or i where perm is null.
//
//   afem_sell_spmv_batched_{f32,f64,bf16_f32}:
//     Y[b, row(i)] = sum_k vals[p(i,k)] * T[b, cols[p(i,k)]],  b < B <= 8
//
// with T[b, c] = t[b * ts_b + c * ts_r] and Y[b, r] = y[b * ys_b + r * ys_r].
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
// The batched form replaces K3b, the weighted window kernel over B <= 8
// tables, arcanefem_tpu/sparse/pallas_spmv.py::_products_b (pallas_call at
// :528), which PlannedGather.call_batched runs with the plan of __call__:
// the same product applied to a stack of tables.  Here it is K1's layout
// and loop with B accumulators per thread: vals and cols are read once for
// all B tables, and each slot reads T's B values of its column.  A
// channel-minor (n, B) table at B = 4 or 8, 16-byte aligned, is read with
// 16-byte loads (one 32-byte sector per slot at B = 8 in f32), and such an
// output written with 16-byte stores; other strides take scalar loads and
// stores.  Its floor is 8 bytes per nonzero plus, per row, the
// permutation's 4 and B values of table and of output: at the 1.9M fine
// operator with B = 8 in f32, 8 per nonzero and 68 per row, 352 MB or
// 0.105 ms at 3.35 TB/s.  Each table's row sum is the same f64 sum in the
// same slot order as K1's on that table.
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

template <typename V> struct Vec16;  // the 16-byte vector of V
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

__device__ __forceinline__ void unpack(const float4& w, float* out) {
  out[0] = w.x; out[1] = w.y; out[2] = w.z; out[3] = w.w;
}
__device__ __forceinline__ void unpack(const double2& w, double* out) {
  out[0] = w.x; out[1] = w.y;
}
__device__ __forceinline__ float4 pack(const double* v, float*) {
  return make_float4(static_cast<float>(v[0]), static_cast<float>(v[1]),
                     static_cast<float>(v[2]), static_cast<float>(v[3]));
}
__device__ __forceinline__ double2 pack(const double* v, double*) {
  return make_double2(v[0], v[1]);
}

// T's B values of column c: 16-byte loads of a channel-minor (n, B) row
// where kVec, else B scalar loads through the strides
template <typename V, int B, bool kVec>
__device__ __forceinline__ void load_row(const V* __restrict__ t, int32_t c,
                                         int64_t ts_r, int64_t ts_b, V* out) {
  if constexpr (kVec) {
    using W = typename Vec16<V>::type;
    constexpr int kPer = 16 / sizeof(V);
    const W* p = reinterpret_cast<const W*>(t + static_cast<int64_t>(c) * B);
#pragma unroll
    for (int q = 0; q < B / kPer; ++q) unpack(__ldg(p + q), out + q * kPer);
  } else {
    const V* p = t + static_cast<int64_t>(c) * ts_r;
#pragma unroll
    for (int b = 0; b < B; ++b) out[b] = __ldg(p + b * ts_b);
  }
}

template <typename Wt, typename V, int B, bool kVec>
__global__ void __launch_bounds__(kThreads)
sell_spmv_batched_kernel(const Wt* __restrict__ vals,
                         const int32_t* __restrict__ cols,
                         const int64_t* __restrict__ slice_ptr,
                         const int32_t* __restrict__ perm,
                         const V* __restrict__ t, V* __restrict__ y,
                         int64_t n_rows, int64_t n_slices, int64_t ts_r,
                         int64_t ts_b, int64_t ys_r, int64_t ys_b) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t s = i / kSlice;
  if (s >= n_slices) return;
  const int64_t begin = slice_ptr[s] + (i % kSlice);
  const int width = static_cast<int>((slice_ptr[s + 1] - slice_ptr[s]) / kSlice);
  const Wt* vp = vals + begin;
  const int32_t* cp = cols + begin;
  double acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = 0.0;
  int k = 0;
  for (; k + kUnroll <= width; k += kUnroll) {
    int32_t c[kUnroll];
    double v[kUnroll];
    V x[kUnroll][B];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) c[u] = __ldcs(cp + u * kSlice);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = stream_load(vp + u * kSlice);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_row<V, B, kVec>(t, c[u], ts_r, ts_b, x[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int b = 0; b < B; ++b) acc[b] += v[u] * static_cast<double>(x[u][b]);
    }
    cp += kUnroll * kSlice;
    vp += kUnroll * kSlice;
  }
  for (; k < width; ++k) {
    V x[B];
    const double v = stream_load(vp);
    load_row<V, B, kVec>(t, __ldcs(cp), ts_r, ts_b, x);
#pragma unroll
    for (int b = 0; b < B; ++b) acc[b] += v * static_cast<double>(x[b]);
    cp += kSlice;
    vp += kSlice;
  }
  if (i >= n_rows) return;
  const int64_t row = perm == nullptr ? i : perm[i];
  if constexpr (kVec) {
    using W = typename Vec16<V>::type;
    constexpr int kPer = 16 / sizeof(V);
    W* p = reinterpret_cast<W*>(y + row * B);
#pragma unroll
    for (int q = 0; q < B / kPer; ++q) p[q] = pack(acc + q * kPer, static_cast<V*>(nullptr));
  } else {
    V* p = y + row * ys_r;
#pragma unroll
    for (int b = 0; b < B; ++b) p[b * ys_b] = static_cast<V>(acc[b]);
  }
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

template <typename Wt, typename V>
int launch_batched(const Wt* vals, const int32_t* cols, const int64_t* slice_ptr,
                   const int32_t* perm, const V* t, V* y, int64_t n_rows,
                   int64_t n_slices, int B, int64_t ts_r, int64_t ts_b,
                   int64_t ys_r, int64_t ys_b, void* stream) {
  if (n_rows <= 0 || n_slices != (n_rows + kSlice - 1) / kSlice || B < 1 || B > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_slices * kSlice + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (B == 4 || B == 8) && ts_b == 1 && ts_r == B && ys_b == 1 &&
                   ys_r == B && reinterpret_cast<uintptr_t>(t) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid(static_cast<unsigned int>(blocks));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define AFEM_BATCHED(BB, VEC)                                                 \
  sell_spmv_batched_kernel<Wt, V, BB, VEC><<<grid, kThreads, 0, st>>>(        \
      vals, cols, slice_ptr, perm, t, y, n_rows, n_slices, ts_r, ts_b, ys_r, \
      ys_b)
  switch (B) {
    case 1: AFEM_BATCHED(1, false); break;
    case 2: AFEM_BATCHED(2, false); break;
    case 3: AFEM_BATCHED(3, false); break;
    case 4: if (vec) AFEM_BATCHED(4, true); else AFEM_BATCHED(4, false); break;
    case 5: AFEM_BATCHED(5, false); break;
    case 6: AFEM_BATCHED(6, false); break;
    case 7: AFEM_BATCHED(7, false); break;
    default: if (vec) AFEM_BATCHED(8, true); else AFEM_BATCHED(8, false); break;
  }
#undef AFEM_BATCHED
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

#define AFEM_SELL_BATCHED(NAME, WT, V)                                          \
  int NAME(const WT* vals, const int32_t* cols, const int64_t* slice_ptr,         \
           const int32_t* perm, const V* t, V* y, int64_t n_rows,                \
           int64_t n_slices, int B, int64_t ts_r, int64_t ts_b, int64_t ys_r,    \
           int64_t ys_b, void* stream) {                                         \
    return launch_batched<WT, V>(vals, cols, slice_ptr, perm, t, y, n_rows,      \
                                 n_slices, B, ts_r, ts_b, ys_r, ys_b, stream);   \
  }

AFEM_SELL_BATCHED(afem_sell_spmv_batched_f32, float, float)
AFEM_SELL_BATCHED(afem_sell_spmv_batched_f64, double, double)
AFEM_SELL_BATCHED(afem_sell_spmv_batched_bf16_f32, __nv_bfloat16, float)

}  // extern "C"
