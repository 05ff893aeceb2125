// Slot-major ("diagonal-coherent") ELL SpMV for Hopper (sm_90a), bound
// through a plain C interface and loaded with ctypes
// (arcanefem_tpu_torch/utils/kernels.py).
//
//   afem_diag_spmv_{f32,f64}: y[r] = sum_w vals[r, w] * x[col[r, w]]
//
// over the plan of sparse/diag_spmv.py::plan_diag (a copy of the JAX
// package's).  Rows come in blocks of R = qn*1024; a block holds G = W*qn
// tiles of (8, 128) entries, tile g = w*qn + q holding slot w of the block's
// rows q*1024 .. q*1024 + 1023, row q*1024 + s*128 + l at (s, l).  Per
// entry the plan stores the diagonalised offset lcols, and per tile the
// first probe chunk c0 and the probe count scnt.  The column is
//
//   col = (lo[blk] - 8)*128 + 128*s + lcols
//
// (lo carries the +8 shift of the TPU layout's 8*128 leading zeros), and
// the entry counts only when lcols >> 7 lies in [c0, c0 + scnt), the
// chunks the TPU kernel probes.
//
// What it replaces.  arcanefem_tpu/sparse/pallas_spmv_diag.py::_products
// (K10, pallas_call at :180, body _make_kernel :120-154), which DMAs the
// block's x window into VMEM and resolves each tile's columns with scnt
// dynamic sublane probes, and the row sum over W that the JAX code does
// outside the kernel.  On Hopper a column is one load through L1/L2, so
// the probe loop collapses to the reach test.
//
// What bounds it.  Bytes: 4- or 8-byte values and a 4-byte offset per
// slot, x gathered (mostly from L2: RCM keeps a block's columns in a band),
// 8 bytes per output row in f64 runs.  One FMA per slot.
//
// Design: one thread per row looping over its W slots.  Threads of a warp
// are 32 consecutive lanes of one sublane, so each slot's vals and lcols
// loads are one coalesced 128-byte line, the classic coalesced ELL layout;
// the tile's c0 and scnt are broadcast loads (packing them as one int2 per
// tile was tried and measured no faster beyond the spread between runs).
// The row sums in f64 registers, as the ELL kernels do (f32 row sums left
// the f32 CG solve's true residual far above f64's), and y is written
// directly.  At the RCM sphere's 244k rows the body runs at 0.75-0.81 of
// its byte bound (profiler device time on an H100), so staging x or the
// tiles in shared memory or through TMA could win no more than the spread
// between runs.  What the kernel's design does decide is the host's work per
// call: DiagEllMatrix checks its five plan arrays once and keeps their
// pointers, so a call checks only x and launches once.
//
// The kernel allocates nothing, launches on the caller's stream and never
// synchronises; each C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLane = 128;
constexpr int kSub = 8;
constexpr int kTileRows = kSub * kLane;

template <typename V>
__global__ void __launch_bounds__(kThreads)
diag_spmv_kernel(const int32_t* __restrict__ lo, const int32_t* __restrict__ c0,
                 const int32_t* __restrict__ scnt,
                 const int32_t* __restrict__ lcols, const V* __restrict__ vals,
                 const V* __restrict__ x, V* __restrict__ y, int64_t n, int W,
                 int qn) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= n) return;
  const int64_t R = static_cast<int64_t>(qn) * kTileRows;
  const int64_t blk = r / R;
  const int rr = static_cast<int>(r - blk * R);
  const int q = rr / kTileRows;
  const int s = (rr % kTileRows) / kLane;
  const int l = rr % kLane;
  const int64_t G = static_cast<int64_t>(W) * qn;
  const int64_t base = (static_cast<int64_t>(lo[blk]) - kSub) * kLane +
                       static_cast<int64_t>(s) * kLane;
  double acc = 0.0;
  for (int w = 0; w < W; ++w) {
    const int64_t tile = blk * G + static_cast<int64_t>(w) * qn + q;
    const int64_t e = (tile * kSub + s) * kLane + l;
    const int32_t lc = lcols[e];
    const int32_t hi = lc >> 7;
    const int32_t t0 = c0[tile];
    if (hi >= t0 && hi < t0 + scnt[tile]) {
      acc += static_cast<double>(vals[e]) * static_cast<double>(x[base + lc]);
    }
  }
  y[r] = static_cast<V>(acc);
}

template <typename V>
int launch(const int32_t* lo, const int32_t* c0, const int32_t* scnt,
           const int32_t* lcols, const V* vals, const V* x, V* y, int64_t n,
           int W, int qn, void* stream) {
  if (n <= 0 || W <= 0 || qn <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  diag_spmv_kernel<V><<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      lo, c0, scnt, lcols, vals, x, y, n, W, qn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int afem_diag_spmv_f32(const int32_t* lo, const int32_t* c0,
                       const int32_t* scnt, const int32_t* lcols,
                       const float* vals, const float* x, float* y, int64_t n,
                       int W, int qn, void* stream) {
  return launch<float>(lo, c0, scnt, lcols, vals, x, y, n, W, qn, stream);
}

int afem_diag_spmv_f64(const int32_t* lo, const int32_t* c0,
                       const int32_t* scnt, const int32_t* lcols,
                       const double* vals, const double* x, double* y,
                       int64_t n, int W, int qn, void* stream) {
  return launch<double>(lo, c0, scnt, lcols, vals, x, y, n, W, qn, stream);
}

}  // extern "C"
