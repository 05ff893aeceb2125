// Banded tile gather for Hopper (sm_90a), bound through a plain C interface
// and loaded with ctypes (arcanefem_tpu_torch/utils/kernels.py).
//
//   afem_band_gather_{f32,f64}, over n_tiles output tiles of 128 requests:
//     narrow tile t < n_narrow:
//       out[b, t*128 + l] = T[b, bases[t]*128 + lcols[t, l]]
//                           if 0 <= lcols[t, l] < K*128, else 0
//     wide tile t >= n_narrow:
//       out[b, t*128 + l] = T[b, wide[(t - n_narrow)*128 + l]]
//                           if wide[...] >= 0, else 0
//   and 0 wherever the index lies past the table's end (>= n_t),
//
// for lanes l < 128 and tables b < B (B <= 8).
//
// What it replaces.  The whole banded pre-gather of
// arcanefem_tpu/sparse/band_gather.py::BandedGather in one launch: its
// narrow-tile kernels _band_products_unit (K9a, def :52, pallas_call :87;
// B = 1) and _band_products_b_unit (K9b, def :109, pallas_call :142; B > 1,
// one plan over a stack of tables), plus the wide tail the JAX class
// gathers with a unit window plan and concatenates after the narrow tiles
// (:283-292).  The TPU kernel DMAs a K-row band of the table (K*128
// consecutive values) into VMEM per tile and resolves each tile-local index
// with a K-step lane-select sweep, because the TPU has no fast general
// gather; there XLA fuses the concatenation into the jitted solve.  Here
// the [narrow; wide] order of the output (the one the plan's tile_perm
// bakes into the downstream remap) is one grid over all tiles, written in
// place: no second gather launch for the wide tail, no concatenation copy.
//
// What bounds it.  Bytes: a 4-byte index per request (lcols or wide), one
// 4- or 8-byte output per request and table, the table read once (its
// bands overlap and stay in L2): 8 bytes per request plus 4 per table row
// in f32 at B = 1; at B = 3 over the (N, 3) f32 coordinates, 16 bytes per
// request and 12 per node.  No arithmetic.
//
// Design: one thread per request (tile, lane), 256 threads per block.  A
// tile is 128 requests, four whole warps, so the narrow/wide branch is
// uniform across every warp and costs no divergence.  A narrow request is
// one load at its tile's base row plus its tile-local index; its band is
// 8 KB of consecutive table memory (K = 16), which L1/L2 serve, so no
// staging in shared memory is needed (the loss this kernel had was never
// its device body, at 0.79-0.86 of its byte bound, but its launches and
// the host work around them).  A wide request is a plain index, -1 for a
// pad.  A thread loads the B values of its node together (12 contiguous
// bytes for the (N, 3) coordinates, whose table stride is 1) into
// registers and then writes them, each table's outputs coalesced across
// the warp.  B is a template parameter, so both loops unroll without a
// per-table test.  Tables and outputs come with a row stride and a table
// stride, so the (N, 3) coordinates are read in place as three strided
// tables.
//
// The kernel allocates nothing, launches on the caller's stream and never
// synchronises; each C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLane = 128;
constexpr int kMaxTables = 8;

template <typename V, int B>
__global__ void __launch_bounds__(kThreads)
band_gather_kernel(const int32_t* __restrict__ bases,
                   const int32_t* __restrict__ lcols,
                   const int32_t* __restrict__ wide,
                   const V* __restrict__ t, V* __restrict__ out,
                   int64_t n_tiles, int64_t n_narrow, int K, int64_t n_t,
                   int64_t ts_r, int64_t ts_b, int64_t os_r, int64_t os_b) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_tiles * kLane) return;
  const int64_t tile = i / kLane;  // the same for all 32 lanes of a warp
  int64_t src = -1;
  if (tile < n_narrow) {
    const int32_t lc = lcols[i];
    if (lc >= 0 && lc < K * kLane) {
      src = static_cast<int64_t>(bases[tile]) * kLane + lc;
    }
  } else {
    src = wide[i - n_narrow * kLane];
  }
  V v[B];
#pragma unroll
  for (int b = 0; b < B; ++b) v[b] = V(0);
  if (src >= 0 && src < n_t) {
    const V* tp = t + src * ts_r;
#pragma unroll
    for (int b = 0; b < B; ++b) v[b] = tp[b * ts_b];
  }
  V* op = out + i * os_r;
#pragma unroll
  for (int b = 0; b < B; ++b) op[b * os_b] = v[b];
}

template <typename V>
int launch(const int32_t* bases, const int32_t* lcols, const int32_t* wide,
           const V* t, V* out, int64_t n_tiles, int64_t n_narrow, int K, int B,
           int64_t n_t, int64_t ts_r, int64_t ts_b, int64_t os_r, int64_t os_b,
           void* stream) {
  if (n_tiles <= 0 || n_narrow < 0 || n_narrow > n_tiles || K <= 0 || B <= 0 ||
      B > kMaxTables || (n_narrow < n_tiles && wide == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_tiles * kLane + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AFEM_BAND(BB)                                                    \
  band_gather_kernel<V, BB><<<grid, kThreads, 0, s>>>(                  \
      bases, lcols, wide, t, out, n_tiles, n_narrow, K, n_t, ts_r, ts_b, \
      os_r, os_b)
  switch (B) {
    case 1: AFEM_BAND(1); break;
    case 2: AFEM_BAND(2); break;
    case 3: AFEM_BAND(3); break;
    case 4: AFEM_BAND(4); break;
    case 5: AFEM_BAND(5); break;
    case 6: AFEM_BAND(6); break;
    case 7: AFEM_BAND(7); break;
    default: AFEM_BAND(8); break;
  }
#undef AFEM_BAND
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int afem_band_gather_f32(const int32_t* bases, const int32_t* lcols,
                         const int32_t* wide, const float* t, float* out,
                         int64_t n_tiles, int64_t n_narrow, int K, int B,
                         int64_t n_t, int64_t ts_r, int64_t ts_b, int64_t os_r,
                         int64_t os_b, void* stream) {
  return launch<float>(bases, lcols, wide, t, out, n_tiles, n_narrow, K, B,
                       n_t, ts_r, ts_b, os_r, os_b, stream);
}

int afem_band_gather_f64(const int32_t* bases, const int32_t* lcols,
                         const int32_t* wide, const double* t, double* out,
                         int64_t n_tiles, int64_t n_narrow, int K, int B,
                         int64_t n_t, int64_t ts_r, int64_t ts_b, int64_t os_r,
                         int64_t os_b, void* stream) {
  return launch<double>(bases, lcols, wide, t, out, n_tiles, n_narrow, K, B,
                        n_t, ts_r, ts_b, os_r, os_b, stream);
}

}  // extern "C"
