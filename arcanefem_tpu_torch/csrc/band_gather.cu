// Banded tile gather for Hopper (sm_90a), bound through a plain C interface
// and loaded with ctypes (arcanefem_tpu_torch/utils/kernels.py).
//
//   afem_band_gather_{f32,f64}:
//     out[b, t*128 + l] = T[b, bases[t]*128 + lcols[t, l]]
//                         if 0 <= lcols[t, l] < K*128 and the index < n_t,
//                         else 0
//
// for tiles t < n_tiles, lanes l < 128 and tables b < B (B <= 8).
//
// What it replaces.  B = 1 is the narrow-tile band gather
// arcanefem_tpu/sparse/band_gather.py::_band_products_unit (K9a,
// pallas_call at :87); B > 1 is its batched form _band_products_b_unit
// (K9b, :142), one plan over a stack of tables.  The TPU kernel DMAs a
// K-row band of the table (K*128 consecutive values) into VMEM per tile and
// resolves each tile-local index with a K-step lane-select sweep, because
// the TPU has no fast general gather.  Here each index is one load: the
// band is 8 KB of consecutive table memory (K = 16), so the loads of a tile
// are served by L1/L2 and no staging in shared memory is needed.  Indices
// outside [0, K*128) are the plan's pads (the _UNIT_PAD sentinel) and give
// an exact 0; so does an index past the table's end, which the TPU reads
// from the zero padding of its table.
//
// What bounds it.  Bytes: a 4-byte index per request, one 4- or 8-byte
// output per request and table, the table read once (its bands overlap and
// stay in L2); at B = 3 over the (N, 3) f32 coordinates, 16 bytes per
// request and 12 per node.  No arithmetic.
//
// Design: one thread per request (tile, lane), 256 threads per block (two
// tiles), serving all B tables.  The first form put the table on the
// grid's y axis, so each of the B passes re-read the requests' lcols and
// tile bases and fetched every coordinate sector again at a 12-byte
// stride: 3.8x the bound.  Now a thread reads lcols[i] and its tile base
// once, loads the B values of its node together (12 contiguous bytes for
// the (N, 3) coordinates, whose table stride is 1) into registers, and
// then writes them, each table's outputs coalesced across the warp.  B is
// a template parameter, so both loops unroll without a per-table test.
// Tables and outputs come with a row stride and a table stride, so the
// (N, 3) coordinates are read in place as three strided tables.
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
                   const V* __restrict__ t, V* __restrict__ out,
                   int64_t n_tiles, int K, int64_t n_t, int64_t ts_r,
                   int64_t ts_b, int64_t os_r, int64_t os_b) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_tiles * kLane) return;
  const int32_t lc = lcols[i];
  V v[B];
#pragma unroll
  for (int b = 0; b < B; ++b) v[b] = V(0);
  if (lc >= 0 && lc < K * kLane) {
    const int64_t src = static_cast<int64_t>(bases[i / kLane]) * kLane + lc;
    if (src < n_t) {
      const V* tp = t + src * ts_r;
#pragma unroll
      for (int b = 0; b < B; ++b) v[b] = tp[b * ts_b];
    }
  }
  V* op = out + i * os_r;
#pragma unroll
  for (int b = 0; b < B; ++b) op[b * os_b] = v[b];
}

template <typename V>
int launch(const int32_t* bases, const int32_t* lcols, const V* t, V* out,
           int64_t n_tiles, int K, int B, int64_t n_t, int64_t ts_r,
           int64_t ts_b, int64_t os_r, int64_t os_b, void* stream) {
  if (n_tiles <= 0 || K <= 0 || B <= 0 || B > kMaxTables) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_tiles * kLane + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AFEM_BAND(BB)                                                    \
  band_gather_kernel<V, BB><<<grid, kThreads, 0, s>>>(                  \
      bases, lcols, t, out, n_tiles, K, n_t, ts_r, ts_b, os_r, os_b)
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
                         const float* t, float* out, int64_t n_tiles, int K,
                         int B, int64_t n_t, int64_t ts_r, int64_t ts_b,
                         int64_t os_r, int64_t os_b, void* stream) {
  return launch<float>(bases, lcols, t, out, n_tiles, K, B, n_t, ts_r, ts_b,
                       os_r, os_b, stream);
}

int afem_band_gather_f64(const int32_t* bases, const int32_t* lcols,
                         const double* t, double* out, int64_t n_tiles, int K,
                         int B, int64_t n_t, int64_t ts_r, int64_t ts_b,
                         int64_t os_r, int64_t os_b, void* stream) {
  return launch<double>(bases, lcols, t, out, n_tiles, K, B, n_t, ts_r, ts_b,
                        os_r, os_b, stream);
}

}  // extern "C"
