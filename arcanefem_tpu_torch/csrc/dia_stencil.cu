// 15-offset DIA stencil kernel of the structured Kuhn box for Hopper
// (sm_90a), bound through a plain C interface and loaded with ctypes
// (arcanefem_tpu_torch/utils/kernels.py).  One kernel, three modes:
//
//   spmv      y = A x
//   jacobi    y = x + omega * aux * (b - A x)        (aux = inverse diagonal)
//   residual  y = (b - A x) * aux                    (aux = mask multiplier,
//                                                     or 1 when aux is null)
//
// What it replaces.  The Pallas plane kernels of
// arcanefem_tpu/sparse/dia_pallas.py: _spmv_p (pallas_call :317), _jacobi_p
// (:341) and _residual_p (:366) on the x-major band layout of the padded
// multigrid path, and _spmv (:98) and _sweep (:151) on the band-major
// layout of DiaStencilMatrix.  The TPU kernels stream one x-plane per grid
// step with a 3-plane window of x in VMEM and shift it with lane/sublane
// rolls.  Here a plane is just an address: the band layout comes in as two
// strides (between x-planes and between bands), so one kernel serves
//   x-major    bands (nx+1, 15, ny', nz'): s_plane = 15 ny' nz', s_band = ny' nz'
//   band-major bands (15, nx+1, ny', nz'): s_plane = ny' nz', s_band = (nx+1) ny' nz'
// and vectors are (nx+1, ny', nz') planes with the real nodes at
// [:, 1:ny+2, 1:nz+2] and zeros elsewhere (sparse/dia_stencil.py).
//
// What bounds it.  Bytes: 15 band values per node (60 B in f32, 30 B in
// bf16) plus x, y and, for jacobi and residual, b and aux, against 30 flops
// per node.  x is read about once: a thread reads the 3x3 (y, z)
// neighbourhood of three x-planes, and three planes of x (<= 0.24 MB at
// 224^3) stay in L2.  At 225^3 nodes an f32 SpMV moves 68 B per node,
// 0.78 GB, about 0.23 ms at the H100's 3.35 TB/s.
//
// Design: one thread per node of the padded plane, z fastest, so a warp's
// band, x and y accesses are contiguous.  Pads are written as exact zeros:
// CG's dot products run over the padded arrays.  A neighbour outside the
// real box (the x boundary, the y/z pads) is skipped, not read: no value
// the kernel did not need is ever multiplied by a zero band, so a NaN left
// in a pad cannot leak in.  bf16 bands are promoted per band and the sum
// runs in the vectors' type: f32 as on the TPU, or f64 vectors over f32
// bands for the solver's residual replacement (sparse/dia_stencil.py).
//
// The kernel allocates nothing, launches on the caller's stream and never
// synchronises; each C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 15;
constexpr int kThreads = 128;
constexpr int kSpmv = 0, kJacobi = 1, kResidual = 2;

// (dx, dy, dz) of band d, in the order of StructuredBox.offsets (lexical
// in (dx, dy, dz)): bands 0-7 are {-1,0}^3, bands 7-14 are {0,1}^3.
__device__ __forceinline__ void band_delta(int d, int& dx, int& dy, int& dz) {
  const int e = d <= 7 ? d : d - 7;
  const int s = d <= 7 ? -1 : 0;
  dx = (e >> 2) + s;
  dy = ((e >> 1) & 1) + s;
  dz = (e & 1) + s;
}

// a band value in the vectors' type (bf16 through the intrinsic)
template <typename V, typename B>
__device__ __forceinline__ V promote(B v) {
  return static_cast<V>(v);
}

template <>
__device__ __forceinline__ float promote<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int kMode, typename B, typename V>
__global__ void __launch_bounds__(kThreads)
dia_stencil_kernel(const B* __restrict__ bands, int64_t s_plane,
                   int64_t s_band, const V* __restrict__ x,
                   const V* __restrict__ b, const V* __restrict__ aux,
                   V* __restrict__ y, int nx1, int nyp, int nzp, int ny1,
                   int nz1, V omega) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int j = blockIdx.y;
  const int i = blockIdx.z;
  if (k >= nzp) return;
  const int64_t plane = static_cast<int64_t>(nyp) * nzp;
  const int64_t v = i * plane + static_cast<int64_t>(j) * nzp + k;
  if (j < 1 || j > ny1 || k < 1 || k > nz1) {
    y[v] = static_cast<V>(0);
    return;
  }
  const B* bp = bands + i * s_plane + static_cast<int64_t>(j) * nzp + k;
  V acc = static_cast<V>(0);
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    int dx, dy, dz;
    band_delta(d, dx, dy, dz);
    const int ii = i + dx, jj = j + dy, kk = k + dz;
    if (ii < 0 || ii >= nx1 || jj < 1 || jj > ny1 || kk < 1 || kk > nz1) continue;
    acc += promote<V>(bp[d * s_band]) * x[v + dx * plane + dy * nzp + dz];
  }
  if (kMode == kSpmv) {
    y[v] = acc;
  } else if (kMode == kJacobi) {
    y[v] = x[v] + omega * aux[v] * (b[v] - acc);
  } else {
    const V r = b[v] - acc;
    y[v] = aux != nullptr ? r * aux[v] : r;
  }
}

template <typename B, typename V>
int launch(int mode, const void* bands, int64_t s_plane, int64_t s_band,
           const void* x, const void* b, const void* aux, void* y, int nx1,
           int nyp, int nzp, int ny1, int nz1, double omega, void* stream) {
  if (nx1 <= 0 || nyp < ny1 + 2 || nzp < nz1 + 2 || nyp > 65535 || nx1 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((mode == kJacobi && (b == nullptr || aux == nullptr)) ||
      (mode == kResidual && b == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((nzp + kThreads - 1) / kThreads, nyp, nx1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const B* bb = static_cast<const B*>(bands);
  const V *xx = static_cast<const V*>(x), *b2 = static_cast<const V*>(b),
          *ax = static_cast<const V*>(aux);
  V* yy = static_cast<V*>(y);
  const V om = static_cast<V>(omega);
  switch (mode) {
    case kSpmv:
      dia_stencil_kernel<kSpmv, B, V><<<grid, kThreads, 0, s>>>(
          bb, s_plane, s_band, xx, b2, ax, yy, nx1, nyp, nzp, ny1, nz1, om);
      break;
    case kJacobi:
      dia_stencil_kernel<kJacobi, B, V><<<grid, kThreads, 0, s>>>(
          bb, s_plane, s_band, xx, b2, ax, yy, nx1, nyp, nzp, ny1, nz1, om);
      break;
    case kResidual:
      dia_stencil_kernel<kResidual, B, V><<<grid, kThreads, 0, s>>>(
          bb, s_plane, s_band, xx, b2, ax, yy, nx1, nyp, nzp, ny1, nz1, om);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// afem_dia_stencil_<bands>_<vectors>
#define AFEM_DIA_STENCIL(NAME, B, V)                                           \
  extern "C" int NAME(int mode, const void* bands, int64_t s_plane,            \
                      int64_t s_band, const void* x, const void* b,            \
                      const void* aux, void* y, int nx1, int nyp, int nzp,     \
                      int ny1, int nz1, double omega, void* stream) {          \
    return launch<B, V>(mode, bands, s_plane, s_band, x, b, aux, y, nx1, nyp,  \
                        nzp, ny1, nz1, omega, stream);                         \
  }

AFEM_DIA_STENCIL(afem_dia_stencil_f32_f32, float, float)
AFEM_DIA_STENCIL(afem_dia_stencil_bf16_f32, __nv_bfloat16, float)
AFEM_DIA_STENCIL(afem_dia_stencil_f32_f64, float, double)
AFEM_DIA_STENCIL(afem_dia_stencil_f64_f64, double, double)
