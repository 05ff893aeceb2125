// P1 stiffness assembly of the structured Kuhn box into its 15 DIA bands,
// for Hopper (sm_90a), bound through a plain C interface and loaded with
// ctypes (arcanefem_tpu_torch/utils/kernels.py).
//
//   afem_stencil_assembly_{f32,f64}: coordinates (nx+1, ny+1, nz+1, 3) ->
//     bands, optionally rhs = sum vol/4 per node, optionally penalty
//     Dirichlet (diag := penalty on masked rows, rhs := f * free * sum vol/4
//     + pg, with pg = penalty * g * mask given as a plane).
//
// What it replaces.  arcanefem_tpu/mesh/pallas_stencil.py::_run (pallas_call
// :215, body _plane_kernel :32-164): per output x-plane, three coordinate
// planes in VMEM, the 6 Kuhn tets of every hex computed on-chip and the
// 15 band planes of that node plane accumulated with rolls.  The TPU
// machinery (ghost x-planes, corner_shift's edge clamping, rolls into
// aligned tiles) exists to keep the pad hexes degenerate on a machine that
// computes whole planes.  Here each thread tests its bounds instead.
//
// Design: node-centric.  One thread per output node gathers the 27 nodes
// around it into registers, visits the <= 8 hexes it is a corner of and,
// in each, the tets that contain it (6 where it is hex corner 0 or 6, 2
// elsewhere: 24 in the interior), and adds its own row of each tet's
// element matrix into its 15 band registers.  Every band entry is written
// once, with no atomics, so the result is the same bits on every run.  The
// price is that each tet's geometry is recomputed by its 4 nodes.  The
// hex-centric alternative (one thread per hex, 96 atomicAdds, as in the
// reference's BSRFormat.h:842-932) would compute each tet once but scatter
// with atomics in a run-dependent order.
//
// Arithmetic per tet, as _plane_kernel: |6V| and the cofactor gradients
// (pallas_stencil.py:120-145); entry (a, b) = vol / |6V|^2 * (ga . gb) with
// 1/|6V| taken as 0 when |6V| <= 1e-30 (:128-129), added into band
// band(lin(b) - lin(a)) of row a.
//
// What bounds it.  Bytes: 12 B of coordinates (+ 4 B mask + 4 B pg) in, 60 B
// of bands (+ 4 B rhs) out per node: 84 B per node with rhs and BC, 0.96 GB
// at 225^3 nodes, 0.29 ms at 3.35 TB/s.  The operations, counted once per
// tet (about 220 flops: edges, |6V|, 12 cofactors, 16 entries), are 14.8
// GFLOP at 224^3, 0.22 ms at 67 TFLOP/s f32; this design evaluates each
// tet 4 times, so the kernel itself may be compute-bound.
//
// Output layout, by (off, nyo, nzo, s_plane, s_band): the real node
// (i, jr, kr) lands at band d, plane i, row jr + off, column kr + off;
// every other (pad) entry of the nyo x nzo plane is written as 0.
//   plane layout (sparse/dia_stencil.py): off 1, bands (nx+1, 15, nyo, nzo)
//   DiaMatrix layout: off 0, nyo = ny+1, nzo = nz+1, bands (15, nx+1, ny+1, nz+1)
// rhs, mask and pg are (nx+1, nyo, nzo) planes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 15;
constexpr int kThreads = 128;

// grid deltas of hex corners 0..7 (mesh/structured.py _HEX_CORNERS)
__device__ __forceinline__ int hex_dx(int c) { return (c == 1 || c == 2 || c == 5 || c == 6) ? 1 : 0; }
__device__ __forceinline__ int hex_dy(int c) { return (c == 2 || c == 3 || c == 6 || c == 7) ? 1 : 0; }
__device__ __forceinline__ int hex_dz(int c) { return c >= 4 ? 1 : 0; }

// band of the offset (dx, dy, dz): bands 0-7 are {-1,0}^3, 7-14 are {0,1}^3,
// lexical in (dx, dy, dz) (StructuredBox.offsets)
__device__ __forceinline__ int band_of(int dx, int dy, int dz) {
  return (dx <= 0 && dy <= 0 && dz <= 0)
             ? (dx + 1) * 4 + (dy + 1) * 2 + (dz + 1)
             : 7 + dx * 4 + dy * 2 + dz;
}

// the cofactor pattern of ops/geometry.py (one gradient component, times |6V|)
template <typename T>
__device__ __forceinline__ void cofactors(const T* u, const T* w, T* c) {
  c[0] = u[1] * (w[3] - w[2]) + u[2] * (w[1] - w[3]) + u[3] * (w[2] - w[1]);
  c[1] = u[0] * (w[2] - w[3]) + u[2] * (w[3] - w[0]) + u[3] * (w[0] - w[2]);
  c[2] = u[0] * (w[3] - w[1]) + u[1] * (w[0] - w[3]) + u[3] * (w[1] - w[0]);
  c[3] = u[0] * (w[1] - w[2]) + u[1] * (w[2] - w[0]) + u[2] * (w[0] - w[1]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_assembly_kernel(const T* __restrict__ coords, const T* __restrict__ mask,
                        const T* __restrict__ pg, T* __restrict__ bands,
                        T* __restrict__ rhs, int nx, int ny, int nz, int nyo,
                        int nzo, int off, int64_t s_plane, int64_t s_band,
                        T penalty, T f) {
  // the Kuhn 6-tet split of a hex (mesh/structured.py _TETS)
  constexpr int kTets[6][4] = {{0, 1, 2, 6}, {0, 2, 3, 6}, {0, 3, 7, 6},
                               {0, 7, 4, 6}, {0, 4, 5, 6}, {0, 5, 1, 6}};
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int j = blockIdx.y;
  const int i = blockIdx.z;
  if (k >= nzo) return;
  T* out = bands + i * s_plane + static_cast<int64_t>(j) * nzo + k;
  const int64_t pv = (static_cast<int64_t>(i) * nyo + j) * nzo + k;
  const int jr = j - off, kr = k - off;
  if (jr < 0 || jr > ny || kr < 0 || kr > nz) {
#pragma unroll
    for (int d = 0; d < kD; ++d) out[d * s_band] = static_cast<T>(0);
    if (rhs != nullptr) rhs[pv] = static_cast<T>(0);
    return;
  }

  // coordinates of the 3x3x3 nodes around this one (0 outside the box:
  // only hexes inside the box are visited, so they are never read)
  T cx[27], cy[27], cz[27];
#pragma unroll
  for (int n = 0; n < 27; ++n) {
    const int ii = i + n / 9 - 1, jj = jr + (n / 3) % 3 - 1, kk = kr + n % 3 - 1;
    if (ii >= 0 && ii <= nx && jj >= 0 && jj <= ny && kk >= 0 && kk <= nz) {
      const T* p = coords + ((static_cast<int64_t>(ii) * (ny + 1) + jj) * (nz + 1) + kk) * 3;
      cx[n] = p[0];
      cy[n] = p[1];
      cz[n] = p[2];
    } else {
      cx[n] = cy[n] = cz[n] = static_cast<T>(0);
    }
  }

  T acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = static_cast<T>(0);
  T vsum = static_cast<T>(0);

  // h: the corner of the hex that this node is; the hex's origin node is
  // this node minus h's delta
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    const int di = hex_dx(h), dj = hex_dy(h), dk = hex_dz(h);
    if (i - di < 0 || i - di >= nx || jr - dj < 0 || jr - dj >= ny ||
        kr - dk < 0 || kr - dk >= nz) {
      continue;
    }
#pragma unroll
    for (int t = 0; t < 6; ++t) {
      int a = -1;  // this node's place in tet t, if it is in it
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (kTets[t][q] == h) a = q;
      }
      if (a < 0) continue;
      T X[4], Y[4], Z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = kTets[t][q];
        const int n = (1 - di + hex_dx(c)) * 9 + (1 - dj + hex_dy(c)) * 3 + (1 - dk + hex_dz(c));
        X[q] = cx[n];
        Y[q] = cy[n];
        Z[q] = cz[n];
      }
      const T v0x = X[1] - X[0], v0y = Y[1] - Y[0], v0z = Z[1] - Z[0];
      const T v1x = X[2] - X[0], v1y = Y[2] - Y[0], v1z = Z[2] - Z[0];
      const T v2x = X[3] - X[0], v2y = Y[3] - Y[0], v2z = Z[3] - Z[0];
      const T cxx = v1y * v2z - v1z * v2y;
      const T cyy = v1z * v2x - v1x * v2z;
      const T czz = v1x * v2y - v1y * v2x;
      const T av6 = fabs(v0x * cxx + v0y * cyy + v0z * czz);
      const T inv = av6 > static_cast<T>(1e-30) ? static_cast<T>(1) / av6 : static_cast<T>(0);
      const T vol = av6 / static_cast<T>(6);
      T gx[4], gy[4], gz[4];
      cofactors(Y, Z, gx);
      cofactors(Z, X, gy);
      cofactors(X, Y, gz);
      const T scale = vol * inv * inv;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = kTets[t][q];
        const int d = band_of(hex_dx(c) - di, hex_dy(c) - dj, hex_dz(c) - dk);
        acc[d] += scale * (gx[a] * gx[q] + gy[a] * gy[q] + gz[a] * gz[q]);
      }
      vsum += vol * static_cast<T>(0.25);
    }
  }

  if (mask != nullptr) {
    const T m = mask[pv];
    const T free = static_cast<T>(1) - m;
    acc[7] = acc[7] * free + penalty * m;
    vsum = vsum * (f * free) + pg[pv];
  }
#pragma unroll
  for (int d = 0; d < kD; ++d) out[d * s_band] = acc[d];
  if (rhs != nullptr) rhs[pv] = vsum;
}

template <typename T>
int launch(const void* coords, const void* mask, const void* pg, void* bands,
           void* rhs, int nx, int ny, int nz, int nyo, int nzo, int off,
           int64_t s_plane, int64_t s_band, double penalty, double f,
           void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0 || off < 0 || nyo < ny + 1 + off ||
      nzo < nz + 1 + off || nyo > 65535 || nx + 1 > 65535 ||
      (mask != nullptr && (pg == nullptr || rhs == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((nzo + kThreads - 1) / kThreads, nyo, nx + 1);
  stencil_assembly_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(coords), static_cast<const T*>(mask),
      static_cast<const T*>(pg), static_cast<T*>(bands), static_cast<T*>(rhs),
      nx, ny, nz, nyo, nzo, off, s_plane, s_band, static_cast<T>(penalty),
      static_cast<T>(f));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define AFEM_STENCIL_ASSEMBLY(NAME, T)                                         \
  extern "C" int NAME(const void* coords, const void* mask, const void* pg,    \
                      void* bands, void* rhs, int nx, int ny, int nz, int nyo, \
                      int nzo, int off, int64_t s_plane, int64_t s_band,       \
                      double penalty, double f, void* stream) {                \
    return launch<T>(coords, mask, pg, bands, rhs, nx, ny, nz, nyo, nzo, off,  \
                     s_plane, s_band, penalty, f, stream);                     \
  }

AFEM_STENCIL_ASSEMBLY(afem_stencil_assembly_f32, float)
AFEM_STENCIL_ASSEMBLY(afem_stencil_assembly_f64, double)
