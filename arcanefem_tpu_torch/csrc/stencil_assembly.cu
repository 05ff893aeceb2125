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
// computes whole planes.  Here a hex outside the box is written as zeros.
//
// What bounds it.  Bytes: 12 B of coordinates (+ 4 B mask + 4 B pg) in, 60 B
// of bands (+ 4 B rhs) out per node: 84 B per node with rhs and BC, 0.96 GB
// at 225^3 nodes, 0.286 ms at 3.35 TB/s.  The operations, counted once per
// tet, are about 110 flops here (cofactor vectors from shared edges and
// cross products, the 10 entries of the symmetric element matrix) and 220
// in _plane_kernel's form (cofactors of the absolute coordinates, 16
// entries): 7.4-14.8 GFLOP for the 67.4M tets at 224^3, 0.11-0.22 ms at
// 67 TFLOP/s f32, under the byte floor if each tet is computed once.
//
// Design.  The node-centric kernel this replaces ran one thread per node,
// which recomputed every tet it is a vertex of: each tet 4 times, ~43 G
// operations at 224^3, issue-bound at 1.86 ms.  Here each tet is computed
// once, and nothing is summed with atomics:
//   * a block of kThreads = 320 threads (10 warps) owns a tile of 8 x 32
//     output nodes in the (y, z) plane, z fastest (a warp's band stores are
//     128-byte lines), and marches along x through a slab of kSlab = 16
//     node planes;
//   * the tile's coordinates with a one-node halo (10 x 34 nodes, AoS as in
//     device memory: a tile row is 102 contiguous values) are copied into a
//     ring of three shared-memory planes with cp.async, one warp per tile
//     row, the plane after next in flight while the current hex plane is
//     computed;
//   * phase A, one thread per hex inside the box of the hex plane between
//     node planes p and p+1 (the tile's hexes and their halo, at most
//     9 x 33 = 297): the hex's 6 tets, which all run (0, a, b, 6), share the
//     edge vectors e_c = P_c - P_0 and the cross products e_c x e_6; each
//     tet adds its 6 off-diagonal entries and its vol/4 into the hex's table
//     of kHexSlots = 27 values in registers (19 edge values: 12 cube edges,
//     6 face diagonals and the body diagonal; 8 corner sums of vol/4), which
//     goes to a ring of three hex-plane tables in shared memory, slot-major.
//     No diagonal entry is stored: a P1 row sums to zero;
//   * phase B, one thread per node of plane p-1: it sums its 14 off-diagonal
//     bands and its rhs from the tables of the <= 8 hexes it is a corner of
//     (hex planes p-2 and p-1), always in the same order, takes the diagonal
//     as minus the sum of the other 14, applies the BC and stores.
// With three tables and three coordinate planes in the rings, iteration p
// runs phase A of hex plane p and phase B of node plane p-1 behind one
// barrier.  Each hex plane is computed once per slab: 17 hex planes for 16
// node planes, and the tile's halo hexes (297 for 256 nodes) are computed
// again by the neighbouring tile.  Shared memory (sizeof(Smem<T>)): 3 x 27 x
// 297 values of tables and 3 x 1020 of coordinates, 108,468 B in f32 (two
// blocks per SM), 216,936 B in f64 (one).  Where each value goes is the
// tables below, which arcanefem_tpu_torch/mesh/stencil_assembly.py defines
// and renders (kernel_tables(); its assemble_by_hex_table runs the same two
// phases on the CPU).  The result is the same bits on every run.
//
// Arithmetic per tet, as _plane_kernel up to rounding: with g1 = e_b x e_6,
// g2 = e_6 x e_a, g3 = e_a x e_b, g0 = -(g1 + g2 + g3) (the cofactor
// vectors, |6V| times the gradients) and |6V| = |e_a . g1|, entry (q, r) is
// vol / |6V|^2 * (g_q . g_r), with 1/|6V| taken as 0 when |6V| <= 1e-30
// (pallas_stencil.py:128-129).
//
// Output layout, by (off, nyo, nzo, s_plane, s_band): the real node
// (i, jr, kr) lands at band d, plane i, row jr + off, column kr + off;
// every other (pad) entry of the nyo x nzo plane is written as 0.
//   plane layout (sparse/dia_stencil.py): off 1, bands (nx+1, 15, nyo, nzo)
//   DiaMatrix layout: off 0, nyo = ny+1, nzo = nz+1, bands (15, nx+1, ny+1, nz+1)
// rhs, mask and pg are (nx+1, nyo, nzo) planes.
//
// The kernel allocates nothing, launches on the caller's stream and never
// synchronises; each C entry point returns the launch's CUDA error.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 15;
constexpr int kDiagBand = 7;  // the band of offset (0, 0, 0)
constexpr int kTY = 8, kTZ = 32;  // output nodes of a tile, y by z
constexpr int kNodes = kTY * kTZ;
constexpr int kHZ = kTZ + 1;  // hexes of the tile in one hex plane: 9 x 33
constexpr int kHexes = (kTY + 1) * kHZ;
constexpr int kThreads = 320;  // >= kHexes: a hex plane in one round
constexpr int kSlab = 16;  // node planes a block marches through
constexpr int kCZ = kTZ + 2;  // nodes of the tile in one plane: 10 x 34
constexpr int kPlaneVals = (kTY + 2) * kCZ * 3;

// BEGIN hex tables: arcanefem_tpu_torch/mesh/stencil_assembly.py::kernel_tables()
constexpr int kHexSlots = 27;
constexpr int kVolSlot0 = 19;
__host__ __device__ __forceinline__ constexpr int tet_corner(int t, int q) {
  constexpr int kTet[6][4] = {{0, 1, 2, 6}, {0, 2, 3, 6}, {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6}, {0, 5, 1, 6}};
  return kTet[t][q];
}
__host__ __device__ __forceinline__ constexpr int tet_edge(int t, int k) {
  constexpr int kEdge[6][6] = {{0, 1, 5, 7, 9, 11}, {1, 2, 5, 10, 11, 12}, {2, 6, 5, 13, 12, 18}, {6, 3, 5, 16, 18, 15}, {3, 4, 5, 14, 15, 17}, {4, 0, 5, 8, 17, 9}};
  return kEdge[t][k];
}
__host__ __device__ __forceinline__ constexpr int corner_slot(int h, int e) {
  constexpr int kSlot[8][7] = {{0, 1, 2, 3, 4, 5, 6}, {0, 7, 8, 9, -1, -1, -1}, {1, 7, 10, 11, -1, -1, -1}, {2, 10, 12, 13, -1, -1, -1}, {3, 14, 15, 16, -1, -1, -1}, {4, 8, 14, 17, -1, -1, -1}, {5, 9, 11, 12, 15, 17, 18}, {6, 13, 16, 18, -1, -1, -1}};
  return kSlot[h][e];
}
__host__ __device__ __forceinline__ constexpr int corner_band(int h, int e) {
  constexpr int kBand[8][7] = {{11, 13, 9, 8, 12, 14, 10}, {3, 9, 8, 10, -1, -1, -1}, {1, 5, 3, 8, -1, -1, -1}, {5, 11, 12, 8, -1, -1, -1}, {6, 11, 13, 9, -1, -1, -1}, {2, 6, 3, 9, -1, -1, -1}, {0, 4, 6, 2, 1, 5, 3}, {4, 6, 5, 11, -1, -1, -1}};
  return kBand[h][e];
}
// END hex tables

// grid deltas of hex corners 0..7 (mesh/structured.py _HEX_CORNERS)
__device__ __forceinline__ int hex_dx(int c) { return (c == 1 || c == 2 || c == 5 || c == 6) ? 1 : 0; }
__device__ __forceinline__ int hex_dy(int c) { return (c == 2 || c == 3 || c == 6 || c == 7) ? 1 : 0; }
__device__ __forceinline__ int hex_dz(int c) { return c >= 4 ? 1 : 0; }

template <typename T>
struct Smem {
  T coords[3][kPlaneVals];        // ring of node planes, (x, y, z) per node
  T table[3][kHexSlots][kHexes];  // ring of hex-plane tables, slot-major
};

template <typename T>
struct Occupancy {  // blocks per SM the shared memory allows
  static constexpr int kBlocks = sizeof(T) == 4 ? 2 : 1;
};

// 1/x for 1e-30 < x: the hardware reciprocal and one Newton step in f32
// (within an ulp, without the correctly rounded division's slow path);
// correctly rounded in f64
__device__ __forceinline__ float rcp(float x) {
  const float r = __fdividef(1.0f, x);
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}
__device__ __forceinline__ double rcp(double x) { return __drcp_rn(x); }

// every tet is (0, a, b, 6) and tet t's b is tet t + 1's a: the ring of
// corners 1, 2, 3, 7, 4, 5 around the body diagonal 0-6
__host__ __device__ constexpr bool kuhn_ring() {
  for (int t = 0; t < 6; ++t) {
    if (tet_corner(t, 0) != 0 || tet_corner(t, 3) != 6 ||
        tet_corner(t, 2) != tet_corner((t + 1) % 6, 1)) {
      return false;
    }
  }
  return true;
}
static_assert(kuhn_ring(), "the hex tables are not the Kuhn split's");

template <typename T>
__device__ __forceinline__ void cross(const T* u, const T* v, T* w) {
  w[0] = u[1] * v[2] - u[2] * v[1];
  w[1] = u[2] * v[0] - u[0] * v[2];
  w[2] = u[0] * v[1] - u[1] * v[0];
}

template <typename T>
__device__ __forceinline__ T dot(const T* u, const T* v) {
  return u[0] * v[0] + u[1] * v[1] + u[2] * v[2];
}

// The table of the hex whose origin is node (hy, hz) of the coordinate
// tile, between planes c0 and c1: its 6 tets, each computed once.  Every
// tet is (0, a, b, 6); with e_c = P_c - P_0 and w_c = e_c x e_6 its
// cofactor vectors are g1 = w_b, g2 = -w_a, g3 = e_a x e_b, g0 = -(g1 +
// g2 + g3), and |6V| = |e_a . w_b|.  Entry (q, r) = (g_q . g_r) / (6 |6V|);
// the rows' zero sums give the entries of vertex 0 from the other six dot
// products, and w_c . w_c serves the two tets around edge 0-c.  A corner's
// sum of vol/4 = |6V| / 24 runs over the tets it is a vertex of: all six
// for corners 0 and 6, tets t - 1 and t for tet t's a.
template <typename T>
__device__ __forceinline__ void hex_table(const T* __restrict__ c0,
                                          const T* __restrict__ c1, int hy,
                                          int hz, T* out) {
  T e[8][3];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const T* p = (hex_dx(c) ? c1 : c0) + ((hy + hex_dy(c)) * kCZ + hz + hex_dz(c)) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) e[c][k] = p[k];
  }
#pragma unroll
  for (int c = 7; c >= 1; --c) {
#pragma unroll
    for (int k = 0; k < 3; ++k) e[c][k] -= e[0][k];
  }
  T w[8][3], ww[8];
#pragma unroll
  for (int c = 1; c < 8; ++c) {
    if (c != 6) {
      cross(e[c], e[6], w[c]);
      ww[c] = dot(w[c], w[c]);
    }
  }
#pragma unroll
  for (int s = 0; s < kVolSlot0; ++s) out[s] = static_cast<T>(0);
  T av6[6];
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    const int a = tet_corner(t, 1), b = tet_corner(t, 2);
    T g3[3];
    cross(e[a], e[b], g3);
    const T d12 = -dot(w[b], w[a]), d13 = dot(w[b], g3), d23 = -dot(w[a], g3);
    const T d11 = ww[b], d22 = ww[a], d33 = dot(g3, g3);
    const T k[6] = {-(d11 + d12 + d13), -(d12 + d22 + d23), -(d13 + d23 + d33),
                    d12, d13, d23};
    av6[t] = fabs(dot(e[a], w[b]));
    const T ok = av6[t] > static_cast<T>(1e-30) ? static_cast<T>(1) : static_cast<T>(0);
    const T scale = rcp(fmax(av6[t], static_cast<T>(1e-30))) *  // no branch
                    (ok * (static_cast<T>(1) / static_cast<T>(6)));
#pragma unroll
    for (int q = 0; q < 6; ++q) out[tet_edge(t, q)] += scale * k[q];
  }
  constexpr T k24 = static_cast<T>(1) / static_cast<T>(24);
  out[kVolSlot0] = out[kVolSlot0 + 6] =
      (((av6[0] + av6[1]) + (av6[2] + av6[3])) + (av6[4] + av6[5])) * k24;
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    out[kVolSlot0 + tet_corner(t, 1)] = (av6[(t + 5) % 6] + av6[t]) * k24;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, Occupancy<T>::kBlocks)
stencil_assembly_kernel(const T* __restrict__ coords, const T* __restrict__ mask,
                        const T* __restrict__ pg, T* __restrict__ bands,
                        T* __restrict__ rhs, int nx, int ny, int nz, int nyo,
                        int nzo, int off, int64_t s_plane, int64_t s_band,
                        T penalty, T f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
  const int tid = threadIdx.x;
  // the real node of the tile's first row and column; the coordinate tile
  // and the hex tile start one node before it
  const int j0 = blockIdx.y * kTY - off, k0 = blockIdx.x * kTZ - off;
  const int i_begin = blockIdx.z * kSlab;
  const int i_end = min(i_begin + kSlab, nx + 1);

  // the coordinate copy: warp r copies row r of the tile, lane l its
  // values u = l + 32 k of the nodes inside the box (u in [u_lo, u_hi));
  // the others are read by no hex inside the box and are left unwritten.
  // Addresses and the four copies' predicates are formed once.
  static_assert(kThreads / 32 == kTY + 2, "one warp per coordinate row");
  constexpr int kRowVals = kCZ * 3;
  const int crow = tid / 32, clane = tid % 32;
  const int jj = j0 - 1 + crow;
  const int u_lo = max(0, 3 * (1 - k0)), u_hi = min(kRowVals, 3 * (nz + 2 - k0));
  unsigned copies = 0;  // bit k: copy value clane + 32 k
#pragma unroll
  for (int k = 0; k < (kRowVals + 31) / 32; ++k) {
    const int u = clane + 32 * k;
    if (jj >= 0 && jj <= ny && u < kRowVals && u >= u_lo && u < u_hi) copies |= 1u << k;
  }
  const T* src_row = coords + (static_cast<int64_t>(jj) * (nz + 1) + k0 - 1) * 3 + clane;
  const int64_t plane_src = static_cast<int64_t>(ny + 1) * (nz + 1) * 3;
  T* const dst_row = &sm.coords[0][0] + crow * kRowVals + clane;
  auto load_plane = [&](int p, int slot) {  // node plane p into ring slot `slot`
    if (p < 0 || p > nx) return;
    const T* src = src_row + p * plane_src;
    T* dst = dst_row + slot * kPlaneVals;
#pragma unroll
    for (int k = 0; k < (kRowVals + 31) / 32; ++k) {
      if (copies & (1u << k)) __pipeline_memcpy_async(dst + 32 * k, src + 32 * k, sizeof(T));
    }
    __pipeline_commit();
  };

  // phase A's hex: the tile's hexes inside the box, (ny_h, nz_h) of them
  // from (hy0, hz0), one per thread; the others stay 0 in the tables
  const int hy0 = max(0, 1 - j0), hz0 = max(0, 1 - k0);
  const int ny_h = max(0, min(kTY + 1, ny + 1 - j0) - hy0);
  const int nz_h = max(0, min(kHZ, nz + 1 - k0) - hz0);
  const bool hexer = tid < ny_h * nz_h;
  const int hy = hexer ? hy0 + tid / nz_h : 0, hz = hexer ? hz0 + tid % nz_h : 0;

  // phase B's node: output row jo, column ko; real node (j0 + ty, k0 + tz)
  const int ty = tid / kTZ, tz = tid % kTZ;
  const int jo = blockIdx.y * kTY + ty, ko = blockIdx.x * kTZ + tz;
  const bool writes = tid < kNodes && jo < nyo && ko < nzo;
  const bool real = writes && j0 + ty >= 0 && j0 + ty <= ny && k0 + tz >= 0 &&
                    k0 + tz <= nz;

  for (int v = tid; v < 3 * kHexSlots * kHexes; v += kThreads) {
    (&sm.table[0][0][0])[v] = static_cast<T>(0);
  }
  // Iteration p computes hex plane p (phase A) and node plane p - 1
  // (phase B, from hex planes p - 2 and p - 1), so one barrier per plane
  // separates every write from its reads: a table slot is rewritten two
  // iterations after the last phase B that read it, a coordinate slot one
  // iteration after the hex plane that read it.  Plane q's slot in both
  // rings is (q + 3) % 3; sp is plane p's.  A hex plane outside the box is
  // a table of zeros.
  int sp = (i_begin + 2) % 3;
  load_plane(i_begin - 1, sp);
  load_plane(i_begin, (sp + 1) % 3);
  for (int p = i_begin - 1; p <= i_end; ++p, sp = (sp + 1) % 3) {
    const int i = p - 1;  // phase B's node plane
    const bool node_plane = i >= i_begin && i < i_end;
    const int64_t pv = (static_cast<int64_t>(i) * nyo + jo) * nzo + ko;
    T m = static_cast<T>(0), pgv = static_cast<T>(0);
    if (mask != nullptr && real && node_plane) {  // in flight through phase A
      m = mask[pv];
      pgv = pg[pv];
    }
    __pipeline_wait_prior(0);  // this thread's copies of planes p, p + 1
    __syncthreads();           // ... and every thread's; phase A of p - 1 done
    load_plane(p + 2, (sp + 2) % 3);  // into the slot hex plane p - 1 read
    if (hexer && p < i_end) {  // phase A
      T out[kHexSlots];
      if (p >= 0 && p < nx) {
        hex_table(sm.coords[sp], sm.coords[(sp + 1) % 3], hy, hz, out);
      } else {
#pragma unroll
        for (int s = 0; s < kHexSlots; ++s) out[s] = static_cast<T>(0);
      }
      T(*tab)[kHexes] = sm.table[sp];
      const int h = hy * kHZ + hz;
#pragma unroll
      for (int s = 0; s < kHexSlots; ++s) tab[s][h] = out[s];
    }
    if (!node_plane || !writes) continue;
    // phase B: this thread's node of plane i from hex planes i - 1 and i
    // (a plane outside the box adds nothing)
    T* out = bands + i * s_plane + static_cast<int64_t>(jo) * nzo + ko;
    if (!real) {
#pragma unroll
      for (int d = 0; d < kD; ++d) out[d * s_band] = static_cast<T>(0);
      if (rhs != nullptr) rhs[pv] = static_cast<T>(0);
      continue;
    }
    T acc[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[d] = static_cast<T>(0);
    T vsum = static_cast<T>(0);
#pragma unroll
    for (int h = 0; h < 8; ++h) {  // this node is corner h of the hex at node - delta(h)
      const T(*tab)[kHexes] = sm.table[(sp + 2 - hex_dx(h)) % 3];  // hex plane i - dx
      const int hh = (ty + 1 - hex_dy(h)) * kHZ + tz + 1 - hex_dz(h);
#pragma unroll
      for (int e = 0; e < 7; ++e) {
        if (corner_slot(h, e) >= 0) acc[corner_band(h, e)] += tab[corner_slot(h, e)][hh];
      }
      vsum += tab[kVolSlot0 + h][hh];
    }
#pragma unroll
    for (int d = 0; d < kD; ++d) {  // a P1 row sums to zero
      if (d != kDiagBand) acc[kDiagBand] -= acc[d];
    }
    if (mask != nullptr) {
      const T free = static_cast<T>(1) - m;
      acc[kDiagBand] = acc[kDiagBand] * free + penalty * m;
      vsum = vsum * (f * free) + pgv;
    }
#pragma unroll
    for (int d = 0; d < kD; ++d) out[d * s_band] = acc[d];
    if (rhs != nullptr) rhs[pv] = vsum;
  }
}

template <typename T>
int launch(const void* coords, const void* mask, const void* pg, void* bands,
           void* rhs, int nx, int ny, int nz, int nyo, int nzo, int off,
           int64_t s_plane, int64_t s_band, double penalty, double f,
           void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0 || off < 0 || nyo < ny + 1 + off ||
      nzo < nz + 1 + off || (mask != nullptr && (pg == nullptr || rhs == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((nzo + kTZ - 1) / kTZ, (nyo + kTY - 1) / kTY, nx / kSlab + 1);
  if (grid.y > 65535 || grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(sizeof(Smem<T>));
  const cudaError_t rc = cudaFuncSetAttribute(
      stencil_assembly_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  stencil_assembly_kernel<T><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
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
