// P1 tetrahedron assembly for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (arcanefem_tpu_torch/utils/kernels.py).
//
//   afem_tet_element_f32:   ke[c, k] = the k-th upper-triangle entry (TRI10
//                           order: (0,0),(0,1),...,(3,3)) of cell c's
//                           stiffness matrix, from its four corners
//   afem_slot_reduce_{f32,f64}:
//                           out[s] = sum over k in [ptr[s], ptr[s+1]) of
//                                    table[ids[k]], in stored order
//   afem_block_slot_reduce_{f32,f64}:
//                           for each node slot s and e < b*b (b = 2, 3):
//                           out[dst[s*b*b + e]] = sum over k in
//                           [ptr[s], ptr[s+1]) of table[ids[k]*b*b + e]
//
// What they replace.  The JAX package assembles the sphere in two Pallas
// roles of the unit-weight window kernel
// arcanefem_tpu/sparse/pallas_spmv.py::_products_unit (K2, def at :444,
// pallas_call at :453): the corner gather of
// arcanefem_tpu/ops/lane_assembly.py::TetraLaneAssembler, followed by XLA
// elementwise element math, and the slot reducer of
// arcanefem_tpu/sparse/pallas_assembly.py::SortedEntryAssembler (the sum of
// each slot's slot-sorted contributors; on 3D meshes no VMEM window covers
// the band, so the TPU fell back to segment_sum).  The port ran K2 three
// times, ~220 PyTorch elementwise launches over (nc,) vectors, and 16
// atomic index_add_ calls whose summation order changed from run to run.
//
// What bounds them.  Bytes.  tet_element reads 16 bytes of connectivity
// per cell (corner-major, coalesced per corner), gathers 12 coordinates
// from an (N, 3) table small enough to stay in the 50 MB L2, does ~180
// flops in registers, and writes 40 bytes.  slot_reduce reads 4 bytes of
// pointer per slot, 4 bytes of contributor id per contributor, and one
// gathered table value per contributor (a 32-byte sector at worst), and
// writes 4 bytes per slot.
//
// Design.  tet_element runs one thread per cell; every intermediate stays
// in registers, and the ten entries go through shared memory so that a
// block writes its cells' rows of the cell-major (nc, 10) table as one
// contiguous run.  Its second input mode reads corners that a route's own
// gather kernel fetched (three (4nc,) rows, corner i of cell c at
// i*nc + c), so every route runs the same arithmetic.  The arithmetic is
// written with round-to-nearest intrinsics in the order of the plain twin
// (ops/lane_assembly.py::tet_element_plain), so nvcc contracts nothing into
// an FMA and the kernel stays within a few ulps of the twin.
// slot_reduce runs one thread per SELL slot in storage order, so a warp
// reads 32 consecutive pointers and writes 32 consecutive values; it keeps
// four contributors' loads in flight (a warp waits for its longest list,
// the diagonal's) and sums in f64 registers in the stored (cell, entry)
// order, rounding once.  A slot without contributors (SELL padding) writes
// 0, so the output needs no memset, and there are no atomics: the result
// is the same bit for bit in every run.  Arrays read or written once (the
// connectivity, gathered corners, both outputs) carry streaming cache
// hints, so the L2 keeps the coordinates and table rows that are gathered
// again.
//
// block_slot_reduce assembles the b x b node blocks of the vector
// systems (elasticity, elastodynamics, the mixed bilaplacian), which the
// JAX package sums with XLA segment_sum (arcanefem_tpu/sparse/bell.py:
// 127-133).  The contributor lists stay those of the node-pair slots, so
// the lists are b*b times shorter than lists of the expanded scalar slots
// (at the 1.9M-node sphere: 175.7M contributors instead of 1.58G, which
// would not fit int32 ids).  One thread per node slot keeps the b*b sums
// in f64 registers, reads each contributor's b*b table entries (one
// contiguous 16- or 36-byte run) in list order, rounds once and writes the
// b*b values to their expanded SELL slots through dst (the output is
// zeroed by the caller: SELL padding has no node slot).  No atomics, so
// the result is the same bit for bit in every run.
//
// The kernels allocate nothing, launch on the caller's stream and never
// synchronise; each C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEntries = 10;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// one cofactor row: the gradient of each barycentric coordinate times 6V
__device__ __forceinline__ void cofactors(const float* u, const float* w, float* d) {
  d[0] = add(add(mul(u[1], sub(w[3], w[2])), mul(u[2], sub(w[1], w[3]))),
             mul(u[3], sub(w[2], w[1])));
  d[1] = add(add(mul(u[0], sub(w[2], w[3])), mul(u[2], sub(w[3], w[0]))),
             mul(u[3], sub(w[0], w[2])));
  d[2] = add(add(mul(u[0], sub(w[3], w[1])), mul(u[1], sub(w[0], w[3]))),
             mul(u[3], sub(w[1], w[0])));
  d[3] = add(add(mul(u[0], sub(w[1], w[2])), mul(u[1], sub(w[2], w[0]))),
             mul(u[2], sub(w[0], w[1])));
}

// kGather: corner i of cell c is node cols[i*nc + c], its coordinates
// cx/cy/cz[node * stride]; else they are cx/cy/cz[i*nc + c].
template <bool kGather>
__global__ void __launch_bounds__(kThreads)
tet_element_kernel(const int32_t* __restrict__ cols, const float* __restrict__ cx,
                   const float* __restrict__ cy, const float* __restrict__ cz,
                   int64_t stride, float* __restrict__ ke, int64_t nc) {
  __shared__ float stage[kThreads * kEntries];
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t c = c0 + threadIdx.x;
  if (c < nc) {
    float x[4], y[4], z[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t r = i * nc + c;
      const int64_t p = kGather ? static_cast<int64_t>(__ldcs(cols + r)) * stride : r;
      x[i] = kGather ? __ldg(cx + p) : __ldcs(cx + p);
      y[i] = kGather ? __ldg(cy + p) : __ldcs(cy + p);
      z[i] = kGather ? __ldg(cz + p) : __ldcs(cz + p);
    }
    // 6V = (p1-p0) . (p2-p0) x (p3-p0)
    const float ax = sub(x[1], x[0]), ay = sub(y[1], y[0]), az = sub(z[1], z[0]);
    const float bx = sub(x[2], x[0]), by = sub(y[2], y[0]), bz = sub(z[2], z[0]);
    const float qx = sub(x[3], x[0]), qy = sub(y[3], y[0]), qz = sub(z[3], z[0]);
    const float v6 = add(add(mul(ax, sub(mul(by, qz), mul(bz, qy))),
                             mul(ay, sub(mul(bz, qx), mul(bx, qz)))),
                         mul(az, sub(mul(bx, qy), mul(by, qx))));
    const float inv = __fdiv_rn(1.0f, fabsf(v6));
    float dx[4], dy[4], dz[4];
    cofactors(y, z, dx);
    cofactors(z, x, dy);
    cofactors(x, y, dz);
    // ke_ij = V (dx_i dx_j + dy_i dy_j + dz_i dz_j) / (6V)^2, V = |6V|/6
    const float scale = __fdiv_rn(inv, 6.0f);
    float* out = stage + threadIdx.x * kEntries;
    int k = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = i; j < 4; ++j) {
        out[k++] = mul(add(add(mul(dx[i], dx[j]), mul(dy[i], dy[j])),
                           mul(dz[i], dz[j])), scale);
      }
    }
  }
  __syncthreads();
  const int64_t rows = nc - c0 < kThreads ? nc - c0 : kThreads;
  float* dst = ke + c0 * kEntries;
  for (int t = threadIdx.x; t < rows * kEntries; t += kThreads) __stcs(dst + t, stage[t]);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
slot_reduce_kernel(const int32_t* __restrict__ ptr, const int32_t* __restrict__ ids,
                   const V* __restrict__ table, V* __restrict__ out, int64_t n) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= n) return;
  int32_t k = __ldg(ptr + s);
  const int32_t end = __ldg(ptr + s + 1);
  double acc = 0.0;
  // four contributors' loads in flight at once, added in stored order;
  // end - k cannot overflow where k + 4 could (an E near 2^31)
  for (; end - k >= 4; k += 4) {
    const int32_t i0 = __ldg(ids + k), i1 = __ldg(ids + k + 1);
    const int32_t i2 = __ldg(ids + k + 2), i3 = __ldg(ids + k + 3);
    const V v0 = __ldg(table + i0), v1 = __ldg(table + i1);
    const V v2 = __ldg(table + i2), v3 = __ldg(table + i3);
    acc += static_cast<double>(v0);
    acc += static_cast<double>(v1);
    acc += static_cast<double>(v2);
    acc += static_cast<double>(v3);
  }
  for (; k < end; ++k) acc += static_cast<double>(__ldg(table + __ldg(ids + k)));
  __stcs(out + s, static_cast<V>(acc));
}

template <typename V, int B>
__global__ void __launch_bounds__(kThreads)
block_slot_reduce_kernel(const int32_t* __restrict__ ptr, const int32_t* __restrict__ ids,
                         const V* __restrict__ table, const int32_t* __restrict__ dst,
                         V* __restrict__ out, int64_t n) {
  constexpr int kBB = B * B;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= n) return;
  const int32_t begin = __ldg(ptr + s), end = __ldg(ptr + s + 1);
  double acc[kBB];
#pragma unroll
  for (int e = 0; e < kBB; ++e) acc[e] = 0.0;
  for (int32_t k = begin; k < end; ++k) {
    const V* row = table + static_cast<int64_t>(__ldg(ids + k)) * kBB;
#pragma unroll
    for (int e = 0; e < kBB; ++e) acc[e] += static_cast<double>(__ldg(row + e));
  }
  const int32_t* d = dst + s * kBB;
#pragma unroll
  for (int e = 0; e < kBB; ++e) __stcs(out + __ldg(d + e), static_cast<V>(acc[e]));
}

inline bool grid_for(int64_t threads, dim3* grid) {
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return false;
  *grid = dim3(static_cast<unsigned int>(blocks));
  return true;
}

template <typename V>
int launch_reduce(const int32_t* ptr, const int32_t* ids, const V* table, V* out,
                  int64_t n, void* stream) {
  dim3 grid;
  if (!grid_for(n, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  slot_reduce_kernel<V><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ptr, ids, table, out, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_block_reduce(const int32_t* ptr, const int32_t* ids, const V* table,
                        const int32_t* dst, V* out, int64_t n, int b, void* stream) {
  dim3 grid;
  if (!grid_for(n, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 2) {
    block_slot_reduce_kernel<V, 2><<<grid, kThreads, 0, s>>>(ptr, ids, table, dst, out, n);
  } else if (b == 3) {
    block_slot_reduce_kernel<V, 3><<<grid, kThreads, 0, s>>>(ptr, ids, table, dst, out, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// cols == nullptr selects the second input mode (gathered corners)
int afem_tet_element_f32(const int32_t* cols, const float* cx, const float* cy,
                         const float* cz, int64_t stride, float* ke, int64_t nc,
                         void* stream) {
  dim3 grid;
  if (!grid_for(nc, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols != nullptr) {
    tet_element_kernel<true><<<grid, kThreads, 0, s>>>(cols, cx, cy, cz, stride, ke, nc);
  } else {
    tet_element_kernel<false><<<grid, kThreads, 0, s>>>(cols, cx, cy, cz, stride, ke, nc);
  }
  return static_cast<int>(cudaGetLastError());
}

int afem_slot_reduce_f32(const int32_t* ptr, const int32_t* ids, const float* table,
                         float* out, int64_t n, void* stream) {
  return launch_reduce<float>(ptr, ids, table, out, n, stream);
}

int afem_slot_reduce_f64(const int32_t* ptr, const int32_t* ids, const double* table,
                         double* out, int64_t n, void* stream) {
  return launch_reduce<double>(ptr, ids, table, out, n, stream);
}

int afem_block_slot_reduce_f32(const int32_t* ptr, const int32_t* ids, const float* table,
                               const int32_t* dst, float* out, int64_t n, int b,
                               void* stream) {
  return launch_block_reduce<float>(ptr, ids, table, dst, out, n, b, stream);
}

int afem_block_slot_reduce_f64(const int32_t* ptr, const int32_t* ids, const double* table,
                               const int32_t* dst, double* out, int64_t n, int b,
                               void* stream) {
  return launch_block_reduce<double>(ptr, ids, table, dst, out, n, b, stream);
}

}  // extern "C"
