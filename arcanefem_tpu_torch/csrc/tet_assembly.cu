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
//                           for each node slot s and e = a*b + c < b*b
//                           (b = 2, 3): the SELL slot of (s, e) in the
//                           scalar expansion's layout = sum over k in
//                           [ptr[s], ptr[s+1]) of table[ids[k]*b*b + e];
//                           every other slot of the layout (padding) = 0
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
// systems (elasticity, elastodynamics, soildynamics, passmo, the mixed
// bilaplacian), which the JAX package sums with XLA segment_sum
// (arcanefem_tpu/sparse/bell.py:124-136); on the TPU that sum is the b x b
// form of K2's window-reducer role (sparse/pallas_spmv.py::_products_unit,
// def at :444, pallas_call at :453).  The contributor lists stay those of
// the node-pair slots, in CSR order, so they are b*b times shorter than
// lists of the expanded scalar slots (at the 1.9M-node sphere: 175.7M
// contributors instead of 1.58G, which would not fit int32 ids).
//
// What bounds it.  Bytes: per node slot its b*b outputs and its pointer,
// per contributor a 4-byte id and its b*b table entries (a contiguous 16-
// or 36-byte run, each read once: the table is most of the bytes).  The
// table is cell-major and the sums node-slot-major, so the rows of a
// cell's block table are read when each of its nodes comes up, as far
// apart as the node order's bandwidth, and the L2 cannot hold them all in
// between: the reads, not the writes, keep it near half of its bound.
//
// Design.  The first version ran one thread per node slot and stored its
// b*b sums one at a time through an (n_node_slots*b*b,) int32 slot map
// into a zeroed output: 32 lanes' stores 128*b bytes or more apart, a
// partial sector each, plus the map's and the memset's bytes.  Here the
// output is indexed by slice, with no map: the expanded row n*b + a holds
// the node slots of node n in ELL order, each widened to c = 0..b-1, and
// the topology puts node n's real ELL slots first in CSR order
// (sparse/bell.py::BlockAssembly checks it), so SELL entry j of that row is
// entry a*b + j%b of node slot row_ptr[n] + j/b.  One block owns one slice
// of 32 rows (perm gives each lane its row, or the position itself where
// sigma = 1): its first warp finds the slice's nodes (a node's rows are a
// few lanes), and the block's threads take its nodes' node slots, node
// after node, one each, so the threads of a warp read the same cells'
// table rows at once, as the first version's did.  A thread sums its list
// in f64 in list order, each entry's b*b values read in 16-byte loads
// (scalar loads of one 36-byte entry took nine L1 round trips), rounds once
// and writes the rows of the block that this slice holds into a stage in
// shared memory; the block then stores the stage as one contiguous run of
// the slice, padding (columns past a row's node slots, lanes past n_rows)
// as 0.  So every slot of the layout is written once, coalesced, and the
// output needs no memset.  A node whose rows straddle two slices (32 % 3
// != 0, or a sigma window) has its node slots summed by both blocks, each
// writing its own rows.  No atomics, so the result is the same bit for bit
// in every run.  Each thread keeps one contributor's loads in flight (its
// b*b values in one to three 16-byte loads).  The block sizes (192 threads
// at b = 3, 64 at b = 2), that depth and the plain __ldg cache policy were
// picked from trials whose harness is not kept, so no timing in the repo
// backs them against the alternatives; the form of the list loop is
// measured (PERF.md section 6).
//
// The kernels allocate nothing, launch on the caller's stream and never
// synchronise; each C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// block_slot_reduce: one block per SELL slice, its columns staged in shared
// memory at a pitch of 33 values, so that a column's 32 lanes and a node
// slot's columns fall in different banks
constexpr int kPitch = 33;
constexpr int kStep = 1;  // contributors per step of a thread's list
// threads per slice: about the items of a slice at b = 3 (32/3 nodes of
// ~15 node slots), two rounds of them at b = 2; the kernel's launch bound
// covers both (the bound it was timed with)
constexpr int slice_threads(int b) { return b == 3 ? 192 : 64; }
constexpr int kSliceBound = 256;
static_assert(slice_threads(3) <= kSliceBound && slice_threads(2) <= kSliceBound,
              "a block_slot_reduce launch exceeds the kernel's launch bound");
// the stage's bytes at most, so that it and the static arrays stay under
// 48 KB; wider slices go through it in chunks of columns
constexpr int kStageBytes = 40 * 1024;

template <typename V> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };
__device__ __forceinline__ void unpack(const float4& w, float* o) {
  o[0] = w.x; o[1] = w.y; o[2] = w.z; o[3] = w.w;
}
__device__ __forceinline__ void unpack(const double2& w, double* o) { o[0] = w.x; o[1] = w.y; }

// v = the kN values table[o, o + kN) through 16-byte loads (the table is
// 16-byte aligned): the chunks start at o rounded down to 16 bytes and each
// holds at least one of the values, so no load leaves the table's 16-byte
// granules
template <typename V, int kN>
__device__ __forceinline__ void load_entry(const V* __restrict__ table, int64_t o, V* v) {
  using Vec = typename Vec16<V>::type;
  constexpr int kVec = 16 / sizeof(V);
  constexpr bool kAligned = kN % kVec == 0;
  constexpr int kChunks = kAligned ? kN / kVec : kN / kVec + 1;
  const int sh = kAligned ? 0 : static_cast<int>(o & (kVec - 1));
  const Vec* q = reinterpret_cast<const Vec*>(table + (o - sh));
  V f[kChunks * kVec];
#pragma unroll
  for (int u = 0; u < kChunks; ++u) unpack(__ldg(q + u), f + u * kVec);
#pragma unroll
  for (int s = 0; s < kVec; ++s) {
    if (s == sh) {
#pragma unroll
      for (int e = 0; e < kN; ++e) v[e] = f[(s + e) % (kChunks * kVec)];
    }
  }
}

template <typename V, int B>
__global__ void __launch_bounds__(kSliceBound)
block_slot_reduce_kernel(const int32_t* __restrict__ ptr, const int32_t* __restrict__ ids,
                         const V* __restrict__ table, const int32_t* __restrict__ row_ptr,
                         const int64_t* __restrict__ slice_ptr,
                         const int32_t* __restrict__ perm, V* __restrict__ out,
                         int64_t n_rows, int cap_slots) {
  constexpr int kBB = B * B;
  extern __shared__ __align__(16) unsigned char stage_bytes[];
  V* stage = reinterpret_cast<V*>(stage_bytes);
  // the slice's nodes ("leaders": a node's first lane): first node slot,
  // node slots, lanes; each lane's a; the item prefix
  __shared__ int32_t start[32], degs[32], first[33], lane_a[32];
  __shared__ uint32_t lanes[32];
  __shared__ int n_nodes;
  const int64_t sl = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t base = __ldg(slice_ptr + sl);
  const int slots = static_cast<int>((__ldg(slice_ptr + sl + 1) - base) / 32) / B;
  if (tid < 32) {
    const int64_t i = sl * 32 + tid;
    int32_t n = -1, s0 = 0, deg = 0, a = 0;
    if (i < n_rows) {
      const int32_t r = perm != nullptr ? __ldg(perm + i) : static_cast<int32_t>(i);
      n = r / B;
      a = r - n * B;
      s0 = __ldg(row_ptr + n);
      deg = __ldg(row_ptr + n + 1) - s0;
    }
    const uint32_t same = __match_any_sync(0xffffffffu, n);
    const bool leader = n >= 0 && __ffs(same) - 1 == tid;
    const uint32_t lead = __ballot_sync(0xffffffffu, leader);
    lane_a[tid] = a;
    if (leader) {
      const int j = __popc(lead & ((1u << tid) - 1u));
      start[j] = s0;
      degs[j] = deg;
      lanes[j] = same;
    }
    if (tid == 0) n_nodes = __popc(lead);
  }
  __syncthreads();
  const int nodes = n_nodes;
  for (int w0 = 0; w0 < slots; w0 += cap_slots) {
    const int nw = min(cap_slots, slots - w0);
    for (int t = tid; t < nw * B * 32; t += nt) stage[(t >> 5) * kPitch + (t & 31)] = V(0);
    if (tid < 32) {  // items: node j's node slots [w0, w0 + nw), node after node
      int cnt = tid < nodes ? min(max(degs[tid] - w0, 0), nw) : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, cnt, o);
        if (tid >= o) cnt += v;
      }
      first[tid + 1] = cnt;
      if (tid == 0) first[0] = 0;
    }
    __syncthreads();
    const int total = first[32];
    for (int t = tid; t < total; t += nt) {
      int j = 0, hi = nodes;  // first[j] <= t < first[j + 1]
      while (hi - j > 1) {
        const int mid = (j + hi) >> 1;
        if (first[mid] <= t) j = mid; else hi = mid;
      }
      const int w = w0 + t - first[j];
      const int32_t s = start[j] + w;
      int32_t k = __ldg(ptr + s);
      const int32_t end = __ldg(ptr + s + 1);
      double acc[kBB];
#pragma unroll
      for (int e = 0; e < kBB; ++e) acc[e] = 0.0;
      // a stepped loop with its remainder, as slot_reduce's, at a step of
      // one contributor: the remainder never runs, but nvcc schedules this
      // form faster on the H100 than one plain k < end loop, which ran 7%
      // slower at b = 3 and 9% at b = 2 in chip_smoke (PERF.md section 6)
      for (; end - k >= kStep; k += kStep) {
        V v[kStep][kBB];
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
          load_entry<V, kBB>(table, static_cast<int64_t>(__ldg(ids + k + u)) * kBB, v[u]);
        }
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
#pragma unroll
          for (int e = 0; e < kBB; ++e) acc[e] += static_cast<double>(v[u][e]);
        }
      }
      for (; k < end; ++k) {
        V v[kBB];
        load_entry<V, kBB>(table, static_cast<int64_t>(__ldg(ids + k)) * kBB, v);
#pragma unroll
        for (int e = 0; e < kBB; ++e) acc[e] += static_cast<double>(v[e]);
      }
      // row a of the block goes to the lanes of the node's rows in this slice
      V* col = stage + (w - w0) * B * kPitch;
      for (uint32_t m = lanes[j]; m; m &= m - 1u) {
        const int l = __ffs(m) - 1;
        const int a = lane_a[l];
#pragma unroll
        for (int r = 0; r < B; ++r) {
          if (r == a) {
#pragma unroll
            for (int c = 0; c < B; ++c) col[c * kPitch + l] = static_cast<V>(acc[r * B + c]);
          }
        }
      }
    }
    __syncthreads();
    V* o = out + base + static_cast<int64_t>(w0) * B * 32;
    for (int t = tid; t < nw * B * 32; t += nt) __stcs(o + t, stage[(t >> 5) * kPitch + (t & 31)]);
    __syncthreads();
  }
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
                        const int32_t* row_ptr, const int64_t* slice_ptr,
                        const int32_t* perm, V* out, int64_t n_rows, int64_t n_slices,
                        int max_slots, int b, void* stream) {
  if (n_slices <= 0 || n_slices > 0x7fffffffLL || max_slots < 0 || (b != 2 && b != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per_slot = b * kPitch * static_cast<int>(sizeof(V));
  const int cap = std::max(1, std::min(max_slots, kStageBytes / per_slot));
  const dim3 grid(static_cast<unsigned int>(n_slices));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 2) {
    block_slot_reduce_kernel<V, 2><<<grid, slice_threads(2), cap * per_slot, s>>>(
        ptr, ids, table, row_ptr, slice_ptr, perm, out, n_rows, cap);
  } else {
    block_slot_reduce_kernel<V, 3><<<grid, slice_threads(3), cap * per_slot, s>>>(
        ptr, ids, table, row_ptr, slice_ptr, perm, out, n_rows, cap);
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

// perm == nullptr: sigma = 1, row position i is row i
// max_slots: the widest slice's node slots (its width / b)
int afem_block_slot_reduce_f32(const int32_t* ptr, const int32_t* ids, const float* table,
                               const int32_t* row_ptr, const int64_t* slice_ptr,
                               const int32_t* perm, float* out, int64_t n_rows,
                               int64_t n_slices, int max_slots, int b, void* stream) {
  return launch_block_reduce<float>(ptr, ids, table, row_ptr, slice_ptr, perm, out, n_rows,
                                    n_slices, max_slots, b, stream);
}

int afem_block_slot_reduce_f64(const int32_t* ptr, const int32_t* ids, const double* table,
                               const int32_t* row_ptr, const int64_t* slice_ptr,
                               const int32_t* perm, double* out, int64_t n_rows,
                               int64_t n_slices, int max_slots, int b, void* stream) {
  return launch_block_reduce<double>(ptr, ids, table, row_ptr, slice_ptr, perm, out, n_rows,
                                     n_slices, max_slots, b, stream);
}

}  // extern "C"
