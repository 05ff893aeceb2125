// P1 tetrahedron assembly for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (arcanefem_tpu_torch/utils/kernels.py).
//
//   afem_tet_element_f32:   ke[c, k] = the k-th upper-triangle entry (TRI10
//                           order: (0,0),(0,1),...,(3,3)) of cell c's
//                           stiffness matrix, from its four corners
//   afem_tet_assemble_f32:  the same sums over the patches' tables of
//                           element entries, computed in shared memory
//                           (one launch, no table in HBM)
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
// tet_assemble fuses the two on the default route.  Two kernels move
// about 2 GB per assembly of the 1.9M-node sphere against 0.31 GB of
// least bytes: tet_element writes the 439 MB table, and slot_reduce reads
// it back by a gather of one value per contributor (175.7M of them, a
// 32-byte sector each, from a table 9x the L2) beside 703 MB of int32
// contributor ids.  The fused kernel keeps the table in shared memory.
// The SELL slices are cut into patches, runs of whole slices whose cells
// (those with a corner on one of the patch's rows) fit a block's table;
// cells on the rows of two patches are computed twice or more (the halo
// factor, about 2.3 at the sphere).  Persistent blocks, one per SM, take
// the patches in turn.  A patch's lists are 16-bit: its cells' corners as
// positions among its nodes (8 bytes a cell), its nodes' global ids, and
// per slot a pointer, a slot and its contributors' local ids (local cell
// * 10 + TRI10 column, 2 bytes each).  cp.async copies them into one of
// two buffers while the block works on the patch before, and gathers the
// patch's node coordinates, which the L2 holds, once per node.  Phase 1
// computes each cell's ten entries with tet_element's arithmetic
// (tet_entries) into the table; phase 2 runs one thread per slot, longest
// list first so that a warp's lists are alike in length, and sums the
// slot's contributors from the table in f64 in the window lists' order,
// rounding once.  So the values equal slot_reduce over tet_element on
// those lists bit for bit, with no atomics, and padding slots get 0.
// What bounds it: the copies, not the arithmetic.  At the sphere it moves
// about 0.83 GB (0.25 ms at the HBM peak) in 0.57 ms; its copies alone,
// with both phases left out, take 0.36 ms, and each phase adds about 0.1
// (PERF.md section 6).  More blocks per SM, with smaller patches, did not
// shorten it.
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

// the ten upper-triangle entries (TRI10 order) of the element matrix of
// the cell with corners (x[i], y[i], z[i]), into out[0..9]; the one copy of
// the arithmetic, so that tet_element and tet_assemble give the same bits
__device__ __forceinline__ void tet_entries(const float* x, const float* y, const float* z,
                                            float* out) {
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
  int k = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = i; j < 4; ++j) {
      out[k++] = mul(add(add(mul(dx[i], dx[j]), mul(dy[i], dy[j])), mul(dz[i], dz[j])), scale);
    }
  }
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
    tet_entries(x, y, z, stage + threadIdx.x * kEntries);
  }
  __syncthreads();
  const int64_t rows = nc - c0 < kThreads ? nc - c0 : kThreads;
  float* dst = ke + c0 * kEntries;
  for (int t = threadIdx.x; t < rows * kEntries; t += kThreads) __stcs(dst + t, stage[t]);
}

// asynchronous copies from global to shared memory (cp.async), in commit
// groups that a thread waits for
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// tet_assemble's patch p, from meta: four (n_patches + 1,) int64 rows, each
// patch's first cell (of lconn), SELL slot, blob entry and node
struct Patch {
  int64_t c0, s0, b0, v0;
  int cells, slots, chunks, nodes;
};
__device__ __forceinline__ Patch patch_at(const int64_t* __restrict__ meta, int64_t m,
                                          int64_t p) {
  Patch q;
  q.c0 = __ldg(meta + p);
  q.cells = static_cast<int>(__ldg(meta + p + 1) - q.c0);
  q.s0 = __ldg(meta + m + p);
  q.slots = static_cast<int>(__ldg(meta + m + p + 1) - q.s0);
  q.b0 = __ldg(meta + 2 * m + p);
  q.chunks = static_cast<int>(__ldg(meta + 2 * m + p + 1) - q.b0) / 8;
  q.v0 = __ldg(meta + 3 * m + p);
  q.nodes = static_cast<int>(__ldg(meta + 3 * m + p + 1) - q.v0);
  return q;
}

// a patch's buffer in shared memory: its cells' local corners (8 bytes a
// cell, to 16), its nodes' global ids (4 bytes a node, nodes a multiple of
// 4), their (x, y, z, unused) (16 bytes a node), then its part of the blob
struct Stage {
  ushort4* lconn;
  int32_t* ids;
  float4* xyz;
  uint16_t* lists;
};
__device__ __forceinline__ Stage stage_at(unsigned char* b, const Patch& q) {
  Stage r;
  r.lconn = reinterpret_cast<ushort4*>(b);
  unsigned char* v = b + (8 * q.cells + 15) / 16 * 16;
  r.ids = reinterpret_cast<int32_t*>(v);
  r.xyz = reinterpret_cast<float4*>(v + 4 * q.nodes);
  r.lists = reinterpret_cast<uint16_t*>(v + 20 * q.nodes);
  return r;
}

// the copies of a patch: its local corners and node ids (N), then its
// nodes' coordinates from the (N, 3) table, which the L2 holds (C, after N
// has landed), and its blob part (B)
template <int kBlock>
__device__ __forceinline__ void fetch_nodes(const ushort4* __restrict__ lconn,
                                            const int32_t* __restrict__ nodes, const Patch& q,
                                            const Stage& r) {
  for (int t = threadIdx.x; t < q.cells; t += kBlock) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(r.lconn + t));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(lconn + q.c0 + t)
                 : "memory");
  }
  for (int t = threadIdx.x; t < q.nodes / 4; t += kBlock) {
    copy16(r.ids + 4 * t, nodes + q.v0 + 4 * t);
  }
}
template <int kBlock>
__device__ __forceinline__ void fetch_coords(const float* __restrict__ coords, const Patch& q,
                                             const Stage& r) {
  for (int t = threadIdx.x; t < q.nodes; t += kBlock) {
    const float* c = coords + static_cast<int64_t>(r.ids[t]) * 3;
    copy4(&r.xyz[t].x, c);
    copy4(&r.xyz[t].y, c + 1);
    copy4(&r.xyz[t].z, c + 2);
  }
}
template <int kBlock>
__device__ __forceinline__ void fetch_lists(const uint16_t* __restrict__ blob, const Patch& q,
                                            const Stage& r) {
  for (int t = threadIdx.x; t < q.chunks; t += kBlock) {
    copy16(r.lists + 8 * t, blob + q.b0 + 8 * t);
  }
}

// tet_assemble: persistent blocks, one on each SM, block b taking patches
// b, b + gridDim.x, ...; a patch is a run of whole SELL slices.  Phase 1
// computes the patch's cells' entries into the table (ten floats a cell,
// tet_entries); phase 2 takes position i of its S slots: it sums the local
// ids lists[ptr[i] .. ptr[i + 1]) (local cell * 10 + TRI10 column) from
// the table in float64 in list order, rounds once and stores slot
// s0 + slot[i].  The blob part of a patch holds ptr (S + 1), slot (S), then
// the lists.  Two buffers: while the block works on one patch, the next
// one's copies land in the other: N during phase 1, C during phase 2, B
// during phase 2 and the next phase 1.  Shared memory: the table (40 max_cells
// bytes, to 16), then two buffers of buf_bytes.
template <int kBlock>
__global__ void __launch_bounds__(kBlock)
tet_assemble_kernel(const ushort4* __restrict__ lconn, const int32_t* __restrict__ nodes,
                    const float* __restrict__ coords, const int64_t* __restrict__ meta,
                    const uint16_t* __restrict__ blob, float* __restrict__ out,
                    int64_t n_patches, int max_cells, int buf_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* table = reinterpret_cast<float*>(smem);
  unsigned char* bufs = smem + (40 * max_cells + 15) / 16 * 16;
  const int64_t m = n_patches + 1;
  int64_t p = blockIdx.x;
  if (p >= n_patches) return;
  Patch cur = patch_at(meta, m, p);
  Stage cb = stage_at(bufs, cur);
  fetch_nodes<kBlock>(lconn, nodes, cur, cb);
  copy_commit();
  copy_wait<0>();
  __syncthreads();
  fetch_coords<kBlock>(coords, cur, cb);
  copy_commit();
  fetch_lists<kBlock>(blob, cur, cb);
  copy_commit();
  for (int it = 0;; ++it) {
    const int64_t pn = p + gridDim.x;
    const bool more = pn < n_patches;
    Patch nxt = cur;
    Stage nb = cb;
    if (more) {
      nxt = patch_at(meta, m, pn);
      nb = stage_at(bufs + ((it + 1) & 1) * buf_bytes, nxt);
      fetch_nodes<kBlock>(lconn, nodes, nxt, nb);
    }
    copy_commit();
    // pending, oldest first: C and B of this patch, N of the next; C done
    copy_wait<2>();
    __syncthreads();
    for (int t = threadIdx.x; t < cur.cells; t += kBlock) {
      const ushort4 q = cb.lconn[t];
      const float4 a = cb.xyz[q.x], b = cb.xyz[q.y], c = cb.xyz[q.z], d = cb.xyz[q.w];
      const float x[4] = {a.x, b.x, c.x, d.x};
      const float y[4] = {a.y, b.y, c.y, d.y};
      const float z[4] = {a.z, b.z, c.z, d.z};
      tet_entries(x, y, z, table + t * kEntries);
    }
    // this patch's B and the next one's N have landed
    copy_wait<0>();
    __syncthreads();
    if (more) fetch_coords<kBlock>(coords, nxt, nb);
    copy_commit();
    if (more) fetch_lists<kBlock>(blob, nxt, nb);
    copy_commit();
    const uint16_t* ptr = cb.lists;
    const uint16_t* slot = ptr + cur.slots + 1;
    const uint16_t* ids = slot + cur.slots;
    for (int t = threadIdx.x; t < cur.slots; t += kBlock) {
      int k = ptr[t];
      const int end = ptr[t + 1];
      double acc = 0.0;
      // four contributors' table values in flight at once, added in list order
      for (; k + 4 <= end; k += 4) {
        const float v0 = table[ids[k]], v1 = table[ids[k + 1]];
        const float v2 = table[ids[k + 2]], v3 = table[ids[k + 3]];
        acc += static_cast<double>(v0);
        acc += static_cast<double>(v1);
        acc += static_cast<double>(v2);
        acc += static_cast<double>(v3);
      }
      for (; k < end; ++k) acc += static_cast<double>(table[ids[k]]);
      __stcs(out + cur.s0 + slot[t], static_cast<float>(acc));
    }
    if (!more) break;
    // the table and this buffer are free again only when every thread is done
    __syncthreads();
    p = pn;
    cur = nxt;
    cb = nb;
  }
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

// the table's bytes that a launch may ask for on the current device (the
// opt-in maximum of dynamic shared memory per block), or -1
int smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess) {
    return -1;
  }
  return bytes;
}

constexpr int kAssembleThreads = 512;

int launch_assemble(const uint16_t* lconn, const int32_t* nodes, const float* coords,
                    const int64_t* meta, const uint16_t* blob, float* out, int64_t n_patches,
                    int max_cells, int buf_bytes, int smem_bytes, int blocks, cudaStream_t s) {
  // raise the kernel's dynamic shared memory limit once per device, to
  // the most asked for so far
  static int granted[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (smem_bytes > granted[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(tet_assemble_kernel<kAssembleThreads>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted[dev] = smem_bytes;
  }
  tet_assemble_kernel<kAssembleThreads><<<blocks, kAssembleThreads, smem_bytes, s>>>(
      reinterpret_cast<const ushort4*>(lconn), nodes, coords, meta, blob, out, n_patches,
      max_cells, buf_bytes);
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

// *bytes = the most dynamic shared memory afem_tet_assemble_f32 may be
// given on the current device
int afem_tet_assemble_smem(int* bytes, void* stream) {
  (void)stream;
  *bytes = smem_optin();
  return *bytes < 0 ? static_cast<int>(cudaErrorInvalidDevice) : 0;
}

// lconn: (cells, 4) uint16, 8-byte aligned; nodes (int32) and blob
// (uint16), each 16-byte aligned; meta: (4, n_patches + 1) int64;
// max_cells: the most cells of a patch; buf_bytes: the largest patch
// buffer, a multiple of 16; blocks: the persistent blocks (one per SM)
int afem_tet_assemble_f32(const uint16_t* lconn, const int32_t* nodes, const float* coords,
                          const int64_t* meta, const uint16_t* blob, float* out,
                          int64_t n_patches, int max_cells, int buf_bytes, int blocks,
                          void* stream) {
  const int64_t smem = (40LL * max_cells + 15) / 16 * 16 + 2LL * buf_bytes;
  if (n_patches <= 0 || max_cells < 0 || buf_bytes < 0 || buf_bytes % 16 || blocks <= 0 ||
      smem > smem_optin() || reinterpret_cast<uintptr_t>(lconn) % 8 ||
      reinterpret_cast<uintptr_t>(nodes) % 16 || reinterpret_cast<uintptr_t>(blob) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_assemble(lconn, nodes, coords, meta, blob, out, n_patches, max_cells, buf_bytes,
                         static_cast<int>(smem), blocks, static_cast<cudaStream_t>(stream));
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
