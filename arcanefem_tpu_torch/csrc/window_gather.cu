// Window gather probes for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (arcanefem_tpu_torch/utils/kernels.py).
//
//   afem_window_take_f32, mode 0 (column take):
//     out[b, g, l] = win[b, idx[b, g, l], l]          (0 if idx outside [0, K))
//   mode 1 (flat take):
//     out[b, g, l] = win[b].flat[idx[b, g, l]]        (0 if outside [0, K*128))
//
// for windows win (nb, K, 128) and indices idx (nb, G, 128), float32.
//
// What it replaces.  The gather probes of arcanefem_tpu's
// tools/probe_gather.py: probe_A (P1, pallas_call at :28, a sublane
// take_along_axis on one (K, 128) window in VMEM), probe_B (P2, :52, a flat
// 1-D take) and bench_A (P3, :79, probe_A over a grid of nb windows).  The
// TPU probes ask how fast a take from a window held in fast memory is; the
// Hopper counterpart of VMEM is a block's shared memory.
//
// What bounds it.  Bytes: each window read once, 4 bytes of index and 4 of
// output per element.  No arithmetic.
//
// Design.  Where a window fits in a block's shared memory (K <= 448, the
// cut-over: 448 * 512 B = 224 KB of the 227 KB a block may have; K = 160 is
// 80 KB) and win is 16-byte aligned, one block per window, or per window and
// chunk of up to 64 index rows when there are fewer than 132 windows,
// stages the window with one bulk asynchronous copy (cp.async.bulk, the
// TMA's 1-D form, completing on an mbarrier) while its threads load their
// indices (at most 32 each) into registers, then serves every take from
// shared memory.  A column take reads bank l mod 32 whatever the row, so a
// warp's 32 reads never conflict.  Larger windows (K = 1024 is 512 KB) keep
// the first design: one thread per element, reading the window through
// L1/L2.
//
// The kernel allocates nothing, launches on the caller's stream and never
// synchronises; the C entry point returns cudaGetLastError() (or the error
// of raising the block's shared-memory limit above 48 KB).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kLane = 128;
constexpr int kSmemMaxK = 448;            // the cut-over K
constexpr int kMaxRows = 64;              // index rows per block: 32 takes a thread
constexpr int kPer = kMaxRows * kLane / kThreads;
constexpr int kSms = 132;                 // H100 SXM

template <int kMode>
__global__ void __launch_bounds__(kThreads)
window_take_kernel(const float* __restrict__ win, const int32_t* __restrict__ idx,
                   float* __restrict__ out, int64_t nb, int K, int G) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t per = static_cast<int64_t>(G) * kLane;
  if (i >= nb * per) return;
  const int64_t b = i / per;
  const int l = static_cast<int>(i % kLane);
  const int32_t j = idx[i];
  const float* w = win + b * static_cast<int64_t>(K) * kLane;
  float v = 0.0f;
  if (kMode == 0) {
    if (j >= 0 && j < K) v = w[static_cast<int64_t>(j) * kLane + l];
  } else {
    if (j >= 0 && j < K * kLane) v = w[j];
  }
  out[i] = v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory form: block (window b, chunk ch) takes index rows
// [ch * rows, min(G, (ch + 1) * rows)) of window b.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
window_take_smem_kernel(const float* __restrict__ win,
                        const int32_t* __restrict__ idx, float* __restrict__ out,
                        int K, int G, int rows, int chunks) {
  extern __shared__ __align__(128) float s_win[];
  __shared__ __align__(8) uint64_t bar;
  const int64_t b = blockIdx.x / chunks;
  const int g0 = (blockIdx.x % chunks) * rows;
  const int count = min(G - g0, rows) * kLane;
  const uint32_t bytes = static_cast<uint32_t>(K) * kLane * sizeof(float);
  const uint32_t sbar = smem_addr(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(sbar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(sbar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        ::"r"(smem_addr(s_win)), "l"(win + b * K * kLane), "r"(bytes),
          "r"(sbar) : "memory");
  }
  // the indices are read while the window is in flight
  const int64_t base = (b * G + g0) * kLane;
  int32_t j[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    j[k] = e < count ? __ldcs(idx + base + e) : 0;
  }
  asm volatile(
      "{\n\t"
      ".reg .pred p;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n\t"
      "}" ::"r"(sbar), "r"(0u) : "memory");
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (e < count) {
      float v = 0.0f;
      if (kMode == 0) {
        // base is a multiple of 128, so the lane of element e is e mod 128
        if (j[k] >= 0 && j[k] < K) v = s_win[j[k] * kLane + (e & (kLane - 1))];
      } else {
        if (j[k] >= 0 && j[k] < K * kLane) v = s_win[j[k]];
      }
      __stcs(out + base + e, v);
    }
  }
}

// Raise the kernels' dynamic shared-memory limit once per device.
int allow_smem(int mode) {
  static bool done[2][64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && done[mode][dev]) return 0;
  const int bytes = kSmemMaxK * kLane * static_cast<int>(sizeof(float));
  e = mode == 0 ? cudaFuncSetAttribute(window_take_smem_kernel<0>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes)
                : cudaFuncSetAttribute(window_take_smem_kernel<1>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64) done[mode][dev] = true;
  return 0;
}

}  // namespace

extern "C" {

int afem_window_take_f32(const float* win, const int32_t* idx, float* out,
                         int64_t nb, int K, int G, int mode, void* stream) {
  if (nb <= 0 || K <= 0 || G <= 0 || (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= kSmemMaxK && reinterpret_cast<uintptr_t>(win) % 16 == 0) {
    // chunks of index rows per window: enough blocks to reach every SM when
    // the windows are few, at least 8 rows (1,024 takes) per staged window
    const int64_t want = nb >= kSms ? 1 : (kSms + nb - 1) / nb;
    int rows = static_cast<int>((G + want - 1) / want);
    rows = std::min(kMaxRows, std::max(rows, std::min(G, 8)));
    const int chunks = (G + rows - 1) / rows;
    if (nb * chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const int rc = allow_smem(mode);
    if (rc != 0) return rc;
    const unsigned int grid = static_cast<unsigned int>(nb * chunks);
    const size_t smem = static_cast<size_t>(K) * kLane * sizeof(float);
    if (mode == 0) {
      window_take_smem_kernel<0><<<grid, kThreads, smem, s>>>(win, idx, out, K, G,
                                                              rows, chunks);
    } else {
      window_take_smem_kernel<1><<<grid, kThreads, smem, s>>>(win, idx, out, K, G,
                                                              rows, chunks);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t blocks = (nb * G * kLane + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 0) {
    window_take_kernel<0><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        win, idx, out, nb, K, G);
  } else {
    window_take_kernel<1><<<static_cast<unsigned int>(blocks), kThreads, 0, s>>>(
        win, idx, out, nb, K, G);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
