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
// TPU probes asked which in-VMEM gathers Mosaic compiles; on Hopper both
// forms are ordinary loads, and the probes measure the card's gather rate
// from a window.  The window is read from global memory (through L1/L2):
// a K = 1024 window is 512 KB, more than a block's 227 KB of shared memory.
//
// What bounds it.  Bytes: each window read once, 4 bytes of index and 4 of
// output per element.  No arithmetic.
//
// Design: one thread per output element, 256 per block; a block's threads
// share one window (G*128 is a multiple of 256 for the probes' G), so its
// loads stay inside 512 B*K of memory.
//
// The kernel allocates nothing, launches on the caller's stream and never
// synchronises; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLane = 128;

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

}  // namespace

extern "C" {

int afem_window_take_f32(const float* win, const int32_t* idx, float* out,
                         int64_t nb, int K, int G, int mode, void* stream) {
  if (nb <= 0 || K <= 0 || G <= 0 || (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (nb * G * kLane + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
