// Gather kernels of the texture-fetch microbenchmarks, for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels of the two gather tools:
//   xr_lane_gather  — tools/probe_lanegather.py `k` (P1):
//                     out[s, j] = tab[s, idx[j]] for a (S, W) table of any
//                     4-byte type (the kernel only copies bits);
//   xr_quad_gather  — tools/microbench_gather.py `k_gather` (P2):
//                     out[n] = sum over the S table rows of tab[s, idx[n]],
//                     uint32 with wraparound (S = 16 in the tool);
//   xr_quad_gather1 — tools/microbench_gather.py `k_gather1` (P3):
//                     out[n] = tab[0, idx[n]].
// An index outside [0, row width) reads as 0 in every kernel (and in the
// plain versions in xr_torch/tools/gather.py), so no input can make a kernel
// read outside its table.
//
// One thread per output element. Neighbouring threads read neighbouring
// idx entries and write neighbouring outputs (coalesced); the table reads
// are random 4-byte loads through the read-only path (__ldg). What bounds
// them on the H100: bytes. At the tools' sizes the table (P2/P3: 16 x
// 174,848 x 4 B = 11.2 MB; P1: at most 9.7 MB) fits the 50 MB L2, so after
// the first touch every table read is an L2 hit, and a random 4-byte read
// costs a whole 32-byte sector there: P2 moves 16 sectors a pixel through
// L2 (1.06 GB for 2,073,600 pixels) against 27.8 MB of compulsory device
// memory traffic. The design does nothing about that yet: it is the simple
// kernel that is right, the yardstick later layouts are measured against.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) lane_gather_kernel(
    const uint32_t* __restrict__ tab, const int* __restrict__ idx,
    uint32_t* __restrict__ out, int S, int W) {
  const int64_t n = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (n >= (int64_t)S * W) return;
  const int s = (int)(n / W);
  const int j = (int)(n - (int64_t)s * W);
  const int i = idx[j];
  out[n] = (unsigned)i < (unsigned)W ? __ldg(tab + (int64_t)s * W + i) : 0u;
}

__global__ void __launch_bounds__(kThreads) quad_gather_kernel(
    const uint32_t* __restrict__ tab, const int* __restrict__ idx,
    uint32_t* __restrict__ out, int64_t N, int S, int PP) {
  const int64_t n = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const int i = idx[n];
  uint32_t acc = 0u;
  if ((unsigned)i < (unsigned)PP) {
    for (int s = 0; s < S; ++s) acc += __ldg(tab + (int64_t)s * PP + i);
  }
  out[n] = acc;
}

__global__ void __launch_bounds__(kThreads) quad_gather1_kernel(
    const uint32_t* __restrict__ tab, const int* __restrict__ idx,
    uint32_t* __restrict__ out, int64_t N, int PP) {
  const int64_t n = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const int i = idx[n];
  out[n] = (unsigned)i < (unsigned)PP ? __ldg(tab + i) : 0u;
}

inline unsigned blocks(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

// Each: one launch on `stream`; allocates nothing. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an empty or negative
// shape.
extern "C" int xr_lane_gather(const void* tab, const int* idx, void* out,
                              int S, int W, void* stream) {
  if (S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  lane_gather_kernel<<<blocks((int64_t)S * W), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tab, idx, (uint32_t*)out, S, W);
  return (int)cudaGetLastError();
}

extern "C" int xr_quad_gather(const void* tab, const int* idx, void* out,
                              int64_t N, int S, int PP, void* stream) {
  if (N <= 0 || S <= 0 || PP <= 0) return (int)cudaErrorInvalidValue;
  quad_gather_kernel<<<blocks(N), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tab, idx, (uint32_t*)out, N, S, PP);
  return (int)cudaGetLastError();
}

extern "C" int xr_quad_gather1(const void* tab, const int* idx, void* out,
                               int64_t N, int PP, void* stream) {
  if (N <= 0 || PP <= 0) return (int)cudaErrorInvalidValue;
  quad_gather1_kernel<<<blocks(N), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tab, idx, (uint32_t*)out, N, PP);
  return (int)cudaGetLastError();
}
