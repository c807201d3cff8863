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
// What bounds them on the H100: bytes, and not those of device memory. The
// tables (P2/P3: 16 x 174,848 x 4 B = 11.2 MB; P1: at most 9.7 MB) fit the
// 50 MB L2, and a random 4-byte read costs a whole 32-byte sector there: an
// SM gets about one sector every two cycles, used or not. The tables come
// channel-major, (S, W): the S values one index selects lie a whole row
// apart, so a gather that reads them in place asks for S sectors an index
// and uses an eighth of each (P2: 1.06 GB of sectors for 27.8 MB of
// compulsory bytes). The designs ask for fewer sectors:
//
// P2 is two kernels a launch. The transpose writes the table row-major,
//   (W, S), into scratch the wrapper allocates, through a padded
//   shared-memory tile, so that it reads and writes whole lines; the scratch
//   stays in the L2. quad_gather_rows_kernel then reads an index's S words
//   as one aligned row (S = 16: 64 bytes, two sectors, all used):
//   XR_P2_LANES lanes share an index, each reads 16-byte pieces of the row,
//   the pieces are summed by shuffles, and the warp stores its 32 results as
//   one line. S that is not a multiple of 4 takes a scalar loop over the
//   same row. Nothing survives a launch: every launch transposes.
// P1 gathers from the same transposed scratch where S is 8, 16 or 32 and
//   the table holds at least XR_P1_ROWS_MIN words (XR_P1_DESIGN 3): a
//   column's S values are one line there. lane_gather_rows_kernel is the
//   transpose run backwards on gathered rows. A smaller table does not pay
//   for the second kernel and is read in place, one thread an element.
// In both, the second kernel is queued as a programmatic dependent of the
// transpose (XR_PDL): it starts while the transpose drains, reads its
// indices, and waits for the transpose before it touches the scratch.
//
// Kept for the sweep tool (python -m xr_torch.tools.sweep_gather), which
// rebuilds this file with other macros: design 0 of P1 and P2, the
// one-thread-an-element kernels that read the table in place, the yardstick
// (P3 is that kernel still); XR_P1_DESIGN 1, a thread a column and
// XR_P1_ROWS rows read in place, with XR_P1_PREFETCH streaming the table
// into the L2 first (1: a hint inside the kernel, 2: a kernel ahead), which
// did not beat design 0; XR_T_ANY, the transpose for any S on every shape;
// XR_P2_NO_TRANSPOSE and XR_P2_NO_GATHER, probes that compile one of P2's
// two kernels out and break the output.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef XR_P1_DESIGN
#define XR_P1_DESIGN 3
#endif
#ifndef XR_P1_THREADS
#define XR_P1_THREADS 256
#endif
#ifndef XR_P1_ROWS
#define XR_P1_ROWS 8
#endif
#ifndef XR_P1_PREFETCH
#define XR_P1_PREFETCH 0
#endif
#ifndef XR_P2_DESIGN
#define XR_P2_DESIGN 1
#endif
#ifndef XR_P2_THREADS
#define XR_P2_THREADS 128
#endif
#ifndef XR_P2_LANES
#define XR_P2_LANES 4
#endif
#ifndef XR_P1_ROWS_MIN
#define XR_P1_ROWS_MIN 400000
#endif
#ifndef XR_T_COLS
#define XR_T_COLS 256
#endif
#ifndef XR_G_COLS
#define XR_G_COLS 128
#endif
#ifndef XR_PDL
#define XR_PDL 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kP2Threads = XR_P2_THREADS;
constexpr int kP2Lanes = XR_P2_LANES;
constexpr int kTCols = XR_T_COLS;  // columns (and threads) of a CTA of the transpose
constexpr int kGCols = XR_G_COLS;  // columns (and threads) of a CTA of P1 from rows
constexpr int kAnyCols = 64;       // the transpose for any S: columns, rows, threads
constexpr int kAnyRows = 32;
constexpr int kAnyThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kP2Lanes == 1 || kP2Lanes == 2 || kP2Lanes == 4 || kP2Lanes == 8,
              "lanes an index: a power of two up to 8");
static_assert(kP2Threads % 32 == 0 && kTCols % 32 == 0 && kGCols % 32 == 0, "whole warps");

// Programmatic dependent launch: the second kernel of a launch is queued
// with the attribute below, starts while the first one drains, reads its
// indices, and waits here until the first has finished and its writes are
// visible. Both are no-ops in a kernel launched without the attribute.
__device__ __forceinline__ void let_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// ---- design 0: one thread an output element, the table read in place ----

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

// ---- the table row-major: (S, W) -> (W, S) ----

// S of 8, 16 or 32. A CTA moves kTCols columns of all S rows: a thread
// reads its column's S words (a warp reads whole lines, S loads a thread in
// flight), the CTA's output is one contiguous run of kTCols rows, written
// 16 bytes a thread. The tile's row stride keeps the second walk off equal
// banks.
template <int kS>
__global__ void __launch_bounds__(kTCols) transpose_kernel(
    const uint32_t* __restrict__ tab, uint32_t* __restrict__ rows, int W) {
  constexpr int kStride = kTCols + 32 / kS, kQ = kS / 4;
  __shared__ uint32_t tile[kS * kStride];
  let_dependents_launch();
  const int p0 = blockIdx.x * kTCols, t = threadIdx.x;
  if (p0 + t < W) {
    uint32_t v[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) v[s] = tab[(int64_t)s * W + p0 + t];
#pragma unroll
    for (int s = 0; s < kS; ++s) tile[s * kStride + t] = v[s];
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(rows + (int64_t)p0 * kS);
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int u = t + kTCols * k, p = u / kQ, q = u % kQ;
    const uint32_t* w = tile + 4 * q * kStride + p;
    if (p0 + p < W) dst[u] = make_uint4(w[0], w[kStride], w[2 * kStride], w[3 * kStride]);
  }
}

// Any S. A CTA moves rows [s0, s0 + cs) of columns [p0, p0 + cp). It reads
// with neighbouring threads on neighbouring columns and writes with
// neighbouring threads on neighbouring rows of one column, then the next
// column: for S <= 32 its output is one contiguous run.
__global__ void __launch_bounds__(kAnyThreads) transpose_any_kernel(
    const uint32_t* __restrict__ tab, uint32_t* __restrict__ rows, int S, int W) {
  __shared__ uint32_t tile[kAnyRows * kAnyCols + 32];
  let_dependents_launch();
  const int p0 = blockIdx.x * kAnyCols, s0 = blockIdx.y * kAnyRows;
  const int cs = min(kAnyRows, S - s0), cp = min(kAnyCols, W - p0);
  const int stride = kAnyCols + ((cs & (cs - 1)) == 0 ? 32 / cs : 1);
  for (int e = threadIdx.x; e < cs * kAnyCols; e += kAnyThreads) {
    const int s = e / kAnyCols, p = e % kAnyCols;
    if (p < cp) tile[s * stride + p] = tab[(int64_t)(s0 + s) * W + p0 + p];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < cp * cs; e += kAnyThreads) {
    const int p = e / cs, s = e - p * cs;
    rows[(int64_t)(p0 + p) * S + s0 + s] = tile[s * stride + p];
  }
}

// ---- P2 from rows ----

// A thread owns the index and the result of its own output element; the
// kLanes lanes of a group take their kLanes indices in turn, each lane
// reading every kLanes-th 16-byte piece of the row, and the group's sums
// meet by a butterfly, so that lane k of the group keeps turn k's total.
template <int kLanes>
__global__ void __launch_bounds__(kP2Threads) quad_gather_rows_kernel(
    const uint32_t* __restrict__ rows, const int* __restrict__ idx,
    uint32_t* __restrict__ out, int64_t N, int S, int PP) {
  const int64_t n = (int64_t)blockIdx.x * kP2Threads + threadIdx.x;
  const int lane = threadIdx.x & 31, sub = lane & (kLanes - 1);
  const int mine = n < N ? idx[n] : -1;
  wait_for_primary();
  const int pieces = S >> 2;
  uint32_t res = 0u;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) {
    const int i = __shfl_sync(kFull, mine, lane - sub + k);
    uint32_t acc = 0u;
    if ((unsigned)i < (unsigned)PP) {
      const uint4* row = reinterpret_cast<const uint4*>(rows + (int64_t)i * S);
      for (int v = sub; v < pieces; v += kLanes) {
        const uint4 q = __ldg(row + v);
        acc += q.x + q.y + q.z + q.w;
      }
    }
#pragma unroll
    for (int m = kLanes >> 1; m; m >>= 1) acc += __shfl_xor_sync(kFull, acc, m);
    if (sub == k) res = acc;
  }
  if (n < N) out[n] = res;
}

// S that is not a multiple of 4: the rows are not 16-byte aligned.
__global__ void __launch_bounds__(kP2Threads) quad_gather_rows_scalar_kernel(
    const uint32_t* __restrict__ rows, const int* __restrict__ idx,
    uint32_t* __restrict__ out, int64_t N, int S, int PP) {
  const int64_t n = (int64_t)blockIdx.x * kP2Threads + threadIdx.x;
  if (n >= N) return;
  const int i = idx[n];
  wait_for_primary();
  uint32_t acc = 0u;
  if ((unsigned)i < (unsigned)PP) {
    const uint32_t* row = rows + (int64_t)i * S;
    for (int s = 0; s < S; ++s) acc += __ldg(row + s);
  }
  out[n] = acc;
}

// ---- P1 in place: a thread a column and kP1Rows rows (the sweep's) ----

#if XR_P1_DESIGN == 1
constexpr int kP1Threads = XR_P1_THREADS;
constexpr int kP1Rows = XR_P1_ROWS;
static_assert(kP1Threads % 32 == 0, "whole warps");

__device__ __forceinline__ void prefetch_line(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// One 128-byte line a thread, in order.
__global__ void __launch_bounds__(kThreads) prefetch_kernel(const char* p, int64_t nbytes) {
  const int64_t at = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * 128;
  if (at < nbytes) prefetch_line(p + at);
}

__global__ void __launch_bounds__(kP1Threads) lane_gather_cols_kernel(
    const uint32_t* __restrict__ tab, const int* __restrict__ idx,
    uint32_t* __restrict__ out, int S, int W) {
#if XR_P1_PREFETCH == 1
  {
    const int64_t t = ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * kP1Threads + threadIdx.x;
    if (t * 128 < (int64_t)S * W * 4) prefetch_line((const char*)tab + t * 128);
  }
#endif
  const int j = blockIdx.x * kP1Threads + threadIdx.x;
  const int s0 = blockIdx.y * kP1Rows;
  if (j >= W) return;
  const int i = idx[j];
  const bool ok = (unsigned)i < (unsigned)W;
  const uint32_t* src = tab + (int64_t)s0 * W + (ok ? i : 0);
  uint32_t* dst = out + (int64_t)s0 * W + j;
  uint32_t v[kP1Rows];
#pragma unroll
  for (int r = 0; r < kP1Rows; ++r)
    v[r] = (ok && s0 + r < S) ? __ldg(src + (int64_t)r * W) : 0u;
#pragma unroll
  for (int r = 0; r < kP1Rows; ++r)
    if (s0 + r < S) dst[(int64_t)r * W] = v[r];
}
#endif

// ---- P1 from rows: a CTA owns kGCols columns of all S rows (8, 16, 32) ----

// The transpose run backwards on gathered rows: neighbouring threads read
// neighbouring 16-byte pieces of a gathered column (S = 32: one line of the
// scratch, S / 4 loads a thread in flight), park them in a padded tile, and
// each thread writes its column's S words, a warp whole lines.
template <int kS>
__global__ void __launch_bounds__(kGCols) lane_gather_rows_kernel(
    const uint32_t* __restrict__ rows, const int* __restrict__ idx,
    uint32_t* __restrict__ out, int W) {
  constexpr int kStride = kGCols + 32 / kS, kQ = kS / 4;
  __shared__ uint32_t tile[kS * kStride];
  __shared__ int col[kGCols];
  const int j0 = blockIdx.x * kGCols, t = threadIdx.x;
  col[t] = j0 + t < W ? idx[j0 + t] : -1;
  __syncthreads();
  wait_for_primary();
  uint4 v[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int u = t + kGCols * k, i = col[u / kQ];
    v[k] = (unsigned)i < (unsigned)W
               ? __ldg(reinterpret_cast<const uint4*>(rows + (int64_t)i * kS) + u % kQ)
               : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int u = t + kGCols * k;
    uint32_t* w = tile + 4 * (u % kQ) * kStride + u / kQ;
    w[0] = v[k].x, w[kStride] = v[k].y, w[2 * kStride] = v[k].z, w[3 * kStride] = v[k].w;
  }
  __syncthreads();
  if (j0 + t < W) {
#pragma unroll
    for (int s = 0; s < kS; ++s) out[(int64_t)s * W + j0 + t] = tile[s * kStride + t];
  }
}

inline unsigned blocks(int64_t n, int per = kThreads) { return (unsigned)((n + per - 1) / per); }

// Queues `kernel` behind the launch's first kernel, as its dependent.
template <typename... Args>
void launch_second(void (*kernel)(Args...), dim3 grid, int threads, cudaStream_t stream,
                   Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = XR_PDL ? 1 : 0;
  cudaLaunchKernelEx(&cfg, kernel, args...);
}

inline bool rows_fast(int S) { return S == 8 || S == 16 || S == 32; }

void transpose(const uint32_t* tab, uint32_t* rows, int S, int W, cudaStream_t stream) {
#ifdef XR_T_ANY
  constexpr bool kFast = false;
#else
  constexpr bool kFast = true;
#endif
  if (kFast && S == 8)
    transpose_kernel<8><<<blocks(W, kTCols), kTCols, 0, stream>>>(tab, rows, W);
  else if (kFast && S == 16)
    transpose_kernel<16><<<blocks(W, kTCols), kTCols, 0, stream>>>(tab, rows, W);
  else if (kFast && S == 32)
    transpose_kernel<32><<<blocks(W, kTCols), kTCols, 0, stream>>>(tab, rows, W);
  else
    transpose_any_kernel<<<dim3(blocks(W, kAnyCols), blocks(S, kAnyRows)), kAnyThreads, 0,
                           stream>>>(tab, rows, S, W);
}

// P1 gathers from rows where the table is large enough to pay for the
// second kernel; a smaller table, or another S, is read in place.
inline bool lane_gather_from_rows(int S, int W) {
  return XR_P1_DESIGN == 3 && rows_fast(S) && (int64_t)S * W >= XR_P1_ROWS_MIN;
}

}  // namespace

// 1 if a launch at this table shape needs a scratch of the table's size.
extern "C" int xr_lane_gather_scratch(int S, int W) { return lane_gather_from_rows(S, W); }
extern "C" int xr_quad_gather_scratch(int S, int W) { return XR_P2_DESIGN == 1; }

// Each: queues its kernels on `stream` and allocates nothing; `scratch`
// holds as many words as `tab` where the function above says 1 and is not
// read otherwise. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// an empty or negative shape or a missing scratch.
extern "C" int xr_lane_gather(const void* tab, const int* idx, void* out, void* scratch,
                              int S, int W, void* stream) {
  if (S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* t = (const uint32_t*)tab;
  uint32_t* o = (uint32_t*)out;
  if (lane_gather_from_rows(S, W)) {
    if (!scratch) return (int)cudaErrorInvalidValue;
    const uint32_t* rows = (const uint32_t*)scratch;
    transpose(t, (uint32_t*)scratch, S, W, st);
    const dim3 grid(blocks(W, kGCols));
    if (S == 8)
      launch_second(lane_gather_rows_kernel<8>, grid, kGCols, st, rows, idx, o, W);
    else if (S == 16)
      launch_second(lane_gather_rows_kernel<16>, grid, kGCols, st, rows, idx, o, W);
    else
      launch_second(lane_gather_rows_kernel<32>, grid, kGCols, st, rows, idx, o, W);
    return (int)cudaGetLastError();
  }
#if XR_P1_DESIGN == 1
#if XR_P1_PREFETCH == 2
  prefetch_kernel<<<blocks(((int64_t)S * W * 4 + 127) / 128), kThreads, 0, st>>>(
      (const char*)tab, (int64_t)S * W * 4);
#endif
  lane_gather_cols_kernel<<<dim3(blocks(W, kP1Threads), blocks(S, kP1Rows)), kP1Threads, 0, st>>>(
      t, idx, o, S, W);
#else
  lane_gather_kernel<<<blocks((int64_t)S * W), kThreads, 0, st>>>(t, idx, o, S, W);
#endif
  return (int)cudaGetLastError();
}

extern "C" int xr_quad_gather(const void* tab, const int* idx, void* out, void* scratch,
                              int64_t N, int S, int PP, void* stream) {
  if (N <= 0 || S <= 0 || PP <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  uint32_t* o = (uint32_t*)out;
#if XR_P2_DESIGN == 0
  quad_gather_kernel<<<blocks(N), kThreads, 0, st>>>((const uint32_t*)tab, idx, o, N, S, PP);
#else
  if (!scratch) return (int)cudaErrorInvalidValue;
  const uint32_t* rows = (const uint32_t*)scratch;
#ifndef XR_P2_NO_TRANSPOSE
  transpose((const uint32_t*)tab, (uint32_t*)scratch, S, PP, st);
#endif
#ifndef XR_P2_NO_GATHER
  const dim3 grid(blocks(N, kP2Threads));
  if (S % 4 == 0)
    launch_second(quad_gather_rows_kernel<kP2Lanes>, grid, kP2Threads, st, rows, idx, o, N, S, PP);
  else
    launch_second(quad_gather_rows_scalar_kernel, grid, kP2Threads, st, rows, idx, o, N, S, PP);
#endif
#endif
  return (int)cudaGetLastError();
}

extern "C" int xr_quad_gather1(const void* tab, const int* idx, void* out,
                               int64_t N, int PP, void* stream) {
  if (N <= 0 || PP <= 0) return (int)cudaErrorInvalidValue;
  quad_gather1_kernel<<<blocks(N), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)tab, idx, (uint32_t*)out, N, PP);
  return (int)cudaGetLastError();
}
