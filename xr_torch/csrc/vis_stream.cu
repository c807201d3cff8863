// Streaming tile visibility kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel xr/raster/pallas_stream.py `_vis_kernel`
// together with the record loop it shares, xr/raster/pallas_smem.py
// `_raster_scalar_records` (fold_records.cuh).
//
// For each screen tile: clear (z, id) to (+inf, BG) — or id -1 in painter's
// order — fold the global large bucket behind a whole-record bbox reject,
// then fold the tile's sorted bin segment
// sid[starts[t] : starts[t] + run_counts[t]]. Tiles that the stream
// capacity did not reach are written as background.
//
// What bounds it on the H100: per record, each thread does a few integer
// multiply-adds per pixel it owns; the records are small (72 bytes) and
// read once per slab, so the kernel is bound by instruction throughput,
// not by memory. The design keeps the framebuffer slab in registers, stages
// records through shared memory and writes each pixel once. The TPU's block
// layout and scalar prefetch have no counterpart here: the torch prep
// computes the block budget's outcome (run_counts, tile_ran).

#include "fold_records.cuh"

namespace {

using namespace xr;

__global__ void __launch_bounds__(kThreads) vis_stream_kernel(
    const int* __restrict__ rec, const int* __restrict__ sid,
    const int* __restrict__ starts, const int* __restrict__ run_counts,
    const int* __restrict__ tile_ran, const int* __restrict__ large_ids,
    const int* __restrict__ large_count, int* __restrict__ tid_out,
    float* __restrict__ z_out, int height, int width, int tile_h, int ntx,
    int sub, int depth_test) {
  __shared__ int s_rec[kChunk][kFields];
  const int t = blockIdx.x;
  Slab s;
  slab_init(s, tile_h, ntx, sub, depth_test != 0);
  const bool ran = tile_ran[t] != 0;
  if (ran) {  // uniform across the CTA
    fold_records<true>(large_ids, *large_count, rec, s_rec, s, depth_test != 0);
    if (gridDim.y > 1) {  // a slab skips the tile's records outside it
      fold_records<true>(sid + starts[t], run_counts[t], rec, s_rec, s, depth_test != 0);
    } else {
      fold_records<false>(sid + starts[t], run_counts[t], rec, s_rec, s, depth_test != 0);
    }
  }
  slab_store(s, ran, depth_test != 0, height, width, tid_out, z_out);
}

}  // namespace

extern "C" const char* xr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One launch on `stream`; allocates nothing. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a tile shape the kernel does not take (tile_w
// other than 128).
extern "C" int xr_vis_stream(
    const int* rec, const int* sid, const int* starts, const int* run_counts,
    const int* tile_ran, const int* large_ids, const int* large_count,
    int* tid_out, float* z_out, int ntiles, int height, int width, int tile_h,
    int tile_w, int ntx, int sub, int depth_test, void* stream) {
  const dim3 grid = slab_grid(ntiles, tile_h, tile_w);
  if (grid.x == 0) return (int)cudaErrorInvalidValue;
  vis_stream_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      rec, sid, starts, run_counts, tile_ran, large_ids, large_count, tid_out,
      z_out, height, width, tile_h, ntx, sub, depth_test);
  return (int)cudaGetLastError();
}
