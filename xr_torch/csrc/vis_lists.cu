// Per-tile list visibility kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel xr/raster/pallas_smem.py `_vis_kernel`
// (the `pallas_smem` backend), with its record loop `_raster_scalar_records`
// shared with the streaming kernel (fold_records.cuh).
//
// For each screen tile: clear (z, id) to (+inf, BG) — or id -1 in painter's
// order — fold the global large bucket large_ids[0 : large_count] behind a
// whole-record bbox reject, then the tile's id list
// lists[t, 0 : counts[t]], capped at bin_capacity by the binning (entries
// past the cap are counted in `dropped` there and never reach the kernel).
// Every tile runs: there is no block budget.
//
// What bounds it on the H100: as the streaming kernel, integer issue rate
// per record and pixel; records are 72 bytes, read by id from the (C, 18)
// table once per slab. The TPU kernel's SMEM record windows, their padding
// to 128 and the scalar prefetch of counts have no counterpart: a CTA reads
// its count and its list straight from device memory.

#include "fold_records.cuh"

namespace {

using namespace xr;

__global__ void __launch_bounds__(kThreads) vis_lists_kernel(
    const int* __restrict__ rec, const int* __restrict__ lists,
    const int* __restrict__ counts, const int* __restrict__ large_ids,
    const int* __restrict__ large_count, int* __restrict__ tid_out,
    float* __restrict__ z_out, int cap, int height, int width, int tile_h,
    int ntx, int sub, int depth_test) {
  __shared__ int s_rec[kChunk][kFields];
  const int t = blockIdx.x;
  Slab s;
  slab_init(s, tile_h, ntx, sub, depth_test != 0);
  fold_records<true>(large_ids, *large_count, rec, s_rec, s, depth_test != 0);
  if (gridDim.y > 1) {  // a slab skips the tile's records outside it
    fold_records<true>(lists + (size_t)t * cap, counts[t], rec, s_rec, s, depth_test != 0);
  } else {
    fold_records<false>(lists + (size_t)t * cap, counts[t], rec, s_rec, s, depth_test != 0);
  }
  slab_store(s, true, depth_test != 0, height, width, tid_out, z_out);
}

}  // namespace

// One launch on `stream`; allocates nothing. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a tile shape the kernel does not take (tile_w
// other than 128).
extern "C" int xr_vis_lists(
    const int* rec, const int* lists, const int* counts, const int* large_ids,
    const int* large_count, int* tid_out, float* z_out, int ntiles, int cap,
    int height, int width, int tile_h, int tile_w, int ntx, int sub,
    int depth_test, void* stream) {
  const dim3 grid = slab_grid(ntiles, tile_h, tile_w);
  if (grid.x == 0 || cap < 0) return (int)cudaErrorInvalidValue;
  vis_lists_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      rec, lists, counts, large_ids, large_count, tid_out, z_out, cap, height,
      width, tile_h, ntx, sub, depth_test);
  return (int)cudaGetLastError();
}
