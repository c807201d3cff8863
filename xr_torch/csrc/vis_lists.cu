// Per-tile list visibility kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel xr/raster/pallas_smem.py `_vis_kernel`
// (the `pallas_smem` backend), with its record loop `_raster_scalar_records`
// shared with the streaming kernel (fold_records.cuh).
//
// For each screen tile: clear (z, id) to (+inf, BG) — or id -1 in painter's
// order — fold the global large bucket large_ids[0 : large_count], then the
// tile's id list lists[t, 0 : counts[t]], capped at bin_capacity by the
// binning (entries past the cap are counted in `dropped` there and never
// reach the kernel). Every tile runs: there is no block budget. The TPU
// kernel's SMEM record windows, their padding to 128 and the scalar prefetch
// of counts have no counterpart: a CTA reads its item, its count and its
// list straight from device memory.
//
// What bounds it on the H100 and what the design does about it is set out
// in fold_records.cuh, as for the streaming kernel: items of 128 records
// spread over the SMs, a reject by warp footprint that makes the walk of a
// tall tile's other slabs cheap (a record is decoded only by the warps it
// touches), and a merge of a tile's chunks through a 64-bit (z, id) key. No
// tensor cores (the edges need int32 wraparound, the depth a rounding per
// operation) and no TMA for the records (gathered by id, 72 bytes each).

#include "fold_records.cuh"

// One visibility launch on `stream` (the clear kernel, then the fold
// kernel); allocates nothing. keys: (nty * tile_h, ntx * 128) 64-bit scratch,
// arrivals: ntiles * ceil(tile_h / 32) ints of scratch, neither initialised.
// Returns the launch status, or cudaErrorInvalidValue for a tile shape the
// kernel does not take (tile_w other than 128).
extern "C" int xr_vis_lists(
    const int* rec, const int* lists, const int* counts, const int* large_ids,
    const int* large_count, const int* item_tile, const int* item_start,
    unsigned long long* keys, int* arrivals, int* tid_out, float* z_out,
    int ntiles, int cap, int item_bound, int height, int width, int tile_h,
    int tile_w, int ntx, int sub, int depth_test, void* stream) {
  if (cap < 0) return (int)cudaErrorInvalidValue;
  const xr::Frame f =
      xr::make_frame(ntiles, height, width, tile_h, tile_w, ntx, sub, depth_test);
  const xr::ListWalk walk = {lists, counts, cap};
  return xr::launch_visibility<xr::ListWalk, 0>(rec, walk, large_ids, large_count,
                                               item_tile, item_start, nullptr, item_bound,
                                               keys, arrivals, nullptr, tid_out, z_out, f,
                                               (cudaStream_t)stream);
}
