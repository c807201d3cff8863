// Streaming tile visibility kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel xr/raster/pallas_stream.py `_vis_kernel`
// together with the record loop it shares, xr/raster/pallas_smem.py
// `_raster_scalar_records` (fold_records.cuh).
//
// For each screen tile: clear (z, id) to (+inf, BG) — or id -1 in painter's
// order — fold the global large bucket, then the tile's sorted bin segment
// sid[starts[t] : starts[t] + run_counts[t]]. Tiles that the stream
// capacity did not reach are written as background. The TPU's block layout
// and scalar prefetch have no counterpart here: the torch prep computes the
// block budget's outcome (run_counts, tile_ran) and the table of work items.
//
// What bounds it on the H100 and what the design does about it is set out
// in fold_records.cuh: the walk is instruction- and latency-bound, so it is
// cut into items of 128 records spread over the SMs, each warp rejects the
// records that miss its 32x8 footprint before it touches a pixel, and the
// chunks of a tile merge through a 64-bit (z, id) key. No tensor cores (the
// edges need int32 wraparound, the depth a rounding per operation) and no
// TMA for the records (gathered by id, 72 bytes each).
//
// Under z_earlyout the fold runs with the z gate (fold_records.cuh,
// zgate_fold_kernel): the chunks taken front chunks first (the prep's
// chunk-major order), and a warp skips the records whose z_min lies behind
// a bound of its whole footprint that the tile's chunks share as they run;
// under z_chunk_gate the staging drops them from the warp's walk as well.

#include "fold_records.cuh"

extern "C" const char* xr_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One visibility launch on `stream` (the clear kernel, then the fold
// kernel); allocates nothing. keys: (nty * tile_h, ntx * 128) 64-bit scratch,
// arrivals: ntiles * ceil(tile_h / 32) ints of scratch, neither initialised.
// gate: 0, 1 (z_earlyout) or 3 (and z_chunk_gate), with the depth test,
// item_order (item_bound ints: the chunk-major walk) and bounds
// (xr_zgate_words(ntiles, tile_h) words of scratch) only. Returns the launch
// status, or cudaErrorInvalidValue for a tile shape the kernel does not take
// (tile_w other than 128) or a gate it does not.
extern "C" int xr_vis_stream(
    const int* rec, const int* sid, const int* starts, const int* run_counts,
    const int* tile_ran, const int* large_ids, const int* large_count,
    const int* item_tile, const int* item_start, const int* item_order,
    unsigned long long* keys, int* arrivals, unsigned* bounds, int* tid_out, float* z_out,
    int ntiles, int item_bound, int height, int width, int tile_h, int tile_w, int ntx,
    int sub, int depth_test, int gate, void* stream) {
  const xr::Frame f =
      xr::make_frame(ntiles, height, width, tile_h, tile_w, ntx, sub, depth_test);
  const xr::StreamWalk walk = {sid, starts, run_counts, tile_ran};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (gate) {
    case 0:
      return xr::launch_visibility<xr::StreamWalk, 0>(
          rec, walk, large_ids, large_count, item_tile, item_start, nullptr, item_bound,
          keys, arrivals, nullptr, tid_out, z_out, f, st);
    case xr::kGateWalk:
      return xr::launch_visibility<xr::StreamWalk, xr::kGateWalk>(
          rec, walk, large_ids, large_count, item_tile, item_start, item_order,
          item_bound, keys, arrivals, bounds, tid_out, z_out, f, st);
    case xr::kGateWalk | xr::kGateStage:
      return xr::launch_visibility<xr::StreamWalk, xr::kGateWalk | xr::kGateStage>(
          rec, walk, large_ids, large_count, item_tile, item_start, item_order,
          item_bound, keys, arrivals, bounds, tid_out, z_out, f, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Words of scratch the gated launch takes as `bounds`.
extern "C" long long xr_zgate_words(int ntiles, int tile_h) {
  return xr::zgate_words(ntiles, tile_h);
}

#ifdef XR_GATE_COUNTS
// The probe's counters (fold_records.cuh g_gate_counts) into out[5], then
// cleared. Only a build with -DXR_GATE_COUNTS has it.
extern "C" int xr_gate_counts(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, xr::g_gate_counts, sizeof(xr::g_gate_counts));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[5] = {0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(xr::g_gate_counts, zero, sizeof(zero));
}
#endif
