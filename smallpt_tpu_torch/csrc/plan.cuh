// The cut of a closest-hit launch's rows into ranges that fill the card,
// shared by the brute sweeps that make one (K2, closest_hit.cu; K6,
// closest_tri.cu): the device's fit and the plan made from it.
//
// A launch has one block a ray block. Where its ray blocks would leave part
// of the blocks the card holds at once (the fill: the SMs times the
// kernel's occupancy, read once a device) idle, the rows are cut into
// ranges of whole chunks, one unit (a block) a (ray block, range): the
// fewest ranges whose units run in full-row waves within kWaveSlack of the
// ideal. Each unit writes a partial a (range, ray), and a counter a ray
// block tells the last unit to merge them; the scratch for both is the
// caller's, of the plan's size.

#pragma once

#include <cuda_runtime.h>
#include <string.h>

#include <algorithm>

// The functions are static: each kernel's library keeps its own copy, and
// its own cache of fits.
namespace smallpt {

constexpr double kWaveSlack = 0.05;  // the plan's waves over the ideal

// The SMs of a device and the blocks of one kernel each holds at once.
struct Fit {
  int n_sm, per_sm;
};

// kernel's fit on the current device (block threads a block), queried once
// a device.
template <typename Kernel>
static cudaError_t device_fit(Kernel kernel, int block, Fit* out) {
  static Fit fits[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Fit& fit = fits[dev & 63];
  if (fit.n_sm == 0) {
    int n_sm = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, block, 0)) != cudaSuccess)
      return err;
    fit.per_sm = std::max(1, per_sm);
    fit.n_sm = std::max(1, n_sm);
  }
  *out = fit;
  return cudaSuccess;
}

// One launch's cut: its ray blocks, the ranges of rows each is cut into
// (range_rows rows each, whole chunks, the last ragged), the fill and the
// int32 words of scratch the ranges need (a partial a (range, ray), then a
// counter a ray block; none for one range).
struct Plan {
  long long blocks, ranges, range_rows, fill, n_sm, per_sm, scratch_words;
};

// The plan of n rays over n_rows rows for a kernel of block_rays rays a
// block that stages chunk rows at a time and writes part_words int32 words
// a partial. forced > 0 cuts the rows into that many ranges (at most one a
// chunk) in place of the plan's own.
static inline Plan make_plan(int n, int n_rows, int forced, const Fit& fit,
                             int block_rays, int chunk, int part_words) {
  Plan p{};
  p.n_sm = fit.n_sm;
  p.per_sm = fit.per_sm;
  p.fill = (long long)fit.n_sm * fit.per_sm;
  p.blocks = (n + block_rays - 1) / block_rays;
  const long long chunks = (n_rows + chunk - 1) / chunk;
  // the fewest ranges r whose units' full-row waves, ceil(blocks * r /
  // fill) / r, come within kWaveSlack of the ideal blocks / fill (every
  // slot busy to the end); the best r up to one range a chunk if none does
  long long ranges = 1;
  if (forced > 0) {
    ranges = std::min((long long)forced, std::max(1LL, chunks));
  } else if (p.blocks > 0) {
    const double ideal = (double)p.blocks / (double)p.fill;
    double best = 0.0;
    for (long long r = 1; r <= std::max(1LL, chunks); ++r) {
      const double cost =
          (double)((p.blocks * r + p.fill - 1) / p.fill) / (double)r;
      if (r == 1 || cost < best) {
        best = cost;
        ranges = r;
      }
      if (cost <= ideal * (1.0 + kWaveSlack)) break;
    }
  }
  const long long per = std::max(1LL, (chunks + ranges - 1) / ranges);
  p.range_rows = per * chunk;
  p.ranges = std::max(1LL, (chunks + per - 1) / per);
  p.scratch_words =
      p.ranges > 1 ? (long long)part_words * p.ranges * n + p.blocks : 0;
  return p;
}

// The plan's fields as seven int64 at out, in the order of
// ops/intersect_pallas.py::PLAN_FIELDS.
static inline void write_plan(const Plan& p, void* out) {
  const long long v[7] = {p.blocks, p.ranges, p.range_rows, p.fill,
                          p.n_sm, p.per_sm, p.scratch_words};
  memcpy(out, v, sizeof(v));
}

}  // namespace smallpt
