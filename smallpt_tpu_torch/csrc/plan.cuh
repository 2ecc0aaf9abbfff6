// The cut of a closest-hit launch's rows into ranges that fill the card,
// shared by the brute sweeps that make one (K2, closest_hit.cu; K5,
// closest_hit_mxu.cu; K6, closest_tri.cu): the device's fit and the plan
// made from it, and the device side those sweeps share: a thread's rays,
// the places of a chunk's live rows as a block stages them, and the end of
// a unit, where the partials of a cut launch are merged.
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

// The index of ray j of this thread in a launch of kRays rays a thread
// (blockIdx.x the ray block, whose ray j * kBlock + threadIdx.x it is).
template <int kBlock, int kRays>
__device__ __forceinline__ int ray_index(int j) {
  return blockIdx.x * kBlock * kRays + j * kBlock + threadIdx.x;
}

// The thread's kRays rays, read coalesced from (3, n) planes; a ray past
// the last is a finite dummy (o = 0, d = +x), traced and not written.
template <int kBlock, int kRays>
__device__ __forceinline__ void load_rays(
    const float* __restrict__ org, const float* __restrict__ dir, int n,
    float (&ox)[kRays], float (&oy)[kRays], float (&oz)[kRays],
    float (&dx)[kRays], float (&dy)[kRays], float (&dz)[kRays]) {
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int i = ray_index<kBlock, kRays>(j);
    const bool ray = i < n;
    ox[j] = ray ? org[i] : 0.0f;
    oy[j] = ray ? org[n + i] : 0.0f;
    oz[j] = ray ? org[2 * n + i] : 0.0f;
    dx[j] = ray ? dir[i] : 1.0f;
    dy[j] = ray ? dir[n + i] : 0.0f;
    dz[j] = ray ? dir[2 * n + i] : 0.0f;
  }
}

// The places of one chunk's rows as a block of kWarps warps stages its
// live ones in shared memory, in row order: each thread holds two of the
// chunk's rows (h = 0, 1: row h * blockDim.x + threadIdx.x), live[h] where
// row h is staged and first[h] where it is of the class that precedes the
// others in row order (part A's rows, the slots below n_a). Sets at[h],
// the place of a live row h (the live rows before it, from the warps'
// ballots), m, the chunk's live rows, and m_first, those of the first
// class. s_warp: 4 * kWarps ints of shared memory. Syncs the block before
// it writes s_warp (the previous chunk's readers are done) and after; the
// caller syncs again once it has written its rows.
template <int kWarps>
__device__ __forceinline__ void stage_places(const bool (&live)[2],
                                             const bool (&first)[2],
                                             int* s_warp, int (&at)[2],
                                             int& m, int& m_first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned ball[2], ball_first[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ball[h] = __ballot_sync(0xffffffffu, live[h]);
    ball_first[h] = __ballot_sync(0xffffffffu, live[h] && first[h]);
  }
  __syncthreads();
  if (lane == 0) {
    s_warp[warp] = __popc(ball[0]);
    s_warp[kWarps + warp] = __popc(ball[1]);
    s_warp[2 * kWarps + warp] = __popc(ball_first[0]);
    s_warp[3 * kWarps + warp] = __popc(ball_first[1]);
  }
  __syncthreads();
  int off[2] = {0, 0};
  m = 0;
  m_first = 0;
#pragma unroll
  for (int e = 0; e < 2 * kWarps; ++e) {
    if (e == warp) off[0] = m;
    if (e == kWarps + warp) off[1] = m;
    m += s_warp[e];
    m_first += s_warp[2 * kWarps + e];
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int h = 0; h < 2; ++h) at[h] = off[h] + __popc(ball[h] & below);
}

// The end of one unit (a (ray block, range)) of a launch cut by make_plan,
// kRays rays a thread: best[j], ray j's best over the unit's range with
// its t in .x (P: float2 or float4, the rest the winner's fields). One
// range: each ray's best is its answer, handed to out(i, best). Several:
// the unit writes its partials (part: one a (range, ray)), and the last
// unit of the ray block to finish (done: a counter a ray block, zeroed on
// the stream before the launch) folds them in range order with the strict
// < on t, which keeps the earliest range's on a tie and so the winner of
// the sequential fold over the rows, and hands each ray's to out. s_last:
// an int of shared memory.
template <int kBlock, int kRays, typename P, typename Out>
__device__ __forceinline__ void finish_unit(const P (&best)[kRays], P* part,
                                            int* done, int n, int* s_last,
                                            Out out) {
  if (gridDim.y == 1) {
#pragma unroll
    for (int j = 0; j < kRays; ++j) {
      const int i = ray_index<kBlock, kRays>(j);
      if (i < n) out(i, best[j]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int i = ray_index<kBlock, kRays>(j);
    if (i < n) part[(size_t)blockIdx.y * n + i] = best[j];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *s_last = atomicAdd(done + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int i = ray_index<kBlock, kRays>(j);
    if (i >= n) continue;
    P b = __ldcg(part + i);
    for (int r = 1; r < (int)gridDim.y; ++r) {
      const P p = __ldcg(part + (size_t)r * n + i);
      if (p.x < b.x) b = p;
    }
    out(i, b);
  }
}

}  // namespace smallpt
