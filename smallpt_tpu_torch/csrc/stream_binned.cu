// The binned scheduler's bounce for sm_90a (kernel K8): one culled,
// frontier-marching bounce of every lane of the binned streaming state.
//
// Replaces: smallpt_tpu/ops/megakernel.py::_binned_kernel (:1414-1935),
// launched there by stream_step_binned (:2268) through one pallas_call
// (:2342); entry point smallpt_stream_binned, which launches four kernels
// in order on the caller's stream: binned_compact_kernel,
// binned_plan_kernel, binned_sweep_kernel and stream_binned_kernel<kL>.
//
// Contract (ops/megakernel.py::stream_step_binned): the state is the JAX
// package's, (8 * nf, n_cols) f32 planes f and (8 * ni, n_cols) i32 planes
// i, plane p in rows 8p..8p+7, updated in place; a tile is kLaneB columns.
// The table (S_pad, 16) f32 is accel-ordered: n_glob global chunks of 8
// rows, then the local ones; rows [cx cy cz r eps | ex ey ez | ax ay az |
// refl | id ...]. Per tile t: stops[t] (the list entries to sweep, -1:
// every local chunk), lists[t, :l_max] (local chunk ids nearest first) and
// dcut[t] (the finality bound). The sweep folds, in this order, the
// global chunks and then the tile's swept chunks, 8 rows a chunk in table
// order: an alive lane's ray into its carried candidate (bt, bi) with the
// strict < of the JAX kernel, and for each NEE slot whose shadow a lane
// holds pending, the slot's direction (drawn between launches,
// ops/accel.py::nee_shadow_prep) into that slot's least candidate. Only
// those folds are read: a lane that is not alive leaves no candidate, and
// a slot without its pending bit resolves nothing. Then, as the JAX
// kernel: the deferred shadows resolve; a lane is final where bt < ts +
// dcut or its frontier left the local geometry's box; a final lane shades
// its hit (emission with NEE suppression, the environment, the AOV modes,
// roulette and the BSDF, NEE vertex marking) and a pending one carries
// (bt, bi) and marches ts += dcut. The winner's row is read directly from
// the table (col 12 is INST_ID's original id): the JAX kernel walks the
// swept chunks a second time to select it (pick_chunk, :1634-1660)
// because the TPU cannot gather a row; it is the same row, so the bits are
// the same. The per-lane formulas are lane.cuh's, shared with K1 and K3.
//
// What bounds it on an H100: the float work of the sweep, for each (item,
// swept row) pair, an item being an alive lane's ray or a pending shadow:
// ~25 ops up to the miss decision, ~38 for a pair that does not miss
// (chip_smoke.py::k8_bound counts both from the launch's own inputs); the
// state's bytes (in and out once, ~200 B a working lane, 24 B a lane
// without work) and the table are far below that at the 10,000-sphere
// scene, except in a launch where no lane works. What kept the one-kernel
// design from that bound was the shape of the work, not its amount: the
// drain's middle launches hold 1-2% of the lanes alive, spread over every
// tile, and their tiles sweep all 1,251 chunks of the scene; sweeping
// lanes in place, a warp with one working lane ran the whole sweep, and a
// few hundred warps of work left most of the 132 SMs idle. With the work
// compacted and cut, the sweep kernel's instruction issue bounds it (~99%
// of K8's device time): its ops run unfused (--fmad=false: half the rate
// the bound assumes), a square root or a division is several
// instructions, and a warp runs the hit path where one of its items hits.
//
// What the design does about it:
// - compaction (binned_compact_kernel, one block a tile): each tile's
//   working items are listed in lane order (the lane ids' order, 8 c + r
//   for row r, column c of the tile, so a group's rays come from a few
//   neighbouring pixels; a lane's primary ray first, then its pending
//   slots in slot order) with a block prefix count, so the order, and
//   with it every output, is the same on every run. A lane without an
//   item, a warp whose group holds none, does no staging and no fold;
// - the cut (binned_plan_kernel, one block): a unit of work is (tile, a
//   group of kGroup items, a range of the tile's chunk sequence). Only when
//   the groups cannot fill the card (fewer than the fill, kUnitsPerSm
//   units for each of the card's SMs, queried once a device) are the
//   sequences cut, into ranges of L chunks, L = max(kMinRange, ceil(the
//   launch's group-chunks / the fill)); the plan is a function of the
//   item counts, the stops and the fill alone, computed on the device, so
//   the launch reads nothing back to the host;
// - the sweep (binned_sweep_kernel, a persistent grid of blocks of
//   kGroup threads, the SMs times the blocks each holds, taking the units
//   in plan order from a counter): the range's rows are staged in shared memory kBatch
//   chunks at a time with cp.async into two buffers, the next batch
//   loading while this one folds; each row is read once a block and
//   broadcast to its items. Each item folds its range into (least t, its
//   row) with the strict <, rows of radius 0 skipped uniformly (never
//   hit), through the sphere test with the miss decided first
//   (sphere_tt_miss_first): a miss, most pairs, skips two square roots and
//   the division;
// - the merge and the tail (stream_binned_kernel<kL>, a thread a lane,
//   coalesced over the state's planes): each working lane folds its
//   carried candidate and its ranges' partials in range order, which is
//   the sweep order, with the strict <: the lexicographic least (t,
//   position), the same winner as one sequential fold; a slot's least t
//   is the fminf of its ranges'. Then the shadow resolution, finality,
//   shading and the march, unchanged from the one-kernel design. A lane
//   without work reads its two work planes and writes the four the tail
//   would change (a drain's tail launches are mostly such lanes);
// - the scratch (item lists, the plan, the partials) comes from the
//   wrapper, from torch's allocator, its size a function of the state's
//   shape, the slot count and the fill alone
//   (smallpt_stream_binned_scratch_words);
// - the NEE slots live in registers up to two lights (template kL = 2),
//   in local memory above (kL = 31);
// - built with --fmad=false, so each op rounds as in the JAX kernel and in
//   the plain version (ops/megakernel.py::stream_step_binned_plain).
// Not done yet (later perf work): skipping the rows of chunks that no item
// of a group can reach.
//
// Interface: plain C functions, loaded with ctypes. The entry point
// launches on the caller's stream, synchronises nothing and returns the
// first cudaGetLastError() of its four launches.

#include <algorithm>

#include "lane.cuh"

namespace {

using namespace smallpt;

constexpr int kLaneB = 1024;  // columns a tile (megakernel._LANE_B)
constexpr int kBlock = 256;   // threads a block of the merge and tail
constexpr int kSubStride = 1 << 20;  // megakernel._BINNED_SUB_STRIDE
// The sweep's constants (ops/megakernel.py::_k8_cut mirrors kGroup and
// kMinRange for the plan's plain version): items a unit (one thread
// each), chunks staged in one shared-memory buffer, the units an SM takes
// to fill the card (more than it holds at once, so that short units even
// out long ones), and the shortest range a cut makes, in chunks.
constexpr int kGroup = 64;
constexpr int kBatch = 16;
constexpr int kUnitsPerSm = 32;
constexpr int kMinRange = 8;
constexpr int kNoCut = 0x7fffffff;  // the plan's L when no sequence is cut
constexpr int kCompact = kLaneB;    // threads of a compaction block
static_assert(kCompact == 32 * 32, "block_scan: one warp scans the warps");

// The binned planes after the classic ones (ops/megakernel.py _F_BT...).
enum { F_BT = F_COUNT, F_BID, F_TS, F_NLX, F_NLY, F_NLZ, F_LD0 };
enum { I_PIXEL = I_COUNT, I_PEND, I_NEEP };
// The binned launch arguments (ops/megakernel.py::stream_step_binned).
enum { B_NCOLS, B_NGLOB, B_NCHUNKS, B_LMAX, B_SHIFT, B_MODE, B_NTILES,
       B_SCRATCH, B_COUNT };
enum { MODE_FULL, MODE_NORMAL, MODE_EMISSION, MODE_INST_ID, MODE_UV };

struct Binned {
  int i[B_COUNT];
  float geo_lo[3], geo_hi[3];
};

// The scratch, carved from the wrapper's one int32 buffer (scratch_words
// gives its size).
struct Scratch {
  int* items;      // (T, cap): a tile's item codes, (8 c + r) << 5 | kind
                   // for lane (r, c) of the tile (kind 0: the primary
                   // ray, 1 + s: slot s)
  int* lane_item;  // (8, n_cols): a lane's first item index in its tile,
                   // -1 without one
  int* n_items;    // (T,)
  int* nr;         // (T,) ranges a group of the tile
  int* unit_base;  // (T + 1,) the tile's first unit; [T]: the unit count
  int* cut;        // (1,) L, the range length in chunks (kNoCut: none)
  int* next;       // (1,) the next unit a sweep block takes
  float* part_t;   // (max_units, kGroup) a unit's least t per item
  int* part_row;   // (max_units, kGroup) its row, -1 without one
  int cap, max_units;
};

// Items a tile can hold, and units a launch can make: a function of the
// state's width, the slot count and the fill. Without a cut every unit is
// a group; with one (fewer groups than the fill, L >= group-chunks /
// fill), a tile's groups make ceil(n_seq / L) units each, fewer than the
// group-chunks / L + the groups <= 2 fill in all.
inline int tile_cap(int n_l) {
  return 8 * kLaneB * (1 + n_l);
}

inline int max_units(int n_tiles, int n_l, int fill) {
  const long long groups =
      (long long)n_tiles * ((tile_cap(n_l) + kGroup - 1) / kGroup);
  return (int)(groups > 2LL * fill ? groups : 2LL * fill);
}

inline long long scratch_words(int n_cols, int n_l, int fill) {
  const long long t = n_cols / kLaneB;
  return t * tile_cap(n_l) + 8LL * n_cols + 3 * t + 3 +
         2LL * max_units((int)t, n_l, fill) * kGroup;
}

inline Scratch carve(int* base, int n_cols, int n_l, int fill) {
  const int t = n_cols / kLaneB;
  Scratch s;
  s.cap = tile_cap(n_l);
  s.max_units = max_units(t, n_l, fill);
  s.items = base;
  s.lane_item = s.items + (size_t)t * s.cap;
  s.n_items = s.lane_item + (size_t)8 * n_cols;
  s.nr = s.n_items + t;
  s.unit_base = s.nr + t;
  s.cut = s.unit_base + t + 1;
  s.next = s.cut + 1;
  s.part_t = reinterpret_cast<float*>(s.next + 1);
  s.part_row = s.next + 1 + (size_t)s.max_units * kGroup;
  return s;
}

// The entry and exit distances of the ray through one slab of the local
// geometry's box (the JAX kernel's _slab).
__device__ __forceinline__ void slab(float o, float d, float lo, float hi,
                                     float& e, float& x) {
  const float inv = 1.0f / (fabsf(d) < 1e-20f ? 1e-20f : d);
  const float t1 = (lo - o) * inv;
  const float t2 = (hi - o) * inv;
  e = fminf(t1, t2);
  x = fmaxf(t1, t2);
}

// fract(sin(v * mult) * 43758.5453), truncated toward zero: one channel of
// the INST_ID colour (smallpt.cpp:24-29).
__device__ __forceinline__ float fract_sin(float v, float mult) {
  const float x = sinf(v * mult) * 43758.5453f;
  return x - (float)(int)x;
}

// lane.cuh::sphere_tt with the miss decided first: where det < 0 or NaN,
// or the radius is not positive, kBig before the two square roots and the
// division that only a hit needs. Otherwise the same ops in the same
// order, so the same bits (--fmad=false); sphere_tt itself, which the
// other kernels call, keeps the JAX order throughout.
__device__ __forceinline__ float sphere_tt_miss_first(
    float ox, float oy, float oz, float dx, float dy, float dz, float scx,
    float scy, float scz, float sr, float seps) {
  const float opx = scx - ox;
  const float opy = scy - oy;
  const float opz = scz - oz;
  const float b = opx * dx + opy * dy + opz * dz;
  const float fx = opx - b * dx;
  const float fy = opy - b * dy;
  const float fz = opz - b * dz;
  const float pp = fx * fx + fy * fy + fz * fz;
  const float sp = sqrtf(pp);
  const float det = (sr - sp) * (sr + sp);
  if (!(det >= 0.0f && sr > 0.0f)) return kBig;
  const float s = sqrtf(fmaxf(det, 0.0f));
  const float opn = sqrtf(b * b + pp);
  const float cc = (opn - sr) * (opn + sr);
  const float denom = b + s;
  const float t_near = denom > 0.0f ? cc / denom : -kBig;
  return t_near > seps ? t_near : (denom > seps ? denom : kBig);
}

// An exclusive prefix sum over a block of kCompact threads (n: this
// thread's count); *total gets the block's sum. Every thread calls it.
__device__ __forceinline__ int block_scan(int n, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = n;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) s_warp[w] = x;
  __syncthreads();
  if (w == 0) {
    int y = s_warp[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, off);
      if (lane >= off) y += z;
    }
    s_warp[lane] = y;  // inclusive over the warps
  }
  __syncthreads();
  const int excl = (w ? s_warp[w - 1] : 0) + x - n;
  *total = s_warp[kCompact / 32 - 1];
  __syncthreads();  // s_warp is free for the next call
  return excl;
}

// One block a tile, a thread a column: the tile's items in lane order
// (the lane ids' order: lane (r, c) of the tile is 8 c + r), each lane's
// first item index, the tile's item count.
__global__ void __launch_bounds__(kCompact)
    binned_compact_kernel(const int* __restrict__ st, int n_cols, int n_l,
                          Scratch s) {
  __shared__ int s_warp[32];
  const int tile = blockIdx.x;
  const int c = threadIdx.x;
  const size_t stride = (size_t)8 * n_cols;
  const size_t col = (size_t)tile * kLaneB + c;
  const int mask = (int)((1u << n_l) - 1u);
  int alive[8], neep[8], n = 0;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const size_t lane = r * (size_t)n_cols + col;
    alive[r] = st[I_ALIVE * stride + lane] != 0 ? 1 : 0;
    neep[r] = n_l ? st[I_NEEP * stride + lane] & mask : 0;
    n += alive[r] + __popc(neep[r]);
  }
  int total;
  int k = block_scan(n, s_warp, &total);
  int* const items = s.items + (size_t)tile * s.cap;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int code = (8 * c + r) << 5;
    s.lane_item[r * (size_t)n_cols + col] =
        alive[r] || neep[r] ? k : -1;
    if (alive[r]) items[k++] = code;
    for (int b = neep[r]; b; b &= b - 1) items[k++] = code | __ffs(b);
  }
  if (c == 0) s.n_items[tile] = total;
}

// One block: the cut and each tile's units (see the header), for a card
// filled by `fill` units.
__global__ void __launch_bounds__(kCompact)
    binned_plan_kernel(const int* __restrict__ stops, int n_tiles,
                       int n_glob, int n_chunks, int fill, Scratch s) {
  __shared__ int s_warp[32];
  __shared__ long long s_sum[2][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  long long groups = 0, work = 0;
  for (int t = threadIdx.x; t < n_tiles; t += kCompact) {
    const int g = (s.n_items[t] + kGroup - 1) / kGroup;
    const int stop = stops[t];
    groups += g;
    work += (long long)g * (n_glob + (stop < 0 ? n_chunks : stop));
  }
  for (int off = 16; off > 0; off >>= 1) {
    groups += __shfl_down_sync(0xffffffffu, groups, off);
    work += __shfl_down_sync(0xffffffffu, work, off);
  }
  if (lane == 0) {
    s_sum[0][w] = groups;
    s_sum[1][w] = work;
  }
  __syncthreads();
  long long n_groups = 0, n_work = 0;
  for (int k = 0; k < kCompact / 32; ++k) {
    n_groups += s_sum[0][k];
    n_work += s_sum[1][k];
  }
  long long cut = kNoCut;
  if (n_groups < fill) {
    cut = (n_work + fill - 1) / fill;
    if (cut < kMinRange) cut = kMinRange;
  }
  const int L = (int)cut;
  int run = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += kCompact) {
    const int t = t0 + threadIdx.x;
    int units = 0;
    if (t < n_tiles) {
      const int g = (s.n_items[t] + kGroup - 1) / kGroup;
      const int stop = stops[t];
      const int n_seq = n_glob + (stop < 0 ? n_chunks : stop);
      const int nr = (g == 0 || n_seq <= 0) ? 0
                     : L == kNoCut            ? 1
                                              : (n_seq + L - 1) / L;
      s.nr[t] = nr;
      units = g * nr;
    }
    int total;
    const int base = run + block_scan(units, s_warp, &total);
    if (t < n_tiles) s.unit_base[t] = base;
    run += total;
  }
  if (threadIdx.x == 0) {
    s.unit_base[n_tiles] = run;
    *s.cut = L;
    *s.next = 0;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(gmem));
}

// A barrier over the first n threads of the block (whole warps): the
// warps of a unit that hold items, the others having returned.
__device__ __forceinline__ void bar_active(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

struct SweepArgs {
  int n_cols, n_glob, n_chunks, l_max, n_tiles;
};

// A persistent grid (the SMs times the blocks each holds) whose blocks
// take the plan's units in order from a counter, each its items' rays
// folded over its range of the tile's chunk sequence into (least t, its
// row), the partials of the merge.
__global__ void __launch_bounds__(kGroup)
    binned_sweep_kernel(const float* __restrict__ table,
                        const float* __restrict__ f,
                        const int* __restrict__ lists,
                        const int* __restrict__ stops, Scratch s,
                        SweepArgs a) {
  __shared__ float4 s_row[2][kBatch * 8];
  __shared__ float s_eps[2][kBatch * 8];
  __shared__ int s_id[2][kBatch * 8];
  __shared__ int s_unit;
  const int n_units = s.unit_base[a.n_tiles];
  const int L = *s.cut;
  const size_t stride = (size_t)8 * a.n_cols;
  for (;;) {
    if (threadIdx.x == 0) s_unit = atomicAdd(s.next, 1);
    __syncthreads();
    const int u = s_unit;
    if (u >= n_units) break;
    // the unit's tile: the last t with unit_base[t] <= u (a tile without
    // units shares its base with the next)
    int lo = 0, hi = a.n_tiles;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s.unit_base[mid] <= u) lo = mid;
      else hi = mid;
    }
    const int tile = lo;
    const int nr = s.nr[tile];
    const int local = u - s.unit_base[tile];
    const int g = local / nr;
    const int r = local - g * nr;
    const int k0 = g * kGroup;
    const int n = min(kGroup, s.n_items[tile] - k0);
    // the warps that hold items stage and fold; the others wait for the
    // next unit
    if ((int)(threadIdx.x & ~31) < n) {
      const int n_thr = (n + 31) & ~31;
      const bool has = (int)threadIdx.x < n;
      const int stop = stops[tile];
      const bool full = stop < 0;
      const int n_seq = a.n_glob + (full ? a.n_chunks : stop);
      const int c_beg = L == kNoCut ? 0 : r * L;
      const int c_end = L == kNoCut ? n_seq : min(n_seq, c_beg + L);
      const int* list = lists + (size_t)tile * a.l_max;

      float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f,
            dz = 0.0f;
      if (has) {
        const int code = s.items[(size_t)tile * s.cap + k0 + threadIdx.x];
        const int lt = code >> 5, kind = code & 31;
        const float* fl = f + (size_t)(lt & 7) * a.n_cols +
                          (size_t)tile * kLaneB + (lt >> 3);
        ox = fl[F_OX * stride];
        oy = fl[F_OY * stride];
        oz = fl[F_OZ * stride];
        const int p = kind ? F_LD0 + 3 * (kind - 1) : F_DX;
        dx = fl[p * stride];
        dy = fl[(p + 1) * stride];
        dz = fl[(p + 2) * stride];
      }

      // stage the batch from chunk c of the sequence into buffer b
      auto stage = [&](int c, int b) {
        const int n_rows = 8 * min(kBatch, c_end - c);
        for (int k = threadIdx.x; k < n_rows; k += n_thr) {
          const int j = c + (k >> 3);
          const int lc = j - a.n_glob;
          const int cid =
              j < a.n_glob ? j
                           : a.n_glob + (full ? lc
                                              : list[min(lc, a.l_max - 1)]);
          const int row = 8 * cid + (k & 7);
          cp_async16(&s_row[b][k], table + 16 * (size_t)row);
          cp_async4(&s_eps[b][k], table + 16 * (size_t)row + 4);
          s_id[b][k] = row;
        }
        asm volatile("cp.async.commit_group;\n" ::);
      };

      float bt = kBig;
      int brow = -1;
      if (c_beg < c_end) stage(c_beg, 0);
      for (int c = c_beg, b = 0; c < c_end; c += kBatch, b ^= 1) {
        if (c + kBatch < c_end) stage(c + kBatch, b ^ 1);
        else asm volatile("cp.async.commit_group;\n" ::);
        asm volatile("cp.async.wait_group 1;\n" ::);
        bar_active(n_thr);  // every thread's copies of this batch landed
        if (has) {
          const int n_rows = 8 * min(kBatch, c_end - c);
          for (int k = 0; k < n_rows; ++k) {
            const float4 q = s_row[b][k];
            if (!(q.w > 0.0f)) continue;
            const float tt = sphere_tt_miss_first(
                ox, oy, oz, dx, dy, dz, q.x, q.y, q.z, q.w, s_eps[b][k]);
            if (tt < bt) {
              bt = tt;
              brow = s_id[b][k];
            }
          }
        }
        bar_active(n_thr);  // the batch's readers are done with buffer b
      }
      asm volatile("cp.async.wait_all;\n" ::);
      if (has) {
        const size_t o = (size_t)u * kGroup + threadIdx.x;
        s.part_t[o] = bt;
        s.part_row[o] = brow;
      }
    }
    __syncthreads();  // every warp, before the next unit's s_unit
  }
}

// One working lane's bounce (alive, or holding a pending shadow): the
// merge, then the per-lane tail. Returns whether the lane finalized.
template <int kL>
__device__ __forceinline__ bool lane_bounce(
    const float* __restrict__ table, float* const fl, int* const il,
    size_t stride, size_t lane, int tile, bool alive, int neep,
    const float* __restrict__ dcut, const Scratch& sc, const Params& p,
    const Binned& b) {
  constexpr int kSlots = kL > 0 ? kL : 1;
  const int mode = b.i[B_MODE];
  const int n_l = kL > 0 ? p.i[IP_N_LIGHTS] : 0;

  float ox = fl[F_OX * stride], oy = fl[F_OY * stride],
        oz = fl[F_OZ * stride];
  float dx = fl[F_DX * stride], dy = fl[F_DY * stride],
        dz = fl[F_DZ * stride];
  float wx = fl[F_WX * stride], wy = fl[F_WY * stride],
        wz = fl[F_WZ * stride];
  float rx = fl[F_RX * stride], ry = fl[F_RY * stride],
        rz = fl[F_RZ * stride];
  float bt = fl[F_BT * stride], bi = fl[F_BID * stride];
  const float ts = fl[F_TS * stride];
  int depth = il[I_DEPTH * stride];
  const int s_idx = il[I_SIDX * stride];
  const int q = il[I_PIXEL * stride];
  const int sup = il[I_SUP * stride];
  float ld[kSlots][3], sbt[kSlots];
#pragma unroll 2
  for (int s = 0; s < kSlots; ++s) {
    sbt[s] = kBig;
    ld[s][0] = ld[s][1] = ld[s][2] = 0.0f;
    if (s < n_l) {
      ld[s][0] = fl[(F_LD0 + 3 * s) * stride];
      ld[s][1] = fl[(F_LD0 + 3 * s + 1) * stride];
      ld[s][2] = fl[(F_LD0 + 3 * s + 2) * stride];
    }
  }

  // ---- the merge: the carried candidate, then each range's partial in
  // range order (the sweep order) with the strict <; a slot's least t ------
  const int k_first = sc.lane_item[lane];
  if (k_first >= 0) {
    const int nr = sc.nr[tile];
    const int ub = sc.unit_base[tile];
    int k = k_first;
    if (alive) {
      const size_t o0 = (size_t)(ub + (k / kGroup) * nr) * kGroup +
                        k % kGroup;
      for (int r = 0; r < nr; ++r) {
        const float pt = sc.part_t[o0 + (size_t)r * kGroup];
        if (pt < bt) {
          bt = pt;
          bi = (float)sc.part_row[o0 + (size_t)r * kGroup];
        }
      }
      ++k;
    }
#pragma unroll 2
    for (int s = 0; s < kSlots; ++s) {
      if (s >= n_l || !((neep >> s) & 1)) continue;
      const size_t o0 = (size_t)(ub + (k / kGroup) * nr) * kGroup +
                        k % kGroup;
      for (int r = 0; r < nr; ++r)
        sbt[s] = fminf(sbt[s], sc.part_t[o0 + (size_t)r * kGroup]);
      ++k;
    }
  }

  // ---- deferred shadow resolution (the bits were set at the previous
  // vertex, whose throughput the weight planes still hold) -----------------
  float vnl[3] = {0.0f, 0.0f, 0.0f};
  if (kL > 0) {
    vnl[0] = fl[F_NLX * stride];
    vnl[1] = fl[F_NLY * stride];
    vnl[2] = fl[F_NLZ * stride];
  }
#pragma unroll 2
  for (int s = 0; s < kSlots; ++s) {
    if (s >= n_l || !((neep >> s) & 1)) continue;
    const float* lrow = table + 16 * p.lights[s];
    const float lcx = lrow[0], lcy = lrow[1], lcz = lrow[2], lrr = lrow[3];
    const float t_light = sphere_tt(ox, oy, oz, ld[s][0], ld[s][1],
                                    ld[s][2], lcx, lcy, lcz, lrr, lrow[4]);
    const float swx = lcx - ox;
    const float swy = lcy - oy;
    const float swz = lcz - oz;
    const float d2 = swx * swx + swy * swy + swz * swz;
    const float cos_a_max =
        sqrtf(fmaxf(1.0f - (lrr * lrr) / fmaxf(d2, 1e-12f), 0.0f));
    const float omega = kTwoPi * (1.0f - cos_a_max);
    const float cosine = fmaxf(
        ld[s][0] * vnl[0] + ld[s][1] * vnl[1] + ld[s][2] * vnl[2], 0.0f);
    if (t_light < kBig && sbt[s] >= t_light) {
      const float scale = cosine * omega * kInvPi;
      rx = rx + wx * lrow[5] * scale;
      ry = ry + wy * lrow[6] * scale;
      rz = rz + wz * lrow[7] * scale;
    }
  }

  // ---- finality: the swept prefix bounds the hit, or the frontier left
  // the local geometry (the globals are folded every launch) ---------------
  float e1, x1, e2, x2, e3, x3;
  slab(ox, dx, b.geo_lo[0], b.geo_hi[0], e1, x1);
  slab(oy, dy, b.geo_lo[1], b.geo_hi[1], e2, x2);
  slab(oz, dz, b.geo_lo[2], b.geo_hi[2], e3, x3);
  const float t_enter = fmaxf(e1, fmaxf(e2, e3));
  const float t_exit = fminf(x1, fminf(x2, x3));
  const bool escaped = ts >= t_exit || t_enter > t_exit;
  const float d_cut = dcut[tile];
  const bool final_ = alive && (bt < ts + d_cut || escaped);
  const bool pend = alive && !final_;
  const bool hit = bt < kBig;
  const bool live_hit = final_ && hit;

  // the winner's row (a miss reads nothing: every use is masked by hit)
  float em[3] = {0.0f, 0.0f, 0.0f}, al[3] = {0.0f, 0.0f, 0.0f};
  float bc[3] = {0.0f, 0.0f, 0.0f}, refl = 1.0f, inst = -1.0f;
  if (hit) {
    const float* w = table + 16 * (int)bi;
    bc[0] = w[0];
    bc[1] = w[1];
    bc[2] = w[2];
    em[0] = w[5];
    em[1] = w[6];
    em[2] = w[7];
    al[0] = w[8];
    al[1] = w[9];
    al[2] = w[10];
    refl = w[11];
    inst = w[12];
  }
  if (p.i[IP_HAS_ENV] != 0 && mode == MODE_FULL && final_ && !hit) {
    // a lane finalizing as a miss picks up the environment
    rx = rx + wx * p.f[FP_ENV_R];
    ry = ry + wy * p.f[FP_ENV_G];
    rz = rz + wz * p.f[FP_ENV_B];
  }
  const float hx = ox + bt * dx;
  const float hy = oy + bt * dy;
  const float hz = oz + bt * dz;
  float nx = 1.0f, ny = 0.0f, nz = 0.0f;
  if (hit) {
    nx = hx - bc[0];
    ny = hy - bc[1];
    nz = hz - bc[2];
  }
  normalize3(nx, ny, nz);
  float nlx = nx, nly = ny, nlz = nz;
  if (p.i[IP_FLIP] != 0 && !(nx * dx + ny * dy + nz * dz < 0.0f)) {
    nlx = -nx;
    nly = -ny;
    nlz = -nz;
  }

  bool parent = false;
  int new_sup = 0;
  float nox = 0.0f, noy = 0.0f, noz = 0.0f;
  Shade sh;
  if (mode == MODE_FULL) {
    // emission whose light the previous vertex sampled is suppressed
    bool em_keep = live_hit;
#pragma unroll 2
    for (int s = 0; s < kSlots; ++s) {
      if (s < n_l && bi == (float)p.lights[s] && ((sup >> s) & 1))
        em_keep = false;
    }
    if (em_keep) {
      rx = rx + wx * em[0];
      ry = ry + wy * em[1];
      rz = rz + wz * em[2];
    }
    if (live_hit) {
      const int shift = b.i[B_SHIFT];
      const int pix = (int)((unsigned)q >> shift);
      int ip = p.i[IP_IP_OFFSET] + s_idx;
      if (shift) ip += (q - (pix << shift)) * kSubStride;
      const uint32_t k0 = (uint32_t)p.i[IP_K0], k1 = (uint32_t)p.i[IP_K1];
      uint32_t sa = (uint32_t)pix ^ k0;
      uint32_t sb = k1 ^ ((uint32_t)ip * kStreamIpMult);
      uint32_t sc = (uint32_t)depth + kGolden, sd = k0 + k1;
      pcg4d(sa, sb, sc, sd);
      sh = shade(p, dx, dy, dz, nx, ny, nz, nlx, nly, nlz, al[0], al[1],
                 al[2], refl, to_unit(sa), to_unit(sb), to_unit(sc),
                 to_unit(sd), depth);
      parent = sh.survive;
      nox = hx + sh.eps_off * nlx;
      noy = hy + sh.eps_off * nly;
      noz = hz + sh.eps_off * nlz;
    }
    // a surviving diffuse vertex outside a light's shell marks its slot;
    // the shadow is drawn and traced at the next launch
#pragma unroll 2
    for (int s = 0; s < kSlots; ++s) {
      if (s >= n_l || !(parent && sh.diffuse)) continue;
      const float* lrow = table + 16 * p.lights[s];
      const float vswx = lrow[0] - nox;
      const float vswy = lrow[1] - noy;
      const float vswz = lrow[2] - noz;
      const float vd2 = vswx * vswx + vswy * vswy + vswz * vswz;
      if (!(vd2 <= lrow[3] * lrow[3])) new_sup |= 1 << s;
    }
  } else if (live_hit) {
    // the AOV modes record at the lane's first final vertex and end it
    float av[3];
    if (mode == MODE_NORMAL) {
      av[0] = nlx;
      av[1] = nly;
      av[2] = nlz;
    } else if (mode == MODE_EMISSION) {
      av[0] = wx * em[0];
      av[1] = wy * em[1];
      av[2] = wz * em[2];
    } else if (mode == MODE_INST_ID) {
      const float oid1 = inst + 1.0f;
      av[0] = fract_sin(oid1, 12.9898f);
      av[1] = fract_sin(oid1, 78.233f);
      av[2] = fract_sin(oid1, 56.128f);
    } else {
      const float phi = atan2_poly(nx, nz);
      av[0] = (phi < 0.0f ? phi + kTwoPi : phi) / kTwoPi;
      av[1] = asin_poly(ny) * kInvPi + 0.5f;
      av[2] = 0.0f;
    }
    rx = rx + av[0];
    ry = ry + av[1];
    rz = rz + av[2];
  }

  if (parent) {
    ox = nox;
    oy = noy;
    oz = noz;
    dx = sh.ndx;
    dy = sh.ndy;
    dz = sh.ndz;
    wx = wx * sh.fx;
    wy = wy * sh.fy;
    wz = wz * sh.fz;
  }
  if (final_) ++depth;
  const bool alive_out = pend || (parent && depth < p.i[IP_MAX_DEPTH]);

  fl[F_OX * stride] = ox;
  fl[F_OY * stride] = oy;
  fl[F_OZ * stride] = oz;
  fl[F_DX * stride] = dx;
  fl[F_DY * stride] = dy;
  fl[F_DZ * stride] = dz;
  fl[F_WX * stride] = wx;
  fl[F_WY * stride] = wy;
  fl[F_WZ * stride] = wz;
  fl[F_RX * stride] = rx;
  fl[F_RY * stride] = ry;
  fl[F_RZ * stride] = rz;
  // a pending lane carries its candidate and marches its frontier; every
  // other lane resets for its next ray
  fl[F_BT * stride] = pend ? bt : kBig;
  fl[F_BID * stride] = pend ? bi : -1.0f;
  fl[F_TS * stride] = pend ? ts + d_cut : 0.0f;
  il[I_DEPTH * stride] = depth;
  il[I_ALIVE * stride] = alive_out ? 1 : 0;
  il[I_RAYS * stride] += final_ ? 1 : 0;
  il[I_PEND * stride] = pend ? 1 : 0;
  if (kL > 0) {
    // sup persists to the next shading event; neep is consumed above
    il[I_SUP * stride] = final_ ? new_sup : sup;
    il[I_NEEP * stride] = final_ ? new_sup : 0;
    if (final_) {
      fl[F_NLX * stride] = nlx;
      fl[F_NLY * stride] = nly;
      fl[F_NLZ * stride] = nlz;
    }
  }
  return final_;
}

// The merge and the per-lane tail, a thread a lane. A lane without work
// (not alive, no pending shadow) finalizes nothing and moves nothing: of
// its planes only the carried candidate, the frontier and the pending bit
// change (to kBig, -1, 0 and 0, as the tail would write them), so it
// reads and writes those alone.
template <int kL>
__global__ void __launch_bounds__(kBlock)
    stream_binned_kernel(const float* __restrict__ table, float* f, int* st,
                         const float* __restrict__ dcut,
                         unsigned long long* rays, Scratch sc, Params p,
                         Binned b) {
  const int n_cols = b.i[B_NCOLS];
  const int col = blockIdx.x * kBlock + threadIdx.x;
  const int tile = blockIdx.x * kBlock / kLaneB;
  const size_t lane = (size_t)blockIdx.y * n_cols + col;
  const size_t stride = (size_t)8 * n_cols;
  float* const fl = f + lane;
  int* const il = st + lane;
  const bool alive = il[I_ALIVE * stride] != 0;
  const int neep = kL > 0 ? il[I_NEEP * stride] : 0;
  bool final_ = false;
  if (alive || neep != 0) {
    final_ = lane_bounce<kL>(table, fl, il, stride, lane, tile, alive, neep,
                             dcut, sc, p, b);
  } else {
    fl[F_BT * stride] = kBig;
    fl[F_BID * stride] = -1.0f;
    fl[F_TS * stride] = 0.0f;
    il[I_PEND * stride] = 0;
  }
  add_rays(rays, final_ ? 1 : 0);
}

// The current device's fill (the plan's target: kUnitsPerSm units an SM)
// and the sweep's resident blocks (the SMs times the blocks each holds),
// queried once a device.
struct Fit {
  int fill, resident;
};

inline cudaError_t device_fit(Fit* out) {
  static Fit fits[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Fit& fit = fits[dev & 63];
  if (fit.fill == 0) {
    int n_sm = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, binned_sweep_kernel, kGroup, 0)) != cudaSuccess)
      return err;
    fit.resident = std::max(1, n_sm * per_sm);
    fit.fill = std::max(1, n_sm) * kUnitsPerSm;
  }
  *out = fit;
  return cudaSuccess;
}

// The compaction and the plan of one launch (the sweep reads their
// scratch).
inline cudaError_t plan(const int* i, const int* stops, int n_cols, int n_l,
                        int n_glob, int n_chunks, int fill,
                        const Scratch& sc, cudaStream_t stream) {
  const int n_tiles = n_cols / kLaneB;
  binned_compact_kernel<<<n_tiles, kCompact, 0, stream>>>(i, n_cols, n_l,
                                                          sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  binned_plan_kernel<<<1, kCompact, 0, stream>>>(stops, n_tiles, n_glob,
                                                 n_chunks, fill, sc);
  return cudaGetLastError();
}

template <int kL>
cudaError_t launch(const float* table, float* f, int* i, const int* stops,
                   const int* lists, const float* dcut,
                   unsigned long long* rays, const Scratch& sc,
                   const Params& p, const Binned& b, const Fit& fit,
                   cudaStream_t stream) {
  const int n_cols = b.i[B_NCOLS], n_tiles = b.i[B_NTILES];
  cudaError_t err = plan(i, stops, n_cols, kL > 0 ? p.i[IP_N_LIGHTS] : 0,
                         b.i[B_NGLOB], b.i[B_NCHUNKS], fit.fill, sc, stream);
  if (err != cudaSuccess) return err;
  const SweepArgs a{n_cols, b.i[B_NGLOB], b.i[B_NCHUNKS], b.i[B_LMAX],
                    n_tiles};
  const int blocks = std::min(sc.max_units, fit.resident);
  binned_sweep_kernel<<<blocks, kGroup, 0, stream>>>(table, f, lists, stops,
                                                     sc, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid(n_cols / kBlock, 8);
  stream_binned_kernel<kL><<<grid, kBlock, 0, stream>>>(table, f, i, dcut,
                                                        rays, sc, p, b);
  return cudaGetLastError();
}

}  // namespace

// The int32 words of scratch that smallpt_stream_binned needs on the
// current device for a state of n_cols columns and n_lights NEE slots
// (the wrapper, ops/megakernel.py::stream_step_binned, sizes its scratch
// by it); -1 if the device cannot be queried.
extern "C" long long smallpt_stream_binned_scratch_words(int n_cols,
                                                         int n_lights) {
  Fit fit;
  if (device_fit(&fit) != cudaSuccess) return -1;
  return scratch_words(n_cols, n_lights, fit.fill);
}

// One binned bounce over the state f (8 * nf, n_cols) f32 and i (8 * ni,
// n_cols) i32, in place. table: the accel-ordered (S_pad, 16) f32 table;
// stops (T,) i32, lists (T, l_max) i32, dcut (T,) f32, T = n_cols / 1024;
// rays: one u64 on the device that gains the lanes this launch finalized
// (the caller zeroes it); scratch: bparams_i[B_SCRATCH] int32 words on the
// device, at least smallpt_stream_binned_scratch_words(n_cols, n_lights)
// on this device (nothing in it is read before this launch writes it).
// iparams/fparams:
// the megakernel's launch arguments (lane.cuh IP_*/FP_*; the light slots
// hold the NEE lights' table rows); bparams_i: {n_cols, n_glob, n_chunks,
// l_max, log2 inflight, mode, n_tiles, scratch words}; bparams_f:
// {geo_lo[3], geo_hi[3]}; stream: a cudaStream_t. Returns the first
// cudaGetLastError() of the four launches.
extern "C" int smallpt_stream_binned(const void* table, void* f, void* i,
                                     const void* stops, const void* lists,
                                     const void* dcut, void* rays,
                                     void* scratch, const void* iparams,
                                     const void* fparams,
                                     const void* bparams_i,
                                     const void* bparams_f, void* stream) {
  const Params p = read_params(iparams, fparams);
  Binned b;
  memcpy(b.i, bparams_i, sizeof(b.i));
  memcpy(b.geo_lo, bparams_f, sizeof(b.geo_lo));
  memcpy(b.geo_hi, (const float*)bparams_f + 3, sizeof(b.geo_hi));
  const int n_l = p.i[IP_N_LIGHTS];
  Fit fit;
  const cudaError_t err = device_fit(&fit);
  if (err != cudaSuccess) return (int)err;
  if (b.i[B_NCOLS] <= 0 || b.i[B_NCOLS] % kLaneB ||
      b.i[B_NTILES] != b.i[B_NCOLS] / kLaneB || b.i[B_NGLOB] < 0 ||
      b.i[B_NCHUNKS] < 0 || b.i[B_LMAX] < 1 || b.i[B_SHIFT] < 0 ||
      b.i[B_SHIFT] > 6 || b.i[B_MODE] < MODE_FULL || b.i[B_MODE] > MODE_UV ||
      n_l < 0 || n_l > kMaxLights ||
      b.i[B_SCRATCH] < scratch_words(b.i[B_NCOLS], n_l, fit.fill))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Scratch sc = carve((int*)scratch, b.i[B_NCOLS], n_l, fit.fill);
  auto* t = (const float*)table;
  auto* ff = (float*)f;
  auto* ii = (int*)i;
  auto* sp = (const int*)stops;
  auto* lp = (const int*)lists;
  auto* dp = (const float*)dcut;
  auto* rp = (unsigned long long*)rays;
  if (n_l == 0)
    return (int)launch<0>(t, ff, ii, sp, lp, dp, rp, sc, p, b, fit, s);
  if (n_l <= 2)
    return (int)launch<2>(t, ff, ii, sp, lp, dp, rp, sc, p, b, fit, s);
  return (int)launch<kMaxLights>(t, ff, ii, sp, lp, dp, rp, sc, p, b, fit,
                                        s);
}
