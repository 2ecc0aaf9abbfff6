// Per-ray DDA closest-hit sphere kernel for sm_90a (kernel K4): the closest
// (t, code) of every ray, found by walking the ray through a uniform grid
// of sphere lists.
//
// Replaces: smallpt_tpu/ops/dda.py::_dda_kernel, launched there by
// _closest_hit_dda through one pallas_call; entry point smallpt_dda, kernel
// dda_kernel; the launch's first wave, smallpt_dda_plan.
//
// Contract (ops/dda.py::closest_hit_dda): org and dir are (3, N) f32 planes;
// part_a is the first 128 rows of the two-part sphere table, [cx cy cz r eps
// 0 0 0]; overflow is (F, 8) [cx cy cz r eps id 0 0]; cells is (C, K, 8),
// slot q of cell c [cx cy cz r id 0 0 0], filled from the front, an empty
// slot's id 3e38 (geom, (C, K) [cx cy cz r], and count, (C,) filled slots,
// are derived from it: ops/dda.py::slot_tables). Per ray, op for op the
// JAX kernel:
// 1. part A in the stable citardauq form (lane.cuh::sphere_tt, as K2's
//    closest_hit.cu sweeps it), the first slot attaining the least t;
// 2. the overflow rows in the direct quadratic (lane.cuh::sphere_tt_fast),
//    folded on (t, original id);
// 3. the walk: clip the ray to the grid box (directions below 1e-20 on an
//    axis are kept off zero), take the entry cell by truncating f32 to i32
//    and clamping, then at most nx + ny + nz + 3 steps, each testing the
//    cell's slots in the direct quadratic at the uniform local eps and
//    folding them on (t, id), ending once min(part A's t, the fold's t) is
//    no further than the cell's exit t, else stepping the axis of least
//    next crossing (ties to x, then y), ending when the ray leaves the grid;
// 4. part A wins a tie; code = an original id when a local or overflow
//    sphere wins, -(slot + 1) when part-A slot wins, 0 on a miss (t 3e38).
// The TPU kernel steps 1024-lane tiles in lockstep until the tile's last
// lane ends; a lane inactive there updates nothing, so each ray's answer
// depends on its own ray and the grid alone, whichever thread walks it and
// when. The JAX kernel's block folds (a chunk's least t, then its least
// id) equal the (t, id) fold, and its empty slots (r = 0) never win.
//
// What bounds it on an H100: float work. Every ray tests part A's live
// rows (all 128 on procedural_sphere_scene(10000): the 7 walls and the
// first 121 small spheres) and the filled slots of each cell it visits
// (48-96 a cell at occ 16-48, about 2-3 cells a bounce ray).
// chip_smoke.py::k4_bound counts the pairs this run's rays test (the plain
// version walks the same cells) and prices each at its early miss's ops
// (a stable pair 24 to a miss, 38 past det; a direct one 17, 26), beside
// the whole test on every pair that this kernel was held to before: at
// 196,608 rays some hundredths of a millisecond of float work against ~6
// MB of rays in, results out and the cell table once.
//
// What the design does about it (K3's walk, csrc/stream_dda.cu, on the
// same grid):
// - the warp sweeps the cells: every walking ray's origin, direction and
//   cell go to all 32 threads, which test the cell's filled slots 32 at a
//   time (coalesced 16-B loads from geom, the count from count; kWalkers
//   cells at once, their loads issued together), each thread folding its
//   own with the strict <; two REDUX minima of the floats' bits (t > eps
//   >= 0 and the ids are whole numbers >= 0, so they order as int32) give
//   the cell's least t and, among equal ones, its least id: the plain
//   version's cell fold whatever the order of the slots. A slot's id is
//   read from cells only where a thread's best changes or ties. Before,
//   one thread walked one ray through its own cells, the warp running its
//   slowest lane's walk, each slot two dependent 16-B loads;
// - a lane queue on a persistent grid: the launch holds only the blocks
//   the card runs at once (the SMs times this kernel's occupancy, asked
//   once a device). A thread starts on the ray of its index; once its ray
//   has ended it writes (t, code), and once the warp has no walk left its
//   threads take the next rays together from a counter in the caller's
//   scratch (zeroed on the stream before the launch), one atomicAdd a
//   warp, so that the rays that start do parts A and the overflow
//   together (taking rays once half the warp waits ran 3-6% slower,
//   PERF.md). The scratch also gathers, a warp at a time, the rays
//   finished, the walk steps and the slots tested, which chip_smoke.py
//   holds to the plain version's counts;
// - an early miss: part A through lane.cuh's early_stable_tt, over its
//   live rows only (staged in shared memory once a block, in slot order,
//   with their slots; the loop unrolled, so that the tests of a ray's
//   next rows overlap), the overflow rows and the slots through
//   early_direct_tt: where !(det >= 0 && r > 0) the pair is dropped before
//   the square roots, the roots and the fold;
// - __launch_bounds__ asks for kMinBlocks blocks an SM: 6 (80 registers,
//   a few spilled) ran 2-4% ahead of 8 (64, 218 B of spill stores) and of
//   4 (96, none), the unrolled part A 3-5% more (PERF.md);
// - the per-step exit test, the step and the clip as before; float-to-int
//   truncation saturates (__float2int_rz), as XLA's conversion does; built
//   with --fmad=false, so every op rounds as in the JAX kernel and in the
//   plain version (ops/dda.py::closest_hit_dda_plain), and each tested
//   pair exactly as K2 tests it.
// The grid clip keeps its own axis order: K3's (stream_dda.cu) keeps the
// kept-off-zero direction, which K3 divides by later, where this walk
// multiplies by the reciprocal, as the JAX kernel does.
//
// Interface: plain C functions, loaded with ctypes. The launch runs on the
// caller's stream (a memset of the scratch, then the kernel), synchronises
// nothing, allocates nothing and returns the first cudaGetLastError().

#include "lane.cuh"
#include "plan.cuh"

namespace {

using namespace smallpt;

constexpr int kBlock = 128;
constexpr int kMinBlocks = 6;  // blocks an SM, for the register cap
constexpr int kPartA = 128;    // ops/intersect_pallas.py::MAX_BIG
constexpr int kSlot = 8;       // floats a cell slot or an overflow row
constexpr int kWalkers = 2;    // walking rays' cells swept at once
constexpr float kBigId = 3.0e38f;
constexpr float kTiny = 1e-20f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBlock == kPartA, "one part-A row a thread is staged");

// integer and float launch arguments (ops/dda.py::_launch_args, same order)
enum { D_N, D_NX, D_NY, D_NZ, D_K, D_F_ROWS, D_COUNT };
enum { DF_LOX, DF_LOY, DF_LOZ, DF_CLX, DF_CLY, DF_CLZ, DF_EPS, DF_COUNT };
// the scratch's u64 words (ops/dda.py::QUEUE_FIELDS): the next ray past
// the first wave, the rays finished, the walk steps, the slots tested
enum { Q_NEXT, Q_RAYS, Q_STEPS, Q_SLOTS, Q_WORDS };

struct Grid {
  int n[3];    // cells per axis
  int k;       // slots a cell
  int f_rows;  // overflow rows, padding included
  float lo[3], cl[3];
  float eps;   // the local spheres' root-rejection eps
};

// The tables a launch reads.
struct Tables {
  const float4* overflow;  // (F, 2) float4: [cx cy cz r] [eps id 0 0]
  const float* cells;      // (C, K, 8): the ids
  const float4* geom;      // (C, K) [cx cy cz r]
  const int* count;        // (C,) filled slots
};

// A ray in flight: the ray, its walk and its two running folds.
struct Walk {
  float o[3], d[3];
  float tm[3], dt[3];
  int ci[3];
  float bta, btb, bidb;
  int bia, it;
};

// Fold a candidate (tt, id) into the running (bt, bid) in (t, id) order.
__device__ __forceinline__ void fold_lex(float tt, float id, float& bt,
                                         float& bid) {
  if (tt < kBig && (tt < bt || (tt == bt && id < bid))) {
    bt = tt;
    bid = id;
  }
}

// ---- 1-3a. a ray's start: part A over its live rows (s_a: [cx cy cz r],
// s_ae: [eps slot], m_a of them), the overflow rows, the clip and the
// entry cell. Returns whether the ray walks.
__device__ __forceinline__ bool start_ray(const float* __restrict__ org,
                                          const float* __restrict__ dir,
                                          int i, int n, const Tables& T,
                                          const Grid& g, const float4* s_a,
                                          const float2* s_ae, int m_a,
                                          Walk& w) {
  w.o[0] = org[i];
  w.o[1] = org[n + i];
  w.o[2] = org[2 * n + i];
  w.d[0] = dir[i];
  w.d[1] = dir[n + i];
  w.d[2] = dir[2 * n + i];
  const float* o = w.o;
  const float* d = w.d;
  // 1. part A: the stable sweep, strict < keeps the first slot
  w.bta = kBig;
  w.bia = 0;
#pragma unroll 4
  for (int q = 0; q < m_a; ++q) {
    float tt;
    if (early_stable_tt(o[0], o[1], o[2], d[0], d[1], d[2], s_a[q],
                        s_ae[q].x, tt) &&
        tt < w.bta) {
      w.bta = tt;
      w.bia = __float_as_int(s_ae[q].y);
    }
  }
  // 2. the overflow rows, folded on (t, id)
  w.btb = kBig;
  w.bidb = kBigId;
  for (int k = 0; k < g.f_rows; ++k) {
    const float4 c = __ldg(T.overflow + 2 * k);
    if (!(c.w > 0.0f)) continue;  // padding
    const float4 e = __ldg(T.overflow + 2 * k + 1);  // eps, id
    float tt;
    if (early_direct_tt(o[0], o[1], o[2], d[0], d[1], d[2], c, c.w * c.w,
                        e.x, tt))
      fold_lex(tt, e.y, w.btb, w.bidb);
  }
  // 3a. clip to the grid box, the entry cell, the crossings
  float t0[3], t1[3], inv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ghi = g.lo[a] + g.cl[a] * (float)g.n[a];
    const float dn = fabsf(d[a]) < kTiny ? (d[a] >= 0.0f ? kTiny : -kTiny)
                                         : d[a];
    inv[a] = 1.0f / dn;
    const float ta = (g.lo[a] - o[a]) * inv[a];
    const float tb = (ghi - o[a]) * inv[a];
    t0[a] = fminf(ta, tb);
    t1[a] = fmaxf(ta, tb);
  }
  const float t_in = fmaxf(fmaxf(t0[0], t0[1]), t0[2]);
  const float t_far = fminf(fminf(t1[0], t1[1]), t1[2]);
  const float enter = fmaxf(t_in, 0.0f);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p = o[a] + d[a] * enter;
    const float invc = 1.0f / g.cl[a];
    w.ci[a] = min(max(__float2int_rz((p - g.lo[a]) * invc), 0), g.n[a] - 1);
    const bool fwd = d[a] >= 0.0f;
    const float nxt = g.lo[a] + (float)(w.ci[a] + (fwd ? 1 : 0)) * g.cl[a];
    const bool tiny = fabsf(d[a]) < kTiny;
    w.tm[a] = tiny ? kBig : (nxt - o[a]) * inv[a];
    w.dt[a] = tiny ? kBig : g.cl[a] * fabsf(inv[a]);
  }
  w.it = 0;
  return enter <= t_far && t_far > 0.0f;
}

// ---- 3b. the cell sweep of every walking ray of the warp (todo: their
// ballot; every thread of the warp calls it), kWalkers cells swept by the
// whole warp at a time: each walker's ray and cell go to every thread,
// which tests the slots q = its index, + 32, ... below the cell's count
// and folds them with the strict < (reading a slot's id where its best
// changes, and on a tie below 3e38); the warp's REDUX minima then keep the
// least t and, among equal ones, the least id. The walker gets its cell's
// (m, idc) (3e38, 3e38 where nothing is hit) and its count of slots.
__device__ __forceinline__ void sweep_cells(const Tables& T, const Grid& g,
                                            const Walk& w, unsigned todo,
                                            float& m_out, float& id_out,
                                            int& cnt_out) {
  const int wl = threadIdx.x & 31;
  const int lin_own = (w.ci[0] * g.n[1] + w.ci[1]) * g.n[2] + w.ci[2];
  while (todo) {
    int src[kWalkers], cnt[kWalkers];
    float ray[kWalkers][6], m[kWalkers], idc[kWalkers];
    const float4* gq[kWalkers];
    int rounds = 0;
#pragma unroll
    for (int j = 0; j < kWalkers; ++j) {
      // a slot of the batch past the last walker sweeps nothing
      src[j] = todo ? __ffs(todo) - 1 : -1;
      todo &= todo - 1;
      const int from = src[j] < 0 ? 0 : src[j];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        ray[j][a] = __shfl_sync(kFull, w.o[a], from);
        ray[j][3 + a] = __shfl_sync(kFull, w.d[a], from);
      }
      const int lin = __shfl_sync(kFull, lin_own, from);
      const bool in = src[j] >= 0;
      gq[j] = T.geom + (size_t)(in ? lin : 0) * g.k;
      cnt[j] = in ? __ldg(T.count + lin) : 0;
      rounds = max(rounds, cnt[j]);
      m[j] = kBig;
      idc[j] = kBigId;
    }
    for (int q = wl; q < rounds; q += 32) {
      float4 c[kWalkers];
#pragma unroll
      for (int j = 0; j < kWalkers; ++j)
        if (q < cnt[j]) c[j] = __ldg(gq[j] + q);
#pragma unroll
      for (int j = 0; j < kWalkers; ++j) {
        float tt;
        if (q >= cnt[j] ||
            !early_direct_tt(ray[j][0], ray[j][1], ray[j][2], ray[j][3],
                             ray[j][4], ray[j][5], c[j], c[j].w * c[j].w,
                             g.eps, tt))
          continue;
        // the slot's id, in the cell table after its [cx cy cz r]
        const float* id = T.cells + ((gq[j] - T.geom) + q) * kSlot + 4;
        if (tt < m[j]) {
          m[j] = tt;
          idc[j] = __ldg(id);
        } else if (tt == m[j] && tt < kBig) {
          idc[j] = fminf(idc[j], __ldg(id));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kWalkers; ++j) {
      const int mb = __reduce_min_sync(kFull, __float_as_int(m[j]));
      const int ib = __reduce_min_sync(
          kFull,
          __float_as_int(m[j]) == mb ? __float_as_int(idc[j]) : 0x7fffffff);
      if (wl == src[j]) {
        m_out = __int_as_float(mb);
        id_out = __int_as_float(ib);
        cnt_out = cnt[j];
      }
    }
  }
}

// ---- 3c. the rest of a walk step: fold the cell's (m, idc), the
// conservative exit (the best so far lies within the visited prefix), the
// step along the axis of least next crossing (ties to x, then y). Returns
// whether the ray walks on.
__device__ __forceinline__ bool finish_step(const Grid& g, float m,
                                            float idc, int max_steps,
                                            Walk& w) {
  fold_lex(m, idc, w.btb, w.bidb);
  const float t_exit = fminf(fminf(w.tm[0], w.tm[1]), w.tm[2]);
  const bool done = fminf(w.bta, w.btb) <= t_exit;
  bool active;
  // constant indices keep the arrays in registers
  if (w.tm[0] <= w.tm[1] && w.tm[0] <= w.tm[2]) {
    w.ci[0] += w.d[0] >= 0.0f ? 1 : -1;
    w.tm[0] = w.tm[0] + w.dt[0];
    active = !done && w.ci[0] >= 0 && w.ci[0] < g.n[0];
  } else if (w.tm[1] <= w.tm[2]) {
    w.ci[1] += w.d[1] >= 0.0f ? 1 : -1;
    w.tm[1] = w.tm[1] + w.dt[1];
    active = !done && w.ci[1] >= 0 && w.ci[1] < g.n[1];
  } else {
    w.ci[2] += w.d[2] >= 0.0f ? 1 : -1;
    w.tm[2] = w.tm[2] + w.dt[2];
    active = !done && w.ci[2] >= 0 && w.ci[2] < g.n[2];
  }
  return active && ++w.it < max_steps;
}

__global__ void __launch_bounds__(kBlock, kMinBlocks)
    dda_kernel(const float* __restrict__ org, const float* __restrict__ dir,
               const float* __restrict__ part_a, const Tables T,
               float* __restrict__ t_out, int* __restrict__ code_out,
               unsigned long long* __restrict__ queue, int n, const Grid g) {
  __shared__ float4 s_a[kPartA];
  __shared__ float2 s_ae[kPartA];
  __shared__ int s_warp[kBlock / 32];
  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << wl) - 1u;
  // part A's live rows (r > 0), in slot order, one row a thread
  {
    const int k = threadIdx.x;
    const float4 c = __ldg(reinterpret_cast<const float4*>(part_a) + 2 * k);
    const bool live = c.w > 0.0f;
    const unsigned ball = __ballot_sync(kFull, live);
    if (wl == 0) s_warp[warp] = __popc(ball);
    __syncthreads();
    int off = 0;
    for (int v = 0; v < warp; ++v) off += s_warp[v];
    if (live) {
      const int at = off + __popc(ball & below);
      s_a[at] = c;
      s_ae[at] = make_float2(__ldg(part_a + kSlot * k + 4),
                             __int_as_float(k));
    }
  }
  __syncthreads();
  int m_a = 0;
  for (int v = 0; v < kBlock / 32; ++v) m_a += s_warp[v];

  const int max_steps = g.n[0] + g.n[1] + g.n[2] + 3;
  // the first wave: a ray a thread by index; the queue hands out the rest
  const int first_wave = gridDim.x * kBlock;
  int ray = blockIdx.x * kBlock + threadIdx.x;
  bool have = ray < n;     // a ray to trace
  bool exhausted = !have;  // the queue has no ray left for this thread
  Walk w = {};
  int n_rays = 0, n_steps = 0, n_slots = 0;
  for (;;) {
    bool walking = have &&
                   start_ray(org, dir, ray, n, T, g, s_a, s_ae, m_a, w);
    // the walk: the warp steps its walking rays, sweeping their cells
    // together, until none walks
    for (;;) {
      const unsigned todo = __ballot_sync(kFull, walking);
      if (!todo) break;
      float m = kBig, idc = kBigId;
      int cnt = 0;
      sweep_cells(T, g, w, todo, m, idc, cnt);
      if (walking) {
        ++n_steps;
        n_slots += cnt;
        walking = finish_step(g, m, idc, max_steps, w);
      }
    }
    // 4. the ray has ended: part A wins ties; misses encode as 0
    if (have) {
      const bool a_wins = w.bta <= w.btb;
      const float best = a_wins ? w.bta : w.btb;
      t_out[ray] = best;
      code_out[ray] = best >= kBig ? 0 : (a_wins ? -(w.bia + 1)
                                                 : (int)w.bidb);
      ++n_rays;
    }
    // the warp's threads take their next rays, one atomic a warp
    const unsigned ask = __ballot_sync(kFull, !exhausted);
    if (!ask) break;
    const int leader = __ffs(ask) - 1;
    unsigned long long base = 0;
    if (wl == leader) base = atomicAdd(queue + Q_NEXT, __popc(ask));
    base = __shfl_sync(kFull, base, leader);
    if (!exhausted) {
      const long long next = first_wave + (long long)base +
                             __popc(ask & below);
      have = next < n;
      exhausted = !have;
      if (have) ray = (int)next;
    } else {
      have = false;
    }
  }
  add_rays(queue + Q_RAYS, n_rays);
  add_rays(queue + Q_STEPS, n_steps);
  add_rays(queue + Q_SLOTS, n_slots);
}

// The kernel's fit on the current device, asked once a device.
cudaError_t dda_fit(Fit* out) { return device_fit(dda_kernel, kBlock, out); }

// The blocks of a launch of n rays: the first wave, one ray a thread, at
// most the blocks the card holds at once.
long long first_wave(int n, const Fit& fit) {
  const long long fill = (long long)fit.n_sm * fit.per_sm;
  const long long want = ((long long)n + kBlock - 1) / kBlock;
  return want < fill ? want : fill;
}

}  // namespace

// The launch smallpt_dda makes on the current device for n rays: out, four
// int64 {blocks, threads (the first wave), n_sm, per_sm}
// (ops/dda.py::PLAN_FIELDS). Returns a cudaError_t (the device query's).
extern "C" int smallpt_dda_plan(int n, void* out) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  Fit fit;
  const cudaError_t err = dda_fit(&fit);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = first_wave(n, fit);
  const long long v[4] = {blocks, blocks * kBlock, fit.n_sm, fit.per_sm};
  memcpy(out, v, sizeof(v));
  return 0;
}

// The closest (t, code) of iparams[D_N] rays. org, dir: (3, N) f32 planes;
// part_a: (128, 8), overflow: (F, 8), cells: (C, K, 8), geom: (C, K, 4) f32
// and count: (C,) i32 on the device; t: (N,) f32 and code: (N,) i32
// outputs; queue: Q_WORDS u64 of scratch on the device (zeroed here, on
// the stream; after the launch the rays handed out past the first wave,
// the rays finished, the walk steps and the slots tested); iparams: host
// int32 {N nx ny nz K F}; fparams: host f32 {lo(3) cell(3) eps}; stream:
// a cudaStream_t. Returns the first cudaGetLastError().
extern "C" int smallpt_dda(const void* org, const void* dir,
                           const void* part_a, const void* overflow,
                           const void* cells, const void* geom,
                           const void* count, void* t, void* code,
                           void* queue, const void* iparams,
                           const void* fparams, void* stream) {
  int ip[D_COUNT];
  float fp[DF_COUNT];
  memcpy(ip, iparams, sizeof(ip));
  memcpy(fp, fparams, sizeof(fp));
  const int n = ip[D_N];
  Grid g;
  for (int a = 0; a < 3; ++a) {
    g.n[a] = ip[D_NX + a];
    g.lo[a] = fp[DF_LOX + a];
    g.cl[a] = fp[DF_CLX + a];
    if (g.n[a] < 1) return (int)cudaErrorInvalidValue;
  }
  g.k = ip[D_K];
  g.f_rows = ip[D_F_ROWS];
  g.eps = fp[DF_EPS];
  // the REDUX fold orders t by its bits, which needs t > eps >= 0
  if (n < 0 || g.k < 1 || g.f_rows < 0 || !(g.eps >= 0.0f))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Fit fit;
  cudaError_t err = dda_fit(&fit);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if ((err = cudaMemsetAsync(queue, 0, Q_WORDS * sizeof(unsigned long long),
                             s)) != cudaSuccess)
    return (int)err;
  const Tables T{(const float4*)overflow, (const float*)cells,
                 (const float4*)geom, (const int*)count};
  dda_kernel<<<(int)first_wave(n, fit), kBlock, 0, s>>>(
      (const float*)org, (const float*)dir, (const float*)part_a, T,
      (float*)t, (int*)code, (unsigned long long*)queue, n, g);
  return (int)cudaGetLastError();
}
