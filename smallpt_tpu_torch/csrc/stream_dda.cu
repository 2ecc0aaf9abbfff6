// Streaming megakernel with a per-ray DDA grid walk, for sm_90a (kernel K3).
//
// Replaces: smallpt_tpu/ops/stream_dda.py::_stream_dda_kernel, launched
// there by _stream_step_dda_jit through one pallas_call; entry point
// smallpt_stream_dda, kernel stream_dda_kernel; the launch's plan,
// smallpt_stream_dda_plan.
//
// Contract (ops/stream_dda.py::stream_step_dda): each iteration advances a
// lane by one unit of its own work, in the JAX kernel's phase order, every
// mask taken at the start of the iteration, at most max_it iterations a
// lane:
// 1. a walk step (main or shadow ray): test the spheres of the lane's cell,
//    fold them into its best candidate, and step to the next cell unless
//    the hit is decided or the ray left the grid;
// 2. resolve: the winner's emission, the BSDF and roulette shade, the next
//    bounce ray or the path's death;
// 3. NEE: the cone sample of the one light at a surviving diffuse vertex,
//    whose occlusion test becomes a shadow walk (walk state 3, or 4 when the
//    path dies at the vertex but still owes its direct sample);
// 4. regenerate a dead lane with its pixel's next sample;
// 5. walk init: sweep the always table (walls, the NEE light, cell
//    overflow), then clip the ray to the grid.
// The camera, shade and NEE cone formulas are lane.cuh's, shared with the
// megakernel (K1), so both routes render the same paths. A lane's result
// depends on its own planes and the launch's arguments alone, whichever
// thread runs it and when.
//
// What bounds it on an H100: the sphere tests in cells, 89% of the counted
// operations. A 512x384 launch of budget 4 on 10,000 spheres (the default
// grid: 240 cells of K = 96 slots, 7 always rows) makes 857 M slot tests in
// 15.2 M walk steps, 1.3% of them past det; its bound
// (chip_smoke.py::k3_bound) prices a miss at the 24 ops up to that decision
// and a test past det at the whole test's 38 (beside it the whole test on
// every slot, as the kernel before this design was held to). The slots
// come from a 0.37-MB geometry table that L1 and L2 serve, 16 B a test.
// The kernel before this design ran one lane a thread to its end, each
// lane sweeping its own cells' slots: a warp's lanes stood in different
// cells of different counts and phases, and it took 21.2 ms for that
// launch; this design takes about a third of that (PERF.md).
//
// What the design does about it:
// - the warp sweeps the cells: every walking lane's ray and cell go to all
//   32 threads, which test the cell's filled slots 32 at a time (coalesced
//   16-B loads from a (C, K) [cx cy cz r] table, the count from a (C,)
//   table; kWalkers cells at once, their loads issued together), each
//   thread folding its own with the strict <; two REDUX minima of the
//   floats' bits (t > eps >= 0 and the ids are whole numbers >= 0, so they
//   order as int32) give the cell's least t and, among equal ones, its
//   least id: the plain version's cell fold whatever the order. A slot's id
//   (the (C, K, 8) cell table, as the plain version reads it) is read only
//   where a thread's best changes or ties;
// - an early miss in lane.cuh's early_stable_tt, shared with K2, K4 and K5
//   (lane.cuh's sphere_tt, which K1 shares, keeps the JAX order): where
//   !(det >= 0 && r > 0) the slot is dropped before the square roots, the
//   division and the fold's compare (the whole test gives 3e38 there,
//   which never decides a fold: the running fold takes a cell's best only
//   below 3e38). The always sweep takes the same test;
// - the walk as its own loop: a walk step that does not end the walk does
//   nothing else in its iteration, so the warp steps its walking lanes
//   back to back (each step an iteration of its lane, up to the cap) until
//   none walks, and then runs the resolve, regeneration and init of every
//   lane that needs them together; the step that ends a walk goes on
//   through the rest of its iteration, as a shadow walk that ends goes on
//   to regeneration and init;
// - a lane queue on a persistent grid: the launch holds only the blocks the
//   card runs at once (the SMs times this kernel's occupancy, asked once a
//   device and shared-memory size). A thread starts on the lane of its
//   index and, when that lane has no work left or has run max_it
//   iterations, stores it and takes the next one from a counter in the
//   caller's scratch (zeroed on the stream before the launch), one
//   warp-aggregated atomicAdd for the warp's threads that ask at once. An
//   idle lane (no sample left) costs three loads and no store;
// - only the walk's hot state in registers (origin, direction, t_max, the
//   best candidate, the cell, walk state, alive, s_idx, budget, depth, sup,
//   the shadow ray): m1 and m2 are read and written at regeneration, the
//   NEE pending term at the cone sample and the shadow walk's end, the
//   winner's cell where it changes, the throughput and radiance in the
//   phases that use them; one instance without NEE and one with, so that
//   the first holds no shadow state; __launch_bounds__ asks for
//   kMinBlocks blocks an SM;
// - the always table's sweep columns [cx cy cz r eps id] and the grid's far
//   corner and inverse cell size sit in shared memory, loaded once a block
//   (24 B a row; opting in above 48 KB);
// - the winner's payload is one indexed load from the scene table by id;
// - the tie rules, the sentinels and the arithmetic order are the JAX
//   kernel's: the running fold replaces on (t < bt) or (t == bt and id <
//   bid), the always sweep likewise; float-to-int truncation saturates
//   (__float2int_rz), as XLA's conversion does; built with --fmad=false;
// - the launch's ray count is the exact int64 sum of the lanes'
//   increments (one per main walk init), summed a thread over its lanes and
//   reduced once a warp at exit; the lanes handed out and the lanes that
//   had work are counted beside the queue's counter.
//
// Interface: plain C functions, loaded with ctypes (ops/stream_dda.py). The
// launch runs on the caller's stream (a memset of the queue, then the
// kernel), synchronises nothing and returns the first cudaGetLastError().

#include "lane.cuh"
#include "plan.cuh"

namespace {

using namespace smallpt;

constexpr int kBlock = 128;         // threads a block
constexpr int kMinBlocks = 8;       // blocks an SM, for the register cap
constexpr int kWalkers = 2;         // walking lanes' cells swept at once
constexpr int kMaxAxis = 32;      // the packed cell's 5 bits per axis
constexpr int kMaxAlways = 9600;  // ops/stream_dda.py::MAX_ALWAYS
constexpr int kSlot = 8;          // floats per cell slot
constexpr float kBigId = 3.0e38f;
constexpr float kTiny = 1e-20f;
constexpr unsigned kFull = 0xffffffffu;

// the walk planes after the classic ones (ops/stream_dda.py::_F_*, _I_*)
enum { F_TMX = F_COUNT, F_TMY, F_TMZ, F_BT, F_BID, F_SDX, F_SDY, F_SDZ,
       F_PCX, F_PCY, F_PCZ, F_TLG };
enum { I_CELL = I_COUNT, I_WALK, I_WCELL };
// grid launch arguments (ops/stream_dda.py::_dda_args, same order)
enum { D_NX, D_NY, D_NZ, D_K, D_N_ALWAYS, D_LIGHT_ROW, D_COUNT };
enum { DF_LOX, DF_LOY, DF_LOZ, DF_CLX, DF_CLY, DF_CLZ, DF_EPS, DF_COUNT };
// the queue's int32 words (ops/stream_dda.py::QUEUE_FIELDS): the next lane
// past the first wave, the lanes handed out, the lanes that had work
enum { Q_NEXT, Q_HANDED, Q_WORKED, Q_WORDS };

struct Grid {
  int n[3];  // cells per axis
  int k, n_always, light_row;
  float lo[3], cl[3];
  float eps;  // the local spheres' intersection eps
};

// What every lane of a launch reads and writes besides its registers.
struct Launch {
  const float* cells;   // (C, K, 8) slots [cx cy cz r id 0 0 0]: the ids
  const float4* geom;   // (C, K) [cx cy cz r]
  const int* count;     // (C,) filled slots, from the front
  const float* table;   // (S, 16) scene table: the winners' payload
  const float* cam;     // (16,) camera vector
  float* f;             // (19 or 26, n) f32 state planes
  int* st;              // (9, n) i32 state planes
  int n;                // lanes, the plane stride
};

// A lane's hot state, held in registers while a thread runs the lane:
// what the walk step and the fold touch, and its progress.
struct Hot {
  float ox, oy, oz, dx, dy, dz;
  float tmx, tmy, tmz, bt, bid;
  float sdx, sdy, sdz, tlg;
  int cellp, walk, depth, s_idx, budget, sup, nrays;
  bool alive;
};

// A lane's throughput and radiance, read and written by the resolve.
struct Path {
  float wx, wy, wz, rx, ry, rz;
};

// One axis of the grid clip (stream_dda.py's axis_clip): the entry and exit
// t of the slab [g0, g1], and the direction kept off zero.
__device__ __forceinline__ void axis_clip(float o, float d, float g0,
                                          float g1, float& t0, float& t1,
                                          float& dn) {
  dn = fabsf(d) < kTiny ? (d >= 0.0f ? kTiny : -kTiny) : d;
  const float inv = 1.0f / dn;
  const float ta = (g0 - o) * inv;
  const float tb = (g1 - o) * inv;
  t0 = fminf(ta, tb);
  t1 = fmaxf(ta, tb);
}

__device__ __forceinline__ Path load_path(const Launch& L, int lane) {
  const float* fl = L.f + lane;
  const size_t n = (size_t)L.n;
  return Path{fl[F_WX * n], fl[F_WY * n], fl[F_WZ * n],
              fl[F_RX * n], fl[F_RY * n], fl[F_RZ * n]};
}

__device__ __forceinline__ void store_path(const Launch& L, int lane,
                                           const Path& w) {
  float* fl = L.f + lane;
  const size_t n = (size_t)L.n;
  fl[F_WX * n] = w.wx; fl[F_WY * n] = w.wy; fl[F_WZ * n] = w.wz;
  fl[F_RX * n] = w.rx; fl[F_RY * n] = w.ry; fl[F_RZ * n] = w.rz;
}

// The lane's hot state, if it has work in this launch; an idle lane (no
// path alive, no sample left) is read no further and left as it is.
__device__ __forceinline__ bool load_lane(const Launch& L, bool nee,
                                          int lane, Hot& h) {
  const size_t n = (size_t)L.n;
  const int* il = L.st + lane;
  h.alive = il[I_ALIVE * n] != 0;
  h.s_idx = il[I_SIDX * n];
  h.budget = il[I_BUDGET * n];
  if (!(h.alive || h.s_idx < h.budget - 1)) return false;
  const float* fl = L.f + lane;
  h.ox = fl[F_OX * n]; h.oy = fl[F_OY * n]; h.oz = fl[F_OZ * n];
  h.dx = fl[F_DX * n]; h.dy = fl[F_DY * n]; h.dz = fl[F_DZ * n];
  h.tmx = fl[F_TMX * n]; h.tmy = fl[F_TMY * n]; h.tmz = fl[F_TMZ * n];
  h.bt = fl[F_BT * n]; h.bid = fl[F_BID * n];
  h.sdx = h.sdy = h.sdz = h.tlg = 0.0f;
  if (nee) {
    h.sdx = fl[F_SDX * n]; h.sdy = fl[F_SDY * n]; h.sdz = fl[F_SDZ * n];
    h.tlg = fl[F_TLG * n];
  }
  h.depth = il[I_DEPTH * n];
  h.nrays = il[I_RAYS * n];
  h.sup = il[I_SUP * n];
  h.cellp = il[I_CELL * n];
  h.walk = il[I_WALK * n];
  return true;
}

__device__ __forceinline__ void store_lane(const Launch& L, bool nee,
                                           int lane, const Hot& h) {
  const size_t n = (size_t)L.n;
  float* fl = L.f + lane;
  int* il = L.st + lane;
  fl[F_OX * n] = h.ox; fl[F_OY * n] = h.oy; fl[F_OZ * n] = h.oz;
  fl[F_DX * n] = h.dx; fl[F_DY * n] = h.dy; fl[F_DZ * n] = h.dz;
  fl[F_TMX * n] = h.tmx; fl[F_TMY * n] = h.tmy; fl[F_TMZ * n] = h.tmz;
  fl[F_BT * n] = h.bt; fl[F_BID * n] = h.bid;
  if (nee) {
    fl[F_SDX * n] = h.sdx; fl[F_SDY * n] = h.sdy; fl[F_SDZ * n] = h.sdz;
    fl[F_TLG * n] = h.tlg;
  }
  il[I_DEPTH * n] = h.depth;
  il[I_SIDX * n] = h.s_idx;
  il[I_ALIVE * n] = h.alive ? 1 : 0;
  il[I_RAYS * n] = h.nrays;
  il[I_SUP * n] = h.sup;
  il[I_CELL * n] = h.cellp;
  il[I_WALK * n] = h.walk;
}

// The walking direction of a lane: the shadow ray's in a shadow walk.
__device__ __forceinline__ void walk_dir(const Hot& h, bool nee, float& wdx,
                                         float& wdy, float& wdz) {
  const bool is_shadow = nee && (h.walk == 3 || h.walk == 4);
  wdx = is_shadow ? h.sdx : h.dx;
  wdy = is_shadow ? h.sdy : h.dy;
  wdz = is_shadow ? h.sdz : h.dz;
}

// ---- 1a. the cell sweep of every walking lane of the warp (todo: their
// ballot; every thread of the warp calls it), kWalkers cells swept by the
// whole warp at a time: each lane's ray and cell go to every thread, which
// tests the slots q = its index, + 32, ... below the cell's count (the
// cells' loads issued together) and folds them with the strict < (reading
// a slot's id where its best changes, and on a tie below 3e38); the warp's
// minimum of (t, id) then keeps the least t and, among equal ones, the
// least id. That is the plain version's cell fold (the least t, then the
// least id) whatever the order of the slots. t > eps >= 0 (or 3e38) and the
// ids are whole numbers >= 0, so as int32 their bits order as the floats
// do: two REDUX minima. The walking lane gets its cell's (m, idc) (3e38
// where nothing is hit).
__device__ __forceinline__ void sweep_cells(const Launch& L, const Grid& g,
                                            const Hot& h, bool nee,
                                            unsigned todo, float& m_out,
                                            float& id_out) {
  const int wl = threadIdx.x & 31;
  const int ny = g.n[1], nz = g.n[2];
  const int n_cells = g.n[0] * ny * nz;
  float wdx, wdy, wdz;
  walk_dir(h, nee, wdx, wdy, wdz);
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
      ray[j][0] = __shfl_sync(kFull, h.ox, from);
      ray[j][1] = __shfl_sync(kFull, h.oy, from);
      ray[j][2] = __shfl_sync(kFull, h.oz, from);
      ray[j][3] = __shfl_sync(kFull, wdx, from);
      ray[j][4] = __shfl_sync(kFull, wdy, from);
      ray[j][5] = __shfl_sync(kFull, wdz, from);
      const int cellp = __shfl_sync(kFull, h.cellp, from);
      const int lin =
          ((cellp >> 10) * ny + ((cellp >> 5) & 31)) * nz + (cellp & 31);
      const bool in = src[j] >= 0 && lin >= 0 && lin < n_cells;
      gq[j] = L.geom + (size_t)(in ? lin : 0) * g.k;
      cnt[j] = in ? __ldg(L.count + lin) : 0;
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
            !early_stable_tt(ray[j][0], ray[j][1], ray[j][2], ray[j][3],
                             ray[j][4], ray[j][5], c[j], g.eps, tt))
          continue;
        // the slot's id, in the cell table after its [cx cy cz r]
        const float* id = L.cells + ((gq[j] - L.geom) + q) * kSlot + 4;
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
      }
    }
  }
}

// ---- 1b. the rest of a walk step: fold the cell's best (m, idc) into the
// lane's candidate, the early-exit test, the DDA advance (cells are stored
// packed but the table index is linear). Returns whether the walk ends at
// this step.
__device__ __forceinline__ bool finish_step(const Launch& L, const Grid& g,
                                            bool nee, int lane, float m,
                                            float idc, Hot& h) {
  const bool is_shadow = nee && (h.walk == 3 || h.walk == 4);
  float wdx, wdy, wdz;
  walk_dir(h, nee, wdx, wdy, wdz);
  const int nx = g.n[0], ny = g.n[1], nz = g.n[2];
  const int ix = h.cellp >> 10, iy = (h.cellp >> 5) & 31, iz = h.cellp & 31;
  if (m < kBig && (m < h.bt || (m == h.bt && idc < h.bid))) {
    h.bt = m;
    h.bid = idc;
    L.st[I_WCELL * (size_t)L.n + lane] = h.cellp;
  }
  const float t_exit = fminf(fminf(h.tmx, h.tmy), h.tmz);
  const bool ax = h.tmx <= h.tmy && h.tmx <= h.tmz;
  const bool ay = !ax && h.tmy <= h.tmz;
  const bool az = !ax && !ay;
  const int ix2 = ax ? ix + (wdx >= 0.0f ? 1 : -1) : ix;
  const int iy2 = ay ? iy + (wdy >= 0.0f ? 1 : -1) : iy;
  const int iz2 = az ? iz + (wdz >= 0.0f ? 1 : -1) : iz;
  const bool inside2 = ix2 >= 0 && ix2 < nx && iy2 >= 0 && iy2 < ny &&
                       iz2 >= 0 && iz2 < nz;
  const bool walk_done = h.walk == 1 && (h.bt <= t_exit || !inside2);
  bool sdone = false;
  if (is_shadow) {
    // a shadow walk ends once occlusion is decided: a confirmed closest
    // hit, no later cell nearer than the light, or off-grid
    sdone = h.bt <= t_exit || t_exit >= h.tlg || !inside2;
    if (sdone) {
      if (h.bt >= h.tlg && h.tlg < kBig) {
        // unoccluded: the pending direct-light term joins the radiance
        float* fl = L.f + lane;
        const size_t n = (size_t)L.n;
        fl[F_RX * n] = fl[F_RX * n] + fl[F_PCX * n];
        fl[F_RY * n] = fl[F_RY * n] + fl[F_PCY * n];
        fl[F_RZ * n] = fl[F_RZ * n] + fl[F_PCZ * n];
      }
      // deferred death (walk 4): the vertex's direct sample is in
      if (h.walk == 4) h.alive = false;
    }
  }
  if (!(walk_done || sdone)) {
    h.cellp = (ix2 << 10) | (iy2 << 5) | iz2;
    if (ax) h.tmx = h.tmx + (fabsf(wdx) < kTiny ? kBig : g.cl[0] / fabsf(wdx));
    if (ay) h.tmy = h.tmy + (fabsf(wdy) < kTiny ? kBig : g.cl[1] / fabsf(wdy));
    if (az) h.tmz = h.tmz + (fabsf(wdz) < kTiny ? kBig : g.cl[2] / fabsf(wdz));
  }
  if (walk_done) h.walk = 2;
  if (sdone) h.walk = 0;
  return walk_done || sdone;
}

// ---- 2-3. resolve: the winner's payload, emission, shade; NEE's cone
// sample of the light, whose occlusion test is a shadow walk from the next
// init on. Returns whether the vertex sampled the light.
__device__ __forceinline__ bool resolve(const Launch& L, const Params& p,
                                        const Grid& g, const float* smem,
                                        bool nee, int lane, Hot& h) {
  const size_t n = (size_t)L.n;
  const bool hit = h.bt < kBig;
  const Pixel px = pixel_of(p, lane);
  uint32_t wa, wb;
  stream_words(p, px, p.i[IP_IP_OFFSET] + h.s_idx, wa, wb);
  Path w = load_path(L, lane);
  bool parent = false, samp = false;
  if (!hit) {
    // escaped: pick up the environment (the smallpt.cpp:168 hook)
    if (p.i[IP_HAS_ENV] != 0) {
      w.rx = w.rx + w.wx * p.f[FP_ENV_R];
      w.ry = w.ry + w.wy * p.f[FP_ENV_G];
      w.rz = w.rz + w.wz * p.f[FP_ENV_B];
    }
  } else {
    const float* row = L.table + 16 * (int)h.bid;
    const float hx = h.ox + h.bt * h.dx;
    const float hy = h.oy + h.bt * h.dy;
    const float hz = h.oz + h.bt * h.dz;
    float nx_ = hx - __ldg(row + 0);
    float ny_ = hy - __ldg(row + 1);
    float nz_ = hz - __ldg(row + 2);
    normalize3(nx_, ny_, nz_);
    float nlx = nx_, nly = ny_, nlz = nz_;
    if (p.i[IP_FLIP] != 0 &&
        !(nx_ * h.dx + ny_ * h.dy + nz_ * h.dz < 0.0f)) {
      nlx = -nx_;
      nly = -ny_;
      nlz = -nz_;
    }
    // emission; the NEE light's is suppressed when the previous vertex
    // sampled it (one slot)
    if (!(nee && h.bid == (float)p.lights[0] && (h.sup & 1) == 1)) {
      w.rx = w.rx + w.wx * __ldg(row + 5);
      w.ry = w.ry + w.wy * __ldg(row + 6);
      w.rz = w.rz + w.wz * __ldg(row + 7);
    }
    const uint32_t kk = (uint32_t)p.i[IP_K0] + (uint32_t)p.i[IP_K1];
    uint32_t sa = wa, sb = wb, sc = (uint32_t)h.depth + kGolden, sd = kk;
    pcg4d(sa, sb, sc, sd);
    const Shade sh = shade(p, h.dx, h.dy, h.dz, nx_, ny_, nz_, nlx, nly, nlz,
                           __ldg(row + 8), __ldg(row + 9), __ldg(row + 10),
                           __ldg(row + 11), to_unit(sa), to_unit(sb),
                           to_unit(sc), to_unit(sd), h.depth);
    if (sh.survive) {
      parent = true;
      const float nox = hx + sh.eps_off * nlx;
      const float noy = hy + sh.eps_off * nly;
      const float noz = hz + sh.eps_off * nlz;
      float ldx, ldy, ldz, t_light, scale;
      if (nee && sh.diffuse) {
        // the light's sweep columns from the always table (its eps as the
        // always sweep uses it), its emission from the scene table
        const int lr = g.light_row, na = g.n_always;
        if (nee_cone(p, nox, noy, noz, nlx, nly, nlz, smem[lr], smem[na + lr],
                     smem[2 * na + lr], smem[3 * na + lr], smem[4 * na + lr],
                     wa, wb, (uint32_t)h.depth + kNeeSalt, ldx, ldy, ldz,
                     t_light, scale)) {
          samp = true;
          const float* lrow = L.table + 16 * p.lights[0];
          float* fl = L.f + lane;
          h.sdx = ldx;
          h.sdy = ldy;
          h.sdz = ldz;
          fl[F_PCX * n] = w.wx * sh.fx * __ldg(lrow + 5) * scale;
          fl[F_PCY * n] = w.wy * sh.fy * __ldg(lrow + 6) * scale;
          fl[F_PCZ * n] = w.wz * sh.fz * __ldg(lrow + 7) * scale;
          h.tlg = t_light;
        }
      }
      h.ox = nox;
      h.oy = noy;
      h.oz = noz;
      h.dx = sh.ndx;
      h.dy = sh.ndy;
      h.dz = sh.ndz;
      w.wx = w.wx * sh.fx;
      w.wy = w.wy * sh.fy;
      w.wz = w.wz * sh.fz;
    }
  }
  store_path(L, lane, w);
  if (nee) h.sup = samp ? 1 : 0;
  ++h.depth;
  const bool bounce_alive = parent && h.depth < p.i[IP_MAX_DEPTH];
  h.alive = bounce_alive || samp;
  h.walk = samp ? (bounce_alive ? 3 : 4) : 0;
  return samp;
}

// ---- 4. regenerate the dead lane with its pixel's next sample. The
// finished sample's luminance is lum(radiance) - m1; m2 sums its square for
// the variance estimate of adaptive sampling.
__device__ __forceinline__ void regenerate(const Launch& L, const Params& p,
                                           int lane, Hot& h) {
  const size_t n = (size_t)L.n;
  float* fl = L.f + lane;
  const float m1 = fl[F_M1 * n];
  const float cur_lum =
      (fl[F_RX * n] + fl[F_RY * n] + fl[F_RZ * n]) * kThird;
  const float delta = cur_lum - m1;
  fl[F_M2 * n] = fl[F_M2 * n] + delta * delta;
  fl[F_M1 * n] = cur_lum;
  ++h.s_idx;
  const Pixel px = pixel_of(p, lane);
  const int ip = p.i[IP_IP_OFFSET] + h.s_idx;
  uint32_t wa, wb;
  stream_words(p, px, ip, wa, wb);
  camera_ray(p, L.cam, px, ip, wa, wb, h.ox, h.oy, h.oz, h.dx, h.dy, h.dz);
  fl[F_WX * n] = 1.0f;
  fl[F_WY * n] = 1.0f;
  fl[F_WZ * n] = 1.0f;
  h.depth = 0;
  h.alive = true;
  h.walk = 0;
  h.sup = 0;
}

// ---- 5. walk init: the always sweep and the grid clip, for a fresh main
// ray or a freshly sampled shadow ray (samp). Returns whether it is a main
// ray's init (one traced ray).
__device__ __forceinline__ bool init_walk(const Launch& L, const Grid& g,
                                          const float* smem, bool samp,
                                          int lane, Hot& h) {
  const int na = g.n_always;
  const float* ghi = smem + 6 * na;
  const float* invc = ghi + 3;
  const float idx = samp ? h.sdx : h.dx;
  const float idy = samp ? h.sdy : h.dy;
  const float idz = samp ? h.sdz : h.dz;
  float abt = kBig, abid = kBigId;
  for (int s = 0; s < na; ++s) {
    const float4 c = make_float4(smem[s], smem[na + s], smem[2 * na + s],
                                 smem[3 * na + s]);
    float tt;
    if (!early_stable_tt(h.ox, h.oy, h.oz, idx, idy, idz, c,
                         smem[4 * na + s], tt))
      continue;
    const float sid = smem[5 * na + s];
    if (tt < kBig && (tt < abt || (tt == abt && sid < abid))) {
      abt = tt;
      abid = sid;
    }
  }
  const float o3[3] = {h.ox, h.oy, h.oz};
  const float d3[3] = {idx, idy, idz};
  float t0[3], t1[3], dn[3];
  for (int a = 0; a < 3; ++a)
    axis_clip(o3[a], d3[a], g.lo[a], ghi[a], t0[a], t1[a], dn[a]);
  const float t_in = fmaxf(fmaxf(t0[0], t0[1]), t0[2]);
  const float t_out = fminf(fminf(t1[0], t1[1]), t1[2]);
  const float enter = fmaxf(t_in, 0.0f);
  const bool hits_grid = enter <= t_out && t_out > 0.0f;
  int ci[3];
  float tmn[3];
  for (int a = 0; a < 3; ++a) {
    const float pa = o3[a] + d3[a] * enter;
    // truncate (saturating), then clip to the grid
    const int c = __float2int_rz((pa - g.lo[a]) * invc[a]);
    ci[a] = min(max(c, 0), g.n[a] - 1);
    const float nxt =
        g.lo[a] + (float)(ci[a] + (d3[a] >= 0.0f ? 1 : 0)) * g.cl[a];
    // rays missing the grid keep BIG t_max, so a shadow walk that never
    // enters a cell resolves on its first step
    tmn[a] = (!hits_grid || fabsf(d3[a]) < kTiny) ? kBig
                                                  : (nxt - o3[a]) / dn[a];
  }
  h.bt = abt;
  h.bid = abid;
  L.st[I_WCELL * (size_t)L.n + lane] = -1;
  if (hits_grid) h.cellp = (ci[0] << 10) | (ci[1] << 5) | ci[2];
  h.tmx = tmn[0];
  h.tmy = tmn[1];
  h.tmz = tmn[2];
  if (samp) return false;
  // main rays walk, or resolve at once when they miss the grid; one traced
  // ray per main walk init
  h.walk = hits_grid ? 1 : 2;
  ++h.nrays;
  return true;
}

// One instance without NEE and one with (g.light_row >= 0), so that the
// lanes without NEE hold no shadow-walk state.
template <bool kNee>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    stream_dda_kernel(const float* __restrict__ always, const Launch L,
                      int* __restrict__ queue,
                      unsigned long long* __restrict__ rays, const Params p,
                      const Grid g) {
  // the always table's sweep columns (6 * n_always floats), then the grid's
  // far corner and inverse cell size, in the JAX kernel's f32 arithmetic
  extern __shared__ float smem[];
  // the block's lanes handed out and lanes with work
  __shared__ int s_lanes[2];
  const int na = g.n_always;
  for (int s = threadIdx.x; s < na; s += blockDim.x) {
    const float* row = always + 16 * s;
    smem[s] = row[0];
    smem[na + s] = row[1];
    smem[2 * na + s] = row[2];
    smem[3 * na + s] = row[3];
    smem[4 * na + s] = row[4];
    smem[5 * na + s] = row[12];
  }
  if (threadIdx.x < 3) {
    const int a = threadIdx.x;
    smem[6 * na + a] = g.lo[a] + g.cl[a] * (float)g.n[a];
    smem[6 * na + 3 + a] = 1.0f / g.cl[a];
  }
  if (threadIdx.x < 2) s_lanes[threadIdx.x] = 0;
  __syncthreads();

  constexpr bool nee = kNee;
  const int n = L.n;
  const int max_it = p.i[IP_MAX_IT];
  const int wl = threadIdx.x & 31;
  const unsigned below = (1u << wl) - 1u;
  // the first wave: a lane a thread by index; the queue hands out the rest
  const int first_wave = gridDim.x * kBlock;
  int lane = blockIdx.x * kBlock + threadIdx.x;
  Hot h;
  int it = 0;
  bool open = lane < n && load_lane(L, nee, lane, h);
  if (lane < n) atomicAdd(s_lanes, 1);
  if (open) atomicAdd(s_lanes + 1, 1);
  long long traced = 0;
  for (;;) {
    if (open && (it >= max_it || !(h.alive || h.s_idx < h.budget - 1))) {
      store_lane(L, nee, lane, h);
      open = false;
    }
    // each thread whose lane is done takes the next, one atomic a warp
    const bool want = !open && lane < n;
    const unsigned ask = __ballot_sync(kFull, want);
    bool fresh = false;
    if (ask) {
      const int leader = __ffs(ask) - 1;
      int base = 0;
      if (wl == leader) base = atomicAdd(queue + Q_NEXT, __popc(ask));
      base = __shfl_sync(kFull, base, leader);
      if (want) {
        lane = first_wave + base + __popc(ask & below);
        fresh = true;
      }
    }
    if (fresh && lane < n) {
      it = 0;
      open = load_lane(L, nee, lane, h);
      atomicAdd(s_lanes, 1);
      if (open) atomicAdd(s_lanes + 1, 1);
    }
    if (__all_sync(kFull, lane >= n)) break;

    // one iteration of every open lane, `it` its index: the phases in
    // order, every mask taken at the start. ---- 1. the walk: a walk step
    // that does not end the walk does nothing else, so the walking lanes
    // step back to back (each step one iteration, `it` counting them, up
    // to the cap), the warp sweeping their cells together
    const bool resolving = open && h.alive && h.walk == 2;
    bool walking = open && (h.walk == 1 || (nee && (h.walk == 3 ||
                                                    h.walk == 4)));
    bool rest = open;  // goes on to phases 2-5 in this iteration
    for (;;) {
      const unsigned todo = __ballot_sync(kFull, walking);
      if (!todo) break;
      float m = kBig, idc = kBigId;
      sweep_cells(L, g, h, nee, todo, m, idc);
      if (walking) {
        if (finish_step(L, g, nee, lane, m, idc, h)) {
          walking = false;
        } else if (it + 1 < max_it) {
          ++it;
        } else {
          walking = rest = false;
        }
      }
    }
    if (rest) {
      // ---- 2-5. resolve, regenerate, init
      const bool samp = resolving && resolve(L, p, g, smem, nee, lane, h);
      if (!h.alive && h.s_idx < h.budget - 1) regenerate(L, p, lane, h);
      // a lane is at most one of a fresh main ray and a fresh shadow ray
      if ((h.alive && h.walk == 0) || samp)
        traced += init_walk(L, g, smem, samp, lane, h) ? 1 : 0;
    }
    if (open) ++it;
  }
  add_rays(rays, traced);
  __syncthreads();
  if (threadIdx.x < 2) atomicAdd(queue + Q_HANDED + threadIdx.x,
                                 s_lanes[threadIdx.x]);
}

// The dynamic shared memory of a launch over n_always always rows.
size_t smem_bytes(int n_always) {
  return sizeof(float) * (6 * (size_t)n_always + 6);
}

// The kernel's fit on the current device for smem bytes of dynamic shared
// memory a block, asked once a (device, size) (the plan.cuh fits assume
// none).
template <bool kNee>
cudaError_t dda_fit(size_t smem, Fit* out) {
  static Fit fits[64];
  static size_t fit_smem[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Fit& fit = fits[dev & 63];
  if (fit.n_sm == 0 || fit_smem[dev & 63] != smem) {
    if (smem > kSmemDefault &&
        (err = opt_in_smem(stream_dda_kernel<kNee>)) != cudaSuccess)
      return err;
    int n_sm = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, stream_dda_kernel<kNee>, kBlock, smem)) !=
            cudaSuccess)
      return err;
    fit.n_sm = n_sm > 1 ? n_sm : 1;
    fit.per_sm = per_sm > 1 ? per_sm : 1;
    fit_smem[dev & 63] = smem;
  }
  *out = fit;
  return cudaSuccess;
}

// The blocks of a launch of n lanes: the first wave, one lane a thread, at
// most the blocks the card holds at once.
long long first_wave(int n, const Fit& fit) {
  const long long fill = (long long)fit.n_sm * fit.per_sm;
  const long long want = ((long long)n + kBlock - 1) / kBlock;
  return want < fill ? want : fill;
}

// The queue's memset and the kernel's launch on the stream s.
template <bool kNee>
int launch(const float* always, const Launch& L, void* queue, void* rays,
           const Params& p, const Grid& g, cudaStream_t s) {
  const size_t smem = smem_bytes(g.n_always);
  Fit fit;
  cudaError_t err = dda_fit<kNee>(smem, &fit);
  if (err != cudaSuccess) return (int)err;
  if (smem > kSmemDefault &&
      (err = opt_in_smem(stream_dda_kernel<kNee>)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(queue, 0, Q_WORDS * sizeof(int), s)) !=
      cudaSuccess)
    return (int)err;
  stream_dda_kernel<kNee><<<(int)first_wave(L.n, fit), kBlock, smem, s>>>(
      always, L, (int*)queue, (unsigned long long*)rays, p, g);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch smallpt_stream_dda makes on the current device for n lanes
// over n_always always rows, with NEE (nee != 0) or without: out, five
// int64 {blocks, threads (the first wave), n_sm, per_sm, smem bytes}
// (ops/stream_dda.py::PLAN_FIELDS). Returns a cudaError_t (the device
// query's).
extern "C" int smallpt_stream_dda_plan(int n, int n_always, int nee,
                                       void* out) {
  if (n < 0 || n_always < 0 || n_always > kMaxAlways)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n_always);
  Fit fit;
  const cudaError_t err =
      nee ? dda_fit<true>(smem, &fit) : dda_fit<false>(smem, &fit);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = first_wave(n, fit);
  const long long v[5] = {blocks, blocks * kBlock, fit.n_sm, fit.per_sm,
                          (long long)smem};
  memcpy(out, v, sizeof(v));
  return 0;
}

// Advance the DDA streaming state by at most params[IP_MAX_IT] iterations of
// every lane. always: (>= n_always, 16) f32 rows of the always table; cells:
// (C, K, 8) f32 slots; geom: (C, K) float4 [cx cy cz r] and count: (C,)
// int32, the slots' geometry and the filled slots of each cell
// (build_stream_dda_tables derives both from cells); table: the (S, 16)
// scene table (the winners' payload); cam: (16,) f32; f: (19 or 26, n) f32
// and i: (9, n) i32 state planes with n = params[IP_N_LANES] lanes, updated
// in place; rays: one u64 on the device that gains the rays this launch
// traced (the caller zeroes it); queue: Q_WORDS int32 of scratch on the
// device (zeroed here, on the stream; after the launch the lanes handed out
// and the lanes that had work); iparams/fparams: host arrays as for
// smallpt_stream_step (the first light slot is the NEE light's sphere id);
// dparams: host int32 [nx ny nz k n_always light_row] (light_row -1: no
// NEE); dfparams: host f32 [lo(3) cell(3) eps_local]; stream: a
// cudaStream_t. Returns the first cudaGetLastError().
extern "C" int smallpt_stream_dda(const void* always, const void* cells,
                                  const void* geom, const void* count,
                                  const void* table, const void* cam,
                                  void* f, void* i, void* rays, void* queue,
                                  const void* iparams, const void* fparams,
                                  const void* dparams, const void* dfparams,
                                  void* stream) {
  const Params p = read_params(iparams, fparams);
  Grid g;
  const int* di = (const int*)dparams;
  const float* df = (const float*)dfparams;
  for (int a = 0; a < 3; ++a) {
    g.n[a] = di[D_NX + a];
    g.lo[a] = df[DF_LOX + a];
    g.cl[a] = df[DF_CLX + a];
  }
  g.k = di[D_K];
  g.n_always = di[D_N_ALWAYS];
  g.light_row = di[D_LIGHT_ROW];
  g.eps = df[DF_EPS];
  for (int a = 0; a < 3; ++a)
    if (g.n[a] < 1 || g.n[a] > kMaxAxis) return (int)cudaErrorInvalidValue;
  if (!(g.eps >= 0.0f) || g.k < 1 || g.n_always < 0 ||
      g.n_always > kMaxAlways ||
      g.light_row >= g.n_always || p.i[IP_WIDTH] <= 0 ||
      p.i[IP_JITTER] <= 0 || p.i[IP_SPP_PER_CELL] <= 0 ||
      (g.light_row >= 0 && p.i[IP_N_LIGHTS] != 1))
    return (int)cudaErrorInvalidValue;
  const int n = p.i[IP_N_LANES];
  if (n <= 0) return 0;
  const Launch L{(const float*)cells, (const float4*)geom,
                 (const int*)count,   (const float*)table,
                 (const float*)cam,   (float*)f,
                 (int*)i,             n};
  return g.light_row >= 0
             ? launch<true>((const float*)always, L, queue, rays, p, g,
                            (cudaStream_t)stream)
             : launch<false>((const float*)always, L, queue, rays, p, g,
                             (cudaStream_t)stream);
}
