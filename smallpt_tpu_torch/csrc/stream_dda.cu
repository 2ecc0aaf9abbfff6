// Streaming megakernel with a per-ray DDA grid walk, for sm_90a (kernel K3).
//
// Replaces: smallpt_tpu/ops/stream_dda.py::_stream_dda_kernel, launched
// there by _stream_step_dda_jit through one pallas_call; entry point
// smallpt_stream_dda, kernel stream_dda_kernel.
//
// Each iteration advances a lane by one unit of its own work, in the JAX
// kernel's phase order, every mask taken at the start of the iteration:
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
// megakernel (K1), so both routes render the same paths.
//
// What bounds it on an H100: float work, as for K1, but the sweep shrinks
// from every sphere to the spheres of the cells a ray crosses: about 3-8
// cell steps of K <= 128 slots each on the procedural scenes, plus the
// always rows at each init. Each cell step reads its occupied slots, 32 B
// each, from the cell table (0.74 MB at 10k spheres: it stays in the 50 MB
// L2). chip_smoke.py gives both bounds, the operations (38 per ray-sphere
// test) and the slot bytes; the operations govern.
//
// What the design does about it:
// - one thread per lane with its state in registers, loading its 19 (26
//   with NEE) f32 and 9 i32 state planes at entry and storing them at exit,
//   as K1 streams; each lane loops on its own until it has no work or the
//   launch's iteration cap is reached (the TPU kernel steps 8x1024-lane
//   tiles in lockstep; per lane the result is the same);
// - the cell table stays in global memory (its reads go through L1/L2),
//   laid out (C, K, 8): a slot is [cx cy cz r id 0 0 0], one 32-B sector,
//   read as two 16-B loads; slots fill from the front, so a walk step stops
//   at the first empty one (id 3e38). The TPU's bf16x3 one-hot MXU gather
//   becomes this indexed load;
// - the always table's sweep columns [cx cy cz r eps id] sit in shared
//   memory, loaded once per block (24 B a row; opting in above 48 KB);
// - the winner's payload is one indexed load from the scene table by id
//   (the TPU kernel's id-match gather over the cell's slots);
// - the tie rules, the sentinels and the arithmetic order are the JAX
//   kernel's: the cell fold takes the least t and then the least id, the
//   running fold replaces on (t < bt) or (t == bt and id < bid), the always
//   sweep likewise; float-to-int truncation saturates (__float2int_rz), as
//   XLA's conversion does; built with --fmad=false;
// - the launch's ray count is the exact int64 sum of the lanes' increments
//   (one per main walk init), reduced per warp with one atomic per warp.
//
// Interface: a plain C function, loaded with ctypes (ops/stream_dda.py). It
// launches on the caller's stream, synchronises nothing and returns
// cudaGetLastError() of the launch.

#include "lane.cuh"

namespace {

using namespace smallpt;

constexpr int kBlock = 128;
constexpr int kMaxAxis = 32;      // the packed cell's 5 bits per axis
constexpr int kMaxAlways = 9600;  // ops/stream_dda.py::MAX_ALWAYS
constexpr int kSlot = 8;          // floats per cell slot
constexpr float kBigId = 3.0e38f;
constexpr float kTiny = 1e-20f;

// the walk planes after the classic ones (ops/stream_dda.py::_F_*, _I_*)
enum { F_TMX = F_COUNT, F_TMY, F_TMZ, F_BT, F_BID, F_SDX, F_SDY, F_SDZ,
       F_PCX, F_PCY, F_PCZ, F_TLG };
enum { I_CELL = I_COUNT, I_WALK, I_WCELL };
// grid launch arguments (ops/stream_dda.py::_dda_args, same order)
enum { D_NX, D_NY, D_NZ, D_K, D_N_ALWAYS, D_LIGHT_ROW, D_COUNT };
enum { DF_LOX, DF_LOY, DF_LOZ, DF_CLX, DF_CLY, DF_CLZ, DF_EPS, DF_COUNT };

struct Grid {
  int n[3];  // cells per axis
  int k, n_always, light_row;
  float lo[3], cl[3];
  float eps;  // the local spheres' intersection eps
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

__global__ void __launch_bounds__(kBlock)
stream_dda_kernel(const float* __restrict__ always,
                  const float* __restrict__ cells,
                  const float* __restrict__ table,
                  const float* __restrict__ cam, float* __restrict__ f,
                  int* __restrict__ st, unsigned long long* __restrict__ rays,
                  const Params p, const Grid g) {
  // the always table's sweep columns: 6 * n_always floats
  extern __shared__ float smem[];
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
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)p.i[IP_N_LANES];  // the plane stride
  long long traced = 0;
  if ((size_t)lane < n) {
    const bool nee = g.light_row >= 0;
    const int nx = g.n[0], ny = g.n[1], nz = g.n[2];
    const int n_cells = nx * ny * nz;
    // the grid's far corner and inverse cell size, in the JAX kernel's f32
    // arithmetic
    float ghi[3], invc[3];
    for (int a = 0; a < 3; ++a) {
      ghi[a] = g.lo[a] + g.cl[a] * (float)g.n[a];
      invc[a] = 1.0f / g.cl[a];
    }
    const Pixel px = pixel_of(p, lane);
    const uint32_t kk = (uint32_t)p.i[IP_K0] + (uint32_t)p.i[IP_K1];
    const int ip_offset = p.i[IP_IP_OFFSET];
    const int max_depth = p.i[IP_MAX_DEPTH];
    const bool flip_normals = p.i[IP_FLIP] != 0;
    const bool has_env = p.i[IP_HAS_ENV] != 0;
    // the NEE light: its sweep columns from the always table (its eps as the
    // always sweep uses it), its emission from the scene table
    float lcx = 0.0f, lcy = 0.0f, lcz = 0.0f, lrr = 0.0f, leps = 0.0f;
    float lex = 0.0f, ley = 0.0f, lez = 0.0f, li_f = -1.0f;
    if (nee) {
      const int lr = g.light_row;
      lcx = smem[lr];
      lcy = smem[na + lr];
      lcz = smem[2 * na + lr];
      lrr = smem[3 * na + lr];
      leps = smem[4 * na + lr];
      const float* lrow = table + 16 * p.lights[0];
      lex = __ldg(lrow + 5);
      ley = __ldg(lrow + 6);
      lez = __ldg(lrow + 7);
      li_f = (float)p.lights[0];
    }

    float* fl = f + lane;
    int* il = st + lane;
    float ox = fl[F_OX * n], oy = fl[F_OY * n], oz = fl[F_OZ * n];
    float dx = fl[F_DX * n], dy = fl[F_DY * n], dz = fl[F_DZ * n];
    float wx = fl[F_WX * n], wy = fl[F_WY * n], wz = fl[F_WZ * n];
    float rx = fl[F_RX * n], ry = fl[F_RY * n], rz = fl[F_RZ * n];
    float m1 = fl[F_M1 * n], m2 = fl[F_M2 * n];
    float tmx = fl[F_TMX * n], tmy = fl[F_TMY * n], tmz = fl[F_TMZ * n];
    float bt = fl[F_BT * n], bid = fl[F_BID * n];
    float sdx = 0.0f, sdy = 0.0f, sdz = 0.0f, pcx = 0.0f, pcy = 0.0f;
    float pcz = 0.0f, tlg = 0.0f;
    if (nee) {
      sdx = fl[F_SDX * n]; sdy = fl[F_SDY * n]; sdz = fl[F_SDZ * n];
      pcx = fl[F_PCX * n]; pcy = fl[F_PCY * n]; pcz = fl[F_PCZ * n];
      tlg = fl[F_TLG * n];
    }
    int depth = il[I_DEPTH * n], s_idx = il[I_SIDX * n];
    bool alive = il[I_ALIVE * n] != 0;
    int nrays = il[I_RAYS * n];
    const int budget = il[I_BUDGET * n];
    int sup = il[I_SUP * n];
    int cellp = il[I_CELL * n], walk = il[I_WALK * n];
    int wcell = il[I_WCELL * n];
    const int rays0 = nrays;

    const int max_it = p.i[IP_MAX_IT];
    for (int it = 0; it < max_it; ++it) {
      if (!(alive || s_idx < budget - 1)) break;
      // walk states: 0 a fresh ray needs init, 1 main walk, 2 resolve,
      // 3 shadow walk (the path continues after), 4 shadow walk then death
      const bool is_shadow = nee && (walk == 3 || walk == 4);
      const bool stepping = walk == 1 || is_shadow;
      const bool resolving = alive && walk == 2;

      // ---- 1. walk step: fold the cell's candidates, early-exit test, DDA
      // advance. Cells are stored packed but the table index is linear.
      if (stepping) {
        const float wdx = is_shadow ? sdx : dx;
        const float wdy = is_shadow ? sdy : dy;
        const float wdz = is_shadow ? sdz : dz;
        const int ix = cellp >> 10, iy = (cellp >> 5) & 31, iz = cellp & 31;
        const int lin = (ix * ny + iy) * nz + iz;
        float m = kBig, idc = kBigId;
        if (lin >= 0 && lin < n_cells) {
          const float* slot = cells + (size_t)lin * g.k * kSlot;
          for (int q = 0; q < g.k; ++q, slot += kSlot) {
            const float sid = __ldg(slot + 4);
            if (sid >= kBigId) break;  // the cell's other slots are empty
            const float4 sp = __ldg((const float4*)slot);
            const float tt = sphere_tt(ox, oy, oz, wdx, wdy, wdz, sp.x, sp.y,
                                       sp.z, sp.w, g.eps);
            if (tt < m) {
              m = tt;
              idc = sid;
            } else if (tt == m && sid < idc) {
              idc = sid;
            }
          }
        }
        if (m < kBig && (m < bt || (m == bt && idc < bid))) {
          bt = m;
          bid = idc;
          wcell = cellp;
        }
        const float t_exit = fminf(fminf(tmx, tmy), tmz);
        const bool ax = tmx <= tmy && tmx <= tmz;
        const bool ay = !ax && tmy <= tmz;
        const bool az = !ax && !ay;
        const float dtx = fabsf(wdx) < kTiny ? kBig : g.cl[0] / fabsf(wdx);
        const float dty = fabsf(wdy) < kTiny ? kBig : g.cl[1] / fabsf(wdy);
        const float dtz = fabsf(wdz) < kTiny ? kBig : g.cl[2] / fabsf(wdz);
        const int ix2 = ax ? ix + (wdx >= 0.0f ? 1 : -1) : ix;
        const int iy2 = ay ? iy + (wdy >= 0.0f ? 1 : -1) : iy;
        const int iz2 = az ? iz + (wdz >= 0.0f ? 1 : -1) : iz;
        const bool inside2 = ix2 >= 0 && ix2 < nx && iy2 >= 0 && iy2 < ny &&
                             iz2 >= 0 && iz2 < nz;
        const bool walk_done = walk == 1 && (bt <= t_exit || !inside2);
        bool sdone = false;
        if (is_shadow) {
          // a shadow walk ends once occlusion is decided: a confirmed
          // closest hit, no later cell nearer than the light, or off-grid
          sdone = bt <= t_exit || t_exit >= tlg || !inside2;
          if (sdone) {
            if (bt >= tlg && tlg < kBig) {
              rx = rx + pcx;
              ry = ry + pcy;
              rz = rz + pcz;
            }
            // deferred death (walk 4): the vertex's direct sample is in
            if (walk == 4) alive = false;
          }
        }
        if (!(walk_done || sdone)) {
          cellp = (ix2 << 10) | (iy2 << 5) | iz2;
          if (ax) tmx = tmx + dtx;
          if (ay) tmy = tmy + dty;
          if (az) tmz = tmz + dtz;
        }
        if (walk_done) walk = 2;
        if (sdone) walk = 0;
      }

      // ---- 2. resolve: the winner's payload, emission, shade ------------
      bool samp = false;
      if (resolving) {
        const bool hit = bt < kBig;
        uint32_t wa, wb;
        stream_words(p, px, ip_offset + s_idx, wa, wb);
        bool parent = false;
        if (!hit) {
          // escaped: pick up the environment (the smallpt.cpp:168 hook)
          if (has_env) {
            rx = rx + wx * p.f[FP_ENV_R];
            ry = ry + wy * p.f[FP_ENV_G];
            rz = rz + wz * p.f[FP_ENV_B];
          }
        } else {
          const float* row = table + 16 * (int)bid;
          const float hx = ox + bt * dx;
          const float hy = oy + bt * dy;
          const float hz = oz + bt * dz;
          float nx_ = hx - __ldg(row + 0);
          float ny_ = hy - __ldg(row + 1);
          float nz_ = hz - __ldg(row + 2);
          normalize3(nx_, ny_, nz_);
          float nlx = nx_, nly = ny_, nlz = nz_;
          if (flip_normals && !(nx_ * dx + ny_ * dy + nz_ * dz < 0.0f)) {
            nlx = -nx_;
            nly = -ny_;
            nlz = -nz_;
          }
          // emission; the NEE light's is suppressed when the previous
          // vertex sampled it (one slot)
          if (!(nee && bid == li_f && (sup & 1) == 1)) {
            rx = rx + wx * __ldg(row + 5);
            ry = ry + wy * __ldg(row + 6);
            rz = rz + wz * __ldg(row + 7);
          }
          uint32_t sa = wa, sb = wb, sc = (uint32_t)depth + kGolden, sd = kk;
          pcg4d(sa, sb, sc, sd);
          const Shade sh = shade(p, dx, dy, dz, nx_, ny_, nz_, nlx, nly, nlz,
                                 __ldg(row + 8), __ldg(row + 9),
                                 __ldg(row + 10), __ldg(row + 11),
                                 to_unit(sa), to_unit(sb), to_unit(sc),
                                 to_unit(sd), depth);
          if (sh.survive) {
            parent = true;
            const float nox = hx + sh.eps_off * nlx;
            const float noy = hy + sh.eps_off * nly;
            const float noz = hz + sh.eps_off * nlz;
            // ---- 3. NEE: cone-sample the light; the occlusion test is a
            // shadow walk from the next init on
            float ldx, ldy, ldz, t_light, scale;
            if (nee && sh.diffuse &&
                nee_cone(p, nox, noy, noz, nlx, nly, nlz, lcx, lcy, lcz, lrr,
                         leps, wa, wb, (uint32_t)depth + kNeeSalt, ldx, ldy,
                         ldz, t_light, scale)) {
              samp = true;
              sdx = ldx;
              sdy = ldy;
              sdz = ldz;
              pcx = wx * sh.fx * lex * scale;
              pcy = wy * sh.fy * ley * scale;
              pcz = wz * sh.fz * lez * scale;
              tlg = t_light;
            }
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
        }
        if (nee) sup = samp ? 1 : 0;
        ++depth;
        const bool bounce_alive = parent && depth < max_depth;
        alive = bounce_alive || samp;
        walk = samp ? (bounce_alive ? 3 : 4) : 0;
      }

      // ---- 4. regenerate a dead lane with its pixel's next sample ---------
      if (!alive && s_idx < budget - 1) {
        // the finished sample's luminance is lum(radiance) - m1; m2 sums its
        // square for the variance estimate of adaptive sampling
        const float cur_lum = (rx + ry + rz) * kThird;
        const float delta = cur_lum - m1;
        m2 = m2 + delta * delta;
        m1 = cur_lum;
        ++s_idx;
        uint32_t wa, wb;
        stream_words(p, px, ip_offset + s_idx, wa, wb);
        camera_ray(p, cam, px, ip_offset + s_idx, wa, wb, ox, oy, oz, dx, dy,
                   dz);
        wx = 1.0f;
        wy = 1.0f;
        wz = 1.0f;
        depth = 0;
        alive = true;
        walk = 0;
        sup = 0;
      }

      // ---- 5. walk init: always sweep + grid clip, for a fresh main ray or
      // a freshly sampled shadow ray (a lane is at most one of them) -------
      const bool init_main = alive && walk == 0;
      if (init_main || samp) {
        const float idx = samp ? sdx : dx;
        const float idy = samp ? sdy : dy;
        const float idz = samp ? sdz : dz;
        float abt = kBig, abid = kBigId;
        for (int s = 0; s < na; ++s) {
          const float tt = sphere_tt(ox, oy, oz, idx, idy, idz, smem[s],
                                     smem[na + s], smem[2 * na + s],
                                     smem[3 * na + s], smem[4 * na + s]);
          const float sid = smem[5 * na + s];
          if (tt < kBig && (tt < abt || (tt == abt && sid < abid))) {
            abt = tt;
            abid = sid;
          }
        }
        const float o3[3] = {ox, oy, oz};
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
          // rays missing the grid keep BIG t_max, so a shadow walk that
          // never enters a cell resolves on its first step
          tmn[a] = (!hits_grid || fabsf(d3[a]) < kTiny) ? kBig
                                                        : (nxt - o3[a]) / dn[a];
        }
        bt = abt;
        bid = abid;
        wcell = -1;
        if (hits_grid) cellp = (ci[0] << 10) | (ci[1] << 5) | ci[2];
        tmx = tmn[0];
        tmy = tmn[1];
        tmz = tmn[2];
        if (init_main) {
          // main rays walk, or resolve at once when they miss the grid; one
          // traced ray per main walk init
          walk = hits_grid ? 1 : 2;
          ++nrays;
        }
      }
    }

    fl[F_OX * n] = ox; fl[F_OY * n] = oy; fl[F_OZ * n] = oz;
    fl[F_DX * n] = dx; fl[F_DY * n] = dy; fl[F_DZ * n] = dz;
    fl[F_WX * n] = wx; fl[F_WY * n] = wy; fl[F_WZ * n] = wz;
    fl[F_RX * n] = rx; fl[F_RY * n] = ry; fl[F_RZ * n] = rz;
    fl[F_M1 * n] = m1; fl[F_M2 * n] = m2;
    fl[F_TMX * n] = tmx; fl[F_TMY * n] = tmy; fl[F_TMZ * n] = tmz;
    fl[F_BT * n] = bt; fl[F_BID * n] = bid;
    if (nee) {
      fl[F_SDX * n] = sdx; fl[F_SDY * n] = sdy; fl[F_SDZ * n] = sdz;
      fl[F_PCX * n] = pcx; fl[F_PCY * n] = pcy; fl[F_PCZ * n] = pcz;
      fl[F_TLG * n] = tlg;
    }
    il[I_DEPTH * n] = depth;
    il[I_SIDX * n] = s_idx;
    il[I_ALIVE * n] = alive ? 1 : 0;
    il[I_RAYS * n] = nrays;
    il[I_SUP * n] = sup;
    il[I_CELL * n] = cellp;
    il[I_WALK * n] = walk;
    il[I_WCELL * n] = wcell;
    traced = (long long)nrays - (long long)rays0;
  }
  add_rays(rays, traced);
}

}  // namespace

// Advance the DDA streaming state by at most params[IP_MAX_IT] iterations of
// every lane. always: (>= n_always, 16) f32 rows of the always table; cells:
// (C, K, 8) f32 slots; table: the (S, 16) scene table (the winners'
// payload); cam: (16,) f32; f: (19 or 26, n) f32 and i: (9, n) i32 state
// planes with n = params[IP_N_LANES] lanes, updated in place; rays: one u64
// on the device that gains the rays this launch traced (the caller zeroes
// it); iparams/fparams: host arrays as for smallpt_stream_step (the first
// light slot is the NEE light's sphere id); dparams: host int32
// [nx ny nz k n_always light_row] (light_row -1: no NEE); dfparams: host
// f32 [lo(3) cell(3) eps_local]; stream: a cudaStream_t. Returns the
// launch's cudaGetLastError().
extern "C" int smallpt_stream_dda(const void* always, const void* cells,
                                  const void* table, const void* cam, void* f,
                                  void* i, void* rays, const void* iparams,
                                  const void* fparams, const void* dparams,
                                  const void* dfparams, void* stream) {
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
  if (g.k < 1 || g.n_always < 0 || g.n_always > kMaxAlways ||
      g.light_row >= g.n_always || p.i[IP_WIDTH] <= 0 ||
      p.i[IP_JITTER] <= 0 || p.i[IP_SPP_PER_CELL] <= 0 ||
      (g.light_row >= 0 && p.i[IP_N_LIGHTS] != 1))
    return (int)cudaErrorInvalidValue;
  const int n = p.i[IP_N_LANES];
  if (n <= 0) return 0;
  const size_t smem = 6 * sizeof(float) * (size_t)g.n_always;
  if (smem > kSmemDefault) {
    const cudaError_t err = opt_in_smem(stream_dda_kernel);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (n + kBlock - 1) / kBlock;
  stream_dda_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      (const float*)always, (const float*)cells, (const float*)table,
      (const float*)cam, (float*)f, (int*)i, (unsigned long long*)rays,
      p, g);
  return (int)cudaGetLastError();
}
