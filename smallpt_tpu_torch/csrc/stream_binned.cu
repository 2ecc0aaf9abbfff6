// The binned scheduler's bounce for sm_90a (kernel K8): one culled,
// frontier-marching bounce of every lane of the binned streaming state.
//
// Replaces: smallpt_tpu/ops/megakernel.py::_binned_kernel (:1414-1935),
// launched there by stream_step_binned (:2268) through one pallas_call
// (:2342); entry point smallpt_stream_binned, kernel stream_binned_kernel.
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
// What bounds it on an H100: the float work of the sweep, ~38 ops a (lane,
// swept row) pair (lane.cuh::sphere_tt and its compare; a square root or a
// division one op), for an alive lane's ray and for each pending shadow,
// over the rows of the chunks each tile really sweeps (chip_smoke.py counts
// them from this launch's stops, alive lanes and pending bits); the
// state's bytes (in and out once, ~200
// B a lane) and the table are far below that at the 10,000-sphere scene.
//
// What the design does about it:
// - one thread a lane. Finality is per lane, and the lists are per tile, so
//   a tile of 8 x 1,024 lanes spans 32 blocks of kBlock = 256 threads (a
//   quarter of one of its 8 rows each), every block reading its tile's
//   stops, list and dcut: exact, and 3,072 blocks at 786,432 lanes, where
//   one block a tile would leave most SMs idle (PERF.md, K7);
// - the block's chunk sequence is uniform, so it is staged through shared
//   memory kBatch chunks (512 rows, 12 KB) at a time, each row read by all
//   threads at once, a broadcast; rows of radius 0 are skipped uniformly
//   (never hit, so the fold is unchanged);
// - a lane without work skips the sweep's arithmetic but still helps
//   stage; its outputs follow from final = pending = false; a warp runs
//   the ray's fold only if one of its lanes is alive and a slot's only if
//   one holds that shadow (fold_rows, chosen once a warp);
// - the state planes are read and written coalesced (consecutive threads,
//   consecutive columns), in place: each thread reads its lane before it
//   writes it;
// - the NEE slots live in registers up to two lights (template kL = 2),
//   in local memory above (kL = 31);
// - built with --fmad=false, so each op rounds as in the JAX kernel and in
//   the plain version (ops/megakernel.py::stream_step_binned_plain).
// Not done yet (later perf work): cp.async double buffering of the chunk
// batches, skipping the rows of chunks a whole warp cannot reach.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// caller's stream, synchronises nothing and returns cudaGetLastError() of
// the launch.

#include "lane.cuh"

namespace {

using namespace smallpt;

constexpr int kLaneB = 1024;  // columns a tile (megakernel._LANE_B)
constexpr int kBlock = 256;   // threads a block: a quarter of a tile row
constexpr int kBatch = 64;    // chunks staged in shared memory at once
constexpr int kSubStride = 1 << 20;  // megakernel._BINNED_SUB_STRIDE

// The binned planes after the classic ones (ops/megakernel.py _F_BT...).
enum { F_BT = F_COUNT, F_BID, F_TS, F_NLX, F_NLY, F_NLZ, F_LD0 };
enum { I_PIXEL = I_COUNT, I_PEND, I_NEEP };
// The binned launch arguments (ops/megakernel.py::stream_step_binned).
enum { B_NCOLS, B_NGLOB, B_NCHUNKS, B_LMAX, B_SHIFT, B_MODE, B_NTILES,
       B_COUNT };
enum { MODE_FULL, MODE_NORMAL, MODE_EMISSION, MODE_INST_ID, MODE_UV };

struct Binned {
  int i[B_COUNT];
  float geo_lo[3], geo_hi[3];
};

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

// Fold n_rows staged rows (radius 0 rows skipped: never hit) into the
// lane's candidate (bt, bi) along its ray if kP, with the strict < of the
// JAX kernel, and into each slot's least shadow candidate along its
// direction if kS, for the slots in the warp's mask.
template <bool kP, bool kS, int kL>
__device__ __forceinline__ void fold_rows(
    int n_rows, const float4* s_row, const float* s_eps, const float* s_id,
    float ox, float oy, float oz, float dx, float dy, float dz,
    const float (&ld)[kL > 0 ? kL : 1][3], int slots, float& bt, float& bi,
    float (&sbt)[kL > 0 ? kL : 1]) {
  for (int k = 0; k < n_rows; ++k) {
    const float4 c = s_row[k];
    if (!(c.w > 0.0f)) continue;
    const float e = s_eps[k];
    if (kP) {
      const float tt =
          sphere_tt(ox, oy, oz, dx, dy, dz, c.x, c.y, c.z, c.w, e);
      if (tt < bt) {
        bt = tt;
        bi = s_id[k];
      }
    }
    if (kS) {
#pragma unroll 2
      for (int s = 0; s < kL; ++s) {
        if ((slots >> s) & 1)
          sbt[s] = fminf(sbt[s], sphere_tt(ox, oy, oz, ld[s][0], ld[s][1],
                                           ld[s][2], c.x, c.y, c.z, c.w, e));
      }
    }
  }
}

template <int kL>
__global__ void __launch_bounds__(kBlock)
    stream_binned_kernel(const float* __restrict__ table, float* f, int* st,
                         const int* __restrict__ stops,
                         const int* __restrict__ lists,
                         const float* __restrict__ dcut,
                         unsigned long long* rays, Params p, Binned b) {
  __shared__ float4 s_row[kBatch * 8];
  __shared__ float s_eps[kBatch * 8];
  __shared__ float s_id[kBatch * 8];
  constexpr int kSlots = kL > 0 ? kL : 1;
  const int n_cols = b.i[B_NCOLS];
  const int col = blockIdx.x * kBlock + threadIdx.x;
  const int tile = blockIdx.x * kBlock / kLaneB;
  const size_t lane = (size_t)blockIdx.y * n_cols + col;
  const size_t stride = (size_t)8 * n_cols;
  float* const fl = f + lane;
  int* const il = st + lane;
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
  const bool alive = il[I_ALIVE * stride] != 0;
  const int q = il[I_PIXEL * stride];
  const int sup = il[I_SUP * stride];
  const int neep = kL > 0 ? il[I_NEEP * stride] : 0;
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
  const bool work = alive || neep != 0;
  // What the sweep folds is chosen a warp at a time: a lane's own needs
  // would diverge inside the warp and save nothing. The primary fold runs
  // if a lane of the warp is alive, a slot's if a lane holds that slot's
  // shadow; the lanes that do not need a fold leave its result unread.
  const bool warp_p = __any_sync(0xffffffffu, alive);
  const int slots = kL > 0 ? __reduce_or_sync(0xffffffffu, neep) : 0;
  const bool warp_s = slots != 0;

  // ---- the culled sweep: the global chunks, then the tile's swept list ----
  const int n_glob = b.i[B_NGLOB];
  const int l_max = b.i[B_LMAX];
  const int stop = stops[tile];
  const bool full = stop < 0;
  const int n_seq = n_glob + (full ? b.i[B_NCHUNKS] : stop);
  const int* list = lists + (size_t)tile * l_max;
  for (int base = 0; base < n_seq; base += kBatch) {
    const int n_rows = 8 * min(kBatch, n_seq - base);
    __syncthreads();  // the previous batch's readers are done
    for (int k = threadIdx.x; k < n_rows; k += kBlock) {
      const int j = base + (k >> 3);
      const int local = j - n_glob;
      const int cid = j < n_glob ? j
                      : n_glob + (full ? local
                                       : list[min(local, l_max - 1)]);
      const int r = 8 * cid + (k & 7);
      s_row[k] = __ldg(reinterpret_cast<const float4*>(table) + 4 * r);
      s_eps[k] = __ldg(table + 16 * r + 4);
      s_id[k] = (float)r;
    }
    __syncthreads();
    if (!work) continue;
    if (warp_p && warp_s)
      fold_rows<true, true, kL>(n_rows, s_row, s_eps, s_id, ox, oy, oz, dx,
                                dy, dz, ld, slots, bt, bi, sbt);
    else if (warp_p)
      fold_rows<true, false, kL>(n_rows, s_row, s_eps, s_id, ox, oy, oz, dx,
                                 dy, dz, ld, slots, bt, bi, sbt);
    else
      fold_rows<false, true, kL>(n_rows, s_row, s_eps, s_id, ox, oy, oz,
                                 dx, dy, dz, ld, slots, bt, bi, sbt);
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
  add_rays(rays, final_ ? 1 : 0);
}

template <int kL>
cudaError_t launch(const float* table, float* f, int* i, const int* stops,
                   const int* lists, const float* dcut,
                   unsigned long long* rays, const Params& p,
                   const Binned& b, cudaStream_t stream) {
  const dim3 grid(b.i[B_NCOLS] / kBlock, 8);
  stream_binned_kernel<kL><<<grid, kBlock, 0, stream>>>(
      table, f, i, stops, lists, dcut, rays, p, b);
  return cudaGetLastError();
}

}  // namespace

// One binned bounce over the state f (8 * nf, n_cols) f32 and i (8 * ni,
// n_cols) i32, in place. table: the accel-ordered (S_pad, 16) f32 table;
// stops (T,) i32, lists (T, l_max) i32, dcut (T,) f32, T = n_cols / 1024;
// rays: one u64 on the device that gains the lanes this launch finalized
// (the caller zeroes it). iparams/fparams: the megakernel's launch
// arguments (lane.cuh IP_*/FP_*; the light slots hold the NEE lights'
// table rows); bparams_i: {n_cols, n_glob, n_chunks, l_max, log2 inflight,
// mode, n_tiles}; bparams_f: {geo_lo[3], geo_hi[3]}; stream: a
// cudaStream_t. Returns the launch's cudaGetLastError().
extern "C" int smallpt_stream_binned(const void* table, void* f, void* i,
                                     const void* stops, const void* lists,
                                     const void* dcut, void* rays,
                                     const void* iparams,
                                     const void* fparams,
                                     const void* bparams_i,
                                     const void* bparams_f, void* stream) {
  const Params p = read_params(iparams, fparams);
  Binned b;
  memcpy(b.i, bparams_i, sizeof(b.i));
  memcpy(b.geo_lo, bparams_f, sizeof(b.geo_lo));
  memcpy(b.geo_hi, (const float*)bparams_f + 3, sizeof(b.geo_hi));
  const int n_l = p.i[IP_N_LIGHTS];
  if (b.i[B_NCOLS] <= 0 || b.i[B_NCOLS] % kLaneB ||
      b.i[B_NTILES] != b.i[B_NCOLS] / kLaneB || b.i[B_NGLOB] < 0 ||
      b.i[B_NCHUNKS] < 0 || b.i[B_LMAX] < 1 || b.i[B_SHIFT] < 0 ||
      b.i[B_SHIFT] > 6 || b.i[B_MODE] < MODE_FULL || b.i[B_MODE] > MODE_UV ||
      n_l < 0 || n_l > kMaxLights)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  auto* t = (const float*)table;
  auto* ff = (float*)f;
  auto* ii = (int*)i;
  auto* sp = (const int*)stops;
  auto* lp = (const int*)lists;
  auto* dp = (const float*)dcut;
  auto* rp = (unsigned long long*)rays;
  if (n_l == 0) return (int)launch<0>(t, ff, ii, sp, lp, dp, rp, p, b, s);
  if (n_l <= 2) return (int)launch<2>(t, ff, ii, sp, lp, dp, rp, p, b, s);
  return (int)launch<kMaxLights>(t, ff, ii, sp, lp, dp, rp, p, b, s);
}
