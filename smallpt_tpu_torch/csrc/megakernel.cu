// Wavefront megakernel for sm_90a: regenerate + intersect + shade (+ NEE),
// fused into one launch.
//
// Replaces: smallpt_tpu/ops/megakernel.py::_mega_kernel in its three uses,
// each launched there through one pallas_call:
// - per-pass (streaming=False), launched by render_pass_megakernel: entry
//   point smallpt_mega_pass, kernel mega_pass_kernel (K1a);
// - per-pass with record_depths, launched by render_record_megakernel (the
//   recorder of grad/replay.py): entry point smallpt_mega_record, the same
//   kernel with kRecord (K1b);
// - streaming (streaming=True), launched by stream_step: entry point
//   smallpt_stream_step, kernel stream_step_kernel (K1c).
// All run one per-lane body, trace_lane<kStreaming, kGlobal, kRecord>, with
// next-event estimation over up to kMaxLights light spheres. The camera,
// shade and NEE cone formulas live in lane.cuh, shared with the streaming
// DDA kernel (stream_dda.cu).
//
// What bounds it on an H100: FP32 ALU work, not memory. A per-pass launch
// reads a sphere table of S x 64 bytes and writes 16 bytes per pixel lane; a
// streaming launch reads and writes 80 bytes of state per lane. Every ray
// costs about 27 float ops per sphere in the closest-hit sweep (plus 3
// square roots and a division) and a few hundred for regeneration, PCG4D
// hashing and shading; each NEE shadow ray costs a cone sample and another
// sweep. The Cornell box (S = 9) spends ~250 ops per ray in the sweep and
// ~200 in the rest. The card's float32 rate outside the tensor cores is
// 67 TFLOP/s, counting an FMA as two flops; built with --fmad=false this
// kernel issues no FMA, so its adds and multiplies retire at most at
// 33.5 T/s. Square roots and divisions are multi-instruction sequences,
// counted here as one op each.
//
// What the design does about it:
// - one thread per pixel lane, each looping on its own until its samples
//   are done or the launch's iteration cap is reached (the TPU kernel's
//   tile-wide any() exists only because 8x1024 lanes retire together); per
//   lane the result is the same. Only two values of a lane that went idle
//   differ: the TPU tile keeps adding 1 to an idle lane's depth and
//   clearing its suppression bits, which the lane's next regeneration
//   resets anyway;
// - path state lives in registers. Per-pass, only radiance (G, 3) f32 and
//   the ray count (G,) i32 are written, once per lane. Streaming, each lane
//   loads its 14 f32 and 6 i32 state planes at entry and stores them at
//   exit (the budget plane is read only); the planes are lane-contiguous,
//   so the loads and stores coalesce. The launch's ray count is the exact
//   sum of the per-lane counter's increments, reduced per warp and added
//   with one 64-bit atomic per warp;
// - the sweep columns [cx cy cz r eps] sit in shared memory, loaded once per
//   block and sized to the scene (20 B a sphere), read as warp-wide
//   broadcasts. Up to 2457 spheres fit the 48 KB a launch gets by default;
//   above that the launcher opts the kernel in to the card's limit (227 KB
//   on an H100, 11,622 spheres), and above that the kernel's second
//   instance, trace_lane's kGlobal = true, sweeps the table's rows straight
//   from global memory (cached in L1/L2, one broadcast row per sphere). The
//   JAX kernel takes up to MAX_VMEM_SPHERES = 65536 spheres, and so does
//   this one. The sweep and the shadow sweep visit the scene's n_spheres
//   rows, not the table's padding to a multiple of 8 (as the JAX kernel's
//   SMEM sweep does);
// - the TPU kernel's 12-way per-sphere select fold (it has no per-lane
//   gather) becomes one indexed load of the winner's material row;
// - the NEE shadow sweep keeps the sweep's arithmetic. A shadow ray is lit
//   when the light's own candidate is finite and no other sphere's is
//   nearer: the JAX kernel's min-over-all-spheres >= t_light with the light
//   taken out of the minimum, so the test never compares one value computed
//   twice;
// - the sweep keeps _shadow_tt's citardauq arithmetic, strict < for ties
//   (the first id wins) and the 3e38 sentinel; built with --fmad=false so
//   each op rounds in the JAX kernel's order.
//
// Interface: plain C functions, loaded with ctypes (ops/megakernel.py). They
// launch on the caller's stream, synchronise nothing and return
// cudaGetLastError() of the launch.

#include "lane.cuh"

namespace {

using namespace smallpt;

constexpr int kMaxSpheres = 65536;  // the JAX kernel's MAX_VMEM_SPHERES
constexpr int kBlock = 128;

// One lane's path state: the streaming planes, in registers.
struct Lane {
  float ox, oy, oz, dx, dy, dz, wx, wy, wz, rx, ry, rz, m1, m2;
  int depth, s_idx, nrays;
  bool alive;
  uint32_t sup;  // bit s: the previous vertex sampled light slot s
};

// The sweep columns [cx cy cz r eps] of sphere s: from the shared-memory
// copy (five columns of n), or with kGlobal straight from the (S, 16) table.
template <bool kGlobal>
struct Columns {
  const float* base;
  int n;
  __device__ __forceinline__ float get(int col, int s) const {
    return kGlobal ? __ldg(base + 16 * s + col) : base[col * n + s];
  }
};

// The sweep columns of the first n spheres: copied into shared memory (every
// thread of the block must call it), or with kGlobal the table itself.
template <bool kGlobal>
__device__ __forceinline__ Columns<kGlobal> load_columns(const float* table,
                                                         float* smem, int n) {
  if (kGlobal) return Columns<kGlobal>{table, n};
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const float* row = table + 16 * s;
    smem[s] = row[0];
    smem[n + s] = row[1];
    smem[2 * n + s] = row[2];
    smem[3 * n + s] = row[3];
    smem[4 * n + s] = row[4];
  }
  __syncthreads();
  return Columns<kGlobal>{smem, n};
}

// The per-lane loop of _mega_kernel: at most max_it iterations, each one
// bounce of the lane's path, regenerating with the pixel's next sample
// while s_idx < budget - 1. With kRecord (budget 1), rec receives the
// lane's winner at each depth (see above).
template <bool kStreaming, bool kGlobal, bool kRecord = false>
__device__ __forceinline__ void trace_lane(Lane& L, const Params& p,
                                           const float* __restrict__ table,
                                           const float* __restrict__ cam,
                                           const Columns<kGlobal>& col,
                                           int lane, int budget, int max_it,
                                           int* __restrict__ rec = nullptr) {
  const int n_spheres = p.i[IP_N_SPHERES];
  const int n_lights = p.i[IP_N_LIGHTS];
  const Pixel px = pixel_of(p, lane);
  const uint32_t k0 = (uint32_t)p.i[IP_K0];
  const uint32_t k1 = (uint32_t)p.i[IP_K1];
  const uint32_t kk = k0 + k1;
  const int ip_offset = p.i[IP_IP_OFFSET];
  const uint32_t spp = (uint32_t)p.i[IP_SPP];
  const int max_depth = p.i[IP_MAX_DEPTH];
  const bool flip_normals = p.i[IP_FLIP] != 0;
  const bool has_env = p.i[IP_HAS_ENV] != 0;
  const float shading_eps = p.f[FP_SHADING_EPS];
  const size_t n_lanes = (size_t)p.i[IP_N_LANES];  // the record's stride

  float ox = L.ox, oy = L.oy, oz = L.oz, dx = L.dx, dy = L.dy, dz = L.dz;
  float wx = L.wx, wy = L.wy, wz = L.wz, rx = L.rx, ry = L.ry, rz = L.rz;
  float m1 = L.m1, m2 = L.m2;
  int depth = L.depth, s_idx = L.s_idx, nrays = L.nrays;
  bool alive = L.alive;
  uint32_t sup = L.sup;

  // The current sample's PCG4D words a and b: per pass (sid ^ k0, k1) with
  // sid = pixel * spp + ip; streaming v2 (pixel ^ k0, k1 ^ ip * mult).
  auto sample_words = [&](uint32_t& wa, uint32_t& wb) {
    const uint32_t ip = (uint32_t)(ip_offset + s_idx);
    if (kStreaming) {
      stream_words(p, px, (int)ip, wa, wb);
    } else {
      wa = (px.id * spp + ip) ^ k0;
      wb = k1;
    }
  };
  uint32_t wa = 0, wb = 0;
  sample_words(wa, wb);

  for (int it = 0; it < max_it; ++it) {
    // ---- regenerate with the pixel's next sample ---------------------------
    if (!alive) {
      if (s_idx >= budget - 1) break;
      if (kStreaming) {
        // the finished sample's luminance is lum(radiance) - m1; m2 sums its
        // square for the variance estimate of adaptive sampling
        const float cur_lum = (rx + ry + rz) * kThird;
        const float delta = cur_lum - m1;
        m2 = m2 + delta * delta;
        m1 = cur_lum;
      }
      ++s_idx;
      sample_words(wa, wb);
      camera_ray(p, cam, px, ip_offset + s_idx, wa, wb, ox, oy, oz, dx, dy,
                 dz);
      wx = 1.0f;
      wy = 1.0f;
      wz = 1.0f;
      depth = 0;
      sup = 0u;
      alive = true;
    }
    ++nrays;

    // ---- closest-hit sweep over the sphere columns -------------------------
    float bt = kBig;
    int bi = -1;
    for (int s = 0; s < n_spheres; ++s) {
      const float tt = sphere_tt(ox, oy, oz, dx, dy, dz, col.get(0, s),
                                 col.get(1, s), col.get(2, s), col.get(3, s),
                                 col.get(4, s));
      if (tt < bt) {
        bt = tt;
        bi = s;
      }
    }
    if (kRecord) rec[(size_t)depth * n_lanes + lane] = bi;
    if (bi < 0) {
      // escaped: pick up the environment (the smallpt.cpp:168 hook), die
      if (has_env) {
        rx = rx + wx * p.f[FP_ENV_R];
        ry = ry + wy * p.f[FP_ENV_G];
        rz = rz + wz * p.f[FP_ENV_B];
      }
      alive = false;
      sup = 0u;
      ++depth;
      continue;
    }

    // ---- the winner's row: one indexed load --------------------------------
    const float* row = table + 16 * bi;
    const float hx = ox + bt * dx;
    const float hy = oy + bt * dy;
    const float hz = oz + bt * dz;
    float nx = hx - __ldg(row + 0);
    float ny = hy - __ldg(row + 1);
    float nz = hz - __ldg(row + 2);
    normalize3(nx, ny, nz);
    float nlx = nx, nly = ny, nlz = nz;
    if (flip_normals && !(nx * dx + ny * dy + nz * dz < 0.0f)) {
      nlx = -nx;
      nly = -ny;
      nlz = -nz;
    }

    // emission, pre-RR (smallpt.cpp:179); with NEE, a light that the
    // previous vertex sampled is suppressed here (one sup bit per slot)
    bool emit = true;
    for (int slot = 0; slot < n_lights; ++slot) {
      if (bi == p.lights[slot] && ((sup >> slot) & 1u)) emit = false;
    }
    if (emit) {
      rx = rx + wx * __ldg(row + 5);
      ry = ry + wy * __ldg(row + 6);
      rz = rz + wz * __ldg(row + 7);
    }

    const int d_shade = depth;
    uint32_t sa = wa, sb = wb, sc = (uint32_t)d_shade + kGolden, sd = kk;
    pcg4d(sa, sb, sc, sd);
    const Shade sh = shade(p, dx, dy, dz, nx, ny, nz, nlx, nly, nlz,
                           __ldg(row + 8), __ldg(row + 9), __ldg(row + 10),
                           __ldg(row + 11), to_unit(sa), to_unit(sb),
                           to_unit(sc), to_unit(sd), depth);
    ++depth;
    if (!sh.survive) {
      alive = false;
      sup = 0u;
      continue;
    }

    uint32_t new_sup = 0u;
    if (sh.diffuse) {
      // ---- next-event estimation: cone-sample each light outside its
      // shell, sweep the scene for a nearer sphere, add f*Le*cos*omega/pi
      const float nox = hx + shading_eps * nlx;
      const float noy = hy + shading_eps * nly;
      const float noz = hz + shading_eps * nlz;
      for (int slot = 0; slot < n_lights; ++slot) {
        const int li = p.lights[slot];
        float ldx, ldy, ldz, t_light, scale;
        if (!nee_cone(p, nox, noy, noz, nlx, nly, nlz, col.get(0, li),
                      col.get(1, li), col.get(2, li), col.get(3, li),
                      col.get(4, li), wa, wb,
                      (uint32_t)d_shade +
                          (kNeeSalt + (uint32_t)slot * kNeeSlotStride),
                      ldx, ldy, ldz, t_light, scale))
          continue;
        new_sup |= 1u << slot;
        bool lit = t_light < kBig;
        for (int s = 0; lit && s < n_spheres; ++s) {
          if (s != li &&
              sphere_tt(nox, noy, noz, ldx, ldy, ldz, col.get(0, s),
                        col.get(1, s), col.get(2, s), col.get(3, s),
                        col.get(4, s)) < t_light)
            lit = false;
        }
        if (lit) {
          const float* lrow = table + 16 * li;
          rx = rx + wx * sh.fx * __ldg(lrow + 5) * scale;
          ry = ry + wy * sh.fy * __ldg(lrow + 6) * scale;
          rz = rz + wz * sh.fz * __ldg(lrow + 7) * scale;
        }
      }
    }

    ox = hx + sh.eps_off * nlx;
    oy = hy + sh.eps_off * nly;
    oz = hz + sh.eps_off * nlz;
    dx = sh.ndx;
    dy = sh.ndy;
    dz = sh.ndz;
    wx = wx * sh.fx;
    wy = wy * sh.fy;
    wz = wz * sh.fz;
    sup = new_sup;
    alive = depth < max_depth;
  }
  if (kRecord) {
    for (int d = depth; d < max_depth; ++d)
      rec[(size_t)d * n_lanes + lane] = -1;
  }

  L.ox = ox; L.oy = oy; L.oz = oz; L.dx = dx; L.dy = dy; L.dz = dz;
  L.wx = wx; L.wy = wy; L.wz = wz; L.rx = rx; L.ry = ry; L.rz = rz;
  L.m1 = m1; L.m2 = m2;
  L.depth = depth; L.s_idx = s_idx; L.nrays = nrays; L.alive = alive;
  L.sup = sup;
}

template <bool kGlobal, bool kRecord>
__global__ void __launch_bounds__(kBlock)
mega_pass_kernel(const float* __restrict__ table,
                 const float* __restrict__ cam, float* __restrict__ rad,
                 int* __restrict__ rays, int* __restrict__ rec,
                 const Params p) {
  // 5 * n_spheres floats of dynamic shared memory (none with kGlobal)
  extern __shared__ float smem[];
  const Columns<kGlobal> col =
      load_columns<kGlobal>(table, smem, p.i[IP_N_SPHERES]);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.i[IP_N_LANES]) return;
  Lane L{};
  L.s_idx = -1;
  trace_lane<false, kGlobal, kRecord>(L, p, table, cam, col, lane,
                                      p.i[IP_K_SAMPLES], p.i[IP_MAX_IT], rec);
  rad[3 * lane + 0] = L.rx;
  rad[3 * lane + 1] = L.ry;
  rad[3 * lane + 2] = L.rz;
  rays[lane] = L.nrays;
}

template <bool kGlobal>
__global__ void __launch_bounds__(kBlock)
stream_step_kernel(const float* __restrict__ table,
                   const float* __restrict__ cam, float* __restrict__ f,
                   int* __restrict__ st, unsigned long long* __restrict__ rays,
                   const Params p) {
  extern __shared__ float smem[];
  const Columns<kGlobal> col =
      load_columns<kGlobal>(table, smem, p.i[IP_N_SPHERES]);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)p.i[IP_N_LANES];  // the plane stride
  long long traced = 0;
  if ((size_t)lane < n) {
    float* fl = f + lane;
    int* il = st + lane;
    Lane L;
    L.ox = fl[F_OX * n]; L.oy = fl[F_OY * n]; L.oz = fl[F_OZ * n];
    L.dx = fl[F_DX * n]; L.dy = fl[F_DY * n]; L.dz = fl[F_DZ * n];
    L.wx = fl[F_WX * n]; L.wy = fl[F_WY * n]; L.wz = fl[F_WZ * n];
    L.rx = fl[F_RX * n]; L.ry = fl[F_RY * n]; L.rz = fl[F_RZ * n];
    L.m1 = fl[F_M1 * n]; L.m2 = fl[F_M2 * n];
    L.depth = il[I_DEPTH * n];
    L.s_idx = il[I_SIDX * n];
    L.alive = il[I_ALIVE * n] != 0;
    L.nrays = il[I_RAYS * n];
    L.sup = (uint32_t)il[I_SUP * n];
    const int rays0 = L.nrays;
    trace_lane<true, kGlobal>(L, p, table, cam, col, lane, il[I_BUDGET * n],
                              p.i[IP_MAX_IT]);
    fl[F_OX * n] = L.ox; fl[F_OY * n] = L.oy; fl[F_OZ * n] = L.oz;
    fl[F_DX * n] = L.dx; fl[F_DY * n] = L.dy; fl[F_DZ * n] = L.dz;
    fl[F_WX * n] = L.wx; fl[F_WY * n] = L.wy; fl[F_WZ * n] = L.wz;
    fl[F_RX * n] = L.rx; fl[F_RY * n] = L.ry; fl[F_RZ * n] = L.rz;
    fl[F_M1 * n] = L.m1; fl[F_M2 * n] = L.m2;
    il[I_DEPTH * n] = L.depth;
    il[I_SIDX * n] = L.s_idx;
    il[I_ALIVE * n] = L.alive ? 1 : 0;
    il[I_RAYS * n] = L.nrays;
    il[I_SUP * n] = (int)L.sup;
    traced = (long long)L.nrays - (long long)rays0;
  }
  add_rays(rays, traced);
}

bool bad_params(const Params& p) {
  if (p.i[IP_N_SPHERES] < 0 || p.i[IP_N_SPHERES] > kMaxSpheres ||
      p.i[IP_WIDTH] <= 0 || p.i[IP_JITTER] <= 0 ||
      p.i[IP_SPP_PER_CELL] <= 0 || p.i[IP_N_LIGHTS] < 0 ||
      p.i[IP_N_LIGHTS] > kMaxLights)
    return true;
  for (int s = 0; s < p.i[IP_N_LIGHTS]; ++s)
    if (p.lights[s] < 0 || p.lights[s] >= p.i[IP_N_SPHERES]) return true;
  return false;
}

// Launch one of the kernel's two instances over n lanes: the sweep columns
// in shared memory (opting in above 48 KB), or, when they do not fit, the
// instance that sweeps from global memory.
template <typename... Args, typename... Ts>
int launch(void (*smem_kernel)(Args...), void (*global_kernel)(Args...),
           const Params& p, void* stream, Ts... args) {
  const int n = p.i[IP_N_LANES];
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  const size_t smem = 5 * sizeof(float) * (size_t)p.i[IP_N_SPHERES];
  if (smem > smem_optin_limit()) {
    global_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
  }
  if (smem > kSmemDefault) {
    const cudaError_t err = opt_in_smem(smem_kernel);
    if (err != cudaSuccess) return (int)err;
  }
  smem_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one per-pass megakernel over params[IP_N_LANES] pixel lanes.
// table: (>= n_spheres, 16) f32 and cam: (16,) f32 on the device; rad: (G, 3)
// f32 and rays: (G,) i32 outputs; iparams: host array of IP_COUNT ints and
// then kMaxLights light indices; fparams: host array of FP_COUNT floats;
// stream: a cudaStream_t. Returns the launch's cudaGetLastError().
extern "C" int smallpt_mega_pass(const void* table, const void* cam,
                                 void* rad, void* rays, const void* iparams,
                                 const void* fparams, void* stream) {
  const Params p = read_params(iparams, fparams);
  if (bad_params(p)) return (int)cudaErrorInvalidValue;
  return launch(mega_pass_kernel<false, false>, mega_pass_kernel<true, false>,
                p, stream, (const float*)table, (const float*)cam,
                (float*)rad, (int*)rays, (int*)nullptr, p);
}

// K1b: one per-pass launch with one sample a lane (params[IP_K_SAMPLES] ==
// 1, params[IP_MAX_IT] == params[IP_MAX_DEPTH] == D) that also records each
// lane's winner sphere id per depth. rec: (D, G) i32 on the device, every
// entry written (-1: a miss, or a depth the path never reached); the other
// arguments as for smallpt_mega_pass. Returns the launch's
// cudaGetLastError().
extern "C" int smallpt_mega_record(const void* table, const void* cam,
                                   void* rad, void* rays, void* rec,
                                   const void* iparams, const void* fparams,
                                   void* stream) {
  const Params p = read_params(iparams, fparams);
  if (bad_params(p) || p.i[IP_K_SAMPLES] != 1 ||
      p.i[IP_MAX_IT] != p.i[IP_MAX_DEPTH] || p.i[IP_MAX_DEPTH] <= 0)
    return (int)cudaErrorInvalidValue;
  return launch(mega_pass_kernel<false, true>, mega_pass_kernel<true, true>,
                p, stream, (const float*)table, (const float*)cam,
                (float*)rad, (int*)rays, (int*)rec, p);
}

// Advance the streaming state by at most params[IP_MAX_IT] iterations of
// every lane. f: (F_COUNT, n) f32 and i: (I_COUNT, n) i32 state planes with
// n = params[IP_N_LANES] lanes each, updated in place; rays: one u64 on the
// device that gains the rays this launch traced (the caller zeroes it);
// the other arguments as for smallpt_mega_pass. Returns the launch's
// cudaGetLastError().
extern "C" int smallpt_stream_step(const void* table, const void* cam,
                                   void* f, void* i, void* rays,
                                   const void* iparams, const void* fparams,
                                   void* stream) {
  const Params p = read_params(iparams, fparams);
  if (bad_params(p)) return (int)cudaErrorInvalidValue;
  return launch(stream_step_kernel<false>, stream_step_kernel<true>, p,
                stream, (const float*)table, (const float*)cam, (float*)f,
                (int*)i, (unsigned long long*)rays, p);
}
