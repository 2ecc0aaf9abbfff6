// Wavefront megakernel for sm_90a: regenerate + intersect + shade (+ NEE),
// fused into one launch.
//
// Replaces: smallpt_tpu/ops/megakernel.py::_mega_kernel in its three uses,
// each launched there through one pallas_call:
// - per-pass (streaming=False), launched by render_pass_megakernel: entry
//   point smallpt_mega_pass, kernel mega_pass_kernel (K1a);
// - per-pass with record_depths, launched by render_record_megakernel (the
//   recorder of grad/replay.py): entry point smallpt_mega_record, kernel
//   mega_record_kernel (K1b);
// - streaming (streaming=True), launched by stream_step: entry point
//   smallpt_stream_step, kernel stream_step_kernel (K1c).
// One body, run_lanes(), and one bounce, bounce(), serve all three, with
// next-event estimation over up to kMaxLights light spheres. The camera,
// shade and NEE cone formulas live in lane.cuh, shared with the streaming
// DDA kernel (stream_dda.cu) and the binned bounce (stream_binned.cu).
//
// Contract: a lane runs iterations until it has no work left (no path
// alive, no sample left in its budget) or has run the launch's max_it
// iterations; each iteration regenerates a dead lane with its pixel's next
// sample and then traces one bounce: the closest-hit sweep, emission, the
// shade, the NEE shadow rays at a diffuse vertex. A lane's result depends
// on its own state and the launch's arguments alone, whichever thread runs
// it and when. Only two values of a lane that went idle differ from the
// TPU kernel's: its tile keeps adding 1 to an idle lane's depth and
// clearing its suppression bits, which the lane's next regeneration resets
// anyway.
//
// What bounds it on an H100: FP32 ALU and SFU work, not memory. A per-pass
// launch reads a sphere table of S x 64 bytes and writes 16 bytes per pixel
// lane; a streaming launch reads and writes 80 bytes of state per lane; a
// recording launch also writes its D x G winner plane (16.8 MB at the
// training step's 512x512, depth 16). Every ray tests every sphere; the
// whole stable test is 27 float ops, 3 IEEE square roots and a division
// (each a multi-instruction sequence), plus compares; regeneration (PCG4D,
// the tent filter's roots, the camera's divisions and normalize), the shade
// and the NEE cone sample add a few hundred. In the Cornell box (S = 9)
// every ray starts inside the six 1e5-radius walls, so six of its nine
// tests take the inside path below, and most of the three small spheres'
// tests miss at det. The card's float32 rate outside the tensor cores is 67
// TFLOP/s counting an FMA as two flops; built with --fmad=false this kernel
// issues no FMA, so its adds and multiplies retire at most at 33.5 T/s
// (chip_smoke.py's bound_nofma_ms). With one thread a lane to its end, a
// warp runs until its longest lane ends: 0.70 of its lanes' slots issued
// work on K1a's 1024x768 main path (chip_smoke.py::lane_utilisation).
//
// What the design does about it:
// - a lane queue on a persistent grid (kLaneQueue), in all three kernels: a
//   launch holds only the blocks the card runs at once (the SMs times the
//   instance's occupancy at its shared memory, asked once a device,
//   instance and size). A thread starts on the lane of its index and, when
//   that lane has no work left or has run max_it iterations, stores it and
//   takes the next one from a counter in the caller's scratch (zeroed on
//   the stream before the launch), one warp-aggregated atomicAdd for the
//   warp's threads that ask at once, so a warp's threads stay busy until
//   the queue runs dry. A lane's samples stay on one thread and in order:
//   its radiance sums them in one chain. A streaming lane with no work
//   costs three loads and no store. The queue's words count the lanes
//   handed out and the lanes that had work;
// - K1's own copy of the stable sphere test (k1_tt), for the sweep and the
//   shadow sweep (lane.cuh::sphere_tt stays as it is for K3, K8 and the NEE
//   cone's own light test): an early miss at det (kEarlyMiss), and an
//   inside path (kInsidePath) that skips the third square root and the
//   division when the ray starts inside the sphere; both give the whole
//   test's bits (the proof is at k1_tt), so the recorder's winners are the
//   whole test's too;
// - two instances of each kernel, without NEE and with it (n_lights > 0),
//   so that the first holds no shadow state; the light indices are copied
//   into shared memory once a block, so that no instance indexes the kernel
//   parameters at run time (which would copy them to the stack);
//   __launch_bounds__ asks for kMinBlocks blocks an SM;
// - path state lives in registers. Per-pass, only radiance (G, 3) f32 and
//   the ray count (G,) i32 are written, once per lane. Streaming, a lane
//   with work loads its 14 f32 and 6 i32 state planes when its thread takes
//   it and stores them when it is done (the budget plane is read only); the
//   planes are lane-contiguous. The launch's ray count is the exact sum of
//   the lanes' rays (one an iteration), summed a thread over its lanes and
//   reduced once a warp at exit;
// - the recorder: a lane is one sample of one pixel (budget 1, lane = pixel
//   * k + s over the launch's k in-pixel samples, written straight in the
//   replay's FLAT lane order) and counts its own iterations against max_it
//   == max_depth; it stores its winner at its own depth, so the thread that
//   runs it does not matter. With kFillPlane the plane is set to -1 on the
//   stream before the launch and a lane stores its hits only; without it a
//   lane stores every bounce's winner (-1 for a miss) and -1 at each depth
//   its path never reached;
// - the sweep columns [cx cy cz r eps] sit in shared memory, loaded once per
//   block and sized to the scene (20 B a sphere), read as warp-wide
//   broadcasts. Up to 2457 spheres fit the 48 KB a launch gets by default;
//   above that the launcher opts the kernel in to the card's limit (227 KB
//   on an H100, 11,622 spheres), and above that the kernel's second
//   instance, kGlobal = true, sweeps the table's rows straight from global
//   memory (cached in L1/L2, one broadcast row per sphere). The JAX kernel
//   takes up to MAX_VMEM_SPHERES = 65536 spheres, and so does this one. The
//   sweep and the shadow sweep visit the scene's n_spheres rows, not the
//   table's padding to a multiple of 8 (as the JAX kernel's SMEM sweep
//   does);
// - the TPU kernel's 12-way per-sphere select fold (it has no per-lane
//   gather) becomes one indexed load of the winner's material row;
// - the NEE shadow sweep keeps the sweep's arithmetic. A shadow ray is lit
//   when the light's own candidate is finite and no other sphere's is
//   nearer: the JAX kernel's min-over-all-spheres >= t_light with the light
//   taken out of the minimum, so the test never compares one value computed
//   twice; the sweep stops at the first nearer sphere;
// - the sweep keeps _shadow_tt's citardauq arithmetic, strict < for ties
//   (the first id wins) and the 3e38 sentinel; built with --fmad=false so
//   each op rounds in the JAX kernel's order.
//
// Interface: plain C functions, loaded with ctypes (ops/megakernel.py). They
// launch on the caller's stream (memsets of the queue and, recording, of
// the winner plane, then the kernel), synchronise nothing and return the
// first cudaGetLastError().

#include "lane.cuh"
#include "plan.cuh"

namespace {

using namespace smallpt;

// The design's constants. Each part is measured on and off by copies of
// this file with one constant edited (PERF.md).
constexpr int kBlock = 128;         // threads a block
constexpr int kMinBlocks = 8;       // blocks an SM, for the register cap
constexpr bool kLaneQueue = true;   // the persistent grid and its queue
constexpr bool kEarlyMiss = true;   // k1_tt decides a miss at det
constexpr bool kInsidePath = true;  // k1_tt's path for an origin inside
constexpr bool kFillPlane = true;   // the winner plane set to -1 by a memset
constexpr int kMaxSpheres = 65536;  // the JAX kernel's MAX_VMEM_SPHERES
constexpr unsigned kFull = 0xffffffffu;
// the queue's int32 words (ops/megakernel.py::QUEUE_FIELDS): the next lane
// past the first wave, the lanes handed out, the lanes that had work
enum { Q_NEXT, Q_HANDED, Q_WORKED, Q_WORDS };
// The three kernels of run_lanes (ops/megakernel.py::MODES): K1a, K1c, K1b
enum { MODE_PASS, MODE_STREAM, MODE_RECORD };

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
  if constexpr (!kGlobal) {
    for (int s = threadIdx.x; s < n; s += blockDim.x) {
      const float* row = table + 16 * s;
      smem[s] = row[0];
      smem[n + s] = row[1];
      smem[2 * n + s] = row[2];
      smem[3 * n + s] = row[3];
      smem[4 * n + s] = row[4];
    }
    __syncthreads();
  }
  return Columns<kGlobal>{kGlobal ? table : smem, n};
}

// K1's copy of lane.cuh::sphere_tt: the same candidate t, bit for bit, in
// fewer ops where it can prove the result early.
// - Early miss (kEarlyMiss): where !(det >= 0 && r > 0) the whole test
//   returns 3e38; so does this one, before the second and third square
//   roots and the division. NaN in the ray, the centre or r makes det NaN
//   (or r > 0 false) and lands here, as in the whole test.
// - Inside path (kInsidePath): let q = b*b + pp, as the whole test rounds
//   it, and rr = r*r rounded. The whole test takes opn = sqrt(q), cc =
//   (opn - r)(opn + r), t_near = denom > 0 ? cc / denom : -3e38, and
//   returns t_near if t_near > eps, else denom if denom > eps, else 3e38.
//   Guard: q < rr, eps >= 0 (checked a sphere), and r > 0 (the early miss
//   above, or the final select).
//   * q < rr proves q < r*r exactly. Rounding to nearest is monotone, so
//     q >= r*r would give q = round(q) >= round(r*r) = rr. This holds in
//     every range, so no margin is needed: where r*r underflows rr is 0 or
//     subnormal, and a q below it is still below r*r; where it overflows rr
//     is inf, and any finite q is below r*r (> FLT_MAX); an infinite or NaN
//     q fails the guard and takes the whole test; a NaN r fails it too.
//   * q < r*r gives sqrt(q) < r exactly, and sqrt is correctly rounded and
//     monotone, so opn <= r (r is a float). Then opn - r <= 0 and opn + r
//     > 0, so cc <= 0, or NaN where opn + r overflows with opn == r.
//   * With denom > 0, t_near = cc / denom is <= 0 or NaN; with denom <= 0
//     or NaN it is -3e38. Either way t_near > eps fails for eps >= 0 (+0 >
//     -0 is false too), so the whole test returns denom > eps ? denom :
//     3e38, which is what this path returns, without opn's square root, cc
//     and the division.
//   A ray of the Cornell box starts inside all six walls, so the path is
//   taken by every lane on six of its nine spheres and the warp does not
//   diverge on it.
__device__ __forceinline__ float k1_tt(float ox, float oy, float oz,
                                       float dx, float dy, float dz,
                                       float scx, float scy, float scz,
                                       float sr, float seps) {
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
  if (kEarlyMiss && !(det >= 0.0f && sr > 0.0f)) return kBig;
  const float s = sqrtf(fmaxf(det, 0.0f));
  const float denom = b + s;
  const float q = b * b + pp;
  float tt;
  if (kInsidePath && q < sr * sr && seps >= 0.0f) {
    tt = denom > seps ? denom : kBig;
  } else {
    const float opn = sqrtf(q);
    const float cc = (opn - sr) * (opn + sr);
    const float t_near = denom > 0.0f ? cc / denom : -kBig;
    tt = t_near > seps ? t_near : (denom > seps ? denom : kBig);
  }
  return (det >= 0.0f && sr > 0.0f) ? tt : kBig;
}

// The PCG4D words a and b of the lane's sample s_idx: per pass (sid ^ k0,
// k1) with sid = pixel * spp + ip; streaming v2 (pixel ^ k0, k1 ^ ip *
// mult).
template <bool kStreaming>
__device__ __forceinline__ void sample_words(const Params& p, const Pixel& px,
                                             int s_idx, uint32_t& wa,
                                             uint32_t& wb) {
  const uint32_t ip = (uint32_t)(p.i[IP_IP_OFFSET] + s_idx);
  if (kStreaming) {
    stream_words(p, px, (int)ip, wa, wb);
  } else {
    wa = (px.id * (uint32_t)p.i[IP_SPP] + ip) ^ (uint32_t)p.i[IP_K0];
    wb = (uint32_t)p.i[IP_K1];
  }
}

// Regenerate the dead lane L with its pixel's next sample.
template <bool kStreaming>
__device__ __forceinline__ void regenerate(Lane& L, const Params& p,
                                           const float* __restrict__ cam,
                                           const Pixel& px, uint32_t& wa,
                                           uint32_t& wb) {
  if (kStreaming) {
    // the finished sample's luminance is lum(radiance) - m1; m2 sums its
    // square for the variance estimate of adaptive sampling
    const float cur_lum = (L.rx + L.ry + L.rz) * kThird;
    const float delta = cur_lum - L.m1;
    L.m2 = L.m2 + delta * delta;
    L.m1 = cur_lum;
  }
  ++L.s_idx;
  sample_words<kStreaming>(p, px, L.s_idx, wa, wb);
  camera_ray(p, cam, px, p.i[IP_IP_OFFSET] + L.s_idx, wa, wb, L.ox, L.oy,
             L.oz, L.dx, L.dy, L.dz);
  L.wx = 1.0f;
  L.wy = 1.0f;
  L.wz = 1.0f;
  L.depth = 0;
  L.sup = 0u;
  L.alive = true;
}

// One bounce of the live lane L: the closest-hit sweep, emission, shade,
// NEE over the n_lights lights at a surviving diffuse vertex (kNee), the
// next ray. lights: the light spheres' table rows by slot; with kRecord,
// rec receives the lane's winner at its depth (with kFillPlane only a hit:
// the plane holds -1 already).
template <bool kGlobal, bool kNee, bool kRecord>
__device__ __forceinline__ void bounce(Lane& L, const Params& p,
                                       const float* __restrict__ table,
                                       const Columns<kGlobal>& col,
                                       const int* lights, uint32_t wa,
                                       uint32_t wb, int lane,
                                       int* __restrict__ rec) {
  const int n_spheres = p.i[IP_N_SPHERES];
  const int n_lights = kNee ? p.i[IP_N_LIGHTS] : 0;
  const uint32_t kk = (uint32_t)p.i[IP_K0] + (uint32_t)p.i[IP_K1];
  const float shading_eps = p.f[FP_SHADING_EPS];
  ++L.nrays;

  // ---- closest-hit sweep over the sphere columns ---------------------------
  const float ox = L.ox, oy = L.oy, oz = L.oz;
  const float dx = L.dx, dy = L.dy, dz = L.dz;
  float bt = kBig;
  int bi = -1;
  for (int s = 0; s < n_spheres; ++s) {
    const float tt =
        k1_tt(ox, oy, oz, dx, dy, dz, col.get(0, s), col.get(1, s),
              col.get(2, s), col.get(3, s), col.get(4, s));
    if (tt < bt) {
      bt = tt;
      bi = s;
    }
  }
  if (kRecord && (!kFillPlane || bi >= 0))
    rec[(size_t)L.depth * (size_t)p.i[IP_N_LANES] + lane] = bi;
  if (bi < 0) {
    // escaped: pick up the environment (the smallpt.cpp:168 hook), die
    if (p.i[IP_HAS_ENV] != 0) {
      L.rx = L.rx + L.wx * p.f[FP_ENV_R];
      L.ry = L.ry + L.wy * p.f[FP_ENV_G];
      L.rz = L.rz + L.wz * p.f[FP_ENV_B];
    }
    L.alive = false;
    L.sup = 0u;
    ++L.depth;
    return;
  }

  // ---- the winner's row: one indexed load ----------------------------------
  const float* row = table + 16 * bi;
  const float hx = ox + bt * dx;
  const float hy = oy + bt * dy;
  const float hz = oz + bt * dz;
  float nx = hx - __ldg(row + 0);
  float ny = hy - __ldg(row + 1);
  float nz = hz - __ldg(row + 2);
  normalize3(nx, ny, nz);
  float nlx = nx, nly = ny, nlz = nz;
  if (p.i[IP_FLIP] != 0 && !(nx * dx + ny * dy + nz * dz < 0.0f)) {
    nlx = -nx;
    nly = -ny;
    nlz = -nz;
  }

  // emission, pre-RR (smallpt.cpp:179); with NEE, a light that the previous
  // vertex sampled is suppressed here (one sup bit per slot)
  bool emit = true;
  for (int slot = 0; slot < n_lights; ++slot) {
    if (bi == lights[slot] && ((L.sup >> slot) & 1u)) emit = false;
  }
  if (emit) {
    L.rx = L.rx + L.wx * __ldg(row + 5);
    L.ry = L.ry + L.wy * __ldg(row + 6);
    L.rz = L.rz + L.wz * __ldg(row + 7);
  }

  const int d_shade = L.depth;
  uint32_t sa = wa, sb = wb, sc = (uint32_t)d_shade + kGolden, sd = kk;
  pcg4d(sa, sb, sc, sd);
  const Shade sh = shade(p, dx, dy, dz, nx, ny, nz, nlx, nly, nlz,
                         __ldg(row + 8), __ldg(row + 9), __ldg(row + 10),
                         __ldg(row + 11), to_unit(sa), to_unit(sb),
                         to_unit(sc), to_unit(sd), d_shade);
  ++L.depth;
  if (!sh.survive) {
    L.alive = false;
    L.sup = 0u;
    return;
  }

  uint32_t new_sup = 0u;
  if (kNee && sh.diffuse) {
    // ---- next-event estimation: cone-sample each light outside its
    // shell, sweep the scene for a nearer sphere, add f*Le*cos*omega/pi
    const float nox = hx + shading_eps * nlx;
    const float noy = hy + shading_eps * nly;
    const float noz = hz + shading_eps * nlz;
    for (int slot = 0; slot < n_lights; ++slot) {
      const int li = lights[slot];
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
            k1_tt(nox, noy, noz, ldx, ldy, ldz, col.get(0, s), col.get(1, s),
                  col.get(2, s), col.get(3, s), col.get(4, s)) < t_light)
          lit = false;
      }
      if (lit) {
        const float* lrow = table + 16 * li;
        L.rx = L.rx + L.wx * sh.fx * __ldg(lrow + 5) * scale;
        L.ry = L.ry + L.wy * sh.fy * __ldg(lrow + 6) * scale;
        L.rz = L.rz + L.wz * sh.fz * __ldg(lrow + 7) * scale;
      }
    }
  }

  L.ox = hx + sh.eps_off * nlx;
  L.oy = hy + sh.eps_off * nly;
  L.oz = hz + sh.eps_off * nlz;
  L.dx = sh.ndx;
  L.dy = sh.ndy;
  L.dz = sh.ndz;
  L.wx = L.wx * sh.fx;
  L.wy = L.wy * sh.fy;
  L.wz = L.wz * sh.fz;
  L.sup = new_sup;
  L.alive = L.depth < p.i[IP_MAX_DEPTH];
}

// ---- the lane queue --------------------------------------------------------

// Take the lane `lane` of a launch: per pass a fresh lane (dead, s_idx -1,
// the launch's k_samples), which is always opened, so that its radiance and
// rays are written; recording a fresh lane that traces one sample s of
// pixel lane / k, lane = pixel * k + s with k the launch's k_samples
// (s_idx s - 1, budget s + 1); streaming its state planes, if it has work
// in this launch (an idle lane is read no further and left as it is). Sets
// the lane's pixel, budget and current sample words.
template <int kMode>
__device__ __forceinline__ bool open_lane(const Params& p,
                                          const int* __restrict__ st,
                                          const float* __restrict__ f,
                                          int lane, Lane& L, Pixel& px,
                                          int& budget, uint32_t& wa,
                                          uint32_t& wb) {
  constexpr bool kStreaming = kMode == MODE_STREAM;
  const size_t n = (size_t)p.i[IP_N_LANES];  // the plane stride
  int pixel = lane;
  if (kStreaming) {
    const int* il = st + lane;
    L.alive = il[I_ALIVE * n] != 0;
    L.s_idx = il[I_SIDX * n];
    budget = il[I_BUDGET * n];
    if (!(L.alive || L.s_idx < budget - 1)) return false;
    const float* fl = f + lane;
    L.ox = fl[F_OX * n]; L.oy = fl[F_OY * n]; L.oz = fl[F_OZ * n];
    L.dx = fl[F_DX * n]; L.dy = fl[F_DY * n]; L.dz = fl[F_DZ * n];
    L.wx = fl[F_WX * n]; L.wy = fl[F_WY * n]; L.wz = fl[F_WZ * n];
    L.rx = fl[F_RX * n]; L.ry = fl[F_RY * n]; L.rz = fl[F_RZ * n];
    L.m1 = fl[F_M1 * n]; L.m2 = fl[F_M2 * n];
    L.depth = il[I_DEPTH * n];
    L.nrays = il[I_RAYS * n];
    L.sup = (uint32_t)il[I_SUP * n];
  } else if (kMode == MODE_PASS) {
    L = Lane{};
    L.s_idx = -1;
    budget = p.i[IP_K_SAMPLES];
  } else {
    const int k = p.i[IP_K_SAMPLES];
    pixel = lane / k;
    L = Lane{};
    L.s_idx = lane - pixel * k - 1;
    budget = L.s_idx + 2;
  }
  px = pixel_of(p, pixel);
  sample_words<kStreaming>(p, px, L.s_idx, wa, wb);
  return true;
}

// Store a lane that is done: per pass its radiance and rays (recording,
// without kFillPlane, also -1 at each depth its path never reached);
// streaming every state plane but the budget.
template <int kMode>
__device__ __forceinline__ void close_lane(const Params& p,
                                           float* __restrict__ f,
                                           int* __restrict__ st,
                                           int* __restrict__ rec, int lane,
                                           const Lane& L) {
  const size_t n = (size_t)p.i[IP_N_LANES];
  if (kMode == MODE_RECORD && !kFillPlane) {
    for (int d = L.depth; d < p.i[IP_MAX_DEPTH]; ++d)
      rec[(size_t)d * n + lane] = -1;
  }
  if (kMode != MODE_STREAM) {
    f[3 * lane + 0] = L.rx;
    f[3 * lane + 1] = L.ry;
    f[3 * lane + 2] = L.rz;
    st[lane] = L.nrays;
    return;
  }
  float* fl = f + lane;
  int* il = st + lane;
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
}

// The body of K1a (per pass: f the (G, 3) radiance, st the (G,) rays), K1c
// (streaming: f and st the state planes, rays the launch's count) and K1b
// (as K1a, and rec the (D, G) winner plane): each thread runs lanes from
// the queue, one iteration of its open lane a round, until no lane is left.
template <int kMode, bool kGlobal, bool kNee>
__device__ __forceinline__ void run_lanes(const float* __restrict__ table,
                                          const float* __restrict__ cam,
                                          float* __restrict__ f,
                                          int* __restrict__ st,
                                          unsigned long long* __restrict__ rays,
                                          int* __restrict__ rec,
                                          int* __restrict__ queue,
                                          const Params& p) {
  constexpr bool kStreaming = kMode == MODE_STREAM;
  // 5 * n_spheres floats of dynamic shared memory (none with kGlobal)
  extern __shared__ float smem[];
  __shared__ int s_lights[kMaxLights];
  // the block's lanes handed out and lanes with work
  __shared__ int s_lanes[2];
  if (kNee && threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kMaxLights; ++k) s_lights[k] = p.lights[k];
  }
  if (threadIdx.x < 2) s_lanes[threadIdx.x] = 0;
  const Columns<kGlobal> col =
      load_columns<kGlobal>(table, smem, p.i[IP_N_SPHERES]);
  if (kGlobal) __syncthreads();

  const int n = p.i[IP_N_LANES];
  const int max_it = p.i[IP_MAX_IT];
  const int wl = threadIdx.x & 31;
  const unsigned below = (1u << wl) - 1u;
  // the first wave: a lane a thread by index; the queue hands out the rest
  const int first_wave = gridDim.x * kBlock;
  int lane = blockIdx.x * kBlock + threadIdx.x;
  Lane L;
  Pixel px;
  int budget = 0, it = 0;
  uint32_t wa = 0, wb = 0;
  bool open =
      lane < n && open_lane<kMode>(p, st, f, lane, L, px, budget, wa, wb);
  if (lane < n) atomicAdd(s_lanes, 1);
  if (open) atomicAdd(s_lanes + 1, 1);
  long long traced = 0;
  for (;;) {
    if (open && (it >= max_it || !(L.alive || L.s_idx < budget - 1))) {
      close_lane<kMode>(p, f, st, rec, lane, L);
      open = false;
    }
    // each thread whose lane is done takes the next, one atomic a warp
    const bool want = !open && lane < n;
    const unsigned ask = __ballot_sync(kFull, want);
    if (ask) {
      const int leader = __ffs(ask) - 1;
      int base = 0;
      if (wl == leader) base = atomicAdd(queue + Q_NEXT, __popc(ask));
      base = __shfl_sync(kFull, base, leader);
      if (want) {
        lane = first_wave + base + __popc(ask & below);
        if (lane < n) {
          it = 0;
          open = open_lane<kMode>(p, st, f, lane, L, px, budget, wa, wb);
          atomicAdd(s_lanes, 1);
          if (open) atomicAdd(s_lanes + 1, 1);
        }
      }
    }
    if (__all_sync(kFull, lane >= n)) break;
    if (open) {
      // one iteration: regenerate a dead lane, then trace one bounce
      if (!L.alive) regenerate<kStreaming>(L, p, cam, px, wa, wb);
      bounce<kGlobal, kNee, kMode == MODE_RECORD>(L, p, table, col,
                                                  s_lights, wa, wb, lane,
                                                  rec);
      ++it;
      ++traced;
    }
  }
  if (kStreaming) add_rays(rays, traced);
  __syncthreads();
  if (threadIdx.x < 2)
    atomicAdd(queue + Q_HANDED + threadIdx.x, s_lanes[threadIdx.x]);
}

template <bool kGlobal, bool kNee>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    mega_pass_kernel(const float* __restrict__ table,
                     const float* __restrict__ cam, float* __restrict__ rad,
                     int* __restrict__ rays, int* __restrict__ queue,
                     const Params p) {
  run_lanes<MODE_PASS, kGlobal, kNee>(table, cam, rad, rays, nullptr, nullptr,
                                      queue, p);
}

template <bool kGlobal, bool kNee>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    stream_step_kernel(const float* __restrict__ table,
                       const float* __restrict__ cam, float* __restrict__ f,
                       int* __restrict__ st,
                       unsigned long long* __restrict__ rays,
                       int* __restrict__ queue, const Params p) {
  run_lanes<MODE_STREAM, kGlobal, kNee>(table, cam, f, st, rays, nullptr,
                                        queue, p);
}

template <bool kGlobal, bool kNee>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
    mega_record_kernel(const float* __restrict__ table,
                       const float* __restrict__ cam, float* __restrict__ rad,
                       int* __restrict__ rays, int* __restrict__ rec,
                       int* __restrict__ queue, const Params p) {
  run_lanes<MODE_RECORD, kGlobal, kNee>(table, cam, rad, rays, nullptr, rec,
                                        queue, p);
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

// The dynamic shared memory of the sweep columns of n spheres.
size_t columns_bytes(int n_spheres) {
  return 5 * sizeof(float) * (size_t)n_spheres;
}

// The kernel of a mode and instance.
template <int kMode, bool kGlobal, bool kNee>
auto k1_kernel() {
  if constexpr (kMode == MODE_PASS)
    return mega_pass_kernel<kGlobal, kNee>;
  else if constexpr (kMode == MODE_STREAM)
    return stream_step_kernel<kGlobal, kNee>;
  else
    return mega_record_kernel<kGlobal, kNee>;
}

// The instance's fit on the current device at smem bytes of dynamic shared
// memory, asked once a (device, size).
template <int kMode, bool kGlobal, bool kNee>
cudaError_t k1_fit(size_t smem, Fit* out) {
  static Fit fits[64];
  static size_t fit_smem[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Fit& fit = fits[dev & 63];
  if (fit.n_sm == 0 || fit_smem[dev & 63] != smem) {
    int n_sm = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k1_kernel<kMode, kGlobal, kNee>(), kBlock, smem);
    if (err != cudaSuccess) return err;
    fit.n_sm = n_sm > 1 ? n_sm : 1;
    fit.per_sm = per_sm > 1 ? per_sm : 1;
    fit_smem[dev & 63] = smem;
  }
  *out = fit;
  return cudaSuccess;
}

// The blocks of a launch of n lanes: with the queue its first wave, one
// lane a thread, at most the blocks the card holds at once; without it one
// thread a lane.
long long first_wave(int n, const Fit& fit) {
  const long long want = ((long long)n + kBlock - 1) / kBlock;
  const long long fill = (long long)fit.n_sm * fit.per_sm;
  return (kLaneQueue && fill < want) ? fill : want;
}

// What a launch of p runs on the current device: the instance (the sweep
// from global memory or shared, NEE or not), its dynamic shared memory, its
// fit and its blocks.
struct Launch {
  bool global, nee;
  size_t smem;
  Fit fit;
  long long blocks;
};

template <int kMode, bool kGlobal, bool kNee>
cudaError_t prepare(size_t smem, int n, Launch* out) {
  const cudaError_t err = k1_fit<kMode, kGlobal, kNee>(smem, &out->fit);
  if (err != cudaSuccess) return err;
  out->global = kGlobal;
  out->nee = kNee;
  out->smem = smem;
  out->blocks = first_wave(n, out->fit);
  return cudaSuccess;
}

// The sweep columns in shared memory, or, when they do not fit beside the
// instance's static shared memory (the light slots, the block's queue
// counts) in the card's opt-in limit, the instance that sweeps from global
// memory. Above the 48 KB a block gets by default (static included) the
// instance is opted in to the limit less its static part.
template <int kMode, bool kNee>
cudaError_t plan_nee(const Params& p, Launch* out) {
  const int n = p.i[IP_N_LANES];
  const size_t cols = columns_bytes(p.i[IP_N_SPHERES]);
  const auto kernel = k1_kernel<kMode, false, kNee>();
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  const size_t limit = smem_optin_limit();
  const size_t dyn = limit > a.sharedSizeBytes ? limit - a.sharedSizeBytes
                                               : 0;
  if (cols > dyn) return prepare<kMode, true, kNee>(0, n, out);
  if (cols + a.sharedSizeBytes > kSmemDefault) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return err;
  }
  return prepare<kMode, false, kNee>(cols, n, out);
}

// The launch of p in a mode: without NEE or with it.
template <int kMode>
cudaError_t plan_launch(const Params& p, Launch* out) {
  return p.i[IP_N_LIGHTS] > 0 ? plan_nee<kMode, true>(p, out)
                              : plan_nee<kMode, false>(p, out);
}

// The queue's memset (recording with kFillPlane, the winner plane's too)
// and the launch of K1a (f the radiance, st the rays), K1c (f, st the state
// planes, rays the count) or K1b (as K1a, rec the winner plane) on the
// stream s.
template <int kMode>
int launch(const Params& p, const float* table, const float* cam, float* f,
           int* st, unsigned long long* rays, int* rec, int* queue,
           cudaStream_t s) {
  if (p.i[IP_N_LANES] <= 0) return 0;
  Launch l;
  cudaError_t err = plan_launch<kMode>(p, &l);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(queue, 0, Q_WORDS * sizeof(int), s);
  if (err == cudaSuccess && kMode == MODE_RECORD && kFillPlane)
    err = cudaMemsetAsync(rec, 0xFF,
                          (size_t)p.i[IP_MAX_DEPTH] *
                              (size_t)p.i[IP_N_LANES] * sizeof(int),
                          s);
  if (err != cudaSuccess) {
    cudaGetLastError();  // the error is returned here, not to the next call
    return (int)err;
  }
  const dim3 grid((unsigned)l.blocks);
#define K1_LAUNCH(G, N)                                                      \
  if constexpr (kMode == MODE_STREAM)                                        \
    stream_step_kernel<G, N><<<grid, kBlock, l.smem, s>>>(table, cam, f, st, \
                                                          rays, queue, p);   \
  else if constexpr (kMode == MODE_PASS)                                     \
    mega_pass_kernel<G, N><<<grid, kBlock, l.smem, s>>>(table, cam, f, st,   \
                                                        queue, p);           \
  else                                                                       \
    mega_record_kernel<G, N><<<grid, kBlock, l.smem, s>>>(table, cam, f, st, \
                                                          rec, queue, p);
  if (l.global) {
    if (l.nee) { K1_LAUNCH(true, true) } else { K1_LAUNCH(true, false) }
  } else {
    if (l.nee) { K1_LAUNCH(false, true) } else { K1_LAUNCH(false, false) }
  }
#undef K1_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// The launch smallpt_mega_pass (mode 0), smallpt_stream_step (mode 1) or
// smallpt_mega_record (mode 2; ops/megakernel.py::MODES) makes on the
// current device for n lanes over n_spheres spheres with n_lights NEE
// lights: out, seven int64 {blocks, threads (the first wave), n_sm, per_sm,
// smem bytes, global (the sweep from global memory), nee}
// (ops/megakernel.py::PLAN_FIELDS). Returns a cudaError_t (the device
// query's).
extern "C" int smallpt_mega_plan(int n, int n_spheres, int n_lights,
                                 int mode, void* out) {
  if (n < 0 || n_spheres < 0 || n_spheres > kMaxSpheres || n_lights < 0 ||
      n_lights > kMaxLights || mode < MODE_PASS || mode > MODE_RECORD)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.i[IP_N_LANES] = n;
  p.i[IP_N_SPHERES] = n_spheres;
  p.i[IP_N_LIGHTS] = n_lights;
  Launch l;
  const cudaError_t err =
      mode == MODE_PASS     ? plan_launch<MODE_PASS>(p, &l)
      : mode == MODE_STREAM ? plan_launch<MODE_STREAM>(p, &l)
                            : plan_launch<MODE_RECORD>(p, &l);
  if (err != cudaSuccess) return (int)err;
  const long long v[7] = {l.blocks, l.blocks * kBlock, l.fit.n_sm,
                          l.fit.per_sm, (long long)l.smem, l.global ? 1 : 0,
                          l.nee ? 1 : 0};
  memcpy(out, v, sizeof(v));
  return 0;
}

// Launch one per-pass megakernel over params[IP_N_LANES] pixel lanes.
// table: (>= n_spheres, 16) f32 and cam: (16,) f32 on the device; rad: (G, 3)
// f32 and rays: (G,) i32 outputs; queue: Q_WORDS int32 of scratch on the
// device (zeroed here, on the stream; after the launch the lanes handed
// out and the lanes that had work); iparams: host array of IP_COUNT ints
// and then kMaxLights light indices; fparams: host array of FP_COUNT
// floats; stream: a cudaStream_t. Returns the first cudaGetLastError().
extern "C" int smallpt_mega_pass(const void* table, const void* cam,
                                 void* rad, void* rays, void* queue,
                                 const void* iparams, const void* fparams,
                                 void* stream) {
  const Params p = read_params(iparams, fparams);
  if (bad_params(p)) return (int)cudaErrorInvalidValue;
  return launch<MODE_PASS>(p, (const float*)table, (const float*)cam,
                           (float*)rad, (int*)rays, nullptr, nullptr,
                           (int*)queue, (cudaStream_t)stream);
}

// K1b: one recording launch of params[IP_N_LANES] = G * k lanes, k =
// params[IP_K_SAMPLES] in-pixel samples of each of G pixels, lane = pixel *
// k + s tracing sample ip_offset + s (params[IP_MAX_IT] ==
// params[IP_MAX_DEPTH] == D), that also records each lane's winner sphere
// id per depth. rad: (G * k, 3) f32 and rays: (G * k,) i32, a lane each;
// rec: (D, G * k) i32 on the device, every entry written (-1: a miss, or a
// depth the path never reached); the other arguments as for
// smallpt_mega_pass. Returns the first cudaGetLastError().
extern "C" int smallpt_mega_record(const void* table, const void* cam,
                                   void* rad, void* rays, void* rec,
                                   void* queue, const void* iparams,
                                   const void* fparams, void* stream) {
  const Params p = read_params(iparams, fparams);
  if (bad_params(p) || p.i[IP_K_SAMPLES] <= 0 ||
      p.i[IP_N_LANES] % p.i[IP_K_SAMPLES] != 0 ||
      p.i[IP_MAX_IT] != p.i[IP_MAX_DEPTH] || p.i[IP_MAX_DEPTH] <= 0)
    return (int)cudaErrorInvalidValue;
  return launch<MODE_RECORD>(p, (const float*)table, (const float*)cam,
                             (float*)rad, (int*)rays, nullptr, (int*)rec,
                             (int*)queue, (cudaStream_t)stream);
}

// Advance the streaming state by at most params[IP_MAX_IT] iterations of
// every lane. f: (F_COUNT, n) f32 and i: (I_COUNT, n) i32 state planes with
// n = params[IP_N_LANES] lanes each, updated in place; rays: one u64 on the
// device that gains the rays this launch traced (the caller zeroes it);
// queue: as for smallpt_mega_pass; the other arguments as for
// smallpt_mega_pass. Returns the first cudaGetLastError().
extern "C" int smallpt_stream_step(const void* table, const void* cam,
                                   void* f, void* i, void* rays, void* queue,
                                   const void* iparams, const void* fparams,
                                   void* stream) {
  const Params p = read_params(iparams, fparams);
  if (bad_params(p)) return (int)cudaErrorInvalidValue;
  return launch<MODE_STREAM>(p, (const float*)table, (const float*)cam,
                             (float*)f, (int*)i, (unsigned long long*)rays,
                             nullptr, (int*)queue, (cudaStream_t)stream);
}
