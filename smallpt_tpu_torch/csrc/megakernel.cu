// Wavefront megakernel for sm_90a: regenerate + intersect + shade (+ NEE),
// fused into one launch.
//
// Replaces: smallpt_tpu/ops/megakernel.py::_mega_kernel (without record
// planes) in both of its modes, each launched there through one pallas_call:
// - per-pass (streaming=False), launched by render_pass_megakernel: entry
//   point smallpt_mega_pass, kernel mega_pass_kernel;
// - streaming (streaming=True), launched by stream_step: entry point
//   smallpt_stream_step, kernel stream_step_kernel.
// Both run one per-lane body, trace_lane<kStreaming>, with next-event
// estimation over up to kMaxLights light spheres.
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
//   block and sized to the scene (2048 x 20 B = 40 KB at most, under the
//   48 KB a launch gets without opting in), read as warp-wide broadcasts;
//   the sweep and the shadow sweep visit the scene's n_spheres rows, not
//   the table's padding to a multiple of 8 (as the JAX kernel's SMEM sweep
//   does);
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

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxSpheres = 2048;
constexpr int kMaxLights = 31;  // the width of the suppression bit mask
constexpr int kBlock = 128;
constexpr float kBig = 3.0e38f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvPi = 0.3183098861837907f;
constexpr float kThird = 1.0f / 3.0f;
constexpr uint32_t kCameraSalt = 0x9E3779B9u;
constexpr uint32_t kGolden = 0x85EBCA6Bu;
constexpr uint32_t kLensSalt = 0x94D049BBu;
constexpr uint32_t kNeeSalt = 0x2545F491u;
constexpr uint32_t kNeeSlotStride = 0x632BE59Bu;
constexpr uint32_t kStreamIpMult = 0x9E3779B1u;

// Integer launch arguments (ops/megakernel.py::_IP_NAMES, same order),
// followed by kMaxLights light indices.
enum {
  IP_N_LANES, IP_N_SPHERES, IP_WIDTH, IP_HEIGHT, IP_ROW_OFFSET, IP_IP_OFFSET,
  IP_K_SAMPLES, IP_MAX_IT, IP_SPP, IP_SPP_PER_CELL, IP_JITTER, IP_MAX_DEPTH,
  IP_RR_DEPTH, IP_TENT, IP_MATRIX, IP_FLIP, IP_HAS_ENV, IP_K0, IP_K1,
  IP_N_LIGHTS, IP_COUNT
};
// Float launch arguments (ops/megakernel.py::_launch_args, same order).
enum {
  FP_IOR, FP_SHADING_EPS, FP_APERTURE, FP_FOCAL, FP_ENV_R, FP_ENV_G,
  FP_ENV_B, FP_COUNT
};
// Streaming state planes (ops/megakernel.py::_F_PLANES/_I_PLANES).
enum { F_OX, F_OY, F_OZ, F_DX, F_DY, F_DZ, F_WX, F_WY, F_WZ, F_RX, F_RY,
       F_RZ, F_M1, F_M2, F_COUNT };
enum { I_DEPTH, I_SIDX, I_ALIVE, I_RAYS, I_BUDGET, I_SUP, I_COUNT };

struct Params {
  int i[IP_COUNT];
  int lights[kMaxLights];
  float f[FP_COUNT];
};

// One lane's path state: the streaming planes, in registers.
struct Lane {
  float ox, oy, oz, dx, dy, dz, wx, wy, wz, rx, ry, rz, m1, m2;
  int depth, s_idx, nrays;
  bool alive;
  uint32_t sup;  // bit s: the previous vertex sampled light slot s
};

// The sweep columns in shared memory.
struct Columns {
  const float* cx;
  const float* cy;
  const float* cz;
  const float* r;
  const float* eps;
};

// PCG4D (Jarzynski & Olano 2020), bit-identical to core/rng.py::_pcg4d.
__device__ __forceinline__ void pcg4d(uint32_t& a, uint32_t& b, uint32_t& c,
                                      uint32_t& d) {
  a = a * 1664525u + 1013904223u;
  b = b * 1664525u + 1013904223u;
  c = c * 1664525u + 1013904223u;
  d = d * 1664525u + 1013904223u;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
  a ^= a >> 16;
  b ^= b >> 16;
  c ^= c >> 16;
  d ^= d >> 16;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
}

__device__ __forceinline__ float to_unit(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = 1.0f / sqrtf(x * x + y * y + z * z);
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// An orthonormal (u, v) around the unit vector n (smallpt.cpp:209):
// u = normalize(up x n), up = y if |n.x| > 0.1 else x; v = n x u.
__device__ __forceinline__ void frame(float nx, float ny, float nz,
                                      float& ux, float& uy, float& uz,
                                      float& vx, float& vy, float& vz) {
  const bool bigx = fabsf(nx) > 0.1f;
  const float upx = bigx ? 0.0f : 1.0f;
  const float upy = bigx ? 1.0f : 0.0f;
  ux = upy * nz;
  uy = -upx * nz;
  uz = upx * ny - upy * nx;
  normalize3(ux, uy, uz);
  vx = ny * uz - nz * uy;
  vy = nz * ux - nx * uz;
  vz = nx * uy - ny * ux;
}

// Candidate hit distance of one sphere: the stable citardauq form of the
// JAX kernel's _shadow_tt (ops/megakernel.py:127-148), op for op; its
// sr > 0 test keeps a zero-radius sphere from being hit by a ray through
// its centre.
__device__ __forceinline__ float sphere_tt(float ox, float oy, float oz,
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
  const float s = sqrtf(fmaxf(det, 0.0f));
  const float opn = sqrtf(b * b + pp);
  const float cc = (opn - sr) * (opn + sr);
  const float denom = b + s;
  const float t_near = denom > 0.0f ? cc / denom : -kBig;
  const float tt = t_near > seps ? t_near : (denom > seps ? denom : kBig);
  return (det >= 0.0f && sr > 0.0f) ? tt : kBig;
}

// Load the sweep columns of the first n spheres into shared memory; every
// thread of the block must call it.
__device__ __forceinline__ Columns load_columns(const float* table,
                                                float* smem, int n) {
  const Columns c{smem, smem + n, smem + 2 * n, smem + 3 * n, smem + 4 * n};
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const float* row = table + 16 * s;
    smem[s] = row[0];
    smem[n + s] = row[1];
    smem[2 * n + s] = row[2];
    smem[3 * n + s] = row[3];
    smem[4 * n + s] = row[4];
  }
  __syncthreads();
  return c;
}

// The per-lane loop of _mega_kernel: at most max_it iterations, each one
// bounce of the lane's path, regenerating with the pixel's next sample
// while s_idx < budget - 1.
template <bool kStreaming>
__device__ __forceinline__ void trace_lane(Lane& L, const Params& p,
                                           const float* __restrict__ table,
                                           const float* __restrict__ cam,
                                           const Columns& col, int lane,
                                           int budget, int max_it) {
  const int n_spheres = p.i[IP_N_SPHERES];
  const int n_lights = p.i[IP_N_LIGHTS];
  const int W = p.i[IP_WIDTH];
  const float Wf = (float)W;
  const float Hf = (float)p.i[IP_HEIGHT];
  const int pix_col = lane % W;
  const int pix_row = lane / W + p.i[IP_ROW_OFFSET];
  const uint32_t pixel = (uint32_t)pix_row * (uint32_t)W + (uint32_t)pix_col;
  const uint32_t k0 = (uint32_t)p.i[IP_K0];
  const uint32_t k1 = (uint32_t)p.i[IP_K1];
  const uint32_t kk = k0 + k1;
  const int ip_offset = p.i[IP_IP_OFFSET];
  const uint32_t spp = (uint32_t)p.i[IP_SPP];
  const int spp_per_cell = p.i[IP_SPP_PER_CELL];
  const int js = p.i[IP_JITTER];
  const float jsf = (float)js;
  const int max_depth = p.i[IP_MAX_DEPTH];
  const int rr_depth = p.i[IP_RR_DEPTH];
  const bool tent = p.i[IP_TENT] != 0;
  const bool matrix = p.i[IP_MATRIX] != 0;
  const bool flip_normals = p.i[IP_FLIP] != 0;
  const bool has_env = p.i[IP_HAS_ENV] != 0;
  const float nt = p.f[FP_IOR];
  const float shading_eps = p.f[FP_SHADING_EPS];
  const float aperture = p.f[FP_APERTURE];
  const float focal = p.f[FP_FOCAL];

  const float ax = cam[0], ay = cam[1], az = cam[2];
  const float bx = cam[3], by = cam[4], bz = cam[5];
  const float cxv = cam[6], cyv = cam[7], czv = cam[8];
  const float o0x = cam[9], o0y = cam[10], o0z = cam[11];
  const float push = cam[12];

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
      wa = pixel ^ k0;
      wb = k1 ^ (ip * kStreamIpMult);
    } else {
      wa = (pixel * spp + ip) ^ k0;
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
      const int ip = ip_offset + s_idx;
      // the jitter cell cycles over the js x js grid (streaming ip runs past
      // spp)
      const int group = (ip / spp_per_cell) % (js * js);
      const float cx_cell = (float)(group % js);
      const float cy_cell = (float)(group / js);
      uint32_t ua = wa, ub = wb, uc = kCameraSalt, ud = kk;
      pcg4d(ua, ub, uc, ud);
      const float u0 = to_unit(ua);
      const float u1 = to_unit(ub);
      float off0, off1;
      if (tent) {
        const float r0 = 2.0f * u0;
        const float r1 = 2.0f * u1;
        const float f0 = r0 < 1.0f ? sqrtf(r0) - 1.0f
                                   : 1.0f - sqrtf(fmaxf(2.0f - r0, 0.0f));
        const float f1 = r1 < 1.0f ? sqrtf(r1) - 1.0f
                                   : 1.0f - sqrtf(fmaxf(2.0f - r1, 0.0f));
        off0 = (cx_cell + 0.5f + f0) / jsf - 0.5f;
        off1 = (cy_cell + 0.5f + f1) / jsf - 0.5f;
      } else {
        off0 = (cx_cell + u0) / jsf - 0.5f;
        off1 = (cy_cell + u1) / jsf - 0.5f;
      }
      float sx = ((float)pix_col + 0.5f + off0) / Wf - 0.5f;
      float sy = ((float)pix_row + 0.5f + off1) / Hf - 0.5f;
      if (matrix) {
        sx = 2.0f * sx;
        sy = 2.0f * sy;
      }
      const float gdx = sx * ax + sy * bx + cxv;
      const float gdy = sx * ay + sy * by + cyv;
      const float gdz = sx * az + sy * bz + czv;
      ox = o0x + gdx * push;
      oy = o0y + gdy * push;
      oz = o0z + gdz * push;
      dx = gdx;
      dy = gdy;
      dz = gdz;
      normalize3(dx, dy, dz);
      if (aperture > 0.0f) {
        // thin lens: jitter the origin on the aperture disk, re-aim at the
        // along-ray focus point (core/camera.py::_thin_lens)
        uint32_t la = wa, lb = wb, lc = kLensSalt, ld = kk;
        pcg4d(la, lb, lc, ld);
        const float lrad = aperture * sqrtf(to_unit(la));
        const float lth = kTwoPi * to_unit(lb);
        const float lx = lrad * cosf(lth);
        const float ly = lrad * sinf(lth);
        float rnx = ax, rny = ay, rnz = az;
        float unx = bx, uny = by, unz = bz;
        normalize3(rnx, rny, rnz);
        normalize3(unx, uny, unz);
        const float fpx = ox + dx * focal;
        const float fpy = oy + dy * focal;
        const float fpz = oz + dz * focal;
        ox = ox + rnx * lx + unx * ly;
        oy = oy + rny * lx + uny * ly;
        oz = oz + rnz * lx + unz * ly;
        dx = fpx - ox;
        dy = fpy - oy;
        dz = fpz - oz;
        normalize3(dx, dy, dz);
      }
      wx = 1.0f;
      wy = 1.0f;
      wz = 1.0f;
      depth = 0;
      sup = 0u;
      alive = true;
    }
    ++nrays;

    // ---- closest-hit sweep over the shared-memory table --------------------
    float bt = kBig;
    int bi = -1;
    for (int s = 0; s < n_spheres; ++s) {
      const float tt = sphere_tt(ox, oy, oz, dx, dy, dz, col.cx[s], col.cy[s],
                                 col.cz[s], col.r[s], col.eps[s]);
      if (tt < bt) {
        bt = tt;
        bi = s;
      }
    }
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
    const float u_rr = to_unit(sa);
    const float u_b1 = to_unit(sb);
    const float u_b2 = to_unit(sc);
    const float u_ch = to_unit(sd);

    // Russian roulette (smallpt.cpp:187-198)
    const float al_x = __ldg(row + 8);
    const float al_y = __ldg(row + 9);
    const float al_z = __ldg(row + 10);
    const float p_rr = fmaxf(al_x, fmaxf(al_y, al_z));
    const bool rr_active = depth > rr_depth;
    const bool survive = !rr_active || u_rr < p_rr;
    ++depth;
    if (!survive) {
      alive = false;
      sup = 0u;
      continue;
    }
    const float boost = rr_active ? 1.0f / fmaxf(p_rr, 1e-12f) : 1.0f;
    float fx = al_x * boost;
    float fy = al_y * boost;
    float fz = al_z * boost;

    const float refl = __ldg(row + 11);
    float ndx, ndy, ndz;
    float eps_off = shading_eps;
    uint32_t new_sup = 0u;
    if (refl < 0.5f) {
      // DIFF: cosine-weighted hemisphere around nl (smallpt.cpp:208-216)
      const float r1 = kTwoPi * u_b1;
      const float r2s = sqrtf(u_b2);
      float tux, tuy, tuz, tvx, tvy, tvz;
      frame(nlx, nly, nlz, tux, tuy, tuz, tvx, tvy, tvz);
      const float cr1 = cosf(r1) * r2s;
      const float sr1 = sinf(r1) * r2s;
      const float wzc = sqrtf(fmaxf(1.0f - u_b2, 0.0f));
      ndx = tux * cr1 + tvx * sr1 + nlx * wzc;
      ndy = tuy * cr1 + tvy * sr1 + nly * wzc;
      ndz = tuz * cr1 + tvz * sr1 + nlz * wzc;
      normalize3(ndx, ndy, ndz);

      // ---- next-event estimation: cone-sample each light outside its
      // shell, sweep the scene for a nearer sphere, add f*Le*cos*omega/pi
      const float nox = hx + shading_eps * nlx;
      const float noy = hy + shading_eps * nly;
      const float noz = hz + shading_eps * nlz;
      for (int slot = 0; slot < n_lights; ++slot) {
        const int li = p.lights[slot];
        const float lcx = col.cx[li], lcy = col.cy[li], lcz = col.cz[li];
        const float lrr = col.r[li];
        const float swx = lcx - nox;
        const float swy = lcy - noy;
        const float swz = lcz - noz;
        const float d2 = swx * swx + swy * swy + swz * swz;
        const float lrr2 = lrr * lrr;
        if (d2 <= lrr2) continue;  // inside the light's shell: no sample
        new_sup |= 1u << slot;
        const float d2c = fmaxf(d2, 1e-12f);
        const float cos_a_max = sqrtf(fmaxf(1.0f - lrr2 / d2c, 0.0f));
        uint32_t na = wa, nb = wb;
        uint32_t nc = (uint32_t)d_shade + (kNeeSalt + (uint32_t)slot *
                                                          kNeeSlotStride);
        uint32_t nd = kk;
        pcg4d(na, nb, nc, nd);
        const float nu0 = to_unit(na);
        const float nu1 = to_unit(nb);
        const float cos_a = 1.0f - nu0 + nu0 * cos_a_max;
        const float sin_a = sqrtf(fmaxf(1.0f - cos_a * cos_a, 0.0f));
        const float nphi = kTwoPi * nu1;
        const float inv_d = 1.0f / sqrtf(d2c);
        const float swnx = swx * inv_d;
        const float swny = swy * inv_d;
        const float swnz = swz * inv_d;
        float sux, suy, suz, svx, svy, svz;
        frame(swnx, swny, swnz, sux, suy, suz, svx, svy, svz);
        const float cphi = cosf(nphi) * sin_a;
        const float sphi = sinf(nphi) * sin_a;
        float ldx = sux * cphi + svx * sphi + swnx * cos_a;
        float ldy = suy * cphi + svy * sphi + swny * cos_a;
        float ldz = suz * cphi + svz * sphi + swnz * cos_a;
        normalize3(ldx, ldy, ldz);
        const float t_light = sphere_tt(nox, noy, noz, ldx, ldy, ldz, lcx, lcy,
                                        lcz, lrr, col.eps[li]);
        bool lit = t_light < kBig;
        for (int s = 0; lit && s < n_spheres; ++s) {
          if (s != li &&
              sphere_tt(nox, noy, noz, ldx, ldy, ldz, col.cx[s], col.cy[s],
                        col.cz[s], col.r[s], col.eps[s]) < t_light)
            lit = false;
        }
        if (lit) {
          const float* lrow = table + 16 * li;
          const float cosine = fmaxf(ldx * nlx + ldy * nly + ldz * nlz, 0.0f);
          const float omega = kTwoPi * (1.0f - cos_a_max);
          const float scale = cosine * omega * kInvPi;
          rx = rx + wx * fx * __ldg(lrow + 5) * scale;
          ry = ry + wy * fy * __ldg(lrow + 6) * scale;
          rz = rz + wz * fz * __ldg(lrow + 7) * scale;
        }
      }
    } else {
      // SPEC mirror (smallpt.cpp:218); REFR reflects the same way
      const float nd = nx * dx + ny * dy + nz * dz;
      ndx = dx - nx * (2.0f * nd);
      ndy = dy - ny * (2.0f * nd);
      ndz = dz - nz * (2.0f * nd);
      if (refl >= 1.5f) {
        // REFR: Snell + TIR + Schlick (smallpt.cpp:225-246)
        const bool into = (nx * nlx + ny * nly + nz * nlz) > 0.0f;
        const float nnt = into ? 1.0f / nt : nt / 1.0f;
        const float ddn = dx * nlx + dy * nly + dz * nlz;
        const float cos2t = 1.0f - nnt * nnt * (1.0f - ddn * ddn);
        const bool tir = cos2t < 0.0f;
        const float sq = sqrtf(fmaxf(cos2t, 0.0f));
        const float tfac = (into ? 1.0f : -1.0f) * (ddn * nnt + sq);
        float tdx = 1.0f, tdy = 0.0f, tdz = 0.0f;
        if (!tir) {
          tdx = dx * nnt - nx * tfac;
          tdy = dy * nnt - ny * tfac;
          tdz = dz * nnt - nz * tfac;
        }
        normalize3(tdx, tdy, tdz);
        const float a = nt - 1.0f;
        const float b = nt + 1.0f;
        const float r0 = (a * a) / (b * b);
        const float cterm =
            1.0f - (into ? -ddn : tdx * nx + tdy * ny + tdz * nz);
        const float re =
            r0 + (1.0f - r0) * cterm * cterm * cterm * cterm * cterm;
        const float tr = 1.0f - re;
        const float p_refl = 0.25f + 0.5f * re;
        const bool choose_refl = u_ch < p_refl;
        float wf = 1.0f;
        if (!tir) {
          wf = choose_refl ? re / p_refl : tr / (1.0f - p_refl);
          if (!choose_refl) {
            ndx = tdx;
            ndy = tdy;
            ndz = tdz;
            eps_off = -shading_eps;
          }
        }
        fx = fx * wf;
        fy = fy * wf;
        fz = fz * wf;
      }
    }

    ox = hx + eps_off * nlx;
    oy = hy + eps_off * nly;
    oz = hz + eps_off * nlz;
    dx = ndx;
    dy = ndy;
    dz = ndz;
    wx = wx * fx;
    wy = wy * fy;
    wz = wz * fz;
    sup = new_sup;
    alive = depth < max_depth;
  }

  L.ox = ox; L.oy = oy; L.oz = oz; L.dx = dx; L.dy = dy; L.dz = dz;
  L.wx = wx; L.wy = wy; L.wz = wz; L.rx = rx; L.ry = ry; L.rz = rz;
  L.m1 = m1; L.m2 = m2;
  L.depth = depth; L.s_idx = s_idx; L.nrays = nrays; L.alive = alive;
  L.sup = sup;
}

__global__ void __launch_bounds__(kBlock)
mega_pass_kernel(const float* __restrict__ table,
                 const float* __restrict__ cam, float* __restrict__ rad,
                 int* __restrict__ rays, const Params p) {
  // 5 * n_spheres floats of dynamic shared memory (40 KB at most)
  extern __shared__ float smem[];
  const Columns col = load_columns(table, smem, p.i[IP_N_SPHERES]);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.i[IP_N_LANES]) return;
  Lane L{};
  L.s_idx = -1;
  trace_lane<false>(L, p, table, cam, col, lane, p.i[IP_K_SAMPLES],
                    p.i[IP_MAX_IT]);
  rad[3 * lane + 0] = L.rx;
  rad[3 * lane + 1] = L.ry;
  rad[3 * lane + 2] = L.rz;
  rays[lane] = L.nrays;
}

__global__ void __launch_bounds__(kBlock)
stream_step_kernel(const float* __restrict__ table,
                   const float* __restrict__ cam, float* __restrict__ f,
                   int* __restrict__ st, unsigned long long* __restrict__ rays,
                   const Params p) {
  extern __shared__ float smem[];
  const Columns col = load_columns(table, smem, p.i[IP_N_SPHERES]);
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
    trace_lane<true>(L, p, table, cam, col, lane, il[I_BUDGET * n],
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
  // exact int64 sum of the increments: per warp, then one atomic
  for (int off = 16; off > 0; off >>= 1)
    traced += __shfl_down_sync(0xFFFFFFFFu, traced, off);
  if ((threadIdx.x & 31) == 0 && traced != 0)
    atomicAdd(rays, (unsigned long long)traced);
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

Params read_params(const void* iparams, const void* fparams) {
  Params p;
  memcpy(p.i, iparams, sizeof(p.i));
  memcpy(p.lights, (const int*)iparams + IP_COUNT, sizeof(p.lights));
  memcpy(p.f, fparams, sizeof(p.f));
  return p;
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
  const int n = p.i[IP_N_LANES];
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  const size_t smem = 5 * sizeof(float) * (size_t)p.i[IP_N_SPHERES];
  mega_pass_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      (const float*)table, (const float*)cam, (float*)rad, (int*)rays, p);
  return (int)cudaGetLastError();
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
  const int n = p.i[IP_N_LANES];
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  const size_t smem = 5 * sizeof(float) * (size_t)p.i[IP_N_SPHERES];
  stream_step_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      (const float*)table, (const float*)cam, (float*)f, (int*)i,
      (unsigned long long*)rays, p);
  return (int)cudaGetLastError();
}
