// Per-ray triangle math of the mesh kernels (culled.cu: K3 nearest hit and
// K4 any hit over Morton clusters; intersect.cu: K5 brute force;
// megakernel.cu: K7), shared by the CUDA kernels and by the host builds
// the CPU tests run (mesh_math_host.cpp, megakernel_host.cpp, g++
// -ffp-contract=off). K3 and K7 split each cluster's records across the
// lanes of a group (lane_nearest) and merge the lanes' answers
// (merge_nearest), K4 likewise with lane_occludes and an OR; the host
// builds run the same split serially.
//
// The formula is the one the JAX package's Pallas kernels use
// (skele_raytracer_tpu/ops/pallas/culled.py `_culled_tile.mt_block`,
// intersect.py `_triangle_kernel`): per ray the features
//   f = [d (0:3), w = o x d (3:6), o (6:9), 1 (9)]
// and per triangle a 20-float record holding the nonzero constants of the
// TPU's folded [10, 4] block (accel.build_clusters `k10`), signs included:
//   A = e2 x e1 (0:3)    B = e2 x v0 (3:6)   -e2 (6:9)
//   -C = -(v0 x e1) (9:12)   -e1 (12:15)   D = e1 x e2 (15:18)
//   -kof = -(e2 . C) (18)    original triangle index (19, as float)
// so that
//   det   = d.A
//   u_num = d.B + w.(-e2)          (times sign: +1 parity, -1 clean)
//   v_num = d.(-C) + w.(-e1)
//   t_num = o.D + (-kof)
// each summed left to right in this fixed order; the plain PyTorch
// versions (ops/cuda/culled.py, ops/cuda/intersect.py) sum in the same
// order with elementwise ops, so kernel and plain agree to the bit when
// both round every operation (nvcc -fmad=false). Padding and masked
// triangles carry an all-zero record: det = 0 fails |det| >= eps.
//
// Both modes compute in full FP32. The JAX package's clean-mode bf16x3
// product (`mt_passes=3`) is an economy of the TPU's matrix unit and is not
// ported.

#pragma once

#include <math.h>
#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

#define MM_FN __host__ __device__ inline

namespace mm {

constexpr int REC = 20;   // floats per triangle record
constexpr int FEAT = 10;  // floats per ray feature row (K4 adds the bound)
constexpr float BIG = 3.0e38f;  // stand-in for +inf (a miss)
constexpr int32_t BIG_I = 1 << 30;  // "no triangle yet" index
constexpr float DET_EPS = 1e-5f;  // config.TRIANGLE_DET_EPS

// The four Moller-Trumbore numerators of one ray (features f) against one
// triangle record r; u_num already carries the mode's sign.
struct Planes {
  float det, u, v, t;
};

MM_FN Planes planes(const float* f, const float* r, float sign) {
  Planes p;
  p.det = f[0] * r[0] + f[1] * r[1] + f[2] * r[2];
  p.u = sign * (f[0] * r[3] + f[1] * r[4] + f[2] * r[5] + f[3] * r[6] +
                f[4] * r[7] + f[5] * r[8]);
  p.v = f[0] * r[9] + f[1] * r[10] + f[2] * r[11] + f[3] * r[12] +
        f[4] * r[13] + f[5] * r[14];
  p.t = f[6] * r[15] + f[7] * r[16] + f[8] * r[17] + r[18];
  return p;
}

// K3's epilogue (culled.py mt_block): rational barycentric tests, one
// division for t, the clean-mode near clip. Returns t, or BIG when the
// triangle is not hit.
MM_FN float culled_t(const Planes& p, bool clip, float t_clip) {
  const bool ok = fabsf(p.det) >= DET_EPS;
  const float det2 = p.det * p.det;
  bool valid = ok && (p.u * p.det >= 0.0f) && (p.v * p.det >= 0.0f) &&
               ((p.u + p.v) * p.det <= det2);
  const float t = p.t / (ok ? p.det : 1.0f);
  if (clip) valid = valid && (t > t_clip);
  return valid ? t : BIG;
}

// Nearest-hit update with the reference's tie-break: an exact-t tie goes to
// the minimum ORIGINAL index (the reference scans in file order), and only
// for a real hit, so misses never stamp an index.
MM_FN void nearest_update(float t, int32_t orig, float& t_best,
                          int32_t& i_best) {
  if (t < t_best || (t < BIG && t == t_best && orig < i_best)) {
    t_best = t;
    i_best = orig;
  }
}

// Two partial answers merged: the lexicographic minimum of (t, original
// index), the tie-break of nearest_update (a miss is (BIG, BIG_I), so it
// never wins a tie). The minimum does not depend on the order in which the
// triangles were visited, so lanes that split a cluster's records and then
// merge give the serial scan's answer to the bit.
MM_FN void merge_nearest(float& t_a, int32_t& i_a, float t_b, int32_t i_b) {
  if (t_b < t_a || (t_b == t_a && i_b < i_a)) {
    t_a = t_b;
    i_a = i_b;
  }
}

// K4's any-hit test (culled.py occ_block): division free, with the t window
// t_clip < t < bound as td > t_clip det^2 and td < bound det^2.
MM_FN bool occludes(const Planes& p, float t_clip, float bound) {
  const bool ok = fabsf(p.det) >= DET_EPS;
  const float det2 = p.det * p.det;
  const float td = p.t * p.det;
  return ok && (p.u * p.det >= 0.0f) && (p.v * p.det >= 0.0f) &&
         ((p.u + p.v) * p.det <= det2) && (td > t_clip * det2) &&
         (td < bound * det2);
}

// K5's epilogue (intersect.py _triangle_kernel): guarded reciprocal, then
// u, v, t and the barycentric bounds. Returns t or BIG; u, v come back for
// the winner's record.
MM_FN float brute_t(const Planes& p, bool clip, float t_clip, float& u,
                    float& v) {
  const bool ok = fabsf(p.det) >= DET_EPS;
  const float inv = (ok ? 1.0f : 0.0f) / (ok ? p.det : 1.0f);
  u = p.u * inv;
  v = p.v * inv;
  const float t = p.t * inv;
  bool valid = ok && (u >= 0.0f) && (u <= 1.0f) && (v >= 0.0f) &&
               (u + v <= 1.0f);
  if (clip) valid = valid && (t > t_clip);
  return valid ? t : BIG;
}

// Slab test of one ray against one box (accel.ray_aabb_entry, unrolled
// over the three axes). inv_d = 1 / where(|d| > 1e-30, d, 1e-30).
MM_FN bool slab(const float* o, const float* inv_d, const float* lo,
                const float* hi, float& tmin, float& tmax) {
  for (int a = 0; a < 3; ++a) {
    const float t0 = (lo[a] - o[a]) * inv_d[a];
    const float t1 = (hi[a] - o[a]) * inv_d[a];
    const float near_a = fminf(t0, t1), far_a = fmaxf(t0, t1);
    tmin = a == 0 ? near_a : fmaxf(tmin, near_a);
    tmax = a == 0 ? far_a : fminf(tmax, far_a);
  }
  return tmin <= tmax;
}

MM_FN float inv_dir(float d) { return 1.0f / (fabsf(d) > 1e-30f ? d : 1e-30f); }

// A float as an int whose signed order is the float's order (non-NaN), so
// a block can take a float minimum with an integer atomicMin. Its own
// inverse.
MM_FN int32_t ordered_key(int32_t bits) {
  return bits >= 0 ? bits : (bits ^ 0x7FFFFFFF);
}

// The kernels' shuffle butterfly over the (t, index) of G <= 32 lanes
// (cluster_walk.cuh group_nearest), run serially for the host builds: at
// step k, lane g merges what lane g ^ k held before the step.
MM_FN void merge_lanes(int G, float* t, int32_t* i) {
  for (int k = 1; k < G; k <<= 1) {
    float t0[32];
    int32_t i0[32];
    for (int g = 0; g < G; ++g) {
      t0[g] = t[g];
      i0[g] = i[g];
    }
    for (int g = 0; g < G; ++g)
      merge_nearest(t[g], i[g], t0[g ^ k], i0[g ^ k]);
  }
}

// A triangle record as one 16-byte-aligned value: a kernel reads it from
// shared memory with five 128-bit loads.
struct alignas(16) Rec {
  float v[REC];
};

// One lane's share of a staged cluster of cs records: lane `lane` of a
// group of G lanes that carry the same ray tests records lane, lane + G,
// lane + 2G, ... and folds them into its own (t_best, i_best). BRUTE picks
// K7's t (brute_t) over K3's (culled_t).
template <bool BRUTE>
MM_FN void lane_nearest(const float* f, const float* recs, int cs, int lane,
                        int G, float sign, bool clip, float t_clip,
                        float& t_best, int32_t& i_best) {
  const Rec* rr = reinterpret_cast<const Rec*>(recs);
  for (int j = lane; j < cs; j += G) {
    const Rec r = rr[j];
    const Planes p = planes(f, r.v, sign);
    float u, v;
    const float t = BRUTE ? brute_t(p, clip, t_clip, u, v)
                          : culled_t(p, clip, t_clip);
    nearest_update(t, (int32_t)r.v[19], t_best, i_best);
  }
}

// K4's share of a staged cluster for one lane: records lane, lane + G, ...
// until the first that occludes inside (t_clip, bound). The group ORs its
// lanes' answers (cluster_walk.cuh group_any); an OR does not depend on
// which lane found the occluder, so any split gives the serial scan's bit.
MM_FN bool lane_occludes(const float* f, const float* recs, int cs, int lane,
                         int G, float sign, float t_clip, float bound) {
  const Rec* rr = reinterpret_cast<const Rec*>(recs);
  for (int j = lane; j < cs; j += G) {
    const Rec r = rr[j];
    if (occludes(planes(f, r.v, sign), t_clip, bound)) return true;
  }
  return false;
}

}  // namespace mm
