// Per-ray math of the fused kernel K7 (megakernel.cu) after its scans: the
// hit data, the shadow origin, each light's direction and the clean
// Blinn-Phong sum. Shared by the CUDA kernel and the host build the CPU
// tests run (megakernel_host.cpp, g++ -ffp-contract=off), which scans
// every record and sphere brute force around the same functions.
//
// The formulas are the JAX package's `_megakernel`
// (skele_raytracer_tpu/ops/pallas/megakernel.py:331-500), operation for
// operation, except that a unit vector is v * (1 / sqrt(|v|^2)) where the
// TPU takes rsqrt (CUDA's rsqrtf is not correctly rounded; a division and
// a square root are, in the kernel and in PyTorch alike). The plain
// PyTorch version (ops/cuda/megakernel.py `fused_shade_torch`) takes the
// same operations in the same order, so hits, indices and shadow bits
// agree to the bit; `direct` goes through powf, which may differ from
// PyTorch's pow by an ulp or two.
//
// Tables (row layouts; the wrapper packs them):
//   sphere row, SROW = 16: center (0:3), |c|^2 - r^2 (3), mask (4),
//     ambient (5:8), diffuse (8:11), specular (11:14), power (14), ior (15)
//   shade row, by original triangle index, TROW = 14: unit normal
//     normalize(cross(v1 - v0, v2 - v0)) (0:3), ambient (3:6), diffuse
//     (6:9), specular (9:12), power (12), ior (13)
//   light row, LROW = 7: position (point) or unit direction toward the
//     light (directional) (0:3), colour (3:6), mask (6); point lights
//     first
//   cnst: camera position (0:3), scene ambient (3:6)

#pragma once

#include "mesh_math.cuh"
#include "sphere_math.cuh"

namespace fm {

constexpr int SROW = 16;
constexpr int TROW = 14;
constexpr int LROW = 7;
constexpr float T_EPS = 1e-4f;  // config.CLEAN_T_EPS
constexpr float TINY = 1e-30f;

// v * (1 / |v|), zero for a zero vector (_normalize_rows).
MM_FN void unit(const float* v, float* out) {
  const float n2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const bool pos = n2 > 0.0f;
  const float inv = (1.0f / sqrtf(pos ? n2 : 1.0f)) * (pos ? 1.0f : 0.0f);
  for (int k = 0; k < 3; ++k) out[k] = v[k] * inv;
}

MM_FN float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// What K7 knows of a ray once the nearest hit is settled.
struct Surface {
  int32_t kind;   // 0 miss, 1 sphere, 2 triangle
  int32_t index;  // sphere row or original triangle index
  float t;        // BIG on a miss
  float shades;   // 1 on a hit, 0 on a miss
  float x[3], n[3], view[3], sh[3];  // point, normal, view, shadow origin
  float amb[3], dif[3], spec[3], power;
  float direct[3];
};

// Hit data from the two scans (megakernel.py:349-389): the triangle wins
// only with t_tri < t_sph. srow: the nearest sphere's row (row 0 on a
// sphere miss); trow: the triangle's shade row when it wins (else unread).
// The miss keeps the sphere scan's index and material, as the TPU kernel's
// one-hot selection does.
MM_FN Surface surface(const float* o, const float* d, float t_tri,
                      int32_t i_tri, float t_sph, int32_t i_sph,
                      const float* srow, const float* trow,
                      const float* cnst) {
  Surface s;
  const bool tri_hit = t_tri < mm::BIG;
  const bool sph_hit = t_sph < mm::BIG;
  const bool tri_wins = tri_hit && (t_tri < t_sph);
  s.kind = tri_wins ? 2 : (sph_hit ? 1 : 0);
  s.index = tri_wins ? i_tri : i_sph;
  s.t = tri_wins ? t_tri : t_sph;
  s.shades = (tri_wins || sph_hit) ? 1.0f : 0.0f;
  const float ts = s.t < mm::BIG ? s.t : 0.0f;
  for (int k = 0; k < 3; ++k) s.x[k] = o[k] + d[k] * ts;
  if (tri_wins) {
    const bool flip = dot3(trow, d) > 0.0f;
    for (int k = 0; k < 3; ++k) s.n[k] = flip ? -trow[k] : trow[k];
  } else {
    float v[3];
    for (int k = 0; k < 3; ++k) v[k] = s.x[k] - srow[k];
    unit(v, s.n);
  }
  const float* mat = tri_wins ? trow + 3 : srow + 5;
  for (int k = 0; k < 3; ++k) {
    s.amb[k] = mat[k];
    s.dif[k] = mat[3 + k];
    s.spec[k] = mat[6 + k];
  }
  s.power = mat[9];
  float cv[3];
  for (int k = 0; k < 3; ++k) cv[k] = cnst[k] - s.x[k];
  unit(cv, s.view);
  for (int k = 0; k < 3; ++k) s.direct[k] = cnst[3 + k] * s.amb[k];
  // shadow origin: x + eps (1 + |x|) n
  const float xn2 = dot3(s.x, s.x);
  const bool pos = xn2 > 0.0f;
  const float xlen = sqrtf(pos ? xn2 : 1.0f) * (pos ? 1.0f : 0.0f);
  const float step = T_EPS * (1.0f + xlen);
  for (int k = 0; k < 3; ++k) s.sh[k] = s.x[k] + step * s.n[k];
  return s;
}

// Direction toward light row `l` (unit), the shadow bound (the light's
// distance for a point light, BIG for a directional one) and the falloff
// 1 / d^2 (1 for a directional light, unused).
MM_FN void light_dir(const Surface& s, const float* l, bool point,
                     float* ldir, float& bound, float& falloff) {
  if (point) {
    float v[3];
    for (int k = 0; k < 3; ++k) v[k] = l[k] - s.x[k];
    const float d2 = dot3(v, v);
    const float dl = sqrtf(fmaxf(d2, TINY));
    const float den = fmaxf(dl, TINY);
    for (int k = 0; k < 3; ++k) ldir[k] = v[k] / den;
    bound = dl;
    falloff = 1.0f / fmaxf(d2, TINY);
  } else {
    for (int k = 0; k < 3; ++k) ldir[k] = l[k];
    bound = mm::BIG;
    falloff = 1.0f;
  }
}

// Shadow-ray features [ldir, sh x ldir, sh, 1] (mesh_math.cuh layout).
MM_FN void shadow_features(const Surface& s, const float* ldir, float* f) {
  const float* a = s.sh;
  for (int k = 0; k < 3; ++k) {
    f[k] = ldir[k];
    f[6 + k] = a[k];
  }
  f[3] = a[1] * ldir[2] - a[2] * ldir[1];
  f[4] = a[2] * ldir[0] - a[0] * ldir[2];
  f[5] = a[0] * ldir[1] - a[1] * ldir[0];
  f[9] = 1.0f;
}

// Does triangle record r block the shadow ray with features f before
// `bound`? (the clean Moller-Trumbore t of brute_t, t > T_EPS)
MM_FN bool blocks(const float* f, const float* r, float bound) {
  float u, v;
  return mm::brute_t(mm::planes(f, r, -1.0f), true, T_EPS, u, v) < bound;
}

// One lane's share of a staged cluster for the shadow ray f: does any of
// records lane, lane + G, ... (of cs) block it before `bound`? Stops at
// the lane's first blocker; the group ORs its lanes' answers.
MM_FN bool lane_blocks(const float* f, const float* recs, int cs, int lane,
                       int G, float bound) {
  const mm::Rec* rr = reinterpret_cast<const mm::Rec*>(recs);
  for (int j = lane; j < cs; j += G) {
    const mm::Rec r = rr[j];
    if (blocks(f, r.v, bound)) return true;
  }
  return false;
}

// One light's Blinn-Phong term (megakernel.py:473-500), added to direct.
MM_FN void add_light(Surface& s, const float* ldir, const float* l,
                     bool point, float unsh, float falloff) {
  const float gate = l[6] * unsh * s.shades;
  const float ndotl = fmaxf(0.0f, dot3(s.n, ldir));
  float hr[3], h[3];
  for (int k = 0; k < 3; ++k) hr[k] = s.view[k] + ldir[k];
  unit(hr, h);
  const float ndoth = fmaxf(0.0f, dot3(s.n, h));
  const float sp =
      powf(fmaxf(ndoth, TINY), s.power) * (ndoth > 0.0f ? 1.0f : 0.0f);
  for (int k = 0; k < 3; ++k) {
    const float w = point ? gate * l[3 + k] * falloff : gate * l[3 + k];
    s.direct[k] = s.direct[k] + w * (s.dif[k] * ndotl + s.spec[k] * sp);
  }
}

}  // namespace fm
