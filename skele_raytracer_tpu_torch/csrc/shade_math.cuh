// Per-ray math of the split route's hit shading (glue.cu `shade_hit_kernel`
// and `shade_direct_kernel`): models/integrator.py `_shade_hit` around the
// triangle kernels, as ops/geometry.py and ops/shading.py compute it.
//
// shade_hit_ray (G3) combines a ray's sphere and triangle hits into the
// hit record (kind, index, t, point, normal: geometry.intersect after the
// scans), gathers its material (shading.gather_material, 14 columns read by
// row from the scene's tables) and writes the shadow rays K4 takes
// (shading._shadow_mask: one feature row [d, o x d, o, 1], its bound and
// its live bit per light). shade_direct_ray (G4) is
// shading.direct_illumination after K4: per light the sphere shadow scan,
// the gate with K4's bits, ambient + diffuse + Blinn-Phong specular.
//
// Each step is the tensor code's operation in its order, each rounded on
// its own (-fmad=false, -ffp-contract=off): dot as x + y + z, _pos_sqrt,
// normalize as v * (1 / n), offset_origin as point + scale * normal,
// _select_rows' out-of-range rule, clamps that keep NaN as torch.clamp
// does. The hit record, the material and K4's operands are the tensor
// code's bits; the direct term is too but where powf rounds otherwise
// than torch.pow.

#pragma once

#include <stdint.h>

#include "glue_math.cuh"

namespace sh {

// ShadeArgs::flags
constexpr int HAS_SPHERES = 1;      // scene.has_spheres: sphere hits given
constexpr int HAS_TRIANGLES = 2;    // scene.has_triangles: a triangle scan
constexpr int TRIANGLES_BLACK = 4;  // quirks.triangles_shade_black
constexpr int SCALAR_EPS = 8;       // quirks.scalar_epsilon_offset
constexpr int POINT_BLOCK = 16;     // point lights shaded (no zeroed fog)
constexpr int DIR_BLOCK = 32;       // directional lights shaded
constexpr int SHADOWS = 64;         // cfg.use_shadows
constexpr int BOUNDED = 128;        // point-light occluders end at the light
constexpr int K4_SHADOWS = 256;     // triangles occlude, through K4
constexpr int HAS_LIVE = 512;       // a bounce wave's live mask is given

constexpr int64_t ONE_HOT_MAX_ROWS = 512;  // shading._ONE_HOT_MAX_ROWS
constexpr int MAT = 14;                    // shading._pack_material columns

// Operands of both kernels. Tables are contiguous float32, per-ray arrays
// contiguous; o and d are read at their strides (in floats). Bools are
// bytes of 0 or 1.
struct ShadeArgs {
  int64_t R;                 // rays
  int64_t S, T, N;           // sphere, triangle and normal-table rows
  int64_t Lp, Ld;            // point and directional light rows
  int64_t so0, so1, sd0, sd1;
  int32_t flags, pad;
  float t_eps, shadow_eps, t_clip, big;
  // rays and the scans' answers (nullptr where the scene has none)
  const float* o;
  const float* d;
  const float* live;
  const float* sph_t;
  const int64_t* sph_index;
  const uint8_t* sph_hit;
  const float* tri_t;
  const int64_t* tri_index;
  const uint8_t* tri_hit;
  // the scene's tables
  const float* center;
  const float* radius;
  const float* smask;
  const float* s_mat[6];  // ambient, diffuse, specular, transmissive, power,
  const float* t_mat[6];  // ior of spheres, then of triangles
  const float* tri_normals;
  const float* p_pos;
  const float* p_col;
  const float* p_mask;
  const float* d_dir;
  const float* d_col;
  const float* d_mask;
  const float* ambient;
  const float* camera;
  // G3's outputs, G4's inputs
  int64_t* kind;
  int64_t* index;
  float* t;
  float* point;    // [R, 3]
  float* normal;   // [R, 3]
  float* mat;      // [R, 14]
  uint8_t* shades;
  uint8_t* miss;
  float* feats_p;  // [Lp * R, 10], K4's rows toward the point lights
  float* bound_p;  // [Lp * R]
  float* feats_d;  // [Ld * R, 10], toward the directional lights
  float* bound_d;  // [Ld * R]
  float* k4_live;  // [max(Lp, Ld) * R]
  // K4's answers (nullptr where K4 did not run) and G4's output
  const uint8_t* occ_p;  // [Lp * R]
  const uint8_t* occ_d;  // [Ld * R]
  float* direct;         // [R, 3]
};

FM_FN float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// geometry._pos_sqrt: sqrt(x) where x > 0, else 0 (NaN included).
FM_FN float pos_sqrt(float x) { return x > 0.0f ? sqrtf(x) : 0.0f; }

// torch.clamp(x, min=lo): NaN stays NaN.
FM_FN float clamp_min(float x, float lo) {
  return gm::clamp_keep_nan(x, lo, INFINITY);
}

// geometry.normalize: v * where(n > 0, 1 / n, 0), n = _pos_sqrt(v . v).
FM_FN void normalize(const float v[3], float out[3]) {
  const float n = pos_sqrt(dot3(v, v));
  const float w = n > 0.0f ? 1.0f / n : 0.0f;
  for (int c = 0; c < 3; ++c) out[c] = v[c] * w;
}

// The shadow rays' origin (shading._shadow_mask): point + 1e-6 on each
// component in parity, geometry.offset_origin along the normal in clean.
FM_FN void shadow_origin(const ShadeArgs& a, const float x[3],
                         const float n[3], float org[3]) {
  if (a.flags & SCALAR_EPS) {
    for (int c = 0; c < 3; ++c) org[c] = x[c] + a.shadow_eps;
    return;
  }
  const float scale = (pos_sqrt(dot3(x, x)) + 1.0f) * a.t_eps;
  for (int c = 0; c < 3; ++c) org[c] = x[c] + scale * n[c];
}

// One light's shadow-ray features (culled._ray_features10): d, o x d in
// geometry.cross's order, o, 1.
FM_FN void feature_row(const float o[3], const float d[3], float* row) {
  row[0] = d[0];
  row[1] = d[1];
  row[2] = d[2];
  row[3] = o[1] * d[2] - o[2] * d[1];
  row[4] = o[2] * d[0] - o[0] * d[2];
  row[5] = o[0] * d[1] - o[1] * d[0];
  row[6] = o[0];
  row[7] = o[1];
  row[8] = o[2];
  row[9] = 1.0f;
}

// G3's answer for one ray, before it is written out.
struct Hit {
  int64_t kind, index;
  float t;
  float p[3], n[3];  // point, normal
  float mat[MAT];
  float org[3];      // the shadow rays' origin
  float live;        // K4's live bit: 1 where the ray hit and is live
};

// The hit record and the material of ray i; the shadow origin and live
// bit where K4 runs.
FM_FN void hit_record(const ShadeArgs& a, int64_t i, Hit& h) {
  float o[3], d[3];
  for (int c = 0; c < 3; ++c) {
    o[c] = a.o[i * a.so0 + c * a.so1];
    d[c] = a.d[i * a.sd0 + c * a.sd1];
  }
  // geometry.intersect: spheres first, a triangle wins with a smaller t
  float st = INFINITY;
  int64_t si = 0;
  bool sh = false;
  if (a.flags & HAS_SPHERES) {
    st = a.sph_t[i];
    si = a.sph_index[i];
    sh = a.sph_hit[i] != 0;
  }
  int64_t ti = 0;
  h.kind = sh ? 1 : 0;
  h.index = si;
  h.t = st;
  if (a.flags & HAS_TRIANGLES) {
    const float tt = a.tri_t[i];
    ti = a.tri_index[i];
    if (a.tri_hit[i] != 0 && tt < (sh ? st : INFINITY)) {
      h.kind = 2;
      h.index = ti;
      h.t = tt;
    }
  }
  const float ts = isfinite(h.t) ? h.t : 0.0f;
  for (int c = 0; c < 3; ++c) {
    h.p[c] = o[c] + d[c] * ts;
    h.n[c] = 0.0f;
  }
  if (a.flags & HAS_SPHERES) {
    float v[3];
    for (int c = 0; c < 3; ++c) v[c] = h.p[c] - a.center[3 * si + c];
    normalize(v, h.n);
  }
  if (a.flags & HAS_TRIANGLES) {
    const float* nt = a.tri_normals + 3 * (ti < a.N - 1 ? ti : a.N - 1);
    const float s = dot3(nt, d) > 0.0f ? -1.0f : 1.0f;
    if (h.kind == 2)
      for (int c = 0; c < 3; ++c) h.n[c] = nt[c] * s;
  }

  // shading.gather_material: _select_rows of the sphere table (parity), or
  // of both tables, each kept where its kind won
  const bool black = (a.flags & TRIANGLES_BLACK) != 0;
  const int64_t index = h.index;
  const int64_t rs = index < a.S - 1 ? index : a.S - 1;
  const int64_t rt = index < a.T - 1 ? index : a.T - 1;
  bool keep_s = a.S > ONE_HOT_MAX_ROWS || index < a.S;
  const bool has_keep_s = !black || a.S <= ONE_HOT_MAX_ROWS;
  if (!black) keep_s = keep_s && h.kind != 2;
  const bool keep_t =
      (a.T > ONE_HOT_MAX_ROWS || index < a.T) && h.kind == 2;
  for (int k = 0, col = 0; k < 6; ++k) {
    const int w = k < 4 ? 3 : 1;
    for (int c = 0; c < w; ++c, ++col) {
      float v = a.s_mat[k][w * rs + c];
      if (has_keep_s) v = v * (keep_s ? 1.0f : 0.0f);
      if (!black) v = v + a.t_mat[k][w * rt + c] * (keep_t ? 1.0f : 0.0f);
      h.mat[col] = v;
    }
  }
  if (!(a.flags & K4_SHADOWS)) return;
  shadow_origin(a, h.p, h.n, h.org);
  h.live = h.kind > 0 ? 1.0f : 0.0f;
  if (a.flags & HAS_LIVE) h.live = h.live * a.live[i];
  h.live = h.live > 0.0f ? 1.0f : 0.0f;
}

// shades (spheres always, triangles in clean mode) and miss of a record.
FM_FN bool shades(const ShadeArgs& a, const Hit& h) {
  return h.kind == 1 || (!(a.flags & TRIANGLES_BLACK) && h.kind == 2);
}

// K4's shadow ray of a record toward point light l: its feature row and
// its bound (the light's distance, or `big` without the bound).
FM_FN float point_shadow_ray(const ShadeArgs& a, const Hit& h, int64_t l,
                             float row[10]) {
  float lv[3], dir[3];
  for (int c = 0; c < 3; ++c) lv[c] = a.p_pos[3 * l + c] - h.p[c];
  normalize(lv, dir);
  feature_row(h.org, dir, row);
  return (a.flags & BOUNDED) ? pos_sqrt(dot3(lv, lv)) : a.big;
}

// K4's shadow ray of a record toward directional light l (unbounded).
FM_FN void dir_shadow_ray(const ShadeArgs& a, const Hit& h, int64_t l,
                          float row[10]) {
  float ld[3], dir[3];
  normalize(a.d_dir + 3 * l, ld);
  normalize(ld, dir);
  feature_row(h.org, dir, row);
}

// G3 of ray i, written straight to its outputs (the host build's loop; the
// kernel stages the rows of a block through shared memory).
FM_FN void shade_hit_ray(const ShadeArgs& a, int64_t i) {
  Hit h;
  hit_record(a, i, h);
  a.kind[i] = h.kind;
  a.index[i] = h.index;
  a.t[i] = h.t;
  for (int c = 0; c < 3; ++c) {
    a.point[3 * i + c] = h.p[c];
    a.normal[3 * i + c] = h.n[c];
  }
  for (int c = 0; c < MAT; ++c) a.mat[MAT * i + c] = h.mat[c];
  a.shades[i] = shades(a, h);
  a.miss[i] = h.kind == 0;
  if (!(a.flags & K4_SHADOWS)) return;
  if (a.flags & POINT_BLOCK)
    for (int64_t l = 0; l < a.Lp; ++l)
      a.bound_p[l * a.R + i] =
          point_shadow_ray(a, h, l, a.feats_p + 10 * (l * a.R + i));
  if (a.flags & DIR_BLOCK)
    for (int64_t l = 0; l < a.Ld; ++l) {
      dir_shadow_ray(a, h, l, a.feats_d + 10 * (l * a.R + i));
      a.bound_d[l * a.R + i] = a.big;
    }
  const int64_t L = a.Lp > a.Ld ? a.Lp : a.Ld;
  for (int64_t l = 0; l < L; ++l) a.k4_live[l * a.R + i] = h.live;
}

// geometry.ray_sphere_all along one shadow ray, reduced as _shadow_mask
// reduces it: does a sphere's valid t lie below `dist` (bounded), or is
// any finite?
FM_FN bool spheres_occlude(const ShadeArgs& a, const float org[3],
                           const float dir[3], bool bounded, float dist) {
  const float aa = dot3(dir, dir);
  const float den = 2.0f * (aa > 0.0f ? aa : 1.0f);
  for (int64_t s = 0; s < a.S; ++s) {
    float ec[3];
    for (int c = 0; c < 3; ++c) ec[c] = org[c] - a.center[3 * s + c];
    const float b = 2.0f * dot3(dir, ec);
    const float r = a.radius[s];
    const float cc = dot3(ec, ec) - r * r;
    const float disc = b * b - 4.0f * aa * cc;
    const float t2 = (-b - pos_sqrt(disc)) / den;
    const bool valid = disc >= 0.0f && t2 >= 0.0f && t2 > a.t_clip &&
                       a.smask[s] > 0.0f;
    const float ts = valid ? t2 : INFINITY;
    if (bounded ? ts < dist : isfinite(ts)) return true;
  }
  return false;
}

// shading._blinn_phong_specular of one light: (n . h)^power, 0 where
// n . h <= 0, h the normalized view + light half vector.
FM_FN float blinn_phong(const float view[3], const float n[3],
                        const float l[3], float power) {
  float h[3];
  for (int c = 0; c < 3; ++c) h[c] = view[c] + l[c];
  const float hn = clamp_min(pos_sqrt(dot3(h, h)), 1e-30f);
  for (int c = 0; c < 3; ++c) h[c] = h[c] / hn;
  const float ndoth = clamp_min(dot3(n, h), 0.0f);
  return powf(clamp_min(ndoth, 1e-30f), power) *
         (ndoth > 0.0f ? 1.0f : 0.0f);
}

// G4: shading.direct_illumination of ray i after K4.
FM_FN void shade_direct_ray(const ShadeArgs& a, int64_t i) {
  const float* x = a.point + 3 * i;
  const float* n = a.normal + 3 * i;
  const float* m = a.mat + MAT * i;  // ambient, diffuse, specular, ., power
  const float power = m[12];
  float total[3];
  for (int c = 0; c < 3; ++c) total[c] = a.ambient[c] * m[c];
  if (!(a.flags & (POINT_BLOCK | DIR_BLOCK))) {
    for (int c = 0; c < 3; ++c) a.direct[3 * i + c] = total[c];
    return;
  }
  const bool shadows = (a.flags & SHADOWS) != 0;
  const bool spheres = (a.flags & HAS_SPHERES) != 0;
  float org[3], view[3], v[3];
  shadow_origin(a, x, n, org);
  for (int c = 0; c < 3; ++c) v[c] = a.camera[c] - x[c];
  normalize(v, view);

  if (a.flags & POINT_BLOCK) {
    const bool bounded = (a.flags & BOUNDED) != 0;
    float acc[3] = {0.0f, 0.0f, 0.0f};
    for (int64_t li = 0; li < a.Lp; ++li) {
      const float* pos = a.p_pos + 3 * li;
      const float* col = a.p_col + 3 * li;
      float lv[3], l[3];
      for (int c = 0; c < 3; ++c) lv[c] = pos[c] - x[c];
      const float dl = pos_sqrt(dot3(lv, lv));
      const float dlc = clamp_min(dl, 1e-30f);
      for (int c = 0; c < 3; ++c) l[c] = lv[c] / dlc;
      bool unshadowed = true;
      if (shadows) {
        bool occ = false;
        if (spheres) {
          float dir[3];
          normalize(lv, dir);
          occ = spheres_occlude(a, org, dir, bounded, dl);
        }
        if (a.occ_p != nullptr) occ = occ || a.occ_p[li * a.R + i] != 0;
        unshadowed = !occ;
      }
      const float gate = a.p_mask[li] * (unshadowed ? 1.0f : 0.0f);
      const float intensity = 1.0f / clamp_min(dl * dl, 1e-30f);
      const float ndotl = clamp_min(dot3(n, l), 0.0f);
      const float sp = blinn_phong(view, n, l, power);
      for (int c = 0; c < 3; ++c) {
        const float diff = (m[3 + c] * col[c]) * (intensity * ndotl);
        const float spec = (m[6 + c] * col[c]) * (intensity * sp);
        acc[c] = acc[c] + (diff + spec) * gate;
      }
    }
    for (int c = 0; c < 3; ++c) total[c] = total[c] + acc[c];
  }

  if (a.flags & DIR_BLOCK) {
    float acc[3] = {0.0f, 0.0f, 0.0f};
    for (int64_t li = 0; li < a.Ld; ++li) {
      const float* col = a.d_col + 3 * li;
      float ld[3];
      normalize(a.d_dir + 3 * li, ld);
      bool unshadowed = true;
      if (shadows) {
        bool occ = false;
        if (spheres) {
          float dir[3];
          normalize(ld, dir);
          occ = spheres_occlude(a, org, dir, false, 0.0f);
        }
        if (a.occ_d != nullptr) occ = occ || a.occ_d[li * a.R + i] != 0;
        unshadowed = !occ;
      }
      const float gate = a.d_mask[li] * (unshadowed ? 1.0f : 0.0f);
      const float ndotl = clamp_min(dot3(n, ld), 0.0f);
      const float sp = blinn_phong(view, n, ld, power);
      for (int c = 0; c < 3; ++c) {
        const float diff = (m[3 + c] * col[c]) * ndotl;
        const float spec = (m[6 + c] * col[c]) * sp;
        acc[c] = acc[c] + (diff + spec) * gate;
      }
    }
    for (int c = 0; c < 3; ++c) total[c] = total[c] + acc[c];
  }
  for (int c = 0; c < 3; ++c) a.direct[3 * i + c] = total[c];
}

}  // namespace sh
