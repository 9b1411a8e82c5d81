// Per-sample adjoint of the whole-frame path tracer: the math of the
// backward kernel (pathtrace_bwd.cu).
//
// The JAX package's backward kernel (ops/pallas/pathtrace.py::
// _build_backward_kernel) is `jax.grad` of the record-driven replay
// (`_build_frame_math(replay=True)`) with respect to the five scene tables,
// contracted with the radiance cotangent. CUDA has no autodiff, so this
// header writes that reverse mode by hand, one sample at a time:
//
// * The replay forward: the camera ray; per record, the recorded
//   primitive's t (`replay_hit`: the selected sphere's quadratic or the
//   selected triangle's Moller-Trumbore t), then frame_math.cuh's material
//   gather and hit geometry; shading with the record's unshadowed bits as
//   the shadow gates (`shade_vjp`); the fog draws recomputed from the RNG.
// * The reverse sweep, path by path: for bounce b = D-1 down to 1 the
//   state entering bounce b is recomputed from the primary hit
//   (`advance`, O(D^2) bounces per path, no saved per-bounce state), the
//   bounce is run forward once more, and its adjoints flow back into the
//   recorded primitive's table row, the lights, the misc row and the
//   adjoint of the incoming state. The primary hit and the camera row come
//   last.
//
// The adjoints divide once per quotient and multiply by the reciprocal
// where the derivative needs it again (1 / x^2, 0.5 / x), and spec_pow's
// value and adjoint share one log and one exp (`spec_pow_vjp`): the
// backward kernel's time is mostly IEEE division, square root and pow.
// Each differs from the plain version's float32 rounding in the last bits,
// well inside the tolerance the kernel is held to.
//
// Each forward function of frame_math.cuh that carries gradient has its
// adjoint here as a function of its own (`normalize3_bwd`, `sphere_t_bwd`,
// `mt_t_bwd`, `hit_geom_bwd`, `gather_mat_bwd`, `spec_pow_vjp`,
// `shade_vjp`, `tangent_frame_bwd`, `sample_dir_bwd`, `offset_origin_bwd`,
// camera in `finish_bwd`). Each follows PyTorch's derivative of the plain
// version's operation (ops/cuda/pathtrace.py::frame_math_torch with
// `recs_in`): clamp(min=c) passes the gradient where x >= c, sqrt where
// its argument is positive, and discrete choices (record bits, fog
// interactions, the tangent-frame branch, the triangle normal's flip) are
// constants.
//
// A sample is split over G lanes (`lane_bwd`, `finish_bwd`): each lane
// replays the primary hit from its record and runs the adjoints of paths
// lane, lane + G, ...; the lane `shade_lane(G)` also runs the primary
// shade. The paths' adjoints are independent until they add into the
// adjoint of the primary state (`PrimaryG`), which the group sums; lane 0
// then finishes the primary hit and the camera row.
//
// Gradients leave through an accumulator `A`, one per thread:
// * `dense(e, v, n)` adds n values at index e of the dense vector
//   (`DenseLayout`: misc row 0, the fog rows' scattering, albedo and mask,
//   the light rows), the entries every sample may reach, into the thread's
//   own copy;
// * `row_begin()` returns the lane's zeroed row of TRI_W floats, into which
//   the adjoints of one record add; `row_commit(kind, idx)` adds it to the
//   recorded primitive's table row (kind 1: sphere row of 16, kind 2:
//   triangle row of 24, 0: nothing). Every lane of a warp makes the same
//   sequence of row_commit calls (the kernel sums a warp's rows together),
//   so a lane also runs, inactive, the paths it does not own;
// * `active` false makes both add nothing.
// The kernel (pathtrace_bwd.cu) and the host build (frame_math_host.cpp)
// implement it with the same summation order.

#pragma once

#include "frame_math.cuh"

namespace fm {

// Offsets of the five gradient tables in one flat array.
struct GradLayout {
  int sph, tri, misc, pl, dl, total;
};

FM_FN GradLayout grad_layout(const Params& p) {
  GradLayout g;
  g.sph = 0;
  g.tri = p.S * SPH_W;
  g.misc = g.tri + p.T * TRI_W;
  g.pl = g.misc + (1 + p.F) * MISC_W;
  g.dl = g.pl + p.L * LIGHT_W;
  g.total = g.dl + p.LD * LIGHT_W;
  return g;
}

// Misc-table columns with a gradient: row 0 columns 0:18 (camera, ambient,
// background); fog rows' scattering, albedo and mask (columns 2:7). Light
// rows: columns 0:7.
constexpr int MISC_G = 18;
constexpr int FOG_G = 5;
constexpr int LIGHT_G = 7;

// The dense vector: the gradient entries that every sample may reach, in
// the order misc row 0 (MISC_G) | fog rows (F x FOG_G) | point lights (L x
// LIGHT_G) | directional lights (LD x LIGHT_G).
struct DenseLayout {
  int misc, fog, pl, dl, total;
};

FM_FN DenseLayout dense_layout(const Params& p) {
  DenseLayout d;
  d.misc = 0;
  d.fog = MISC_G;
  d.pl = d.fog + p.F * FOG_G;
  d.dl = d.pl + p.L * LIGHT_G;
  d.total = d.dl + p.LD * LIGHT_G;
  return d;
}

// The dense index of flat gradient entry e (GradLayout), or -1 where e is
// a primitive row's entry or no gradient reaches it.
FM_FN int dense_index(const GradLayout& g, const DenseLayout& d, int e) {
  if (e < g.misc) return -1;
  if (e < g.pl) {
    const int r = (e - g.misc) / MISC_W, c = (e - g.misc) % MISC_W;
    if (r == 0) return c < MISC_G ? d.misc + c : -1;
    return (c >= 2 && c < 2 + FOG_G) ? d.fog + (r - 1) * FOG_G + c - 2 : -1;
  }
  const bool point = e < g.dl;
  const int k = e - (point ? g.pl : g.dl);
  const int r = k / LIGHT_W, c = k % LIGHT_W;
  return c < LIGHT_G ? (point ? d.pl : d.dl) + r * LIGHT_G + c : -1;
}

// The backward kernel's block (pathtrace_bwd.cu; frame_math_host.cpp runs
// the same schedule): BWD_THREADS threads, and the floats of shared memory
// it carves: the scene tables, one row table per warp, one staged row per
// thread, and one dense vector per thread, laid out [value][thread] at a
// padded pitch. Each light adds LIGHT_W + LIGHT_G * BWD_DENSE_PITCH floats
// (3.6 KiB), so ops/cuda/pathtrace.py's MAX_REPLAY_LIGHTS bounds the block.
constexpr int BWD_THREADS = 128;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_DENSE_PITCH = BWD_THREADS + 1;
constexpr int BWD_ROW_PITCH = TRI_W + 1;

FM_FN long long bwd_smem_floats(const GradLayout& lay, const DenseLayout& d) {
  return (long long)lay.total + (long long)BWD_WARPS * lay.misc +
         (long long)BWD_WARPS * 32 * BWD_ROW_PITCH +
         (long long)d.total * BWD_DENSE_PITCH;
}

template <class A>
FM_FN void dense3(A& acc, int e, V3 v) {
  const float f[3] = {v.x, v.y, v.z};
  acc.dense(e, f, 3);
}

struct MatG {
  V3 amb, dif, spec, cen;
  float power;
};

FM_FN V3 add3(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
FM_FN V3 sub3(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
FM_FN V3 mul3(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
FM_FN V3 scale3(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
FM_FN V3 cross3(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
FM_FN V3 zero3() { return v3(0.0f, 0.0f, 0.0f); }
FM_FN void acc3(float* dst, V3 v) {
  dst[0] += v.x;
  dst[1] += v.y;
  dst[2] += v.z;
}
FM_FN MatG zero_matg() {
  MatG g;
  g.amb = g.dif = g.spec = g.cen = zero3();
  g.power = 0.0f;
  return g;
}

// ---- adjoints of the building blocks -----------------------------------

// normalize3: y = v / |v| (zero maps to zero).
FM_FN V3 normalize3_bwd(V3 v, V3 gy) {
  float n2 = dot3(v, v);
  float nn = pos_sqrt(n2);
  if (!(nn > 0.0f)) return zero3();
  float inv = 1.0f / nn;
  float g_inv = dot3(gy, v);
  float g_nn = -g_inv * (inv * inv);
  float g_n2 = g_nn * 0.5f * inv;
  return add3(scale3(gy, inv), scale3(v, 2.0f * g_n2));
}

// a = max(x, c) passes the gradient where x >= c (torch.clamp).
FM_FN float clamp_bwd(float x, float c, float g) { return x >= c ? g : 0.0f; }

// ---- the replay's nearest hit -------------------------------------------

struct RHit {
  bool hit, tri_wins, sph_sel, shades;
  int idx;
  float t;
};

// t of the recorded sphere (row r): the replay's quadratic, whose `a` is
// forced to 1 for zero-length directions.
FM_FN float sphere_t(const float* r, V3 o, V3 d) {
  float a = dot3(d, d);
  a = a > 0.0f ? a : 1.0f;
  V3 e = v3(o.x - r[0], o.y - r[1], o.z - r[2]);
  float b = 2.0f * dot3(d, e);
  float c = dot3(e, e) - r[3];
  float disc = b * b - 4.0f * a * c;
  return (-b - pos_sqrt(disc)) * (0.5f / a);
}

// Adjoint of sphere_t: into go, gd and the row's center (0:3) and r^2 (3).
FM_FN void sphere_t_bwd(const float* r, V3 o, V3 d, float gt, V3* go, V3* gd,
                        float* grow) {
  float a2 = dot3(d, d);
  float a = a2 > 0.0f ? a2 : 1.0f;
  V3 e = v3(o.x - r[0], o.y - r[1], o.z - r[2]);
  float b = 2.0f * dot3(d, e);
  float c = dot3(e, e) - r[3];
  float a4 = 4.0f * a;
  float disc = b * b - a4 * c;
  float sq = pos_sqrt(disc);
  float num = -b - sq;
  float ia = 1.0f / a;
  float inv2a = 0.5f * ia;
  float g_num = gt * inv2a;
  float g_a = -(gt * num) * inv2a * ia;
  float g_b = -g_num;
  float g_disc = disc > 0.0f ? -g_num * 0.5f / sq : 0.0f;
  g_b += 2.0f * b * g_disc;
  g_a += 4.0f * (-g_disc * c);
  float g_c = -g_disc * a4;
  V3 g_e = add3(scale3(e, 2.0f * g_c), scale3(d, 2.0f * g_b));
  V3 gdd = scale3(e, 2.0f * g_b);
  if (a2 > 0.0f) gdd = add3(gdd, scale3(d, 2.0f * g_a));
  *gd = add3(*gd, gdd);
  *go = add3(*go, g_e);
  grow[0] -= g_e.x;
  grow[1] -= g_e.y;
  grow[2] -= g_e.z;
  grow[3] -= g_c;
}

// Moller-Trumbore t of the recorded triangle (row r: v0 0:3, e1 3:6,
// e2 6:9).
FM_FN float mt_t(const float* r, V3 o, V3 d) {
  V3 e1 = load3(r + 3), e2 = load3(r + 6);
  V3 pv = cross3(d, e2);
  float det = dot3(e1, pv);
  bool ok = fabsf(det) >= TRIANGLE_DET_EPS;
  float inv = (ok ? 1.0f : 0.0f) / (ok ? det : 1.0f);
  V3 tv = sub3(o, load3(r));
  V3 q = cross3(tv, e1);
  return dot3(e2, q) * inv;
}

// Adjoint of mt_t: into go, gd and the row's v0, e1, e2 (0:9).
FM_FN void mt_t_bwd(const float* r, V3 o, V3 d, float gt, V3* go, V3* gd,
                    float* grow) {
  V3 e1 = load3(r + 3), e2 = load3(r + 6);
  V3 pv = cross3(d, e2);
  float det = dot3(e1, pv);
  bool ok = fabsf(det) >= TRIANGLE_DET_EPS;
  float inv = (ok ? 1.0f : 0.0f) / (ok ? det : 1.0f);
  V3 tv = sub3(o, load3(r));
  V3 q = cross3(tv, e1);
  float num = dot3(e2, q);
  float g_num = gt * inv;
  float g_det = ok ? -(gt * num) / (det * det) : 0.0f;
  V3 g_e2 = scale3(q, g_num);
  V3 g_q = scale3(e2, g_num);
  V3 g_e1 = scale3(pv, g_det);
  V3 g_p = scale3(e1, g_det);
  // q = tv x e1, p = d x e2
  V3 g_tv = cross3(e1, g_q);
  g_e1 = add3(g_e1, cross3(g_q, tv));
  *gd = add3(*gd, cross3(e2, g_p));
  g_e2 = add3(g_e2, cross3(g_p, d));
  *go = add3(*go, g_tv);
  grow[0] -= g_tv.x;
  grow[1] -= g_tv.y;
  grow[2] -= g_tv.z;
  acc3(grow + 3, g_e1);
  acc3(grow + 6, g_e2);
}

// The recorded hit of one slot (ops/cuda/pathtrace.py::_pack_record).
FM_FN RHit replay_hit(const Params& p, const Tables& tb, uint32_t rec, V3 o,
                      V3 d) {
  RHit h;
  h.hit = ((rec >> 8) & 1u) != 0;
  h.idx = (int)(rec & 0xFFu);
  h.tri_wins = p.tri_on && ((rec >> 9) & 1u) != 0;
  h.sph_sel = h.hit && !h.tri_wins;
  h.shades = (p.tri_on && p.tri_black) ? h.sph_sel : h.hit;
  h.t = 0.0f;
  if (h.tri_wins && h.idx < p.T) {
    h.t = mt_t(tb.tri + h.idx * TRI_W, o, d);
  } else if (h.sph_sel && p.sph_on && h.idx < p.S) {
    h.t = sphere_t(tb.sph + h.idx * SPH_W, o, d);
  }
  return h;
}

FM_FN Hit as_hit(const RHit& r) {
  Hit h;
  h.hit = r.hit;
  h.tri_wins = r.tri_wins;
  h.shades = r.shades;
  h.t = r.t;
  h.idx = r.idx;
  return h;
}

// The table row a record's gradients land in: the triangle's where it
// won, else the sphere at the index (materials gather there even for
// misses and parity's black triangles, with a zero cotangent).
FM_FN int row_kind(const Params& p, const RHit& h) {
  if (h.tri_wins) return h.idx < p.T ? 2 : 0;
  return h.idx < p.S ? 1 : 0;
}

FM_FN void replay_t_bwd(const Params& p, const Tables& tb, const RHit& h,
                        V3 o, V3 d, float gt, V3* go, V3* gd, float* grow) {
  if (h.tri_wins && h.idx < p.T) {
    mt_t_bwd(tb.tri + h.idx * TRI_W, o, d, gt, go, gd, grow);
  } else if (h.sph_sel && p.sph_on && h.idx < p.S) {
    sphere_t_bwd(tb.sph + h.idx * SPH_W, o, d, gt, go, gd, grow);
  }
}

// Adjoint of gather_mat: material (and the sphere center) into the row.
FM_FN void gather_mat_bwd(const Params& p, const RHit& h, const MatG& g,
                          float* grow) {
  if (p.tri_on && !p.tri_black && h.tri_wins) {
    if (h.idx >= p.T) return;
    acc3(grow + 13, g.amb);
    acc3(grow + 16, g.dif);
    acc3(grow + 19, g.spec);
    grow[22] += g.power;
    return;
  }
  if (h.tri_wins || h.idx >= p.S) return;  // zero cotangent (see row_kind)
  acc3(grow + 0, g.cen);
  acc3(grow + 5, g.amb);
  acc3(grow + 8, g.dif);
  acc3(grow + 11, g.spec);
  grow[14] += g.power;
}

// Adjoint of hit_geom: gx, gn of (point, normal) into go, gd, gt, the
// center's gradient and the triangle normal (row 10:13).
FM_FN void hit_geom_bwd(const Params& p, const Tables& tb, V3 o, V3 d,
                        const Hit& h, V3 cen, V3 gx, V3 gn, V3* go, V3* gd,
                        float* gt, V3* gcen, float* grow) {
  float ts = h.hit ? h.t : 0.0f;
  V3 x = v3(o.x + d.x * ts, o.y + d.y * ts, o.z + d.z * ts);
  if (p.tri_on && h.tri_wins) {
    V3 tn = load3(tb.tri + h.idx * TRI_W + 10);
    float flip = dot3(tn, d) > 0.0f ? -1.0f : 1.0f;
    acc3(grow + 10, scale3(gn, flip));
  } else {
    V3 gv = normalize3_bwd(sub3(x, cen), gn);
    gx = add3(gx, gv);
    *gcen = sub3(*gcen, gv);
  }
  *go = add3(*go, gx);
  *gd = add3(*gd, scale3(gx, ts));
  if (h.hit) *gt += dot3(d, gx);
}

// spec_pow and its adjoint in one pass: returns spec_pow(n, view, l,
// power), with pow(base, power) as exp(power log(base)), and adds the
// adjoint of the cotangent gs into gn, gview, gl and gpow (d/dbase of
// pow(base, power) as power pow(base, power) / base).
FM_FN float spec_pow_vjp(V3 n, V3 view, V3 l, float power, float gs, V3* gn,
                         V3* gview, V3* gl, float* gpow) {
  V3 h = add3(view, l);
  float h2 = h.x * h.x + h.y * h.y + h.z * h.z;
  float hn0 = pos_sqrt(h2);
  float hn = jmax(hn0, 1e-30f);
  float ihn = 1.0f / hn;
  float ndr = n.x * h.x * ihn + n.y * h.y * ihn + n.z * h.z * ihn;
  float ndoth = jmax(ndr, 0.0f);
  if (!(ndoth > 0.0f)) return 0.0f;  // spow = pow(...) * 0
  float base = jmax(ndoth, 1e-30f);
  float lb = logf(base);
  float pw = expf(power * lb);
  *gpow += gs * pw * lb;
  float g_base = gs * power * (pw / base);
  float g_ndr = clamp_bwd(ndr, 0.0f, clamp_bwd(ndoth, 1e-30f, g_base));
  *gn = add3(*gn, scale3(h, g_ndr * ihn));
  V3 g_h = scale3(n, g_ndr * ihn);
  float g_ihn = g_ndr * (n.x * h.x + n.y * h.y + n.z * h.z);
  float g_hn0 = clamp_bwd(hn0, 1e-30f, -g_ihn * (ihn * ihn));
  float g_h2 = h2 > 0.0f ? g_hn0 * 0.5f * ihn : 0.0f;
  g_h = add3(g_h, scale3(h, 2.0f * g_h2));
  *gview = add3(*gview, g_h);
  *gl = add3(*gl, g_h);
  return pw;
}

// Replay shading and its adjoint in one pass: returns shade's value at
// (x, n, m) with the record's unshadowed bits as gates, and adds the
// adjoint of the cotangent `g` to gx, gn, gm and, through acc.dense, to
// misc row 0, the fog rows and (once per light) the light rows.
template <class A>
FM_FN V3 shade_vjp(const Params& p, const Tables& tb, const DenseLayout& dl,
                   V3 x, V3 n, const Mat& m, V3 pc, uint32_t idp,
                   uint32_t bounce, uint32_t rec, V3 g, V3* gx, V3* gn,
                   MatG* gm, A& acc) {
  const float* misc = tb.misc;
  V3 amb_s = load3(misc + 12);
  V3 val = mul3(amb_s, m.amb);
  gm->amb = add3(gm->amb, mul3(amb_s, g));
  dense3(acc, dl.misc + 12, mul3(m.amb, g));
  if (!(p.point_on || p.dir_on)) return val;
  V3 cv = sub3(load3(misc), x);
  V3 view = normalize3(cv);
  V3 g_view = zero3();
  for (int li = 0; p.point_on && li < p.L; ++li) {
    const float* r = tb.pl + li * LIGHT_W;
    float cr = r[3], cg = r[4], cb = r[5], lm = r[6];
    V3 lv = v3(r[0] - x.x, r[1] - x.y, r[2] - x.z);
    float d2 = lv.x * lv.x + lv.y * lv.y + lv.z * lv.z;
    float d_l = pos_sqrt(d2);
    float m30 = jmax(d_l, 1e-30f);
    float inv_dl = 1.0f / m30;
    V3 ld = v3(lv.x * inv_dl, lv.y * inv_dl, lv.z * inv_dl);
    float bit = p.use_shadows ? (float)((rec >> (10 + li)) & 1u) : 1.0f;
    float gate = lm * bit;
    float dl2 = d_l * d_l;
    float mi = jmax(dl2, 1e-30f);
    float intensity = 1.0f / mi;
    float nd_raw = dot3(n, ld);
    float ndotl = jmax(nd_raw, 0.0f);
    float lg[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float g_gate, g_int = 0.0f, g_ndotl = 0.0f;
    V3 g_ld = zero3();
    if (p.F > 0) {
      float diff_base = intensity * ndotl;
      float fr = 0.0f, fg = 0.0f, fb = 0.0f;
      V3 g_f = v3(g.x * gate * cr, g.y * gate * cg, g.z * gate * cb);
      float g_db = 0.0f;
      for (int fi = 0; fi < p.F; ++fi) {
        const float* f = misc + (1 + fi) * MISC_W;
        float rad = f[0], absn = f[1], scat = f[2], mf = f[6];
        V3 al = load3(f + 3);
        V3 dc = v3(pc.x - r[0], pc.y - r[1], pc.z - r[2]);
        float dist = sqrtf(jmax(dc.x * dc.x + dc.y * dc.y + dc.z * dc.z, 0.0f));
        dist = jmin(dist, 2.0f * rad);
        float p_no = expf(-dist * (absn + scat));
        float u[4][2];
        uint32_t base_p = (uint32_t)((li * p.F + fi) * 4);
        for (int k = 0; k < 4; ++k)
          draw2(p.seed, bounce, PURPOSE_FOG, idp, base_p + k, &u[k][0],
                &u[k][1]);
        float g_scat = 0.0f, g_mf = 0.0f;
        V3 g_al = zero3();
        for (int term = 0; term < 2; ++term) {
          bool interacts = u[0][term] > p_no;
          V3 du = v3(u[1][term] * 2.0f - 1.0f, u[2][term] * 2.0f - 1.0f,
                     u[3][term] * 2.0f - 1.0f);
          V3 nl = v3(ld.x + scat * du.x, ld.y + scat * du.y,
                     ld.z + scat * du.z);
          float nd2_raw = dot3(n, nl);
          float ndotl2 = jmax(nd2_raw, 0.0f);
          V3 sel = interacts ? scale3(m.dif, diff_base) : scale3(al, ndotl2);
          fr += sel.x * mf;
          fg += sel.y * mf;
          fb += sel.z * mf;
          V3 g_sel = scale3(g_f, mf);
          g_mf += dot3(g_f, sel);
          if (interacts) {
            gm->dif = add3(gm->dif, scale3(g_sel, diff_base));
            g_db += dot3(g_sel, m.dif);
          } else {
            g_al = add3(g_al, scale3(g_sel, ndotl2));
            float g_nd2 = clamp_bwd(nd2_raw, 0.0f, dot3(g_sel, al));
            *gn = add3(*gn, scale3(nl, g_nd2));
            V3 g_nl = scale3(n, g_nd2);
            g_ld = add3(g_ld, g_nl);
            g_scat += dot3(g_nl, du);
          }
        }
        const float fg5[FOG_G] = {g_scat, g_al.x, g_al.y, g_al.z, g_mf};
        acc.dense(dl.fog + fi * FOG_G, fg5, FOG_G);
      }
      val = add3(val, v3(cr * fr * gate, cg * fg * gate, cb * fb * gate));
      lg[3] += g.x * gate * fr;
      lg[4] += g.y * gate * fg;
      lg[5] += g.z * gate * fb;
      g_gate = g.x * (cr * fr) + g.y * (cg * fg) + g.z * (cb * fb);
      g_int += g_db * ndotl;
      g_ndotl += g_db * intensity;
    } else {
      float gi = gate * intensity;
      V3 g_a = scale3(g, gi);
      V3 c3 = v3(cr, cg, cb);
      float spow = spec_pow_vjp(n, view, ld, m.power,
                                dot3(g_a, mul3(m.spec, c3)), gn, &g_view,
                                &g_ld, &gm->power);
      V3 av = v3(m.dif.x * cr * ndotl + m.spec.x * cr * spow,
                 m.dif.y * cg * ndotl + m.spec.y * cg * spow,
                 m.dif.z * cb * ndotl + m.spec.z * cb * spow);
      val = add3(val, scale3(av, gi));
      float g_gi = dot3(g, av);
      gm->dif = add3(gm->dif, scale3(mul3(g_a, c3), ndotl));
      gm->spec = add3(gm->spec, scale3(mul3(g_a, c3), spow));
      lg[3] += g_a.x * (m.dif.x * ndotl + m.spec.x * spow);
      lg[4] += g_a.y * (m.dif.y * ndotl + m.spec.y * spow);
      lg[5] += g_a.z * (m.dif.z * ndotl + m.spec.z * spow);
      g_ndotl += dot3(g_a, mul3(m.dif, c3));
      g_gate = g_gi * intensity;
      g_int = g_gi * gate;
    }
    lg[6] += g_gate * bit;
    float g_dl =
        2.0f * d_l * clamp_bwd(dl2, 1e-30f, -g_int * (intensity * intensity));
    float g_ndr = clamp_bwd(nd_raw, 0.0f, g_ndotl);
    *gn = add3(*gn, scale3(ld, g_ndr));
    g_ld = add3(g_ld, scale3(n, g_ndr));
    V3 g_lv = scale3(g_ld, inv_dl);
    g_dl += clamp_bwd(d_l, 1e-30f, -dot3(g_ld, lv) * (inv_dl * inv_dl));
    float g_d2 = d2 > 0.0f ? g_dl * 0.5f * inv_dl : 0.0f;
    g_lv = add3(g_lv, scale3(lv, 2.0f * g_d2));
    acc3(lg, g_lv);
    *gx = sub3(*gx, g_lv);
    acc.dense(dl.pl + li * LIGHT_G, lg, LIGHT_G);
  }
  for (int li = 0; p.dir_on && li < p.LD; ++li) {
    const float* r = tb.dl + li * LIGHT_W;
    float cr = r[3], cg = r[4], cb = r[5], lm = r[6];
    V3 ld = load3(r);
    float bit =
        p.use_shadows ? (float)((rec >> (10 + p.L + li)) & 1u) : 1.0f;
    float gate = lm * bit;
    float nd_raw = dot3(n, ld);
    float ndotl = jmax(nd_raw, 0.0f);
    float lg[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    V3 g_a = scale3(g, gate);
    V3 c3 = v3(cr, cg, cb);
    float g_ndr = clamp_bwd(nd_raw, 0.0f, dot3(g_a, mul3(m.dif, c3)));
    V3 g_ld = scale3(n, g_ndr);
    *gn = add3(*gn, scale3(ld, g_ndr));
    float spow = spec_pow_vjp(n, view, ld, m.power,
                              dot3(g_a, mul3(m.spec, c3)), gn, &g_view,
                              &g_ld, &gm->power);
    V3 av = v3(m.dif.x * cr * ndotl + m.spec.x * cr * spow,
               m.dif.y * cg * ndotl + m.spec.y * cg * spow,
               m.dif.z * cb * ndotl + m.spec.z * cb * spow);
    val = add3(val, scale3(av, gate));
    gm->dif = add3(gm->dif, scale3(mul3(g_a, c3), ndotl));
    gm->spec = add3(gm->spec, scale3(mul3(g_a, c3), spow));
    lg[3] += g_a.x * (m.dif.x * ndotl + m.spec.x * spow);
    lg[4] += g_a.y * (m.dif.y * ndotl + m.spec.y * spow);
    lg[5] += g_a.z * (m.dif.z * ndotl + m.spec.z * spow);
    acc3(lg, g_ld);
    lg[6] += dot3(g, av) * bit;
    acc.dense(dl.dl + li * LIGHT_G, lg, LIGHT_G);
  }
  V3 g_cv = normalize3_bwd(cv, g_view);
  dense3(acc, dl.misc + 0, g_cv);
  *gx = sub3(*gx, g_cv);
  return val;
}

// ---- Monte-Carlo continuation adjoints ----------------------------------

// Adjoint of tangent_frame(n) -> (pn, pb): gpn, gpb into gn.
FM_FN V3 tangent_frame_bwd(V3 n, V3 gpn, V3 gpb) {
  V3 pn, pb;
  tangent_frame(n, &pn, &pb);
  // pb = n x pn
  V3 gn = cross3(pn, gpb);
  gpn = add3(gpn, cross3(gpb, n));
  if (fabsf(n.x) > fabsf(n.y)) {
    float q = n.x * n.x + n.z * n.z;
    float s = sqrtf(jmax(q, 1e-30f));
    float inv_a = 1.0f / s;
    gn.z += gpn.x * inv_a;
    gn.x += -gpn.z * inv_a;
    float g_inv = gpn.x * n.z + gpn.z * -n.x;
    float g_q = clamp_bwd(q, 1e-30f, -g_inv * (inv_a * inv_a) * 0.5f * inv_a);
    gn.x += 2.0f * n.x * g_q;
    gn.z += 2.0f * n.z * g_q;
  } else {
    float q = n.y * n.y + n.z * n.z;
    float s = sqrtf(jmax(q, 1e-30f));
    float inv_b = 1.0f / s;
    gn.z += -gpn.y * inv_b;
    gn.y += gpn.z * inv_b;
    float g_inv = gpn.y * -n.z + gpn.z * n.y;
    float g_q = clamp_bwd(q, 1e-30f, -g_inv * (inv_b * inv_b) * 0.5f * inv_b);
    gn.y += 2.0f * n.y * g_q;
    gn.z += 2.0f * n.z * g_q;
  }
  return gn;
}

// Adjoint of sample_dir: gd into gn, gpn, gpb.
FM_FN void sample_dir_bwd(const Params& p, float r1, float r2, V3 n, V3 pn,
                          V3 pb, V3 gd, V3* gn, V3* gpn, V3* gpb) {
  float s_th = pos_sqrt(1.0f - r1 * r1);
  float phi = TWO_PI_F * r2;
  float sx = s_th * cosf(phi);
  float sy = r1;
  float sz = s_th * sinf(phi);
  V3 g = gd;
  if (!p.unnormalized_dirs) {
    V3 third = p.buggy_tangent ? v3(pn.x, pb.y, pb.z) : pn;
    V3 d = v3(sx * pb.x + sy * n.x + sz * third.x,
              sx * pb.y + sy * n.y + sz * third.y,
              sx * pb.z + sy * n.z + sz * third.z);
    g = normalize3_bwd(d, gd);
  }
  *gpb = add3(*gpb, scale3(g, sx));
  *gn = add3(*gn, scale3(g, sy));
  if (p.buggy_tangent) {
    gpn->x += sz * g.x;
    gpb->y += sz * g.y;
    gpb->z += sz * g.z;
  } else {
    *gpn = add3(*gpn, scale3(g, sz));
  }
}

// Adjoint of offset_origin: go into gx, gn.
FM_FN void offset_origin_bwd(const Params& p, V3 x, V3 n, V3 go, V3* gx,
                             V3* gn) {
  *gx = add3(*gx, go);
  if (!p.clean_offsets) return;
  float q = x.x * x.x + x.y * x.y + x.z * x.z;
  float xn = sqrtf(jmax(q, 0.0f));
  float sc = CLEAN_T_EPS * (1.0f + xn);
  *gn = add3(*gn, scale3(go, sc));
  float g_xn = CLEAN_T_EPS * dot3(go, n);
  float g_q = xn > 0.0f ? g_xn * 0.5f / xn : 0.0f;
  *gx = add3(*gx, scale3(x, 2.0f * g_q));
}

// The state a path carries into bounce b: the previous hit's point,
// normal, tangent frame, diffuse colour and shades flag, and the
// throughput T before bounce b's factor.
struct PathState {
  V3 x, n, pn, pb, dif, T;
  float sf;
};

struct PathStateG {
  V3 x, n, pn, pb, dif, T;
};

FM_FN PathStateG zero_stateg() {
  PathStateG g;
  g.x = g.n = g.pn = g.pb = g.dif = g.T = zero3();
  return g;
}

// One bounce forward from state s, up to its hit geometry.
struct Bounce {
  float r1, r2;
  V3 d, o, T;
  RHit h;
  Mat m;
  V3 x, n;
};

FM_FN Bounce bounce_fwd(const Params& p, const Tables& tb, const PathState& s,
                        V3 base, int b, uint32_t idp, uint32_t rec) {
  Bounce k;
  draw2(p.seed, (uint32_t)(b - 1), PURPOSE_PATH, idp, 0, &k.r1, &k.r2);
  k.d = sample_dir(p, k.r1, k.r2, s.n, s.pn, s.pb);
  k.o = offset_origin(p, s.x, s.n);
  if (b == 1) {
    k.T = scale3(base, k.r1);
  } else {
    float f = TWO_PI_F * k.r1;
    k.T = v3(s.T.x * (f * s.dif.x) * s.sf, s.T.y * (f * s.dif.y) * s.sf,
             s.T.z * (f * s.dif.z) * s.sf);
  }
  k.h = replay_hit(p, tb, rec, k.o, k.d);
  Hit hb = as_hit(k.h);
  k.m = gather_mat(p, tb, hb);
  k.x = s.x;
  k.n = s.n;
  bool last = b == p.D - 1;
  if (p.point_on || p.dir_on || !last)
    hit_geom(p, tb, k.o, k.d, hb, k.m.cen, &k.x, &k.n);
  return k;
}

// The state entering bounce b + 1 (b < D - 1).
FM_FN PathState advance(const Bounce& k) {
  PathState s;
  s.x = k.x;
  s.n = k.n;
  tangent_frame(k.n, &s.pn, &s.pb);
  s.dif = k.m.dif;
  s.sf = k.h.shades ? 1.0f : 0.0f;
  s.T = k.T;
  return s;
}

// ---- one sample, split over G lanes -------------------------------------

// The camera ray and the primary hit of a sample, replayed from its first
// record (no scans).
struct Primary {
  V3 draw, d0;  // the camera ray's unnormalized and used directions
  float u, v;   // its screen coordinates
  RHit h;
  Mat m;
  V3 x, n;
  float sf, mf;  // shades, misses
};

FM_FN Primary primary_replay(const Params& p, const Tables& tb, uint32_t id,
                             float xs, float ys, float cj, float ci,
                             uint32_t rec0) {
  const float* misc = tb.misc;
  V3 cam = load3(misc), right = load3(misc + 3), up = load3(misc + 6);
  V3 cdir = load3(misc + 9);
  Primary q;
  float jx = 0.5f, jy = 0.5f;
  if (p.grid > 0) {
    float r0, r1;
    draw2(p.seed, 0, PURPOSE_JITTER, id, 0, &r0, &r1);
    if (p.diagonal_jitter) {
      jx = jy = r0;
    } else {
      jx = (cj + r0) / (float)p.grid;
      jy = (ci + r1) / (float)p.grid;
    }
  }
  q.u = (2.0f * ((xs + jx) * p.inv_w) - 1.0f) * p.angle * p.aspect;
  q.v = (1.0f - 2.0f * ((ys + jy) * p.inv_h)) * p.angle;
  q.draw = v3(cdir.x + q.u * right.x + q.v * up.x,
              cdir.y + q.u * right.y + q.v * up.y,
              cdir.z + q.u * right.z + q.v * up.z);
  q.d0 = p.unnormalized_dirs ? q.draw : normalize3(q.draw);
  q.h = replay_hit(p, tb, rec0, cam, q.d0);
  const Hit H = as_hit(q.h);
  q.m = gather_mat(p, tb, H);
  hit_geom(p, tb, cam, q.d0, H, q.m.cen, &q.x, &q.n);
  q.sf = q.h.shades ? 1.0f : 0.0f;
  q.mf = q.h.hit ? 0.0f : 1.0f;
  return q;
}

// The adjoint of the primary state that a lane's paths and the primary
// shade add to: the hit point, normal and tangent frame, the paths' base
// throughput and the material (`m.cen` stays zero until finish_bwd).
// PRIMARY_G floats of it are summed over the group.
struct PrimaryG {
  V3 x, n, pn, pb, base;
  MatG m;
};

constexpr int PRIMARY_G = 25;

FM_FN PrimaryG zero_primaryg() {
  PrimaryG g;
  g.x = g.n = g.pn = g.pb = g.base = zero3();
  g.m = zero_matg();
  return g;
}

template <class F>
FM_FN void zip3(V3& a, const V3& b, F& f) {
  f(a.x, b.x);
  f(a.y, b.y);
  f(a.z, b.z);
}

// f(a's float, b's float) for each of the PRIMARY_G summed floats: the
// group sum adds another lane's share with it (the kernel's butterfly
// shuffles, the host build adds the other lane's copy).
template <class F>
FM_FN void zip_primaryg(PrimaryG& a, const PrimaryG& b, F f) {
  zip3(a.x, b.x, f);
  zip3(a.n, b.n, f);
  zip3(a.pn, b.pn, f);
  zip3(a.pb, b.pb, f);
  zip3(a.base, b.base, f);
  zip3(a.m.amb, b.m.amb, f);
  zip3(a.m.dif, b.m.dif, f);
  zip3(a.m.spec, b.m.spec, f);
  f(a.m.power, b.m.power);
}

// The lane of a group of G that shades the primary hit.
FM_FN int shade_lane(int G) { return G - 1; }

// Adjoint of one path's bounces 1..D-1 from the primary state s1: adds
// each bounce's record row and dense gradients through `acc`; returns the
// adjoint of s1's point, normal and tangent frame, with the adjoint of the
// base throughput in .T.
template <class A>
FM_FN PathStateG path_bwd(const Params& p, const Tables& tb,
                          const DenseLayout& dl, const PathState& s1, V3 base,
                          V3 g_ar, uint32_t idp, const int32_t* prec,
                          int stride, A& acc) {
  const bool lights = p.point_on || p.dir_on;
  const V3 amb_s = load3(tb.misc + 12), bg = load3(tb.misc + 15);
  PathStateG gs = zero_stateg();  // adjoint of the state after bounce b
  V3 g_base = zero3();
  for (int b = p.D - 1; b >= 1; --b) {
    PathState s = s1;
    for (int bb = 1; bb < b; ++bb)
      s = advance(bounce_fwd(p, tb, s, base, bb, idp,
                             (uint32_t)prec[(bb - 1) * stride]));
    const uint32_t recb = (uint32_t)prec[(b - 1) * stride];
    Bounce k = bounce_fwd(p, tb, s, base, b, idp, recb);
    const bool last = b == p.D - 1;
    Hit hb = as_hit(k.h);
    float sfb = k.h.shades ? 1.0f : 0.0f;
    float mfb = k.h.hit ? 0.0f : 1.0f;
    V3 g_c = mul3(g_ar, k.T);
    V3 g_dbv = v3(g_c.x * sfb * k.m.dif.x / PI_F,
                  g_c.y * sfb * k.m.dif.y / PI_F,
                  g_c.z * sfb * k.m.dif.z / PI_F);
    MatG g_mb = zero_matg();
    g_mb.dif = gs.dif;
    V3 g_xb = gs.x, g_nb = gs.n;
    if (!last) g_nb = add3(g_nb, tangent_frame_bwd(k.n, gs.pn, gs.pb));
    V3 dbv;
    if (lights) {
      V3 pc = fog_point(p, hb, k.x, k.m.cen);
      dbv = shade_vjp(p, tb, dl, k.x, k.n, k.m, pc, idp, (uint32_t)b, recb,
                      g_dbv, &g_xb, &g_nb, &g_mb, acc);
    } else {
      dbv = mul3(amb_s, k.m.amb);
      g_mb.amb = add3(g_mb.amb, mul3(amb_s, g_dbv));
      dense3(acc, dl.misc + 12, mul3(k.m.amb, g_dbv));
    }
    V3 cval = v3(sfb * (dbv.x / PI_F * k.m.dif.x) + mfb * bg.x,
                 sfb * (dbv.y / PI_F * k.m.dif.y) + mfb * bg.y,
                 sfb * (dbv.z / PI_F * k.m.dif.z) + mfb * bg.z);
    V3 g_T = add3(gs.T, mul3(g_ar, cval));
    g_mb.dif = add3(g_mb.dif, scale3(mul3(g_c, dbv), sfb / PI_F));
    dense3(acc, dl.misc + 15, scale3(g_c, mfb));

    float* grow = acc.row_begin();
    V3 g_o = zero3(), g_d = zero3();
    float g_t = 0.0f;
    if (lights || !last)
      hit_geom_bwd(p, tb, k.o, k.d, hb, k.m.cen, g_xb, g_nb, &g_o, &g_d,
                   &g_t, &g_mb.cen, grow);
    gather_mat_bwd(p, k.h, g_mb, grow);
    replay_t_bwd(p, tb, k.h, k.o, k.d, g_t, &g_o, &g_d, grow);
    acc.row_commit(row_kind(p, k.h), k.h.idx);

    PathStateG gp = zero_stateg();
    if (b == 1) {
      g_base = scale3(g_T, k.r1);
    } else {
      float f = TWO_PI_F * k.r1;
      V3 gu = scale3(g_T, s.sf);
      gp.T = v3(gu.x * (f * s.dif.x), gu.y * (f * s.dif.y),
                gu.z * (f * s.dif.z));
      gp.dif = scale3(mul3(gu, s.T), f);
    }
    offset_origin_bwd(p, s.x, s.n, g_o, &gp.x, &gp.n);
    sample_dir_bwd(p, k.r1, k.r2, s.n, s.pn, s.pb, g_d, &gp.n, &gp.pn,
                   &gp.pb);
    gs = gp;
  }
  gs.T = g_base;
  return gs;
}

// One lane's share of the adjoint of <radiance(sample), g> with respect to
// the five tables, for the sample's records rec[k * stride]: lane `lane` of
// G runs paths lane, lane + G, ... (all lanes run ceil(P / G) of them, those
// past P inactive) and, on shade_lane(G), the primary shade. Returns the
// lane's share of the primary state's adjoint; acc.active is as on entry.
template <class A>
FM_FN PrimaryG lane_bwd(const Params& p, const Tables& tb, uint32_t id,
                        float xs, float ys, float cj, float ci,
                        const int32_t* rec, int stride, V3 g, int lane, int G,
                        A& acc) {
  const DenseLayout dl = dense_layout(p);
  const uint32_t rec0 = (uint32_t)rec[0];
  const Primary q = primary_replay(p, tb, id, xs, ys, cj, ci, rec0);
  PrimaryG pg = zero_primaryg();
  if (lane == shade_lane(G)) {
    dense3(acc, dl.misc + 15, scale3(g, q.mf));
    V3 g_sh0 = scale3(g, q.sf);  // cotangent of the primary shade
    if (p.mc)
      g_sh0 = v3(g.x * q.sf * q.m.dif.x / PI_F, g.y * q.sf * q.m.dif.y / PI_F,
                 g.z * q.sf * q.m.dif.z / PI_F);
    V3 d0v = shade_vjp(p, tb, dl, q.x, q.n, q.m,
                       fog_point(p, as_hit(q.h), q.x, q.m.cen), id, 0, rec0,
                       g_sh0, &pg.x, &pg.n, &pg.m, acc);
    if (p.mc) pg.m.dif = add3(pg.m.dif, scale3(mul3(g, d0v), q.sf / PI_F));
  }
  if (!(p.mc && p.D > 1)) return pg;
  PathState s1;
  s1.x = q.x;
  s1.n = q.n;
  tangent_frame(q.n, &s1.pn, &s1.pb);
  s1.dif = q.m.dif;
  s1.sf = q.sf;
  const V3 base = v3(TWO_PI_F * q.m.dif.x * q.sf, TWO_PI_F * q.m.dif.y * q.sf,
                     TWO_PI_F * q.m.dif.z * q.sf);
  s1.T = base;
  const V3 g_ar = scale3(g, p.inv_p);
  const bool owner = acc.active;
  for (int k = 0; k < (p.P + G - 1) / G; ++k) {
    const int path = k * G + lane;
    const bool real = path < p.P;
    acc.active = owner && real;
    const int pi = real ? path : 0;
    const PathStateG gs = path_bwd(
        p, tb, dl, s1, base, g_ar, id * (uint32_t)p.P + (uint32_t)pi,
        rec + (1 + pi * (p.D - 1)) * stride, stride, acc);
    if (real) {
      pg.x = add3(pg.x, gs.x);
      pg.n = add3(pg.n, gs.n);
      pg.pn = add3(pg.pn, gs.pn);
      pg.pb = add3(pg.pb, gs.pb);
      pg.base = add3(pg.base, gs.T);
    }
  }
  acc.active = owner;
  return pg;
}

// The group's last step, on every lane with the group's summed PrimaryG
// (acc active on lane 0 only): the tangent frame's and base throughput's
// adjoints, the primary hit's row, and the camera row.
template <class A>
FM_FN void finish_bwd(const Params& p, const Tables& tb, uint32_t id,
                      float xs, float ys, float cj, float ci, uint32_t rec0,
                      PrimaryG pg, A& acc) {
  const DenseLayout dl = dense_layout(p);
  const Primary q = primary_replay(p, tb, id, xs, ys, cj, ci, rec0);
  if (p.mc && p.D > 1) {
    pg.n = add3(pg.n, tangent_frame_bwd(q.n, pg.pn, pg.pb));
    pg.m.dif = add3(pg.m.dif, scale3(pg.base, TWO_PI_F * q.sf));
  }
  const V3 cam = load3(tb.misc);
  float* grow = acc.row_begin();
  V3 g_o = zero3(), g_d = zero3();
  float g_t = 0.0f;
  hit_geom_bwd(p, tb, cam, q.d0, as_hit(q.h), q.m.cen, pg.x, pg.n, &g_o,
               &g_d, &g_t, &pg.m.cen, grow);
  gather_mat_bwd(p, q.h, pg.m, grow);
  replay_t_bwd(p, tb, q.h, cam, q.d0, g_t, &g_o, &g_d, grow);
  acc.row_commit(row_kind(p, q.h), q.h.idx);

  // camera row: origin, right, up, direction
  V3 g_draw = p.unnormalized_dirs ? g_d : normalize3_bwd(q.draw, g_d);
  dense3(acc, dl.misc + 0, g_o);
  dense3(acc, dl.misc + 3, scale3(g_draw, q.u));
  dense3(acc, dl.misc + 6, scale3(g_draw, q.v));
  dense3(acc, dl.misc + 9, g_draw);
}

// The key a committed row is grouped by: equal for the same table row,
// 0 for none.
FM_FN int row_key(int kind, int idx) {
  return kind == 0 ? 0 : (kind << 16) | idx;
}

// Where a row key's values go in the primitive tables (sph | tri, the first
// GradLayout.misc entries of the flat gradient), and how many.
FM_FN int row_offset(const GradLayout& lay, int key, int* width) {
  const int kind = key >> 16, idx = key & 0xFFFF;
  *width = kind == 1 ? SPH_W : TRI_W;
  return kind == 1 ? lay.sph + idx * SPH_W : lay.tri + idx * TRI_W;
}

}  // namespace fm
