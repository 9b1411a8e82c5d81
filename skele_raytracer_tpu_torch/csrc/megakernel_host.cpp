// Host build of the fused kernel K7's per-ray math (fused_math.cuh, with
// mesh_math.cuh and sphere_math.cuh), for the CPU tests: g++ -O2
// -ffp-contract=off -shared -fPIC. It scans every triangle record and
// every sphere brute force (the kernel's answers do not depend on its
// culling) around the header functions the kernel runs, one ray after
// another, so that faults in the header show on a machine with no GPU.

#include "fused_math.cuh"

// K7's contract (megakernel.cu `fused_shade`) over all records rec [C, cs,
// 20], split over G lanes per ray as the kernel splits them (1 <= G <= 32,
// a power of two): the nearest hit with mm::lane_nearest and the lanes
// merged after each cluster (mm::merge_lanes), and each shadow ray's
// clusters with fm::lane_blocks, the lanes' bits ORed, up to the first
// cluster with a blocker. G = 1 is the serial scan. T triangles in the
// shade table, S sphere rows, L lights of which the first Lp are point
// lights.
extern "C" void fused_shade_host(int n, int C, int cs, int G, int T, int S,
                                 int Lp, int L, int use_shadows,
                                 const float* feats, const float* live,
                                 const float* rec, const float* shade,
                                 const float* sph, const float* lights,
                                 const float* cnst, float* out_direct,
                                 float* out_t, int32_t* out_kind,
                                 int32_t* out_index, float* out_unsh) {
  for (int r = 0; r < n; ++r) {
    float* unsh = out_unsh + (size_t)r * L;
    if (live != nullptr && live[r] == 0.0f) {
      for (int k = 0; k < 3; ++k) out_direct[(size_t)r * 3 + k] = 0.0f;
      out_t[r] = mm::BIG;
      out_kind[r] = 0;
      out_index[r] = 0;
      for (int l = 0; l < L; ++l) unsh[l] = 1.0f;
      continue;
    }
    const float* f = feats + (size_t)r * mm::FEAT;
    float t_lane[32];
    int32_t i_lane[32];
    for (int g = 0; g < G; ++g) {
      t_lane[g] = mm::BIG;
      i_lane[g] = mm::BIG_I;
    }
    for (int c = 0; c < C; ++c) {
      for (int g = 0; g < G; ++g)
        mm::lane_nearest<true>(f, rec + (size_t)c * cs * mm::REC, cs, g, G,
                               -1.0f, true, fm::T_EPS, t_lane[g], i_lane[g]);
      mm::merge_lanes(G, t_lane, i_lane);
    }
    const float t_tri = t_lane[0];
    const int32_t i_tri = i_lane[0] < T - 1 ? i_lane[0] : T - 1;
    const float* o = f + 6;
    int32_t i_sph;
    const float t_sph =
        sm::nearest(sm::ray(o, f), sph, S, fm::SROW, fm::T_EPS, i_sph);
    fm::Surface s = fm::surface(o, f, t_tri, i_tri, t_sph, i_sph,
                                sph + (size_t)i_sph * fm::SROW,
                                shade + (size_t)i_tri * fm::TROW, cnst);
    for (int l = 0; l < L; ++l) {
      const float* lr = lights + (size_t)l * fm::LROW;
      const bool point = l < Lp;
      float ldir[3], bound, falloff;
      fm::light_dir(s, lr, point, ldir, bound, falloff);
      float un = 1.0f;
      if (use_shadows) {
        bool occ = sm::any_below(sm::ray(s.sh, ldir), sph, S, fm::SROW,
                                 fm::T_EPS, bound);
        if (!occ && s.kind > 0 && lr[6] > 0.0f) {
          float fs[mm::FEAT];
          fm::shadow_features(s, ldir, fs);
          for (int c = 0; c < C && !occ; ++c)
            for (int g = 0; g < G; ++g)
              occ = fm::lane_blocks(fs, rec + (size_t)c * cs * mm::REC, cs,
                                    g, G, bound) || occ;
        }
        un = occ ? 0.0f : 1.0f;
      }
      unsh[l] = un;
      fm::add_light(s, ldir, lr, point, un, falloff);
    }
    for (int k = 0; k < 3; ++k) out_direct[(size_t)r * 3 + k] = s.direct[k];
    out_t[r] = s.t;
    out_kind[r] = s.kind;
    out_index[r] = s.index;
  }
}
