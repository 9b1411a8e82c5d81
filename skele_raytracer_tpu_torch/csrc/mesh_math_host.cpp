// Host build of the mesh kernels' per-ray math (mesh_math.cuh), for the
// CPU tests: g++ -O2 -ffp-contract=off -shared -fPIC. Each function runs
// the header's functions the CUDA kernels run, over every triangle record
// (no culling: the culled kernels' answer does not depend on it), one ray
// after another, so indexing faults or float promotions that change
// rounding in the header show on a machine with no GPU.

#include "mesh_math.cuh"

// K3's math as the kernel splits it: rec [C, cs, 20] cluster by cluster,
// each cluster's records split over G lanes (1 <= G <= 32, a power of two;
// mm::lane_nearest), the lanes merged after each cluster
// (mm::merge_lanes). G = 1 is the serial scan.
extern "C" void culled_nearest_host(int n, int C, int cs, int G, int clip,
                                    float sign, float t_clip,
                                    const float* feats, const float* live,
                                    const float* rec, float* out_t,
                                    int32_t* out_i) {
  for (int r = 0; r < n; ++r) {
    float t[32];
    int32_t i[32];
    for (int g = 0; g < G; ++g) {
      t[g] = mm::BIG;
      i[g] = mm::BIG_I;
    }
    if (live == nullptr || live[r] != 0.0f) {
      const float* f = feats + (size_t)r * mm::FEAT;
      for (int c = 0; c < C; ++c) {
        for (int g = 0; g < G; ++g)
          mm::lane_nearest<false>(f, rec + (size_t)c * cs * mm::REC, cs, g, G,
                                  sign, clip, t_clip, t[g], i[g]);
        mm::merge_lanes(G, t, i);
      }
    }
    out_t[r] = t[0];
    out_i[r] = i[0];
  }
}

// K4's math as the kernel splits it: is any record of rec [C, cs, 20] hit
// inside (t_clip, bound[r])? Cluster by cluster, each cluster's records
// split over G lanes (1 <= G <= 32; mm::lane_occludes, each lane stopping
// at its first occluder), the lanes' bits ORed after each cluster (the
// kernel's group_any), stopping after the first cluster that holds an
// occluder. G = 1 is the serial scan.
extern "C" void culled_occluded_host(int n, int C, int cs, int G, float sign,
                                     float t_clip, const float* feats,
                                     const float* bound, const float* live,
                                     const float* rec, float* out_occ) {
  for (int r = 0; r < n; ++r) {
    bool occ = false;
    if (live == nullptr || live[r] != 0.0f) {
      const float* f = feats + (size_t)r * mm::FEAT;
      for (int c = 0; c < C && !occ; ++c) {
        bool any = false;
        for (int g = 0; g < G; ++g)
          any = mm::lane_occludes(f, rec + (size_t)c * cs * mm::REC, cs, g, G,
                                  sign, t_clip, bound[r]) || any;
        occ = any;
      }
    }
    out_occ[r] = occ ? 1.0f : 0.0f;
  }
}

// K5's math: first minimum over records, then u, v at the winner.
extern "C" void triangle_nearest_host(int n, int T, int clip, float sign,
                                      float t_clip, const float* feats,
                                      const float* rec, float* out_t,
                                      int32_t* out_i, float* out_u,
                                      float* out_v) {
  for (int r = 0; r < n; ++r) {
    float f[mm::FEAT];
    for (int k = 0; k < 9; ++k) f[k] = feats[(size_t)r * 9 + k];
    f[9] = 1.0f;
    float t_best = mm::BIG, u, v;
    int32_t i_best = 0;
    for (int j = 0; j < T; ++j) {
      const float t = mm::brute_t(mm::planes(f, rec + (size_t)j * mm::REC, sign),
                                  clip, t_clip, u, v);
      if (t < t_best) {
        t_best = t;
        i_best = j;
      }
    }
    mm::brute_t(mm::planes(f, rec + (size_t)i_best * mm::REC, sign), clip,
                t_clip, u, v);
    out_t[r] = t_best;
    out_i[r] = i_best;
    out_u[r] = u;
    out_v[r] = v;
  }
}
