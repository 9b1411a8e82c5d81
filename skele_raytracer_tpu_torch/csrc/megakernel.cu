// Fused intersect + shadow + Blinn-Phong kernel for Hopper (sm_90a): K7.
//
// Replaces: the JAX package's Pallas TPU kernel
//   skele_raytracer_tpu/ops/pallas/megakernel.py::_megakernel
//   (launched by _fused_from_feats; entry fused_shade, a custom_vjp).
//
// Per ray, in one launch: the nearest triangle over the clustered mesh
// (the clean Moller-Trumbore t of mesh_math.cuh `brute_t`, the
// lexicographic minimum of (t, original index) over hits), the nearest
// sphere (sphere_math.cuh), the hit data, and for each light the shadow
// test (spheres, then triangles) and the clean Blinn-Phong term
// (fused_math.cuh). Outputs: direct [n, 3], t [n] (BIG on a miss), kind and
// index [n] int32, and the unshadowed bit of each light [n, L]. Dead rays
// (live == 0) get the defaults: direct 0, t BIG, kind 0, index 0, unsh 1.
//
// What bounds it: the FP32 throughput and latency of the (ray, triangle)
// tests -- the primary pass over the shortlisted clusters and one shadow
// pass per light (4 dot products, a reciprocal and ~8 compares per pair,
// dependent and unfused) -- and how many warps are in flight to hide that
// latency. Device memory is small: 40 B in, ~24 B plus 4 B per light out
// per ray, and the records (L2-resident: dragon's are 0.8 MB).
//
// Design (cluster_walk.cuh). The first port ran one thread per ray in
// 256-ray tiles: dragon's 4,096-ray primary wave filled 16 blocks of 132
// SMs, the tile walked the union of 256 rays' shortlists, each cluster was
// copied with plain loads between two barriers, and each light swept all
// C boxes in index order with two barriers per box. Now:
// * G lanes per ray (32 for waves of up to 16,384 rays, 16 above), 256
//   threads = 256 / G rays per block; the sphere and light tables and the
//   box table sit in shared memory.
// * Primary hit: the block's front-to-back shortlist over the widened
//   `kernel_boxes` (the lanes split the slab tests), the records through
//   the two-stage cp.async.bulk ring, each lane every G-th record of a
//   cluster (brute_t), the group's (t, index) merged by shuffles after
//   each cluster, and the block stops once the next entry lies past every
//   ray's best t. The TPU took the shortlist from host-side [R, C] tables
//   and an argsort, and culled with the unwidened boxes; with the widened
//   ones the answer is the brute-force minimum whatever the tiling.
// * Triangle shading data: the TPU streamed 14 shade planes beside every
//   cluster and picked the winner's with a one-hot product on each
//   iteration. Here only the records are staged; after the walk each lane
//   reads its winner's 14 floats from the [T, 14] table by original index.
//   The per-ray epilogue (sphere scan, fm::surface, add_light) runs in
//   every lane of the group, which gives the same bits in each.
// * Shadows (shadow origins exist only after the hit): per unmasked light,
//   the block builds the shortlist of the clusters that some hit,
//   unoccluded shadow ray of the tile enters before its bound, front to
//   back, and only those are staged, through the same ring. Each lane tests
//   every G-th record (stopping at its first blocker), the group ORs its
//   bits; a ray stops at its first occluder, and the block stops when no
//   ray is left unoccluded with a bound past the next entry. Spheres
//   occlude every ray, hit or not, as on the TPU.
// * One mode: the TPU's VMEM-resident and DMA-streaming variants become
//   records read from L2 through the ring.
// * No tensor cores: a TF32 or 3xTF32 wgmma for the numerators is not
//   bitwise equal to FP32, and the division, compares and minimum after the
//   product stay on the FP32 cores anyway (culled.cu's note).
//
// Built with -fmad=false so every operation rounds as in the plain version.

#include <cuda_runtime.h>

#include "cluster_walk.cuh"
#include "fused_math.cuh"

namespace {

struct FusedArgs {
  int n;   // rays
  int C;   // clusters
  int cs;  // triangles per cluster
  int T;   // triangles in the shade table
  int S;   // sphere rows
  int Lp;  // point lights (the first Lp light rows)
  int L;   // lights
};

// floats of K7's own tables in shared memory: spheres, lights, cnst
__host__ __device__ inline int extra_floats(const FusedArgs& a) {
  return a.S * fm::SROW + a.L * fm::LROW + 6;
}

template <int G, bool SHADOWS, bool COUNT>
__global__ void __launch_bounds__(cw::kThreads)
    fused_kernel(FusedArgs a, const float* __restrict__ feats,
                 const float* __restrict__ live,
                 const float* __restrict__ rec, const float* __restrict__ lo,
                 const float* __restrict__ hi, const float* __restrict__ root,
                 const float* __restrict__ shade,
                 const float* __restrict__ sph,
                 const float* __restrict__ lights,
                 const float* __restrict__ cnst,
                 float* __restrict__ out_direct, float* __restrict__ out_t,
                 int32_t* __restrict__ out_kind,
                 int32_t* __restrict__ out_index,
                 float* __restrict__ out_unsh,
                 unsigned long long* __restrict__ ctr) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t s_bar[2];
  __shared__ int s_n;
  __shared__ unsigned s_pairs;  // the block's shadow-walk pairs (COUNT)
  const int tid = threadIdx.x;
  if (COUNT && tid == 0) s_pairs = 0u;
  const cw::Shared sh = cw::carve(smem4, a.C, a.cs, extra_floats(a));
  float* s_sph = sh.extra;                // [S * SROW]
  float* s_lig = s_sph + a.S * fm::SROW;  // [L * LROW]
  float* s_cn = s_lig + a.L * fm::LROW;   // [6]
  cw::Ring ring{sh.ring, s_bar, a.cs * mm::REC};
  ring.init();
  cw::load_boxes(sh, lo, hi, a.C);
  for (int k = tid; k < a.S * fm::SROW; k += cw::kThreads) s_sph[k] = sph[k];
  for (int k = tid; k < a.L * fm::LROW; k += cw::kThreads)
    s_lig[k] = lights[k];
  if (tid < 6) s_cn[tid] = cnst[tid];

  const int lane = tid % G;
  const int r = blockIdx.x * (cw::kThreads / G) + tid / G;
  const bool alive = r < a.n && (live == nullptr || live[r] != 0.0f);
  float f[mm::FEAT];
  for (int k = 0; k < mm::FEAT; ++k)
    f[k] = alive ? feats[(size_t)r * mm::FEAT + k] : 0.0f;
  const float* d = f;
  const float* o = f + 6;
  const float inv_d[3] = {mm::inv_dir(f[0]), mm::inv_dir(f[1]),
                          mm::inv_dir(f[2])};

  // ---- nearest triangle: the tile's shortlist, clusters front to back ---
  const int n_list = cw::shortlist<G>(sh, a.C, alive, [&](int c, float& tmin) {
    float tmax;
    return mm::slab(o, inv_d, sh.lo + 3 * c, sh.hi + 3 * c, tmin, tmax) &&
           (tmax > 0.0f);
  }, &s_n);
  if (COUNT) cw::count_walk<G>(ctr, r < a.n, alive, n_list);
  float texit;
  {
    float tmin;
    mm::slab(o, inv_d, root, root + 3, tmin, texit);
  }
  float t_tri = mm::BIG;
  int32_t i_tri = mm::BIG_I;
  cw::walk(ring, rec, sh.list, n_list, [&](int p, const float* recs) {
    if (alive) {
      const int c = sh.list[p];
      float tmin, tmax;
      const bool enter = mm::slab(o, inv_d, sh.lo + 3 * c, sh.hi + 3 * c,
                                  tmin, tmax) && (tmax > fm::T_EPS) &&
                         (tmin <= t_tri);
      if (enter)
        mm::lane_nearest<true>(f, recs, a.cs, lane, G, -1.0f, true,
                               fm::T_EPS, t_tri, i_tri);
    }
    cw::group_nearest<G>(t_tri, i_tri);
    return alive && fminf(t_tri, texit) >= sh.ent[p + 1];
  });

  // ---- nearest sphere and the hit data (every lane) ----------------------
  fm::Surface s{};
  if (alive) {
    i_tri = i_tri < a.T - 1 ? i_tri : a.T - 1;
    int32_t i_sph;
    const float t_sph =
        sm::nearest(sm::ray(o, d), s_sph, a.S, fm::SROW, fm::T_EPS, i_sph);
    s = fm::surface(o, d, t_tri, i_tri, t_sph, i_sph,
                    s_sph + i_sph * fm::SROW,
                    shade + (size_t)i_tri * fm::TROW, s_cn);
  }
  const bool hit = alive && s.kind > 0;
  const bool out = r < a.n && lane == 0;

  // ---- lights: shadow test, then the Blinn-Phong term -------------------
  unsigned shadow_pairs = 0;  // the ray's, m per shadow walk it takes
  for (int l = 0; l < a.L; ++l) {
    const float* lr = s_lig + l * fm::LROW;
    const bool point = l < a.Lp;
    float ldir[3] = {0.0f, 0.0f, 0.0f}, bound = mm::BIG, falloff = 1.0f;
    if (alive) fm::light_dir(s, lr, point, ldir, bound, falloff);
    bool occ = false;
    if (SHADOWS) {
      if (alive)
        occ = sm::any_below(sm::ray(s.sh, ldir), s_sph, a.S, fm::SROW,
                            fm::T_EPS, bound);
      if (lr[6] > 0.0f) {  // the same for every thread of the block
        float fs[mm::FEAT], inv_s[3];
        fm::shadow_features(s, ldir, fs);
        for (int k = 0; k < 3; ++k) inv_s[k] = mm::inv_dir(ldir[k]);
        auto enters = [&](int c, float& tmin) {
          float tmax;
          return mm::slab(s.sh, inv_s, sh.lo + 3 * c, sh.hi + 3 * c, tmin,
                          tmax) && (tmax > fm::T_EPS) && (tmin < bound);
        };
        const int m = cw::shortlist<G>(sh, a.C, hit && !occ, enters, &s_n);
        if (COUNT && lane == 0 && hit && !occ) shadow_pairs += m;
        cw::walk(ring, rec, sh.list, m, [&](int p, const float* recs) {
          float tmin;
          if (hit && !occ && enters(sh.list[p], tmin))
            occ = fm::lane_blocks(fs, recs, a.cs, lane, G, bound);
          occ = cw::group_any<G>(occ);
          // a later cluster's entry is at least ent[p + 1]: past the
          // bound, the ray enters none of them
          return hit && !occ && bound > sh.ent[p + 1];
        });
      }
    }
    const float unsh = occ ? 0.0f : 1.0f;
    if (alive) fm::add_light(s, ldir, lr, point, unsh, falloff);
    if (out) out_unsh[(size_t)r * a.L + l] = alive ? unsh : 1.0f;
  }

  // the device counters' shadow walks: each ray's pairs (m per walk it
  // takes) summed into the block's in shared memory, which thread 0 adds
  if (COUNT) {
    if (shadow_pairs != 0u) atomicAdd(&s_pairs, shadow_pairs);
    __syncthreads();
    if (tid == 0 && s_pairs != 0u)
      atomicAdd(ctr + 2, (unsigned long long)s_pairs);
  }
  if (out) {
    for (int k = 0; k < 3; ++k)
      out_direct[(size_t)r * 3 + k] = alive ? s.direct[k] : 0.0f;
    out_t[r] = alive ? s.t : mm::BIG;
    out_kind[r] = alive ? s.kind : 0;
    out_index[r] = alive ? s.index : 0;
  }
}

// The counting instance (COUNT) runs only when the device counters' row
// is given: K7 testing the row for null itself ran 3.2% slower with the
// counters off (dragon's bounce wave, CUDA events), and the instance
// without them is the earlier K7's SASS, instruction for instruction.
template <int G, bool SHADOWS>
int launch(const FusedArgs& a, const float* feats, const float* live,
           const float* rec, const float* lo, const float* hi,
           const float* root, const float* shade, const float* sph,
           const float* lights, const float* cnst, float* out_direct,
           float* out_t, int32_t* out_kind, int32_t* out_index,
           float* out_unsh, void* stream, unsigned long long* ctr) {
  const auto kernel = ctr != nullptr ? fused_kernel<G, SHADOWS, true>
                                     : fused_kernel<G, SHADOWS, false>;
  const size_t smem = cw::smem_bytes(a.C, a.cs, extra_floats(a));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  constexpr int rays = cw::kThreads / G;
  kernel<<<(a.n + rays - 1) / rays, cw::kThreads, smem,
           (cudaStream_t)stream>>>(
      a, feats, live, rec, lo, hi, root, shade, sph, lights, cnst,
      out_direct, out_t, out_kind, out_index, out_unsh, ctr);
  return (int)cudaGetLastError();
}

template <int G>
int launch_g(const FusedArgs& a, int use_shadows, const float* feats,
             const float* live, const float* rec, const float* lo,
             const float* hi, const float* root, const float* shade,
             const float* sph, const float* lights, const float* cnst,
             float* out_direct, float* out_t, int32_t* out_kind,
             int32_t* out_index, float* out_unsh, void* stream,
             unsigned long long* ctr) {
  if (use_shadows)
    return launch<G, true>(a, feats, live, rec, lo, hi, root, shade, sph,
                           lights, cnst, out_direct, out_t, out_kind,
                           out_index, out_unsh, stream, ctr);
  return launch<G, false>(a, feats, live, rec, lo, hi, root, shade, sph,
                          lights, cnst, out_direct, out_t, out_kind,
                          out_index, out_unsh, stream, ctr);
}

}  // namespace

// K7 with G lanes per ray (8, 16 or 32; anything else returns
// cudaErrorInvalidValue): feats [n, 10] (d, o x d, o, 1), live [n]
// (nullptr = all live), rec [C, cs, 20] (the coarse clustering's
// records), lo/hi [C, 3] (widened cull boxes), root [6], shade [T, 14],
// sph [S, 16], lights [L, 7] (the first Lp point lights), cnst [6]
// (fused_math.cuh layouts). Writes direct [n, 3], t [n], kind [n], index
// [n] and unsh [n, L]. Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError(). `counters`, last (after the
// stream, where a launcher of an earlier tree ignores it): K7's row of the
// device counters, or nullptr: the primary walk's rays, live rays and
// pairs (cluster_walk.cuh count_walk), and each shadow walk's pairs.
extern "C" int fused_shade_lanes(int G, int n, int C, int cs, int T, int S,
                                 int Lp, int L, int use_shadows,
                                 const float* feats, const float* live,
                                 const float* rec, const float* lo,
                                 const float* hi, const float* root,
                                 const float* shade, const float* sph,
                                 const float* lights, const float* cnst,
                                 float* out_direct, float* out_t,
                                 int32_t* out_kind, int32_t* out_index,
                                 float* out_unsh, void* stream,
                                 unsigned long long* counters) {
  if (n <= 0) return (int)cudaGetLastError();
  const FusedArgs a{n, C, cs, T, S, Lp, L};
#define K7_LAUNCH(g)                                                        \
  case g:                                                                   \
    return launch_g<g>(a, use_shadows, feats, live, rec, lo, hi, root,      \
                       shade, sph, lights, cnst, out_direct, out_t,         \
                       out_kind, out_index, out_unsh, stream, counters);
  switch (G) {
    K7_LAUNCH(8)
    K7_LAUNCH(16)
    K7_LAUNCH(32)
  }
#undef K7_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K7 with the lanes per ray cw::lanes_for(n) picks.
extern "C" int fused_shade(int n, int C, int cs, int T, int S, int Lp, int L,
                           int use_shadows, const float* feats,
                           const float* live, const float* rec,
                           const float* lo, const float* hi,
                           const float* root, const float* shade,
                           const float* sph, const float* lights,
                           const float* cnst, float* out_direct,
                           float* out_t, int32_t* out_kind,
                           int32_t* out_index, float* out_unsh,
                           void* stream, unsigned long long* counters) {
  return fused_shade_lanes(cw::lanes_for(n), n, C, cs, T, S, Lp, L,
                           use_shadows, feats, live, rec, lo, hi, root, shade,
                           sph, lights, cnst, out_direct, out_t, out_kind,
                           out_index, out_unsh, stream, counters);
}
