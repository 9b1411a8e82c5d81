// Cluster-culled triangle kernels for Hopper (sm_90a): nearest hit (K3) and
// any hit for shadow rays (K4).
//
// Replaces: the JAX package's Pallas TPU kernels
//   skele_raytracer_tpu/ops/pallas/culled.py::_culled_kernel/_culled_tile
//   (launched by _culled_from_feats) and ::_occluded_kernel/_occ_tile
//   (launched by _occluded_from_fb).
//
// Both answer for rays over the Morton clusters of ops/accel.py: each
// block builds its own front-to-back cluster shortlist in shared memory
// (the TPU took it from host-side [R, C] tables and an argsort), walks it
// and stops when the next entry lies past every live ray's settle bound
// (its best t, or its exit from the root box; for K4, the light distance,
// and rays already occluded drop out). Dead rays (live == 0) return a miss.
// Results do not depend on tiling, order, clustering or `live`: the boxes
// the wrapper passes are widened by a small margin, so every cull and
// every early exit is conservative against the rounding of the
// Moller-Trumbore t; K3's answer is the lexicographic minimum of (t,
// original index) over all hit triangles, which the plain version computes
// brute force.
//
// What bounds them: the FP32 throughput of the per-(ray, triangle) test (4
// dot products, a division and ~10 compares per pair, operands from shared
// memory) times the pairs the walk visits, and the latency of those
// dependent, unfused chains. Device memory is small: 44 B in and 8 B out
// per ray, and each block reads only its shortlisted clusters' records
// (L2-resident: dragon's are 0.8 MB).
//
// K3, `nearest_kernel<G, COUNT>` (cluster_walk.cuh; COUNT: the instance
// that feeds the device counters). The first port ran one thread
// per ray in 256-ray tiles: dragon's 4,096-ray primary wave filled 16
// blocks of 132 SMs, a warp ran a cluster's whole loop when one of its rays
// entered the box, the tile walked the union of 256 rays' shortlists, and
// each cluster was copied with plain loads between two barriers. Now:
// * G lanes per ray (G = 32 for waves of up to 16,384 rays, 16 above;
//   cw::lanes_for), 256 threads = 256 / G rays per block: the primary wave
//   fills 512 blocks, and a tile's shortlist is the union of 8-16 rays'.
//   Each lane tests every G-th record of a cluster; the group merges its
//   lanes' (t, index) with shuffles after each cluster, so the per-ray cull
//   (entry <= best t) and the settle-bound exit stay exact, and the
//   lexicographic minimum is the serial scan's to the bit.
// * The records go through a two-stage ring in shared memory, filled by
//   cp.async.bulk on an mbarrier: cluster p + 1 loads while p is tested.
// * The box table is read into shared memory once per block.
//
// No tensor cores. The TPU kernel cast the four numerators as a [rays, 10]
// x [10, cs] product for its matrix unit. On Hopper a TF32 or 3xTF32 wgmma
// is not bitwise equal to FP32, parity's K3 output is byte-compared with
// the reference goldens, and the division, the compares and the minimum
// after the product (about a third of each pair's work) stay on the FP32
// cores anyway.
//
// K4, `occluded_kernel<G, COUNT>`, on the same walk. The first port ran one
// thread per ray in 256-ray tiles with synchronous staging: a shadow wave
// is mostly dead rays (84% of dragon's bounce shadow wave; the wrapper
// sorts them last), so about 41 of its 256 blocks held a live ray, and a
// live thread tested a cluster's 128 triangles one after another. Now:
// * G lanes per ray, 256 / G rays per block (32, kOccludedLanes; 8 and
//   16 only in the lane-sweep build, CULLED_LANE_SWEEP);
//   each lane tests every G-th record of an entered cluster and stops at
//   its first occluder (mm::lane_occludes), and the group ORs its lanes'
//   bits after each cluster (cw::group_any), so every lane holds the ray's
//   answer before the block votes on the early exit.
// * The block's shortlist holds the clusters a live ray enters before its
//   bound; the block stops once no live, unoccluded ray's min(root exit,
//   bound) reaches the next entry. Occluded rays drop out.
// * A block whose rays are all dead writes misses and returns before it
//   arms the ring or reads the box table.
//
// Built with -fmad=false so every operation rounds as in the plain version.

#include <cuda_runtime.h>

#include "cluster_walk.cuh"
#include "mesh_math.cuh"

namespace {

struct CullArgs {
  int n;             // rays
  int C;             // clusters
  int cs;            // triangles per cluster
  int allow_negative;  // parity: boxes behind the origin count
  int clip;          // clean: reject t <= t_clip (K3)
  float sign;        // +1 parity (mirrored u), -1 clean
  float t_clip;      // near clip (K3 when clip; K4 always)
};

template <int G, bool COUNT>
__global__ void __launch_bounds__(cw::kThreads)
    nearest_kernel(CullArgs a, const float* __restrict__ feats,
                   const float* __restrict__ live,
                   const float* __restrict__ rec, const float* __restrict__ lo,
                   const float* __restrict__ hi,
                   const float* __restrict__ root, float* __restrict__ out_t,
                   int32_t* __restrict__ out_i,
                   unsigned long long* __restrict__ ctr) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t s_bar[2];
  __shared__ int s_n;
  const cw::Shared sh = cw::carve(smem4, a.C, a.cs, 0);
  cw::Ring ring{sh.ring, s_bar, a.cs * mm::REC};
  ring.init();
  cw::load_boxes(sh, lo, hi, a.C);

  const int lane = threadIdx.x % G;
  const int r = blockIdx.x * (cw::kThreads / G) + threadIdx.x / G;
  const bool alive = r < a.n && (live == nullptr || live[r] != 0.0f);
  float f[mm::FEAT];
  for (int k = 0; k < mm::FEAT; ++k)
    f[k] = alive ? feats[(size_t)r * mm::FEAT + k] : 0.0f;
  const float o[3] = {f[6], f[7], f[8]};
  const float inv_d[3] = {mm::inv_dir(f[0]), mm::inv_dir(f[1]),
                          mm::inv_dir(f[2])};

  const int n = cw::shortlist<G>(sh, a.C, alive, [&](int c, float& tmin) {
    float tmax;
    const bool e = mm::slab(o, inv_d, sh.lo + 3 * c, sh.hi + 3 * c, tmin,
                            tmax);
    return a.allow_negative ? e : (e && tmax > 0.0f);
  }, &s_n);
  if (COUNT) cw::count_walk<G>(ctr, r < a.n, alive, n);

  // settle bound: no hit lies past the ray's exit from the root box
  float texit;
  {
    float tmin;
    mm::slab(o, inv_d, root, root + 3, tmin, texit);
  }

  float t_best = mm::BIG;
  int32_t i_best = mm::BIG_I;
  cw::walk(ring, rec, sh.list, n, [&](int p, const float* recs) {
    if (alive) {
      const int c = sh.list[p];
      float tmin, tmax;
      bool enter = mm::slab(o, inv_d, sh.lo + 3 * c, sh.hi + 3 * c, tmin,
                            tmax);
      if (!a.allow_negative)
        enter = enter && (tmax > (a.clip ? a.t_clip : 0.0f));
      if (enter && tmin <= t_best)
        mm::lane_nearest<false>(f, recs, a.cs, lane, G, a.sign, a.clip,
                                a.t_clip, t_best, i_best);
    }
    cw::group_nearest<G>(t_best, i_best);
    return alive && fminf(t_best, texit) >= sh.ent[p + 1];
  });

  if (r < a.n && lane == 0) {
    out_t[r] = t_best;
    out_i[r] = i_best;
  }
}

template <int G, bool COUNT>
__global__ void __launch_bounds__(cw::kThreads)
    occluded_kernel(CullArgs a, const float* __restrict__ feats,
                    const float* __restrict__ bound,
                    const float* __restrict__ live,
                    const float* __restrict__ rec,
                    const float* __restrict__ lo,
                    const float* __restrict__ hi,
                    const float* __restrict__ root,
                    float* __restrict__ out_occ,
                    unsigned long long* __restrict__ ctr) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t s_bar[2];
  __shared__ int s_n;
  const int lane = threadIdx.x % G;
  const int r = blockIdx.x * (cw::kThreads / G) + threadIdx.x / G;
  const bool alive = r < a.n && (live == nullptr || live[r] != 0.0f);
  // the dead tail: every thread of an all-dead block leaves here, before
  // any mbarrier is armed or any copy started
  if (!__syncthreads_or(alive)) {
    if (r < a.n && lane == 0) out_occ[r] = 0.0f;
    if (COUNT) cw::count_walk<G>(ctr, r < a.n, false, 0);
    return;
  }
  const cw::Shared sh = cw::carve(smem4, a.C, a.cs, 0);
  cw::Ring ring{sh.ring, s_bar, a.cs * mm::REC};
  ring.init();
  cw::load_boxes(sh, lo, hi, a.C);

  float f[mm::FEAT];
  for (int k = 0; k < mm::FEAT; ++k)
    f[k] = alive ? feats[(size_t)r * mm::FEAT + k] : 0.0f;
  const float bnd = (alive && bound != nullptr) ? bound[r] : mm::BIG;
  const float o[3] = {f[6], f[7], f[8]};
  const float inv_d[3] = {mm::inv_dir(f[0]), mm::inv_dir(f[1]),
                          mm::inv_dir(f[2])};

  const int n = cw::shortlist<G>(sh, a.C, alive, [&](int c, float& tmin) {
    float tmax;
    const bool e = mm::slab(o, inv_d, sh.lo + 3 * c, sh.hi + 3 * c, tmin,
                            tmax);
    return e && (a.allow_negative || tmax > 0.0f) && tmin < bnd;
  }, &s_n);
  if (COUNT) cw::count_walk<G>(ctr, r < a.n, alive, n);

  // settle bound: no occluder lies past the ray's exit from the root box
  // or past its bound
  float texit;
  {
    float tmin, tmax;
    mm::slab(o, inv_d, root, root + 3, tmin, tmax);
    texit = fminf(tmax, bnd);
  }

  bool occ = false;
  cw::walk(ring, rec, sh.list, n, [&](int p, const float* recs) {
    if (alive && !occ) {
      const int c = sh.list[p];
      float tmin, tmax;
      const bool enter = mm::slab(o, inv_d, sh.lo + 3 * c, sh.hi + 3 * c,
                                  tmin, tmax) &&
                         (tmax > a.t_clip) && (tmin < bnd);
      if (enter)
        occ = mm::lane_occludes(f, recs, a.cs, lane, G, a.sign, a.t_clip,
                                bnd);
    }
    occ = cw::group_any<G>(occ);
    return alive && !occ && texit >= sh.ent[p + 1];
  });

  if (r < a.n && lane == 0) out_occ[r] = occ ? 1.0f : 0.0f;
}

// Lanes per ray of K4 (culled_occluded_lanes_per_ray). A shadow wave's
// live rays are few and sorted first, so what fills the card is the live
// part, which the host does not know without a synchronisation. Tuned on
// the H100 at dragon's chunk-37 shadow waves (chip_smoke.py `[tune]`,
// device ms at 8 / 16 / 32 lanes): 65,536 rays, 15.9% live, 0.0881 /
// 0.0648 / 0.0528; 4,096 rays, 53.2% live, 0.0164 / 0.0115 / 0.0100. 32
// lanes at both sizes.
constexpr int kOccludedLanes = 32;

// Each launcher runs a kernel's counting instance (COUNT) only when the
// device counters' row is given, so that with the counters off the kernel
// is the one built before them (as K7's, megakernel.cu).
template <int G>
int launch_occluded(const CullArgs& a, const float* feats, const float* bound,
                    const float* live, const float* rec, const float* lo,
                    const float* hi, const float* root, float* out_occ,
                    void* stream, unsigned long long* ctr) {
  const auto kernel = ctr != nullptr ? occluded_kernel<G, true>
                                     : occluded_kernel<G, false>;
  const size_t smem = cw::smem_bytes(a.C, a.cs, 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  constexpr int rays = cw::kThreads / G;
  kernel<<<(a.n + rays - 1) / rays, cw::kThreads, smem,
           (cudaStream_t)stream>>>(a, feats, bound, live, rec, lo, hi, root,
                                   out_occ, ctr);
  return (int)cudaGetLastError();
}

template <int G>
int launch_nearest(const CullArgs& a, const float* feats, const float* live,
                   const float* rec, const float* lo, const float* hi,
                   const float* root, float* out_t, int32_t* out_i,
                   void* stream, unsigned long long* ctr) {
  const auto kernel = ctr != nullptr ? nearest_kernel<G, true>
                                     : nearest_kernel<G, false>;
  const size_t smem = cw::smem_bytes(a.C, a.cs, 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  constexpr int rays = cw::kThreads / G;
  kernel<<<(a.n + rays - 1) / rays, cw::kThreads, smem,
           (cudaStream_t)stream>>>(a, feats, live, rec, lo, hi, root, out_t,
                                   out_i, ctr);
  return (int)cudaGetLastError();
}

}  // namespace

// K3 with G lanes per ray (8, 16 or 32; anything else returns
// cudaErrorInvalidValue): feats [n, 10], live [n] (nullptr = all live),
// rec [C, cs, 20], lo/hi [C, 3] (widened cull boxes), root [6] (root box
// lo, hi). Writes t [n] (BIG = miss) and the ORIGINAL triangle index [n]
// (BIG_I = miss). Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError(). `counters`, last (after the
// stream, where a launcher of an earlier tree ignores it): K3's row of the
// device counters (cluster_walk.cuh count_walk), or nullptr.
extern "C" int culled_nearest_lanes(int G, int n, int C, int cs,
                                    int allow_negative, int clip, float sign,
                                    float t_clip, const float* feats,
                                    const float* live, const float* rec,
                                    const float* lo, const float* hi,
                                    const float* root, float* out_t,
                                    int32_t* out_i, void* stream,
                                    unsigned long long* counters) {
  if (n <= 0) return (int)cudaGetLastError();
  const CullArgs a{n, C, cs, allow_negative, clip, sign, t_clip};
  switch (G) {
    case 8:
      return launch_nearest<8>(a, feats, live, rec, lo, hi, root, out_t,
                               out_i, stream, counters);
    case 16:
      return launch_nearest<16>(a, feats, live, rec, lo, hi, root, out_t,
                                out_i, stream, counters);
    case 32:
      return launch_nearest<32>(a, feats, live, rec, lo, hi, root, out_t,
                                out_i, stream, counters);
  }
  return (int)cudaErrorInvalidValue;
}

// K3 with the lanes per ray cw::lanes_for(n) picks.
extern "C" int culled_nearest(int n, int C, int cs, int allow_negative,
                              int clip, float sign, float t_clip,
                              const float* feats, const float* live,
                              const float* rec, const float* lo,
                              const float* hi, const float* root,
                              float* out_t, int32_t* out_i, void* stream,
                              unsigned long long* counters) {
  return culled_nearest_lanes(cw::lanes_for(n), n, C, cs, allow_negative,
                              clip, sign, t_clip, feats, live, rec, lo, hi,
                              root, out_t, out_i, stream, counters);
}

// K4 with kOccludedLanes lanes per ray: is any triangle strictly inside
// (t_clip, bound) along each ray? Operands as culled_nearest_lanes, plus
// bound [n] (BIG = unbounded). Writes 1.0 / 0.0 into out_occ [n]; counts
// into K4's row of `counters` unless it is nullptr.
extern "C" int culled_occluded(int n, int C, int cs, int allow_negative,
                               float sign, float t_clip, const float* feats,
                               const float* bound, const float* live,
                               const float* rec, const float* lo,
                               const float* hi, const float* root,
                               float* out_occ, void* stream,
                               unsigned long long* counters) {
  if (n <= 0) return (int)cudaGetLastError();
  const CullArgs a{n, C, cs, allow_negative, 1, sign, t_clip};
  return launch_occluded<kOccludedLanes>(a, feats, bound, live, rec, lo, hi,
                                         root, out_occ, stream, counters);
}

extern "C" int culled_occluded_lanes_per_ray() { return kOccludedLanes; }

#ifdef CULLED_LANE_SWEEP
// The lane sweep, a library of its own (ops/cuda/_build.py
// "culled_sweep"), for measurement and tests: K4 with G lanes per ray (8,
// 16 or 32; anything else returns cudaErrorInvalidValue), operands as
// culled_occluded.
extern "C" int culled_occluded_lanes(int G, int n, int C, int cs,
                                     int allow_negative, float sign,
                                     float t_clip, const float* feats,
                                     const float* bound, const float* live,
                                     const float* rec, const float* lo,
                                     const float* hi, const float* root,
                                     float* out_occ, void* stream,
                                     unsigned long long* counters) {
  if (n <= 0) return (int)cudaGetLastError();
  const CullArgs a{n, C, cs, allow_negative, 1, sign, t_clip};
  switch (G) {
    case 8:
      return launch_occluded<8>(a, feats, bound, live, rec, lo, hi, root,
                                out_occ, stream, counters);
    case 16:
      return launch_occluded<16>(a, feats, bound, live, rec, lo, hi, root,
                                 out_occ, stream, counters);
    case 32:
      return launch_occluded<32>(a, feats, bound, live, rec, lo, hi, root,
                                 out_occ, stream, counters);
  }
  return (int)cudaErrorInvalidValue;
}
#endif
