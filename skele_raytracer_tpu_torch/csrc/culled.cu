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
// K3, `nearest_kernel<G>` (cluster_walk.cuh). The first port ran one thread
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
// K4, `occluded_kernel`, keeps the first port's schedule (it was
// `culled_kernel<true>`): one thread per ray, 256-ray tiles, synchronous
// staging, a ray stops at its first occluder and the tile once every ray
// is occluded.
//
// Built with -fmad=false so every operation rounds as in the plain version.

#include <cuda_runtime.h>

#include "cluster_walk.cuh"
#include "mesh_math.cuh"

namespace {

constexpr int kTile = 256;  // K4: rays per block (one shortlist per tile)

struct CullArgs {
  int n;             // rays
  int C;             // clusters
  int cs;            // triangles per cluster
  int allow_negative;  // parity: boxes behind the origin count
  int clip;          // clean: reject t <= t_clip (K3)
  float sign;        // +1 parity (mirrored u), -1 clean
  float t_clip;      // near clip (K3 when clip; K4 always)
};

template <int G>
__global__ void __launch_bounds__(cw::kThreads)
    nearest_kernel(CullArgs a, const float* __restrict__ feats,
                   const float* __restrict__ live,
                   const float* __restrict__ rec, const float* __restrict__ lo,
                   const float* __restrict__ hi,
                   const float* __restrict__ root, float* __restrict__ out_t,
                   int32_t* __restrict__ out_i) {
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

__global__ void __launch_bounds__(kTile)
    occluded_kernel(CullArgs a, const float* __restrict__ feats,
                    const float* __restrict__ bound,
                    const float* __restrict__ live,
                    const float* __restrict__ rec,
                    const float* __restrict__ lo,
                    const float* __restrict__ hi,
                    const float* __restrict__ root,
                    float* __restrict__ out_occ) {
  extern __shared__ float4 smem4[];
  float* s_rec = reinterpret_cast<float*>(smem4);   // [cs * REC]
  int32_t* s_key = reinterpret_cast<int32_t*>(s_rec + a.cs * mm::REC);  // [C]
  int32_t* s_cand = s_key + a.C;                    // [C] entered, unsorted
  int32_t* s_list = s_cand + a.C;                   // [C] sorted shortlist
  float* s_ent = reinterpret_cast<float*>(s_list + a.C);  // [C + 1]
  __shared__ int s_n;

  const int tid = threadIdx.x;
  const int r = blockIdx.x * kTile + tid;
  float f[mm::FEAT];
  bool alive = r < a.n && (live == nullptr || live[r] != 0.0f);
  for (int k = 0; k < mm::FEAT; ++k) f[k] = alive ? feats[(size_t)r * mm::FEAT + k] : 0.0f;
  const float bnd = (alive && bound != nullptr) ? bound[r] : mm::BIG;
  const float o[3] = {f[6], f[7], f[8]};
  const float inv_d[3] = {mm::inv_dir(f[0]), mm::inv_dir(f[1]),
                          mm::inv_dir(f[2])};

  // ---- the tile's shortlist ------------------------------------------
  const int32_t key_big = mm::ordered_key(__float_as_int(mm::BIG));
  for (int c = tid; c < a.C; c += kTile) s_key[c] = key_big;
  if (tid == 0) s_n = 0;
  __syncthreads();
  if (alive) {
    for (int c = 0; c < a.C; ++c) {
      float tmin, tmax;
      bool enter = mm::slab(o, inv_d, lo + 3 * c, hi + 3 * c, tmin, tmax);
      if (!a.allow_negative) enter = enter && (tmax > 0.0f);
      enter = enter && (tmin < bnd);
      if (enter) atomicMin(&s_key[c], mm::ordered_key(__float_as_int(tmin)));
    }
  }
  __syncthreads();
  for (int c = tid; c < a.C; c += kTile)
    if (s_key[c] < key_big) s_cand[atomicAdd(&s_n, 1)] = c;
  __syncthreads();
  const int n = s_n;
  for (int i = tid; i < n; i += kTile) {
    const int ci = s_cand[i];
    const int32_t ki = s_key[ci];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const int cj = s_cand[j];
      const int32_t kj = s_key[cj];
      rank += (kj < ki) || (kj == ki && cj < ci);
    }
    s_list[rank] = ci;
    s_ent[rank] = __int_as_float(mm::ordered_key(ki));
  }
  if (tid == 0) s_ent[n] = mm::BIG;
  __syncthreads();

  // ---- settle bound: no hit lies past the ray's exit from the root box --
  float texit;
  {
    float tmin, tmax;
    mm::slab(o, inv_d, root, root + 3, tmin, tmax);
    texit = fminf(tmax, bnd);
  }

  // ---- clusters front to back -----------------------------------------
  bool occ = false;
  const int n4 = a.cs * mm::REC / 4;
  for (int p = 0; p < n; ++p) {
    const int c = s_list[p];
    const float4* src = reinterpret_cast<const float4*>(rec) + (size_t)c * n4;
    __syncthreads();  // the previous cluster's records are no longer read
    for (int k = tid; k < n4; k += kTile) smem4[k] = src[k];
    __syncthreads();
    if (alive && !occ) {
      float tmin, tmax;
      bool enter = mm::slab(o, inv_d, lo + 3 * c, hi + 3 * c, tmin, tmax);
      enter = enter && (tmax > a.t_clip) && (tmin < bnd);
      if (enter) {
        for (int j = 0; j < a.cs; ++j) {
          if (mm::occludes(mm::planes(f, s_rec + j * mm::REC, a.sign),
                           a.t_clip, bnd)) {
            occ = true;
            break;
          }
        }
      }
    }
    const float next = s_ent[p + 1];
    if (!__syncthreads_or(alive && !occ && texit >= next)) break;
  }

  if (r < a.n) out_occ[r] = occ ? 1.0f : 0.0f;
}

template <int G>
int launch_nearest(const CullArgs& a, const float* feats, const float* live,
                   const float* rec, const float* lo, const float* hi,
                   const float* root, float* out_t, int32_t* out_i,
                   void* stream) {
  const size_t smem = cw::smem_bytes(a.C, a.cs, 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nearest_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  constexpr int rays = cw::kThreads / G;
  nearest_kernel<G><<<(a.n + rays - 1) / rays, cw::kThreads, smem,
                      (cudaStream_t)stream>>>(a, feats, live, rec, lo, hi,
                                              root, out_t, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// K3 with G lanes per ray (8, 16 or 32; anything else returns
// cudaErrorInvalidValue): feats [n, 10], live [n] (nullptr = all live),
// rec [C, cs, 20], lo/hi [C, 3] (widened cull boxes), root [6] (root box
// lo, hi). Writes t [n] (BIG = miss) and the ORIGINAL triangle index [n]
// (BIG_I = miss). Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError().
extern "C" int culled_nearest_lanes(int G, int n, int C, int cs,
                                    int allow_negative, int clip, float sign,
                                    float t_clip, const float* feats,
                                    const float* live, const float* rec,
                                    const float* lo, const float* hi,
                                    const float* root, float* out_t,
                                    int32_t* out_i, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const CullArgs a{n, C, cs, allow_negative, clip, sign, t_clip};
  switch (G) {
    case 8:
      return launch_nearest<8>(a, feats, live, rec, lo, hi, root, out_t,
                               out_i, stream);
    case 16:
      return launch_nearest<16>(a, feats, live, rec, lo, hi, root, out_t,
                                out_i, stream);
    case 32:
      return launch_nearest<32>(a, feats, live, rec, lo, hi, root, out_t,
                                out_i, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// K3 with the lanes per ray cw::lanes_for(n) picks.
extern "C" int culled_nearest(int n, int C, int cs, int allow_negative,
                              int clip, float sign, float t_clip,
                              const float* feats, const float* live,
                              const float* rec, const float* lo,
                              const float* hi, const float* root,
                              float* out_t, int32_t* out_i, void* stream) {
  return culled_nearest_lanes(cw::lanes_for(n), n, C, cs, allow_negative,
                              clip, sign, t_clip, feats, live, rec, lo, hi,
                              root, out_t, out_i, stream);
}

// K4: is any triangle strictly inside (t_clip, bound) along each ray?
// bound [n] (BIG = unbounded). Writes 1.0 / 0.0 into out_occ [n].
extern "C" int culled_occluded(int n, int C, int cs, int allow_negative,
                               float sign, float t_clip, const float* feats,
                               const float* bound, const float* live,
                               const float* rec, const float* lo,
                               const float* hi, const float* root,
                               float* out_occ, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const CullArgs a{n, C, cs, allow_negative, 1, sign, t_clip};
  const size_t smem = sizeof(float) * (size_t)a.cs * mm::REC +
                      sizeof(int32_t) * 3 * (size_t)a.C +
                      sizeof(float) * ((size_t)a.C + 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        occluded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  occluded_kernel<<<(a.n + kTile - 1) / kTile, kTile, smem,
                    (cudaStream_t)stream>>>(a, feats, bound, live, rec, lo, hi,
                                            root, out_occ);
  return (int)cudaGetLastError();
}
