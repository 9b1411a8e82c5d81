// The cluster walk shared by the cluster-culled kernels on Hopper
// (sm_90a): K3 (culled.cu `nearest_kernel`), K4 (culled.cu
// `occluded_kernel`) and K7 (megakernel.cu `fused_kernel`); K5
// (intersect.cu `triangle_kernel`) takes its groups and its ring. Device code
// only; the per-pair math is in mesh_math.cuh and fused_math.cuh, which the
// host builds test.
//
// * Groups. G consecutive threads (a power of two <= 32, inside one warp)
//   carry one ray; a block of kThreads threads holds kThreads / G rays.
//   Each lane tests every G-th record of a cluster (mm::lane_nearest,
//   mm::lane_occludes), and the group merges its lanes' answers with a
//   shuffle butterfly (group_nearest, group_any), so every lane holds the
//   ray's answer.
// * The shortlist. The block's rays slab-test the cluster boxes (read once
//   into shared memory), each lane a G-th of them; the tile minimum of the
//   entry distances goes in with an integer atomicMin on order-preserving
//   keys, and the entered clusters are ranked by (entry, cluster).
// * The ring. Each shortlisted cluster's records (cs x 80 B, contiguous
//   and 16-byte aligned) go into one of two shared-memory stages through
//   the bulk asynchronous copy unit (cp.async.bulk, completing on an
//   mbarrier with the byte count), so that cluster p + 1 loads while
//   cluster p is tested. The one block vote per cluster (the early exit)
//   is also what frees a stage for the load after next.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mesh_math.cuh"

namespace cw {

constexpr int kThreads = 256;  // threads per block

// Lanes per ray for an n-ray wave (ops/cuda/culled.py `lanes_for`): a small
// wave takes more lanes per ray so that it still fills the SMs. Tuned on
// the H100 at dragon's waves (chip_smoke.py `[tune]` lines): fewer lanes
// were slower at every wave, and 32 lanes beat 16 only on small waves.
inline int lanes_for(int n) { return n <= 16384 ? 32 : 16; }

// Dynamic shared memory of a launch, in `carve` order: the ring (two stages
// of cs records), `extra` floats of the kernel's own tables, the boxes and
// the shortlist arrays (ops/cuda/culled.py `launch_shape`).
inline size_t smem_bytes(int C, int cs, int extra) {
  return sizeof(float) * (2 * (size_t)cs * mm::REC + (size_t)extra +
                          6 * (size_t)C + (size_t)C + 1) +
         sizeof(int32_t) * 3 * (size_t)C;
}

struct Shared {
  float* ring;    // [2][cs * REC] staged records
  float* extra;   // the kernel's own tables
  float* lo;      // [C * 3] widened cull boxes
  float* hi;      // [C * 3]
  int32_t* key;   // [C] the tile's minimum entry, as an ordered key
  int32_t* cand;  // [C] entered clusters, unsorted
  int32_t* list;  // [C] the shortlist, front to back
  float* ent;     // [C + 1] its entry distances; BIG after the last
};

__device__ inline Shared carve(float4* smem, int C, int cs, int extra) {
  Shared s;
  s.ring = reinterpret_cast<float*>(smem);
  s.extra = s.ring + 2 * cs * mm::REC;
  s.lo = s.extra + extra;
  s.hi = s.lo + 3 * C;
  s.key = reinterpret_cast<int32_t*>(s.hi + 3 * C);
  s.cand = s.key + C;
  s.list = s.cand + C;
  s.ent = reinterpret_cast<float*>(s.list + C);
  return s;
}

// Copies the box table; visible after the caller's next __syncthreads.
__device__ inline void load_boxes(const Shared& s, const float* lo,
                                  const float* hi, int C) {
  for (int k = threadIdx.x; k < 3 * C; k += kThreads) {
    s.lo[k] = lo[k];
    s.hi[k] = hi[k];
  }
}

// ---- group reductions (every thread of the warp calls them) -------------

template <int G>
__device__ inline void group_nearest(float& t, int32_t& i) {
#pragma unroll
  for (int k = 1; k < G; k <<= 1) {
    const float t_o = __shfl_xor_sync(0xffffffffu, t, k);
    const int32_t i_o = __shfl_xor_sync(0xffffffffu, i, k);
    mm::merge_nearest(t, i, t_o, i_o);
  }
}

template <int G>
__device__ inline bool group_any(bool b) {
  int v = b ? 1 : 0;
#pragma unroll
  for (int k = 1; k < G; k <<= 1) v |= __shfl_xor_sync(0xffffffffu, v, k);
  return v != 0;
}

// ---- the shortlist -------------------------------------------------------

// Every thread of the block calls it. The lanes of each active ray test
// boxes lane, lane + G, ... with enter(c, tmin) (true when the ray enters
// box c, its entry in tmin). Returns the count n of entered clusters;
// s.list[0, n) and s.ent[0, n] hold them front to back when it returns.
template <int G, class Enter>
__device__ int shortlist(const Shared& s, int C, bool active, Enter enter,
                         int* s_n) {
  const int tid = threadIdx.x;
  const int32_t key_big = mm::ordered_key(__float_as_int(mm::BIG));
  for (int c = tid; c < C; c += kThreads) s.key[c] = key_big;
  if (tid == 0) *s_n = 0;
  __syncthreads();
  if (active) {
    for (int c = tid % G; c < C; c += G) {
      float tmin;
      if (enter(c, tmin))
        atomicMin(&s.key[c], mm::ordered_key(__float_as_int(tmin)));
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads)
    if (s.key[c] < key_big) s.cand[atomicAdd(s_n, 1)] = c;
  __syncthreads();
  const int n = *s_n;
  for (int i = tid; i < n; i += kThreads) {
    const int ci = s.cand[i];
    const int32_t ki = s.key[ci];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const int cj = s.cand[j];
      const int32_t kj = s.key[cj];
      rank += (kj < ki) || (kj == ki && cj < ci);
    }
    s.list[rank] = ci;
    s.ent[rank] = __int_as_float(mm::ordered_key(ki));
  }
  if (tid == 0) s.ent[n] = mm::BIG;
  __syncthreads();
  return n;
}

// ---- device counters (utils/profiling.py `walk_counters`) ----------------

// The block's count of a walk, right after cw::shortlist returned n: into
// ctr (the kernel's row: rays, live rays, (ray, cluster) pairs), thread 0
// adds the block's rays (`ray`: one in range), the rays it holds live and
// n x live, the pairs its live rays walk at most. Every thread of the
// block calls it (two block barriers), in a kernel's counting instance
// only: K3, K4 and K7 launch it when the row is given.
template <int G>
__device__ inline void count_walk(unsigned long long* ctr, bool ray,
                                  bool live, int n) {
  const bool first = threadIdx.x % G == 0;
  const int rays = __syncthreads_count(first && ray);
  const int lives = __syncthreads_count(first && live);
  if (threadIdx.x == 0) {
    atomicAdd(ctr, (unsigned long long)rays);
    atomicAdd(ctr + 1, (unsigned long long)lives);
    atomicAdd(ctr + 2, (unsigned long long)n * (unsigned long long)lives);
  }
}

// ---- the ring of staged clusters ------------------------------------------

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

struct Ring {
  float* buf;     // [2][floats]
  uint64_t* bar;  // [2] mbarriers, one per stage
  int floats;     // floats per stage: one cluster's records
  int started;    // loads started and loads waited for (0 at the start),
  int used;       // counted alike in every thread; load q uses stage q % 2

  // Thread 0 sets up the barriers (one arrival each: its own, with the
  // byte count); the caller's next __syncthreads publishes them.
  __device__ void init() {
    if (threadIdx.x == 0) {
      for (int k = 0; k < 2; ++k)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                         smem_addr(bar + k))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }

  // Every thread: the next load brings cluster c of rec [C, floats].
  __device__ void fetch(const float* rec, int c) {
    fetch_n(rec + (size_t)c * floats, floats);
  }

  // Every thread: the next load brings n <= floats floats (a multiple of
  // 4, 16-byte aligned) from src; thread 0 starts it. The stage's earlier
  // readers have passed a block barrier; the proxy fence orders their
  // reads before the copy's writes.
  __device__ void fetch_n(const float* src, int n) {
    const int k = started & 1;
    if (threadIdx.x == 0) {
      const uint32_t b = smem_addr(bar + k);
      const uint32_t bytes = (uint32_t)(n * sizeof(float));
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                       "r"(b),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];" ::"r"(smem_addr(buf + k * floats)),
          "l"(src), "r"(bytes), "r"(b)
          : "memory");
    }
    ++started;
  }

  // Every thread: waits for the oldest load not waited for yet (the
  // (q / 2)-th completion of its stage's barrier) and returns its stage.
  __device__ const float* wait() {
    const int k = used & 1;
    const uint32_t b = smem_addr(bar + k);
    const uint32_t parity = (uint32_t)(used >> 1) & 1u;
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(b), "r"(parity)
          : "memory");
    }
    ++used;
    return buf + k * floats;
  }

  // Every thread: no copy may still write to the ring when the block moves
  // on (or exits).
  __device__ void drain() {
    while (used < started) wait();
  }
};

// Every thread of the block calls it. Stages clusters list[0, n) of rec
// front to back, two loads in flight, and runs body(p, records) for each:
// body returns whether its ray needs the clusters after p. The block stops
// once no ray needs them; that vote is also the barrier after which a
// stage may be refilled.
template <class Body>
__device__ void walk(Ring& ring, const float* rec, const int32_t* list, int n,
                     Body body) {
  for (int q = 0; q < n && q < 2; ++q) ring.fetch(rec, list[q]);
  for (int p = 0; p < n; ++p) {
    const float* recs = ring.wait();
    if (!__syncthreads_or(body(p, recs))) break;
    if (p + 2 < n) ring.fetch(rec, list[p + 2]);
  }
  ring.drain();
}

}  // namespace cw
