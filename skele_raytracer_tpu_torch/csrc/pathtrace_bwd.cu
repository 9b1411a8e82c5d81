// Backward of the whole-frame path tracer, for Hopper (sm_90a).
//
// Replaces: the JAX package's Pallas TPU kernel
//   skele_raytracer_tpu/ops/pallas/pathtrace.py::_build_backward_kernel
// (launched by `_backward_call`): the gradient of sum(radiance * g) with
// respect to the five scene tables, replayed from the hit records that the
// records variant of the forward kernel (pathtrace.cu) wrote.
//
// What bounds it: FP32 and SFU issue of the replay and its hand-written
// adjoint (frame_adjoint.cuh; about three times the forward's shading work
// per record), and the latency of its long dependent chains (sqrt,
// division, exp, pow, sin/cos, threefry); device memory carries only the
// records, the planes and the cotangent. The first port ran one thread per
// sample at 255 registers (2 blocks of 128 threads per SM) and reduced
// every record's gradients across its warp as it went: a staged row and a
// 32-step serial loop per record, a 5-step shuffle tree per light value.
// Now:
// * G lanes per sample (the launcher takes 1, kLanes; others for
//   measurement): lane l runs the adjoints of paths l, l + G, ...; lane
//   G - 1 also the primary shade. The lanes' adjoints of the primary state
//   (25 floats, fm::PrimaryG) are summed by an xor butterfly, and lane 0
//   finishes the primary hit and the camera row (fm::lane_bwd,
//   fm::finish_bwd).
// * Entries every sample may reach (misc row 0, fog rows, light rows:
//   fm::DenseLayout) are summed per thread, in shared memory laid out
//   [value][thread] (no bank conflicts), and reduced once at the block's
//   end in thread order. That takes 3.6 KiB of the block's shared memory
//   per light (fm::bwd_smem_floats). With the largest tables the replay
//   takes (64 spheres, 32 triangles, 2 fog volumes) a block needs 140 KiB
//   at the 22 lights shadows allow (one block per SM) and 176 KiB at
//   MAX_REPLAY_LIGHTS (ops/cuda/pathtrace.py `_can_replay`), within the
//   card's 227 KiB; more lights take the wavefront gradient.
// * A record's primitive row is staged per lane in shared memory (the
//   adjoint adds into it there, not in registers); the warp groups the
//   lanes that hold the same row with __match_any_sync and each group's
//   row is summed column by column in lane order into the warp's table.
// * One resident wave of blocks (the occupancy the launcher queries) each
//   striding over the samples; stage 2 (`reduce_kernel`) sums the blocks'
//   partial tables in block order.
//
// Every sum runs in an order fixed by the launch shape and the inputs, with
// no float atomics: two runs on the same inputs give bitwise-equal tables.
// Threads past the last sample replay sample `base` of their stride and
// add nothing. The host build (frame_math_host.cpp) runs this schedule
// serially in the same order. Built with -fmad=false like the forward.

#include <cuda_runtime.h>

#include "frame_adjoint.cuh"

namespace {

constexpr int kThreads = fm::BWD_THREADS;
// Blocks per SM the register budget is cut for: 168 registers a thread
// (576 B of spills). Unbounded, ptxas takes 250 (2 blocks); cut to 128 (4
// blocks) it spills more. 3 ran the fastest on the H100.
constexpr int kMinBlocks = 3;
constexpr int kWarps = fm::BWD_WARPS;
constexpr int kDensePitch = fm::BWD_DENSE_PITCH;  // [value][thread], padded
constexpr int kRowPitch = fm::BWD_ROW_PITCH;      // staged rows, padded
constexpr unsigned kFull = 0xffffffffu;
// Lanes per sample the launcher takes. Other powers of two up to 32 run
// through pathtrace_backward_lanes, for measurement: the H100 readings of
// small batches (chip_smoke.py `[tune]`) put no lane count ahead of 1 by
// more than the spread between calls, and a whole frame runs fastest at 1.
constexpr int kLanes = 1;

struct Smem {
  float* tab;    // [lay.total] the scene tables, flat layout
  float* rows;   // [kWarps][lay.misc] each warp's sph | tri row table
  float* stage;  // [kWarps][32][kRowPitch] staged record rows
  float* dense;  // [dense.total][kDensePitch] per-thread dense sums
};

size_t smem_bytes(const fm::Params& p) {
  return sizeof(float) *
         (size_t)fm::bwd_smem_floats(fm::grad_layout(p), fm::dense_layout(p));
}

__device__ Smem carve(float* smem, const fm::GradLayout& lay) {
  Smem s;
  s.tab = smem;
  s.rows = s.tab + lay.total;
  s.stage = s.rows + kWarps * lay.misc;
  s.dense = s.stage + kWarps * 32 * kRowPitch;
  return s;
}

// One thread's accumulator (frame_adjoint.cuh's contract). Its methods are
// __host__ __device__ because the header's functions that call them are;
// only the device body is ever run.
struct LaneAcc {
  float* col;    // this thread's column of the dense sums
  float* stage;  // this warp's staged rows
  float* table;  // this warp's row table
  fm::GradLayout lay;
  int lane;      // lane in the warp
  bool active;

  __host__ __device__ void dense(int e, const float* v, int n) {
    if (active)
      for (int c = 0; c < n; ++c) col[(e + c) * kDensePitch] += v[c];
  }

  __host__ __device__ float* row_begin() {
    float* r = stage + lane * kRowPitch;
    for (int c = 0; c < fm::TRI_W; ++c) r[c] = 0.0f;
    return r;
  }

  // Every lane of the warp calls it. The groups of lanes with one key are
  // taken in the order of their lowest lane; lane c adds column c of the
  // group's staged rows in lane order, then the sum to the table row.
  __host__ __device__ void row_commit(int kind, int idx) {
#ifdef __CUDA_ARCH__
    const int key = active ? fm::row_key(kind, idx) : 0;
    __syncwarp();
    const unsigned mine = __match_any_sync(kFull, key);
    unsigned todo = __ballot_sync(kFull, key != 0);
    while (todo) {
      const int leader = __ffs(todo) - 1;
      const unsigned grp = __shfl_sync(kFull, mine, leader);
      const int k = __shfl_sync(kFull, key, leader);
      todo &= ~grp;
      int width;
      const int off = fm::row_offset(lay, k, &width);
      if (lane < width) {
        float s = 0.0f;
        for (unsigned m = grp; m; m &= m - 1)
          s += stage[(__ffs(m) - 1) * kRowPitch + lane];
        table[off + lane] += s;
      }
    }
    __syncwarp();
#endif
  }
};

// One step of the group sum, an xor butterfly over the lanes of a sample:
// each summed float of a PrimaryG becomes its own plus lane ^ k's.
struct ShuffleAdd {
  int k;
  __host__ __device__ void operator()(float& v, const float&) const {
#ifdef __CUDA_ARCH__
    v += __shfl_xor_sync(kFull, v, k);
#endif
  }
};

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    pathtrace_bwd_kernel(fm::Params p, int G, const float* __restrict__ sph,
                         const float* __restrict__ tri,
                         const float* __restrict__ misc,
                         const float* __restrict__ pl,
                         const float* __restrict__ dl,
                         const int32_t* __restrict__ ids,
                         const float* __restrict__ xs,
                         const float* __restrict__ ys,
                         const float* __restrict__ cj,
                         const float* __restrict__ ci,
                         const int32_t* __restrict__ recs,
                         const float* __restrict__ gr,
                         const float* __restrict__ gg,
                         const float* __restrict__ gb,
                         float* __restrict__ partial) {
  extern __shared__ float smem[];
  const fm::GradLayout lay = fm::grad_layout(p);
  const fm::DenseLayout dlay = fm::dense_layout(p);
  const Smem sm = carve(smem, lay);
  const int sizes[5] = {lay.tri - lay.sph, lay.misc - lay.tri,
                        lay.pl - lay.misc, lay.dl - lay.pl,
                        lay.total - lay.dl};
  const float* srcs[5] = {sph, tri, misc, pl, dl};
  for (int t = 0, off = 0; t < 5; off += sizes[t], ++t)
    for (int i = threadIdx.x; i < sizes[t]; i += kThreads)
      sm.tab[off + i] = srcs[t][i];
  for (int i = threadIdx.x; i < kWarps * lay.misc; i += kThreads)
    sm.rows[i] = 0.0f;
  for (int i = threadIdx.x; i < dlay.total * kDensePitch; i += kThreads)
    sm.dense[i] = 0.0f;
  __syncthreads();

  const int warp = threadIdx.x / 32;
  LaneAcc acc{sm.dense + threadIdx.x, sm.stage + warp * 32 * kRowPitch,
              sm.rows + warp * lay.misc, lay, (int)(threadIdx.x % 32),
              false};
  const fm::Tables tb{sm.tab + lay.sph, sm.tab + lay.tri, sm.tab + lay.misc,
                      sm.tab + lay.pl, sm.tab + lay.dl};
  const int lane = threadIdx.x % G;
  const int spb = kThreads / G;  // samples per block and stride step
  for (int base = blockIdx.x * spb; base < p.n; base += gridDim.x * spb) {
    const int i = base + threadIdx.x / G;
    const bool active = i < p.n;
    const int j = active ? i : base;
    acc.active = active;
    fm::PrimaryG pg =
        fm::lane_bwd(p, tb, (uint32_t)ids[j], xs[j], ys[j], cj[j], ci[j],
                     recs + j, p.n, fm::v3(gr[j], gg[j], gb[j]), lane, G, acc);
    for (int k = 1; k < G; k <<= 1) fm::zip_primaryg(pg, pg, ShuffleAdd{k});
    acc.active = active && lane == 0;
    fm::finish_bwd(p, tb, (uint32_t)ids[j], xs[j], ys[j], cj[j], ci[j],
                   (uint32_t)recs[j], pg, acc);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < lay.total; e += kThreads) {
    float s = 0.0f;
    if (e < lay.misc) {
      for (int w = 0; w < kWarps; ++w) s += sm.rows[w * lay.misc + e];
    } else {
      const int di = fm::dense_index(lay, dlay, e);
      if (di >= 0)
        for (int t = 0; t < kThreads; ++t) s += sm.dense[di * kDensePitch + t];
    }
    partial[(size_t)blockIdx.x * lay.total + e] = s;
  }
}

__global__ void reduce_kernel(const float* __restrict__ partial, int blocks,
                              int total, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * total + e];
  out[e] = s;
}

bool valid_lanes(int G) { return G >= 1 && G <= 32 && (G & (G - 1)) == 0; }

// Stage 1's grid: one resident wave (the occupancy of its block at this
// shared memory, times the SMs), no more blocks than the samples fill; 0
// on an error, which is left in cudaGetLastError.
int stage1_blocks(const fm::Params& p, int G, size_t smem) {
  int dev, sms, per_sm;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(pathtrace_bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pathtrace_bwd_kernel, kThreads, smem) != cudaSuccess ||
      per_sm < 1)
    return 0;
  const long long need = ((long long)p.n * G + kThreads - 1) / kThreads;
  const long long wave = (long long)sms * per_sm;
  return (int)(need < wave ? (need > 0 ? need : 1) : wave);
}

}  // namespace

// Lanes per sample the launcher picks for p (pathtrace_backward).
extern "C" int pathtrace_bwd_lanes_for(const fm::Params*) { return kLanes; }

// Floats of the partial table the caller allocates for p->n samples at G
// lanes per sample (a power of two <= 32); -1 when the launch shape cannot
// be had (an invalid G, shared memory beyond the card's, a CUDA error).
extern "C" long long pathtrace_bwd_partial_floats_lanes(int G,
                                                        const fm::Params* p) {
  if (!valid_lanes(G)) return -1;
  const int blocks = stage1_blocks(*p, G, smem_bytes(*p));
  return blocks > 0 ? (long long)blocks * fm::grad_layout(*p).total : -1;
}

extern "C" long long pathtrace_bwd_partial_floats(const fm::Params* p) {
  return pathtrace_bwd_partial_floats_lanes(kLanes, p);
}

// Launches both stages on `stream` with G lanes per sample (a power of two
// <= 32; others return cudaErrorInvalidValue): `out` receives the flat
// gradient (fm::grad_layout: sph | tri | misc | pl | dl) of sum(radiance *
// g) for the p->n samples whose [K, n] records are `recs`. `partial` holds
// pathtrace_bwd_partial_floats_lanes(G, p) floats. Allocates nothing, does
// not synchronise; returns cudaGetLastError() (0 on success).
extern "C" int pathtrace_backward_lanes(
    int G, const fm::Params* p, const float* sph, const float* tri,
    const float* misc, const float* pl, const float* dl, const int32_t* ids,
    const float* xs, const float* ys, const float* cj, const float* ci,
    const int32_t* recs, const float* gr, const float* gg, const float* gb,
    float* partial, float* out, void* stream) {
  if (!valid_lanes(G)) return (int)cudaErrorInvalidValue;
  const fm::GradLayout lay = fm::grad_layout(*p);
  cudaStream_t s = (cudaStream_t)stream;
  if (p->n <= 0) {
    cudaError_t e = cudaMemsetAsync(out, 0, sizeof(float) * lay.total, s);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  const size_t smem = smem_bytes(*p);
  const int blocks = stage1_blocks(*p, G, smem);
  if (blocks == 0) {
    cudaError_t e = cudaGetLastError();
    return e != cudaSuccess ? (int)e : (int)cudaErrorInvalidConfiguration;
  }
  pathtrace_bwd_kernel<<<blocks, kThreads, smem, s>>>(
      *p, G, sph, tri, misc, pl, dl, ids, xs, ys, cj, ci, recs, gr, gg, gb,
      partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_kernel<<<(lay.total + 127) / 128, 128, 0, s>>>(partial, blocks,
                                                         lay.total, out);
  return (int)cudaGetLastError();
}

// The same with the launcher's kLanes lanes per sample.
extern "C" int pathtrace_backward(const fm::Params* p, const float* sph,
                                  const float* tri, const float* misc,
                                  const float* pl, const float* dl,
                                  const int32_t* ids, const float* xs,
                                  const float* ys, const float* cj,
                                  const float* ci, const int32_t* recs,
                                  const float* gr, const float* gg,
                                  const float* gb, float* partial, float* out,
                                  void* stream) {
  return pathtrace_backward_lanes(kLanes, p, sph, tri, misc, pl, dl,
                                  ids, xs, ys, cj, ci, recs, gr, gg, gb,
                                  partial, out, stream);
}
