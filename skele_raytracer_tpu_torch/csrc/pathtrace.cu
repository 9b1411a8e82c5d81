// Whole-frame path-trace kernel for small (non-mesh) scenes, for Hopper
// (sm_90a).
//
// Replaces: the JAX package's Pallas TPU kernel
//   skele_raytracer_tpu/ops/pallas/pathtrace.py::_build_kernel
// (body `_build_frame_math`, launched by `_pathtrace_call`), in both its
// variants: forward only, and with the per-(sample, bounce) hit records
// (`emit_records`) that feed the backward kernel (pathtrace_bwd.cu). The
// records variant is a template instance of the same kernel, so the
// forward-only instance keeps its code.
//
// Design. One thread renders one flat sample id: camera ray, threefry2x32
// draws, the nearest-sphere and nearest-triangle scans as runtime loops
// over the tables (S <= 256 spheres, T <= 32 triangles), Blinn-Phong with
// shadow scans, the fog reroute (F <= 2 volumes) and all P Monte-Carlo
// paths as a runtime loop. The math lives in frame_math.cuh. Each block
// first copies the five scene tables (a few KB) into dynamic shared
// memory and stages the scan rows there (fm::stage_scan): one 16-byte row
// per sphere, and the camera's rows for the primary scan. Every thread of
// a warp then reads the same row at the same time, a shared-memory
// broadcast. Nothing but r, g, b (and the records) goes to device memory.
//
// What bounds it on this card: instruction issue, almost all of it in the
// scans (at the 1080p parity headline 17 nearest-sphere scans of 16 rows
// per sample; in clean mode also 4 shadow scans per shading point), and
// the latency of each (ray, sphere) test's dependent chain (dot product,
// discriminant, IEEE square root, compare). There is no device-memory
// traffic to speak of. What the design does about it (frame_math.cuh's
// intersection notes): a row is one 128-bit load, not five 32-bit ones;
// the scan takes U rows at a time as independent chains and folds them in
// row order; a row that no lane of the warp can hit skips its square root
// (`warp_any`), in the nearest and the shadow scans alike; the primary
// scan starts from the camera's staged rows. None of it changes a
// rounding: the kernel gives the serial scan's bits, and the g++ host
// build runs the same order.
//
// Two instances per launch shape: a scene whose lights are all off
// (parity's quirk at the headline) takes one that holds none of the lights'
// code, so its register budget is the scans' alone. The launch shape and
// scan order below are the fastest of a sweep over launch shapes and rows
// per step on the H100 (PERF.md): 4 blocks of 256 threads per SM (64
// registers), U = 4 rows per step without lights and 1 with them. The scan
// rows stay in shared memory: one 128-bit load per row was faster than the
// constant bank's narrower loads. A shading point's shadow rays are scanned
// one light at a time: scanning several lights per pass over the rows, to
// share each row's o - c and c, was slower at every shape tried (PERF.md).
//
// Built with -fmad=false so each operation rounds as in the plain PyTorch
// version; letting nvcc contract to FMA is for later performance work,
// checked against the reference goldens.

#include <cuda_runtime.h>
#include <stdio.h>

#include "frame_math.cuh"

namespace {

// The kernel's launch shape: threads per block and the minimum resident
// blocks per SM given to __launch_bounds__ (4 blocks of 256 threads cap
// the registers at 64). Chosen from a sweep of launch shapes on the
// H100.
constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;

// kLit: p.point_on || p.dir_on (the launcher picks the instance); U rows
// per scan step; kT threads per block, kB minimum blocks per SM.
template <bool kRec, bool kLit, int U, int kT, int kB>
__global__ void __launch_bounds__(kT, kB)
    pathtrace_kernel(fm::Params p, const float* __restrict__ sph,
                     const float* __restrict__ tri,
                     const float* __restrict__ misc,
                     const float* __restrict__ pl,
                     const float* __restrict__ dl,
                     const int32_t* __restrict__ ids,
                     const float* __restrict__ xs,
                     const float* __restrict__ ys,
                     const float* __restrict__ cj,
                     const float* __restrict__ ci,
                     float* __restrict__ out_r, float* __restrict__ out_g,
                     float* __restrict__ out_b,
                     int32_t* __restrict__ recs,
                     const int64_t* __restrict__ seed_dev) {
  extern __shared__ fm::F4 smem[];
  fm::F4* s_rows = smem;        // [S] scan rows
  fm::F4* s_cam = smem + p.S;   // [S] the camera's rows
  const int n_sph = p.S * fm::SPH_W;
  const int n_tri = p.T * fm::TRI_W;
  const int n_misc = (1 + p.F) * fm::MISC_W;
  const int n_pl = p.L * fm::LIGHT_W;
  const int n_dl = p.LD * fm::LIGHT_W;
  // every table's size is a multiple of 4 floats: the triangle rows stay
  // 16-byte aligned (fm::tri_origin reads them as F4)
  float* s_sph = reinterpret_cast<float*>(smem + 2 * p.S);
  float* s_tri = s_sph + n_sph;
  float* s_misc = s_tri + n_tri;
  float* s_pl = s_misc + n_misc;
  float* s_dl = s_pl + n_pl;
  for (int i = threadIdx.x; i < n_sph; i += kT) s_sph[i] = sph[i];
  for (int i = threadIdx.x; i < n_tri; i += kT) s_tri[i] = tri[i];
  for (int i = threadIdx.x; i < n_misc; i += kT) s_misc[i] = misc[i];
  for (int i = threadIdx.x; i < n_pl; i += kT) s_pl[i] = pl[i];
  for (int i = threadIdx.x; i < n_dl; i += kT) s_dl[i] = dl[i];
  __syncthreads();
  const fm::Tables tb{s_sph, s_tri, s_misc, s_pl, s_dl};
  fm::stage_scan(p, tb, s_rows, s_cam, threadIdx.x, kT);
  __syncthreads();

  const int i = blockIdx.x * kT + threadIdx.x;
  if (i >= p.n) return;
  // a replayed graph's launch keeps the p it was captured with: its seed
  // comes from device memory, written before each replay
  fm::Params q = p;
  if (seed_dev != nullptr) q.seed = (uint32_t)*seed_dev;
  float out[3];
  fm::frame_sample<kRec, kLit, U>(q, tb, fm::MemRows{s_rows}, s_cam,
                                  (uint32_t)ids[i], xs[i], ys[i], cj[i],
                                  ci[i], out, recs + i, p.n);
  out_r[i] = out[0];
  out_g[i] = out[1];
  out_b[i] = out[2];
}

using Launch = int (*)(const fm::Params*, const float*, const float*,
                       const float*, const float*, const float*,
                       const int32_t*, const float*, const float*,
                       const float*, const float*, float*, float*, float*,
                       int32_t*, const int64_t*, cudaStream_t);

template <bool kRec, bool kLit, int U, int kT, int kB>
int launch(const fm::Params* p, const float* sph, const float* tri,
           const float* misc, const float* pl, const float* dl,
           const int32_t* ids, const float* xs, const float* ys,
           const float* cj, const float* ci, float* out_r, float* out_g,
           float* out_b, int32_t* recs, const int64_t* seed_dev,
           cudaStream_t stream) {
  const auto kernel = pathtrace_kernel<kRec, kLit, U, kT, kB>;
  const size_t smem =
      sizeof(fm::F4) * 2 * (size_t)p->S +
      sizeof(float) * ((size_t)p->S * fm::SPH_W + (size_t)p->T * fm::TRI_W +
                       (size_t)(1 + p->F) * fm::MISC_W +
                       (size_t)(p->L + p->LD) * fm::LIGHT_W);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (p->n + kT - 1) / kT;
  kernel<<<blocks, kT, smem, stream>>>(*p, sph, tri, misc, pl, dl, ids, xs,
                                       ys, cj, ci, out_r, out_g, out_b, recs,
                                       seed_dev);
  return (int)cudaGetLastError();
}

// One launch shape, in the instance without lights (U rows per scan
// step) or with them (UL rows) as the scene needs (p->point_on ||
// p->dir_on).
template <bool kRec, int U, int UL, int kT, int kB>
int launch_either(const fm::Params* p, const float* sph, const float* tri,
                  const float* misc, const float* pl, const float* dl,
                  const int32_t* ids, const float* xs, const float* ys,
                  const float* cj, const float* ci, float* out_r,
                  float* out_g, float* out_b, int32_t* recs,
                  const int64_t* seed_dev, cudaStream_t stream) {
  const Launch fn = p->point_on || p->dir_on
                        ? launch<kRec, true, UL, kT, kB>
                        : launch<kRec, false, U, kT, kB>;
  return fn(p, sph, tri, misc, pl, dl, ids, xs, ys, cj, ci, out_r, out_g,
            out_b, recs, seed_dev, stream);
}

}  // namespace

// Launches the kernel on `stream` over p->n samples; allocates nothing and
// does not synchronise. With `recs` non-null, the records variant also
// writes the [K, n] int32 hit records (K = 1 + P * (D - 1) with Monte-Carlo
// depth > 1, else 1). The stream's seed is `seed_dev`'s low word (a 0-d
// int64 on the device, read when the kernel runs, so that a CUDA graph's
// replay draws the seed written before it) or, when that is nullptr,
// p->seed. Returns cudaGetLastError() (0 on success).
extern "C" int pathtrace_forward(const fm::Params* p, const float* sph,
                                 const float* tri, const float* misc,
                                 const float* pl, const float* dl,
                                 const int32_t* ids, const float* xs,
                                 const float* ys, const float* cj,
                                 const float* ci, float* out_r, float* out_g,
                                 float* out_b, int32_t* recs,
                                 const int64_t* seed_dev, void* stream) {
  if (p->n <= 0) return (int)cudaGetLastError();
  constexpr int U = fm::SCAN_U, UL = fm::SCAN_U_LIT;
  const Launch fn = recs != nullptr
                        ? launch_either<true, U, UL, kThreads, kMinBlocks>
                        : launch_either<false, U, UL, kThreads, kMinBlocks>;
  return fn(p, sph, tri, misc, pl, dl, ids, xs, ys, cj, ci, out_r, out_g,
            out_b, recs, seed_dev, (cudaStream_t)stream);
}

extern "C" int pathtrace_params_size() { return (int)sizeof(fm::Params); }

// The kernel's scan order and launch shape ("U4 256x4, lit U1": rows per
// scan step, threads per block x minimum blocks per SM, and the lit
// instance's rows per step).
extern "C" const char* pathtrace_config() {
  static char name[32];
  snprintf(name, sizeof name, "U%d %dx%d, lit U%d", fm::SCAN_U, kThreads,
           kMinBlocks, fm::SCAN_U_LIT);
  return name;
}
