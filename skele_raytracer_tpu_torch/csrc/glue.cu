// The wavefront glue's chains as single launches, for Hopper (sm_90a): the
// ray sort keys and the threefry draws (integer chains), and the split
// route's hit shading before and after K4 (float chains).
//
// Replaces no TPU kernel: on the TPU these chains are XLA fusions of the
// jnp code (the JAX package's ops/pallas/culled.py `_footprint_sort_keys`
// and ops/sampling.py `uniform`). The port ran them as eager int64 tensor
// ops, inside each chunk's CUDA graph about 500 launches a split dragon
// chunk for the keys of four sorts and 182 for one call of the draws, each
// a few microseconds of launch and tail on 4,096 or 65,536 rays. Here each
// chain is one launch; the int64 tensor code (ops/cuda/culled.py,
// ops/sampling.py) stays the CPU path and the tests' oracle, and the
// per-ray math (glue_math.cuh) gives its bits exactly.
//
// What bounds them: neither has enough work to fill the card for long. A
// key is ~120 float and integer operations a ray for 16 slab tests plus
// the Morton and direction code, reading 24-28 B and writing 8 B a ray
// (65,536 rays: 2.4 MB, 0.7 us of device memory at 3.35 TB/s); a pair of
// draws is threefry's 20 rounds (~100 integer operations) for 8 B written.
// Their time is the launch and one wave of blocks, so the design only
// keeps each to one launch that allocates and synchronises nothing: one
// thread a ray (keys) or a pair of draws (grid-stride), the supercluster
// table staged in shared memory once per block, strided o and d read in
// place (a shadow wave's directions are one row expanded), and the seed
// read from device memory when a chunk's graph holds it there, so a
// replay with a new seed draws the new stream without a host copy.
//
// The hit shading (shade_math.cuh) replaces what models/integrator.py
// `_shade_hit` ran around K3 and K4 on the split route: about 170 float
// tensor operations a wave (the hit record after the scans, the material
// gather, K4's shadow-ray setup, the eager Blinn-Phong), each its own
// launch. G3 (`shade_hit_kernel`) runs before K4 and writes the hit record,
// the material and K4's operands; G4 (`shade_direct_kernel`) runs after it
// and writes the direct term. G3 reads ~40 B a ray besides the table rows
// it gathers (L2-resident) and writes ~100 B plus ~50 B a light; G4 reads
// ~80 B and writes 12 B: at 65,536 rays ~17 MB, ~5 us of device memory,
// so both are bounded by their launch and a wave of blocks. One thread a
// ray; G3 stages its rows of several floats (point, normal, material,
// K4's feature rows) through shared memory, a block's rows at a time, so
// that its stores are whole lines: written by each thread in place, a warp
// store touches 32 rows and the L2 takes ~8x the transactions.

#include <cuda_runtime.h>
#include <stdint.h>

#include "glue_math.cuh"
#include "shade_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // the draws' grid-stride cap

struct KeyArgs {
  int n, mode, n_sc, allow_negative;
  int64_t so0, so1, sd0, sd1;  // o's and d's strides, in floats
};

__global__ void __launch_bounds__(kThreads)
    sort_keys_kernel(KeyArgs a, const float* __restrict__ o,
                     const float* __restrict__ d,
                     const float* __restrict__ live,
                     const float* __restrict__ table,
                     int64_t* __restrict__ keys) {
  __shared__ float tab[6 * gm::N_SUPER + 6];
  for (int k = threadIdx.x; k < 6 * a.n_sc + 6; k += kThreads)
    tab[k] = table[k];
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  float oi[3], di[3];
  for (int c = 0; c < 3; ++c) {
    oi[c] = o[i * a.so0 + c * a.so1];
    di[c] = d[i * a.sd0 + c * a.sd1];
  }
  keys[i] = (int64_t)gm::ray_key(a.mode, oi, di, tab, a.n_sc,
                                 a.allow_negative != 0, live != nullptr,
                                 live != nullptr ? live[i] : 0.0f);
}

template <typename Id>
__global__ void __launch_bounds__(kThreads)
    uniform_kernel(int64_t R, int64_t m, int64_t n,
                   const Id* __restrict__ ids,
                   const int64_t* __restrict__ seed_dev, uint32_t seed,
                   uint32_t bounce, uint32_t purpose,
                   float* __restrict__ out) {
  const uint32_t s = seed_dev != nullptr ? (uint32_t)*seed_dev : seed;
  const int64_t total = R * m;
  for (int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * kThreads) {
    const int64_t r = t / m;
    gm::uniform_pair(s, bounce, purpose, (uint32_t)ids[r],
                     (uint32_t)(t - r * m), n, out + r * n);
  }
}

// Stores the block's rows of W floats (`mine`, one row a thread, the first
// n threads' rows) to out[0, n W) through shared memory, so that each warp
// store covers whole lines and not one float of 32 rows.
template <int W>
__device__ void store_rows(float* stage, const float* mine, float* out,
                           int n) {
  __syncthreads();  // the last rows are out of the stage
  if ((int)threadIdx.x < n)
    for (int c = 0; c < W; ++c) stage[threadIdx.x * W + c] = mine[c];
  __syncthreads();
  for (int k = threadIdx.x; k < n * W; k += kThreads) out[k] = stage[k];
}

__global__ void __launch_bounds__(kThreads)
    shade_hit_kernel(sh::ShadeArgs a) {
  __shared__ float stage[kThreads * sh::MAT];
  const int64_t i0 = (int64_t)blockIdx.x * kThreads, i = i0 + threadIdx.x;
  const int n = (int)(a.R - i0 < kThreads ? a.R - i0 : kThreads);
  sh::Hit h;
  if (i < a.R) {
    sh::hit_record(a, i, h);
    a.kind[i] = h.kind;
    a.index[i] = h.index;
    a.t[i] = h.t;
    a.shades[i] = sh::shades(a, h);
    a.miss[i] = h.kind == 0;
  }
  store_rows<3>(stage, h.p, a.point + 3 * i0, n);
  store_rows<3>(stage, h.n, a.normal + 3 * i0, n);
  store_rows<sh::MAT>(stage, h.mat, a.mat + sh::MAT * i0, n);
  if (!(a.flags & sh::K4_SHADOWS)) return;  // uniform across the block
  float row[10];
  if (a.flags & sh::POINT_BLOCK)
    for (int64_t l = 0; l < a.Lp; ++l) {
      if (i < a.R) a.bound_p[l * a.R + i] = sh::point_shadow_ray(a, h, l, row);
      store_rows<10>(stage, row, a.feats_p + 10 * (l * a.R + i0), n);
    }
  if (a.flags & sh::DIR_BLOCK)
    for (int64_t l = 0; l < a.Ld; ++l) {
      if (i < a.R) {
        sh::dir_shadow_ray(a, h, l, row);
        a.bound_d[l * a.R + i] = a.big;
      }
      store_rows<10>(stage, row, a.feats_d + 10 * (l * a.R + i0), n);
    }
  if (i < a.R) {
    const int64_t L = a.Lp > a.Ld ? a.Lp : a.Ld;
    for (int64_t l = 0; l < L; ++l) a.k4_live[l * a.R + i] = h.live;
  }
}

__global__ void __launch_bounds__(kThreads)
    shade_direct_kernel(sh::ShadeArgs a) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < a.R) sh::shade_direct_ray(a, i);
}

}  // namespace

// The sort keys of n rays: o, d [n, 3] float32 at strides (so0, so1),
// (sd0, sd1) in floats; live [n] float32 or nullptr; table [6 n_sc + 6]
// (glue_math.cuh footprint_key). mode gm::KEY_FOOTPRINT (1 <= n_sc <=
// gm::N_SUPER) or gm::KEY_SPATIAL (the mesh box at table + 6 n_sc). Writes
// keys [n] int64 as ops/cuda/culled.py's int64 code does. Launches on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a mode or n_sc it does
// not take.
extern "C" int glue_sort_keys(int n, int mode, int n_sc, int allow_negative,
                              long long so0, long long so1, long long sd0,
                              long long sd1, const float* o, const float* d,
                              const float* live, const float* table,
                              int64_t* keys, void* stream) {
  if (n_sc < 0 || n_sc > gm::N_SUPER ||
      (mode == gm::KEY_FOOTPRINT && n_sc < 1) ||
      (mode != gm::KEY_FOOTPRINT && mode != gm::KEY_SPATIAL))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const KeyArgs a{n, mode, n_sc, allow_negative, so0, so1, sd0, sd1};
  sort_keys_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                     (cudaStream_t)stream>>>(a, o, d, live, table, keys);
  return (int)cudaGetLastError();
}

// `sampling.uniform`'s draws: out [R, n] float32 for ids [R] (int64 when
// ids_int64, else int32), the stream's key from `seed_dev` (a 0-d int64 on
// the device, read when the kernel runs) or, when that is nullptr, `seed`.
// Launch and return as glue_sort_keys.
extern "C" int glue_uniform(long long R, long long n, int ids_int64,
                            const void* ids, const int64_t* seed_dev,
                            unsigned seed, unsigned bounce, unsigned purpose,
                            float* out, void* stream) {
  if (R <= 0 || n <= 0) return (int)cudaGetLastError();
  const long long m = (n + 1) / 2, total = R * m;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  const cudaStream_t st = (cudaStream_t)stream;
  if (ids_int64)
    uniform_kernel<int64_t><<<blocks, kThreads, 0, st>>>(
        R, m, n, (const int64_t*)ids, seed_dev, seed, bounce, purpose, out);
  else
    uniform_kernel<int32_t><<<blocks, kThreads, 0, st>>>(
        R, m, n, (const int32_t*)ids, seed_dev, seed, bounce, purpose, out);
  return (int)cudaGetLastError();
}

// G3 and G4 on a->R rays (shade_math.cuh ShadeArgs, read from host memory
// when the call is made, so a graph keeps the operands of its capture).
// Launch and return as glue_sort_keys.
extern "C" int glue_shade_hit(const sh::ShadeArgs* a, void* stream) {
  if (a->R <= 0) return (int)cudaGetLastError();
  shade_hit_kernel<<<(int)((a->R + kThreads - 1) / kThreads), kThreads, 0,
                     (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int glue_shade_direct(const sh::ShadeArgs* a, void* stream) {
  if (a->R <= 0) return (int)cudaGetLastError();
  shade_direct_kernel<<<(int)((a->R + kThreads - 1) / kThreads), kThreads,
                        0, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// sizeof(ShadeArgs), which ops/cuda/glue.py's ctypes mirror must match.
extern "C" long long glue_shade_args_bytes() {
  return (long long)sizeof(sh::ShadeArgs);
}
