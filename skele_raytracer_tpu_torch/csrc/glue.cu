// The wavefront glue's integer chains as single launches, for Hopper
// (sm_90a): the ray sort keys and the threefry draws.
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "glue_math.cuh"

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
