// Host build of the glue kernels' per-ray math (glue_math.cuh,
// shade_math.cuh), for the CPU tests: g++ -O2 -ffp-contract=off -shared
// -fPIC. The functions take glue.cu's launchers' operands (host pointers, no
// stream) and run the same per-ray functions serially, so the tests hold
// them to the tensor code on a machine with no GPU.

#include <stdint.h>

#include "glue_math.cuh"
#include "shade_math.cuh"

extern "C" int glue_sort_keys_host(int n, int mode, int n_sc,
                                   int allow_negative, long long so0,
                                   long long so1, long long sd0,
                                   long long sd1, const float* o,
                                   const float* d, const float* live,
                                   const float* table, int64_t* keys) {
  if (n_sc < 0 || n_sc > gm::N_SUPER ||
      (mode == gm::KEY_FOOTPRINT && n_sc < 1) ||
      (mode != gm::KEY_FOOTPRINT && mode != gm::KEY_SPATIAL))
    return -1;
  for (int64_t i = 0; i < n; ++i) {
    float oi[3], di[3];
    for (int c = 0; c < 3; ++c) {
      oi[c] = o[i * so0 + c * so1];
      di[c] = d[i * sd0 + c * sd1];
    }
    keys[i] = (int64_t)gm::ray_key(mode, oi, di, table, n_sc,
                                   allow_negative != 0, live != nullptr,
                                   live != nullptr ? live[i] : 0.0f);
  }
  return 0;
}

extern "C" void glue_uniform_host(long long R, long long n, int ids_int64,
                                  const void* ids, const int64_t* seed_dev,
                                  unsigned seed, unsigned bounce,
                                  unsigned purpose, float* out) {
  const uint32_t s = seed_dev != nullptr ? (uint32_t)*seed_dev : seed;
  const long long m = (n + 1) / 2;
  for (long long r = 0; r < R; ++r) {
    const uint32_t id = ids_int64 ? (uint32_t)((const int64_t*)ids)[r]
                                  : (uint32_t)((const int32_t*)ids)[r];
    for (long long j = 0; j < m; ++j)
      gm::uniform_pair(s, bounce, purpose, id, (uint32_t)j, n, out + r * n);
  }
}

extern "C" void glue_shade_hit_host(const sh::ShadeArgs* a) {
  for (int64_t i = 0; i < a->R; ++i) sh::shade_hit_ray(*a, i);
}

extern "C" void glue_shade_direct_host(const sh::ShadeArgs* a) {
  for (int64_t i = 0; i < a->R; ++i) sh::shade_direct_ray(*a, i);
}

extern "C" long long glue_shade_args_bytes_host() {
  return (long long)sizeof(sh::ShadeArgs);
}
