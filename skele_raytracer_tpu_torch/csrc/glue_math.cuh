// Per-ray math of the wavefront glue's two integer chains (glue.cu): the
// ray sort keys of ops/cuda/culled.py (`_footprint_sort_keys`,
// `_spatial_sort_keys`, the dead-ray key) and the threefry draws of
// ops/sampling.py (`uniform`). Each function gives, bit for bit, what the
// int64 tensor ops there give; those stay the CPU path and the oracle.
//
// The keys' integer steps run on 64-bit words as the int64 tensors do
// (left shifts on the unsigned word, as PyTorch shifts an int64; every
// right shift here acts on a value already masked to 32 bits). The float
// steps (the slab test, 1/d, the quantisation to 255, the 3.999 ratio
// buckets) are single float operations, each rounded on its own
// (-fmad=false, -ffp-contract=off), in the tensor ops' order; min and max
// propagate NaN as torch.minimum, torch.maximum and amax do, and clamps
// keep NaN as torch.clamp does, so even a NaN ray keys as it did. Float to
// integer is the C cast, as PyTorch's `.to(torch.int64)`.
//
// The draws reuse frame_math.cuh's `draw2`, so K1, K2 and the glue share
// one generator.

#pragma once

#include "frame_math.cuh"

namespace gm {

constexpr int N_SUPER = 16;  // ops/cuda/culled.py N_SUPER
constexpr uint64_t MASK = 0xFFFFFFFFull;
constexpr uint64_t DEAD = MASK;  // the key of a dead ray: sorts last

// Key modes (ops/cuda/glue.py): the footprint key of the culled kernels,
// or the spatial key alone of the fused kernel's sort, where a ray given a
// live mask keys as spatial >> 1.
constexpr int KEY_FOOTPRINT = 0;
constexpr int KEY_SPATIAL = 1;

// torch.minimum / torch.maximum (and amax): NaN if either is NaN.
FM_FN float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
FM_FN float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

// torch.clamp(v, lo, hi) (hi may be +inf for clamp(min=lo)): NaN stays.
FM_FN float clamp_keep_nan(float v, float lo, float hi) {
  if (v != v) return v;
  v = v > lo ? v : lo;
  return v < hi ? v : hi;
}

// float -> int64 -> the unsigned word, as `.to(torch.int64)`.
FM_FN uint64_t to_word(float v) { return (uint64_t)(int64_t)v; }

// 8 bits -> every third bit of 24.
FM_FN uint64_t spread8(uint64_t v) {
  v = (v | (v << 8)) & 0x00F00Full;
  v = (v | (v << 4)) & 0x0C30C3ull;
  v = (v | (v << 2)) & 0x249249ull;
  return v;
}

// `_spatial_sort_keys` of one ray: a 7-bit direction bucket (octant and two
// 2-bit axis ratios) above a 24-bit Morton code of the origin quantised to
// the box [lo, hi].
FM_FN uint64_t spatial_key(const float o[3], const float d[3],
                           const float lo[3], const float hi[3]) {
  uint64_t q[3];
  for (int a = 0; a < 3; ++a) {
    const float span = clamp_keep_nan(hi[a] - lo[a], 1e-9f, INFINITY);
    q[a] = to_word(clamp_keep_nan((o[a] - lo[a]) / span * 255.0f, 0.0f,
                                  255.0f));
  }
  const uint64_t morton =
      (spread8(q[0]) << 2) | (spread8(q[1]) << 1) | spread8(q[2]);
  const uint64_t octant = (uint64_t)(d[0] > 0.0f) * 4 +
                          (uint64_t)(d[1] > 0.0f) * 2 +
                          (uint64_t)(d[2] > 0.0f);
  float ad[3];
  for (int a = 0; a < 3; ++a) ad[a] = fabsf(d[a]) + 1e-30f;
  const float dmax = nan_max(nan_max(ad[0], ad[1]), ad[2]);
  const uint64_t u1 = to_word(ad[1] / dmax * 3.999f);
  const uint64_t u2 = to_word(ad[2] / dmax * 3.999f);
  const uint64_t dbucket = (octant << 4) | (u1 << 2) | u2;
  return ((dbucket << 24) | morton) & MASK;
}

// accel.ray_aabb_entry's hit bit for one box (t_clip 0): the three slabs
// in order, pairwise min and max.
FM_FN bool enters(const float o[3], const float inv[3], const float* lo,
                  const float* hi, bool allow_negative) {
  float tmin = 0.0f, tmax = 0.0f;
  for (int a = 0; a < 3; ++a) {
    const float t0 = (lo[a] - o[a]) * inv[a];
    const float t1 = (hi[a] - o[a]) * inv[a];
    const float near = nan_min(t0, t1), far = nan_max(t0, t1);
    tmin = a == 0 ? near : nan_max(tmin, near);
    tmax = a == 0 ? far : nan_min(tmax, far);
  }
  return tmin <= tmax && (allow_negative || tmax > 0.0f);
}

// `_footprint_sort_keys` of one ray. `table` holds the n_sc supercluster
// boxes' lo [n_sc, 3], then their hi [n_sc, 3], then the mesh box's lo [3]
// and hi [3] (ops/cuda/culled.py `_key_table`).
FM_FN uint64_t footprint_key(const float o[3], const float d[3],
                             const float* table, int n_sc,
                             bool allow_negative) {
  float inv[3];
  for (int a = 0; a < 3; ++a)
    inv[a] = 1.0f / (fabsf(d[a]) > 1e-30f ? d[a] : 1e-30f);
  const float* sc_hi = table + 3 * n_sc;
  uint64_t scmask = 0;
  for (int k = 0; k < n_sc; ++k)
    if (enters(o, inv, table + 3 * k, sc_hi + 3 * k, allow_negative))
      scmask |= 1ull << k;
  const float* box = table + 6 * n_sc;
  const uint64_t spatial = spatial_key(o, d, box, box + 3);
  return ((scmask << (32 - n_sc)) & MASK) | (spatial >> n_sc);
}

// The key one ray sorts by: `mode`'s key, or DEAD where a live mask is
// given (`has_live`) and the ray's entry is not > 0.
FM_FN uint64_t ray_key(int mode, const float o[3], const float d[3],
                       const float* table, int n_sc, bool allow_negative,
                       bool has_live, float live) {
  if (has_live && !(live > 0.0f)) return DEAD;
  if (mode == KEY_FOOTPRINT)
    return footprint_key(o, d, table, n_sc, allow_negative);
  const float* box = table + 6 * n_sc;
  const uint64_t key = spatial_key(o, d, box, box + 3);
  return has_live ? key >> 1 : key;
}

// Draws 2*pair and 2*pair + 1 of `sampling.uniform` for one ray into
// `row` (its n draws), the second only where 2*pair + 1 < n.
FM_FN void uniform_pair(uint32_t seed, uint32_t bounce, uint32_t purpose,
                        uint32_t id, uint32_t pair, int64_t n, float* row) {
  float u0, u1;
  fm::draw2(seed, bounce, purpose, id, pair, &u0, &u1);
  row[2 * (int64_t)pair] = u0;
  if (2 * (int64_t)pair + 1 < n) row[2 * (int64_t)pair + 1] = u1;
}

}  // namespace gm
