// Per-pair math of the kernel lab (culled_lab.cu: L1 lab_v6, L2 lab_v5, L3
// lab_base, L4 lab_probe, L5 lab_flat, L6 lab_presplit), shared by the CUDA
// kernels and by the host build the CPU tests run (lab_math_host.cpp, g++
// -ffp-contract=off).
//
// The lab kernels are the JAX package's tools/ kernels (tools/lab_v5.py
// `_v6_kernel`, `_v5_kernel`; tools/kernel_lab.py `_lab_kernel`,
// `_flat_kernel`, `_presplit_kernel`; tools/lab_probe.py `_probe_kernel`):
// the nearest Moller-Trumbore hit of a
// 256-ray tile over its front-to-back cluster shortlist, cast as a product
// of the ray features
//   f = [d (0:3), w = o x d (3:6), o (6:9), 1 (9)]
// against per-cluster constant blocks K [rows][4 planes][cs] (planes det,
// u_num, v_num, t_num). Two layouts:
// * unfolded (L3, L4): rows = 9, tools/kernel_lab.py's `kc` [C, 9, 4, cs];
//   the epilogue subtracts kof from t_num and applies the mask, both read
//   from `aux` [C, 3, cs] (kof, mask, original index); L5 takes the same
//   rows zero-padded to 16 on the host (`launch_flat`'s kcf [C, 16, 4 cs])
//   and L6 each value split into bf16 hi and lo on the host
//   (`launch_presplit`'s kh, kl), both with `aux`;
// * folded (L1, L2): rows = 10, `launch_v6`'s k10 [C, 10, 4, cs]: row 9
//   (against the constant 1 feature) carries -kof into the t plane, and
//   masked columns are all zero (det = 0 fails |det| >= eps); `org`
//   [C, 1, cs] holds the original index (ops/cuda/lab.py `fold`, on the
//   host).
//
// Two products:
// * passes = 6, full FP32: each column as a mesh_math.cuh record
//   (`columns4`) and the four numerators summed term by term in its order
//   (mm::planes), so that every pair rounds as K3's plain version
//   (culled.culled_nearest_torch) rounds it;
// * passes = 3, bf16x3 (the TPU's `_plane_dot` with passes=3): features
//   and constants split into bf16 hi + lo (`split`), and the three products
//   hi.hi, hi.lo, lo.hi (lo.lo dropped), on tensor cores in the CUDA kernel
//   (mma.sync m16n8k16 bf16 -> f32; its order of accumulation is the
//   hardware's, so it matches the plain version to a tolerance, not
//   bitwise); `planes3` turns the four plane sums into the numerators.
// Two epilogues: the product form (`product_t`, K3's mm::culled_t with the
// clean near clip) and the sign-bit form (`thin_t`, tools/kernel_lab.py's
// `thin_epilogue`: u >= 0 <=> sign(u_num) == sign(det), by an XOR of sign
// bits; zero-safe).
//
// Every walk of a shortlist spreads a tile's walk over many blocks: the
// work items (a tile and a range of its groups; `item_at`) and the exact
// merge of their answers (`best_key`, `unpack_key`, `min_key`) are here
// too, and the tiles that each block of L4's one-group stream takes
// (`stream_tiles`, `stream_tile`).
//
// Everything here is what culled_lab.cu calls; the host build
// (lab_math_host.cpp) runs the same functions pair by pair for the CPU
// tests, which hold them bitwise against the plain version's pairs.

#pragma once

#include <stdint.h>
#include <string.h>

#include "mesh_math.cuh"

namespace lab {

constexpr int TILE = 256;        // rays per tile (tools/kernel_lab.py TILE_R)
constexpr int PLANES = 4;        // det, u_num, v_num, t_num
constexpr int ROWS_FOLDED = 10;  // k10: kc's 9 rows + the kof row
constexpr int ROWS_KC = 9;       // kc
constexpr int ROWS_FLAT = 16;    // kcf: kc's rows and 7 zero rows
constexpr int AUX_FOLDED = 1;    // org: original index
constexpr int AUX_KC = 3;        // aux: kof, mask, original index

// The probe's stages (tools/lab_probe.py `_probe_kernel`): the whole loop
// (every other kernel), one unconditional group, or the product and a
// cheap minimum (wrong on purpose, for timing).
enum Stage { kLoop = 0, kFull1 = 1, kMatmul = 2 };

MM_FN int32_t fbits(float x) {
  int32_t b;
  memcpy(&b, &x, sizeof b);
  return b;
}

MM_FN float from_bits(uint32_t b) {
  float x;
  memcpy(&x, &b, sizeof x);
  return x;
}

// Minimum and maximum that carry a NaN through, as jnp.minimum/maximum and
// torch.minimum/maximum do (fminf/fmaxf would drop it).
MM_FN float min_nan(float a, float b) {
  return (a != a || b != b) ? a + b : (b < a ? b : a);
}
MM_FN float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : (b > a ? b : a);
}

// x rounded to bf16 (round to nearest, ties to even: XLA's and PyTorch's
// float -> bfloat16 conversion) and widened back to float.
MM_FN float bf16_round(float x) {
  uint32_t b = (uint32_t)fbits(x);
  if ((b & 0x7fffffffu) > 0x7f800000u) return x;  // NaN stays NaN
  b += 0x7fffu + ((b >> 16) & 1u);
  return from_bits(b & 0xffff0000u);
}

// The bf16x3 split: hi = bf16(x), lo = bf16(x - hi) (x - hi is exact).
MM_FN void split(float x, float& hi, float& lo) {
  hi = bf16_round(x);
  lo = bf16_round(x - hi);
}

// Two bf16 values (already rounded, as floats) in one register, as an
// mma.sync fragment holds them: x in the low half (the lower k or column
// index), y in the high half.
MM_FN uint32_t pack2(float x, float y) {
  return ((uint32_t)fbits(x) >> 16) | ((uint32_t)fbits(y) & 0xffff0000u);
}

// L6's host-split table: each value x of kc as one 32-bit word holding
// bf16(x) (hi, low half) and bf16(x - hi) (lo, high half), the layout of a
// little-endian bf16 pair [hi, lo] (ops/cuda/lab.py `presplit`).
MM_FN uint32_t presplit_word(float x) {
  float hi, lo;
  split(x, hi, lo);
  return pack2(hi, lo);
}

// The hi and lo B-fragment registers of two rows' words w0 (the lower k)
// and w1: pack2(hi0, hi1) and pack2(lo0, lo1), as L3 packs the values it
// splits itself (two byte permutes on the card).
MM_FN uint32_t hi_pair(uint32_t w0, uint32_t w1) {
  return (w0 & 0xffffu) | (w1 << 16);
}
MM_FN uint32_t lo_pair(uint32_t w0, uint32_t w1) {
  return (w0 >> 16) | (w1 & 0xffff0000u);
}

// Four consecutive floats of p (16-byte aligned on the device: one
// vector load).
MM_FN void ld4(const float* p, float* q) {
#ifdef __CUDA_ARCH__
  const float4 v = *reinterpret_cast<const float4*>(p);
  q[0] = v.x;
  q[1] = v.y;
  q[2] = v.z;
  q[3] = v.w;
#else
  memcpy(q, p, 4 * sizeof(float));
#endif
}

// Record slot s < 18 of mesh_math.cuh as (row, plane) of a block: A (det,
// rows 0:3), B and -e2 (u, rows 0:6), -C and -e1 (v, rows 0:6), D (t, rows
// 6:9).
__host__ __device__ constexpr int slot_row(int s) {
  return s < 3 ? s : s < 9 ? s - 3 : s - 9;
}
__host__ __device__ constexpr int slot_plane(int s) {
  return s < 3 ? 0 : s < 9 ? 1 : s < 15 ? 2 : 3;
}

// Columns j..j+3 (j a multiple of 4) of a cluster block K [rows][4][cs]
// whose rows lie rs floats apart, with the block's aux rows A (cs floats
// apart: folded org; unfolded kof, mask, original index): each column as
// the 20-float record of mesh_math.cuh, and whether it is in the mesh
// (folded: always, masked columns are zero). Slot 18 is -kof (the folded
// block's row 9, or minus aux's kof; 0 without `with_kof`, the probe's
// product stage), slot 19 the original index. So mm::planes(f, r[e], -1)
// gives the lab's numerators: u_num = -(f . K[:, 1]) is sign * (...) with
// sign = -1, and x - kof rounds as x + (-kof).
MM_FN void columns4(const float* K, int rs, const float* A, int cs, int j,
                    bool folded, bool with_kof, float (&r)[4][mm::REC],
                    bool (&in)[4]) {
  float q[4];
#pragma unroll
  for (int s = 0; s < 18; ++s) {
    ld4(K + slot_row(s) * rs + slot_plane(s) * cs + j, q);
#pragma unroll
    for (int e = 0; e < 4; ++e) r[e][s] = q[e];
  }
  ld4(folded ? K + 9 * rs + 3 * cs + j : A + j, q);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    r[e][18] = folded ? q[e] : -(with_kof ? q[e] : 0.0f);
  ld4(A + (folded ? 0 : 2 * cs) + j, q);
#pragma unroll
  for (int e = 0; e < 4; ++e) r[e][19] = q[e];
  if (!folded) ld4(A + cs + j, q);
#pragma unroll
  for (int e = 0; e < 4; ++e) in[e] = folded || q[e] > 0.0f;
}

// Column j's side data from its block's aux rows A: kof (unfolded; 0
// folded, whose row 9 carries it), whether the triangle is in the mesh and
// its original index.
MM_FN void column_aux(const float* A, int cs, int j, bool folded,
                      float& kof, bool& in, float& orig) {
  kof = folded ? 0.0f : A[j];
  in = folded || A[cs + j] > 0.0f;
  orig = A[(folded ? 0 : 2 * cs) + j];
}

// passes = 3: the numerators of a pair from the bf16x3 product's four
// plane sums (f . K[:, plane] over det 0:3, u and v 0:6, t 6:9 and row 9
// when folded): u negated, and unfolded t_num - kof after the product.
MM_FN mm::Planes planes3(float det, float u, float v, float t, bool folded,
                         float kof) {
  mm::Planes p;
  p.det = det;
  p.u = -u;
  p.v = v;
  p.t = folded ? t : t - kof;
  return p;
}

// The product-form epilogue: t, or BIG where the pair misses.
MM_FN float product_t(const mm::Planes& p, float t_clip) {
  return mm::culled_t(p, true, t_clip);
}

// The sign-bit epilogue (tools/kernel_lab.py `thin_epilogue`): u >= 0 <=>
// sign(u_num) == sign(det) or u_num == 0, likewise v, and u + v <= 1 <=>
// the same for w = det - (u_num + v_num).
MM_FN float thin_t(const mm::Planes& p, float t_clip) {
  const bool ok = fabsf(p.det) >= mm::DET_EPS;
  const float w = p.det - (p.u + p.v);
  const int32_t bd = fbits(p.det);
  bool valid = ok && (((fbits(p.u) ^ bd) >= 0) || p.u == 0.0f) &&
               (((fbits(p.v) ^ bd) >= 0) || p.v == 0.0f) &&
               (((fbits(w) ^ bd) >= 0) || w == 0.0f);
  const float t = p.t / (ok ? p.det : 1.0f);
  valid = valid && (t > t_clip);
  return valid ? t : mm::BIG;
}

// A pair's t under the kernel's epilogue, with the unfolded mask. It is
// BIG or a t > t_clip (both epilogues end in `t > t_clip`, false for a
// NaN), so with t_clip >= 0 no NaN and no negative t reaches
// mm::nearest_update, and a best is (BIG, BIG_I) or a hit (t, index) with
// t_clip < t < BIG and index >= 0: what `best_key` needs.
MM_FN float pair_t(const mm::Planes& p, bool thin, bool masked_in,
                   float t_clip) {
  if (!masked_in) return mm::BIG;
  return thin ? thin_t(p, t_clip) : product_t(p, t_clip);
}

// The settle bound's other half: the ray's exit from the root box (the
// union of the cluster boxes), min over the axes of max((lo - o) / d,
// (hi - o) / d), with tools/kernel_lab.py's guarded reciprocal.
MM_FN float root_exit(const float* f, const float* root_lo,
                      const float* root_hi) {
  float te = 0.0f;
  for (int a = 0; a < 3; ++a) {
    const float inv = mm::inv_dir(f[a]);
    const float m = max_nan((root_lo[a] - f[6 + a]) * inv,
                            (root_hi[a] - f[6 + a]) * inv);
    te = a == 0 ? m : min_nan(te, m);
  }
  return te;
}

// ---- the split walk --------------------------------------------------------

// A ray's best (t, original index) as one 64-bit key, t's bits above the
// index's. For t >= +0 that is not NaN and an index >= 0, keys order as
// the pairs do lexicographically (non-negative floats order as their bit
// patterns), so the smallest key is mm::merge_nearest's answer, whatever
// order the keys come in. `pair_t` gives only such bests, and the miss
// (BIG, BIG_I) is the largest key of all.
static_assert(mm::BIG > 0.0f && mm::BIG_I > 0,
              "the miss must be the largest best key");
MM_FN uint64_t best_key(float t, int32_t idx) {
  return ((uint64_t)(uint32_t)fbits(t) << 32) | (uint32_t)idx;
}
MM_FN void unpack_key(uint64_t key, float& t, int32_t& idx) {
  t = from_bits((uint32_t)(key >> 32));
  idx = (int32_t)(uint32_t)key;
}
MM_FN uint64_t min_key(uint64_t a, uint64_t b) { return b < a ? b : a; }

// A tile's walk is ceil(n / G) groups of G clusters (n its shortlist's
// length). The split walk cuts it into work items of at most L groups:
// groups / L full items, then one shorter item if L does not divide them.
MM_FN int tile_groups(int n, int G) { return (n + G - 1) / G; }
MM_FN int full_items(int groups, int L) { return groups / L; }
MM_FN int rest_items(int groups, int L) { return groups % L != 0 ? 1 : 0; }

// A work item: groups p0 .. p1 - 1 of tile `tile`'s walk.
struct Item {
  int tile, p0, p1;
};

// Item `it` of the list that every tile's full items open, in tile order,
// and the shorter items close (the longest first). full_off and rest_off
// [T + 1] are the exclusive prefix sums over the tiles of full_items and
// rest_items (their last entries the totals); it < full_off[T] +
// rest_off[T].
MM_FN Item item_at(int it, const int32_t* full_off, const int32_t* rest_off,
                   const int32_t* counts, int T, int G, int L) {
  const bool full = it < full_off[T];
  const int32_t* off = full ? full_off : rest_off;
  const int j = full ? it : it - full_off[T];
  int lo = 0, hi = T;  // off[lo] <= j < off[hi]: the tile is the last lo
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (off[mid] <= j)
      lo = mid;
    else
      hi = mid;
  }
  Item r;
  r.tile = lo;
  if (full) {
    r.p0 = (j - off[lo]) * L;
    r.p1 = r.p0 + L;
  } else {
    const int g = tile_groups(counts[lo], G);
    r.p0 = g / L * L;
    r.p1 = g;
  }
  return r;
}

// ---- L4's one-group stream (its full1 and mm stages) -----------------------

// A persistent grid of `grid` blocks over T tiles: block b takes tiles b,
// b + grid, b + 2 grid, ... below T, `stream_tiles` of them, the k-th
// `stream_tile`; so every tile is taken once, by one block.
MM_FN int stream_tiles(int block, int grid, int T) {
  return block < T ? (T - block + grid - 1) / grid : 0;
}
MM_FN int stream_tile(int block, int grid, int k) { return block + k * grid; }

}  // namespace lab
