// The kernel lab on Hopper (sm_90a): six nearest-hit kernels in the
// Plucker / matrix-product form of Moller-Trumbore, for measurement. No
// render path launches them; ops/cuda/lab.py wraps them and
// skele_raytracer_tpu_torch/tools/ times them.
//
// Replaces the JAX package's TPU lab kernels:
//   L1 lab_v6_kernel       tools/lab_v5.py::_v6_kernel (launch_v6)
//   L2 lab_v5_kernel       tools/lab_v5.py::_v5_kernel (launch_v5)
//   L3 lab_base_kernel     tools/kernel_lab.py::_lab_kernel (launch_lab)
//   L4 lab_probe_stream_kernel (its full1 and mm stages; its loop stage
//                          runs lab_base_kernel)
//                          tools/lab_probe.py::_probe_kernel (launch_probe)
//   L5 lab_flat_kernel     tools/kernel_lab.py::_flat_kernel (launch_flat)
//   L6 lab_presplit_kernel tools/kernel_lab.py::_presplit_kernel
//                          (launch_presplit)
//
// Each computes, for every ray of a 256-ray tile of a footprint-sorted
// batch, the nearest hit (t, original index; an exact-t tie to the lower
// index) over the tile's cluster shortlist, front to back, group_c
// clusters at a time, and stops once the next group's entry lies past the
// tile's settle bound (the block-wide maximum of each ray's min(best t,
// exit from the root box)). The shortlist (order, counts, entries) comes
// from the host, as on the TPU. L1 and L2 take the folded blocks (k10, org;
// lab_math.cuh), L3 and L4 the unfolded ones (kc, aux), L5 the unfolded
// ones padded to 16 rows on the host (kcf), L6 the unfolded ones split into
// bf16 hi and lo on the host (one 32-bit word per value: lab::presplit_word).
// L5 and L6 take no switch and settle after every group. Their switches:
// L1 per_group (merge the lanes after each cluster, the TPU's per-cluster
// epilogue), L2 split (tiles with counts <= group_c take one straight group
// without the settle; counts 0 a miss; L1 always), L3 thin (sign-bit
// epilogue), gate (no settle after the last group), no_exit, L4 stage (one
// unconditional group with or without the epilogue: wrong on purpose,
// timing only). None changes an output bit except L4's stages.
//
// Design. Every walk of a shortlist (L1, L2, L3, L5, L6 and L4's loop
// stage) takes the split walk: a tile's walk is cut into work items of at
// most item_groups groups (lab::item_at; every tile's full items first,
// then the shorter last ones), which a persistent grid of blocks (blocks
// per SM times the SMs) takes from an atomic counter, so that no long tile
// runs alone at the end of a launch; each item is walked by one block of
// 256 threads (a tile's rays) as a tile would be (the settle test from its
// own bests; L1's and L2's split control path: a tile with counts <=
// group_c is one item of one group, with no settle test and no barrier
// after it), and each ray's best is merged into a 64-bit key
// (lab::best_key: t's bits, then the index) with atomicMin: exact, and the
// same in any order of the items. Three kernels per call: lab_split_init
// (the keys, the items' prefix sums, the counter and the root box), the
// walk, lab_split_unpack. L4's full1 and mm stages have no walk to split:
// one unconditional group per tile, whose value (mm: a minimum of sums that
// may be negative or NaN) no key could order. They stream the tiles
// through a persistent grid (lab_stream: block b takes tiles b, b + grid,
// ...; lab::stream_tile), the ring holding the block's next tile's group
// in flight while the current one's product runs, no root box, and each
// ray's answer written once, straight to the outputs: one kernel per call;
// at passes = 3 each block splits the landed group's constants in place,
// once, into L6's words and reads L6's fragments.
// A group's cluster blocks (rows x 4 planes x cs floats, plus the aux
// rows) go into one of two shared-memory stages through the bulk
// asynchronous copy unit
// (cp.async.bulk: one copy per row, all completing on the stage's mbarrier
// with the group's byte count; cluster_walk.cuh's cw::Ring waits and
// drains), so group p + 1 loads while p is tested. Each staged row is
// padded by 4 floats so that the tensor-core path's fragment loads (rows
// 2q, 2q + 1 of eight columns) fall in 32 distinct banks.
// * passes = 6: one thread per ray; each pair's numerators in
//   mesh_math.cuh's order (lab::columns4's records, mm::planes) from
//   float4 loads of four columns at a time, bitwise equal to the plain
//   version.
// * passes = 3: bf16x3 on tensor cores, mma.sync.aligned.m16n8k16.row.col
//   .f32.bf16.bf16.f32. A warp holds 32 rays as two 16-row A tiles (the
//   10 features, padded to k = 16, split into hi and lo once per block) and
//   walks the group's columns 8 at a time: per column tile it splits the
//   four planes' constants into hi and lo B fragments, and for each A tile
//   and plane issues hi.lo, lo.hi and hi.hi into one FP32 accumulator
//   (lo.lo dropped). One MMA group per plane over the same 8 columns puts
//   det, u_num, v_num and t_num of a (ray, column) pair in the same lane
//   and register slot, so the epilogue runs in place; each lane keeps its
//   own best per ray, and a quad shuffle merges the 4 lanes of a row.
// * L5 (the TPU's flat blocks): every row of a fragment is staged (rows 9-15
//   are the host's zeros), so its fragment loads carry no row guard; at p6
//   it reads rows 0-8 as L3 does. Two stages of 4 clusters of 16 padded
//   rows (276,480 B) would not fit a block's 232,448 B, so at G = 4 it
//   stages one group at a time (one stage, 138,240 B: the group's copy no
//   longer overlaps the previous group's tests); at G 1 and 2, two stages.
// * L6 (p3 only): the B fragments come from the host's words with two byte
//   permutes per register (lab::hi_pair, lo_pair) in place of L3's split
//   of each constant; staging, walk, MMA order and epilogue are L3's, and
//   the staged bytes too (a word holds hi and lo in the bytes of a float).
// L5 and L6 feed the tensor cores L3's fragments bit for bit, so their p3
// answers are L3 p3's.
// What bounds it: the pairs of the walk (256 rays x the tile's shortlisted
// columns) times the epilogue on the FP32 cores (a division and ~15
// operations per pair), and at passes = 6 the 34 product operations too;
// at passes = 3 the product is 3 x 4 MMAs per 16 x 8 pairs (tensor rate)
// plus the split of the constants per warp (L4's stream: once per block).
// Device memory is small (44 B per ray, the shortlist tables, the
// clusters' blocks once per group from L2).
//
// Built with -fmad=false so that every operation rounds as in the plain
// version.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "cluster_walk.cuh"
#include "lab_math.cuh"

namespace {

constexpr int kThreads = lab::TILE;  // a block holds a tile's rays
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;  // floats after each staged row of 4 cs floats
constexpr int kFeat = 10;

struct LabArgs {
  int n_tiles;  // tiles of lab::TILE rays
  int C;        // clusters
  int cs;       // triangles per cluster (a multiple of 8)
  int thin, gate, no_exit, split, per_group, stage;
  float t_clip;
};

// The cluster blocks' layouts: L3/L4 kc, L1/L2 k10, L5 kcf, L6 the words.
enum Layout { kKc = 0, kFolded = 1, kFlat = 2, kPresplit = 3 };

__host__ __device__ constexpr int rows_of(int L) {
  return L == kFolded ? lab::ROWS_FOLDED
                      : L == kFlat ? lab::ROWS_FLAT : lab::ROWS_KC;
}
__host__ __device__ constexpr int aux_rows_of(int L) {
  return L == kFolded ? lab::AUX_FOLDED : lab::AUX_KC;
}
// Stages of the ring: two, but one for L5's 16-row blocks at G = 4 (two
// would not fit).
__host__ __device__ constexpr int stages_of(int L, int G) {
  return L == kFlat && G == 4 ? 1 : 2;
}

// Floats (L6: words) of one staged cluster: the padded rows, then the aux
// rows.
__host__ __device__ inline int cluster_floats(int cs, int L) {
  return rows_of(L) * (lab::PLANES * cs + kPad) + aux_rows_of(L) * cs;
}

__device__ inline void bulk_copy(float* dst, const float* src,
                                 uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(cw::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Every thread: the ring's next load brings group p of the tile's
// shortlist (clusters order_row[min(p G + g, C - 1)], g < G, as the TPU
// clamps); thread 0 arms the stage's barrier with the group's bytes and
// starts one copy per row. The stage's earlier readers have passed a block
// barrier. A one-stage ring (floats 0) loads every group into stage 0.
template <int L>
__device__ void fetch_group(cw::Ring& ring, const float* K, const float* aux,
                            const int32_t* order_row, int p, int G,
                            const LabArgs& a) {
  const int k = ring.started & 1;
  if (threadIdx.x == 0) {
    constexpr int rows = rows_of(L);
    const int rs = lab::PLANES * a.cs;
    const int cl = cluster_floats(a.cs, L);
    const uint32_t row_bytes = (uint32_t)(rs * sizeof(float));
    const uint32_t aux_bytes =
        (uint32_t)(aux_rows_of(L) * a.cs * sizeof(float));
    const uint32_t bar = cw::smem_addr(ring.bar + k);
    const uint32_t total = (uint32_t)G * (rows * row_bytes + aux_bytes);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                     "r"(bar),
                 "r"(total)
                 : "memory");
    float* dst = ring.buf + k * ring.floats;
    for (int g = 0; g < G; ++g) {
      const int slot = min(p * G + g, a.C - 1);
      const int ci = order_row[slot];
      const float* src = K + (size_t)ci * rows * rs;
      float* d = dst + g * cl;
      for (int r = 0; r < rows; ++r)
        bulk_copy(d + r * (rs + kPad), src + r * rs, row_bytes, bar);
      bulk_copy(d + rows * (rs + kPad),
                aux + (size_t)ci * aux_rows_of(L) * a.cs, aux_bytes, bar);
    }
  }
  ++ring.started;
}

// passes = 6: thread `r` of the block folds every column of the staged
// group into its ray's best (t, index), four columns per step
// (lab::columns4's vector loads).
template <int G, int L>
__device__ __forceinline__ void scalar_group(const float* st, const float* f,
                                             const LabArgs& a, float& tb,
                                             int32_t& ib) {
  constexpr int rows = rows_of(L);
  constexpr bool folded = L == kFolded;
  const int cs = a.cs;
  const int srs = lab::PLANES * cs + kPad;
  const int cl = cluster_floats(cs, L);
  const bool mm_stage = a.stage == lab::kMatmul;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float* Kc = st + g * cl;
    const float* Ac = Kc + rows * srs;
    for (int j = 0; j < cs; j += 4) {
      float rec[4][mm::REC];
      bool in[4];
      // the probe's product stage takes the t plane before kof; L5 reads
      // rows 0-8 of its 16
      lab::columns4(Kc, srs, Ac, cs, j, folded, !mm_stage, rec, in);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const mm::Planes q = mm::planes(f, rec[e], -1.0f);
        if (mm_stage) {
          tb = lab::min_nan(tb, q.det + q.t);
          continue;
        }
        mm::nearest_update(lab::pair_t(q, a.thin, in[e], a.t_clip),
                           (int32_t)rec[e][19], tb, ib);
      }
    }
  }
}

// ---- the tensor-core path (passes = 3) ----------------------------------

// d += a b for one m16n8k16 tile: bf16 inputs, FP32 accumulator.
__device__ inline void mma_bf16(float* d, const uint32_t* a,
                                const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Merges the best (t, index) of the 4 lanes of each quad (a row's 8
// columns are spread over them), or their minimum in the probe's product
// stage; afterwards every lane of the quad holds the row's answer.
template <int NR>
__device__ inline void quad_merge(float* tb, int32_t* ib, bool mm_stage) {
#pragma unroll
  for (int k = 0; k < NR; ++k)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float t_o = __shfl_xor_sync(0xffffffffu, tb[k], off);
      const int32_t i_o = __shfl_xor_sync(0xffffffffu, ib[k], off);
      if (mm_stage)
        tb[k] = lab::min_nan(tb[k], t_o);
      else
        mm::merge_nearest(tb[k], ib[k], t_o, i_o);
    }
}

// passes = 3: the warp's 32 rays (two A tiles: ahi/alo [2][4]) against
// every column of the staged group. Lane (g = lane / 4, q = lane % 4)
// keeps rays g and g + 8 of each A tile: slot k = 2 tile + half.
template <int G, int L>
__device__ __forceinline__ void mma_group(const float* st,
                                          const uint32_t (&ahi)[2][4],
                                          const uint32_t (&alo)[2][4],
                                          const LabArgs& a, float* tb,
                                          int32_t* ib) {
  constexpr int rows = rows_of(L);
  constexpr bool folded = L == kFolded;
  const int cs = a.cs;
  const int srs = lab::PLANES * cs + kPad;
  const int cl = cluster_floats(cs, L);
  const int lane = threadIdx.x % 32;
  const int g8 = lane >> 2, q = lane & 3;
  const bool mm_stage = a.stage == lab::kMatmul;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float* Kc = st + g * cl;
    const float* Ac = Kc + rows * srs;
    for (int j0 = 0; j0 < cs; j0 += 8) {
      // B fragments: rows 2q, 2q + 1 (b0) and 2q + 8, 2q + 9 (b1) of column
      // j0 + g8, per plane, in hi and lo: rows past the block's are 0, but
      // L5's block holds all 16 (no guard); L6 unpacks the host's words,
      // the others split the constants here
      uint32_t bh[lab::PLANES][2], bl[lab::PLANES][2];
#pragma unroll
      for (int pl = 0; pl < lab::PLANES; ++pl)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r0 = 2 * q + 8 * h;
          const bool in0 = L == kFlat || r0 < rows;
          const bool in1 = L == kFlat || r0 + 1 < rows;
          const float* col = Kc + pl * cs + j0 + g8;
          if constexpr (L == kPresplit) {
            const uint32_t w0 = in0 ? (uint32_t)lab::fbits(col[r0 * srs]) : 0u;
            const uint32_t w1 =
                in1 ? (uint32_t)lab::fbits(col[(r0 + 1) * srs]) : 0u;
            bh[pl][h] = lab::hi_pair(w0, w1);
            bl[pl][h] = lab::lo_pair(w0, w1);
          } else {
            const float x0 = in0 ? col[r0 * srs] : 0.0f;
            const float x1 = in1 ? col[(r0 + 1) * srs] : 0.0f;
            float h0, l0, h1, l1;
            lab::split(x0, h0, l0);
            lab::split(x1, h1, l1);
            bh[pl][h] = lab::pack2(h0, h1);
            bl[pl][h] = lab::pack2(l0, l1);
          }
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float acc[lab::PLANES][4];
#pragma unroll
        for (int pl = 0; pl < lab::PLANES; ++pl) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[pl][e] = 0.0f;
          mma_bf16(acc[pl], ahi[mt], bl[pl]);
          mma_bf16(acc[pl], alo[mt], bh[pl]);
          mma_bf16(acc[pl], ahi[mt], bh[pl]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 2 * mt + (e >> 1);
          const int c = j0 + 2 * q + (e & 1);
          if (mm_stage) {
            tb[k] = lab::min_nan(tb[k], acc[0][e] + acc[3][e]);
            continue;
          }
          float kof, orig;
          bool in;
          lab::column_aux(Ac, cs, c, folded, kof, in, orig);
          const mm::Planes pq = lab::planes3(acc[0][e], acc[1][e], acc[2][e],
                                             acc[3][e], folded, kof);
          mm::nearest_update(lab::pair_t(pq, a.thin, in, a.t_clip),
                             (int32_t)orig, tb[k], ib[k]);
        }
      }
    }
    if (a.per_group) quad_merge<4>(tb, ib, mm_stage);
  }
  quad_merge<4>(tb, ib, mm_stage);
}

// ---- the split walk (L1, L2, L3, L5, L6, L4's loop) ----------------------

// The rows of its tile that a thread holds: passes = 3 four, rays
// (lane / 4) + 8 k' of its warp's two 16-ray A tiles; passes = 6 its own.
template <int PASSES, int NR>
__device__ __forceinline__ void thread_rows(int (&ray)[NR]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < NR; ++k)
    ray[k] = PASSES == 3
                 ? 32 * warp + 16 * (k >> 1) + (lane >> 2) + 8 * (k & 1)
                 : (int)threadIdx.x;
}

// The thread's rays of the tile at row `base`: with EXIT, each one's exit
// from the root box [root_lo, root_hi] (`texit`; without, texit and the
// box are not read); passes = 6 its ray's features (`f`); passes = 3 the A
// fragments of the warp's two 16-ray tiles, hi and lo: register r holds
// row (lane / 4) + 8 (r & 1), features 2q + 8 (r >> 1) and the next (0
// past the 10th).
template <int PASSES, int NR, bool EXIT = true>
__device__ __forceinline__ void load_rays(
    const float* __restrict__ feats, size_t base, const int (&ray)[NR],
    const float* root_lo, const float* root_hi, float (&texit)[NR],
    float (&f)[kFeat], uint32_t (&ahi)[2][4], uint32_t (&alo)[2][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < NR; ++k) {
    float fr[kFeat];
#pragma unroll
    for (int c = 0; c < kFeat; ++c) fr[c] = feats[(base + ray[k]) * kFeat + c];
    if constexpr (EXIT) texit[k] = lab::root_exit(fr, root_lo, root_hi);
    if (PASSES == 6)
#pragma unroll
      for (int c = 0; c < kFeat; ++c) f[c] = fr[c];
  }
  if (PASSES == 3) {
    const int q = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const size_t row = base + 32 * warp + 16 * mt + (lane >> 2) +
                           8 * (r & 1);
        const int c0 = 2 * q + 8 * (r >> 1);
        const float x0 = c0 < kFeat ? feats[row * kFeat + c0] : 0.0f;
        const float x1 = c0 + 1 < kFeat ? feats[row * kFeat + c0 + 1] : 0.0f;
        float h0, l0, h1, l1;
        lab::split(x0, h0, l0);
        lab::split(x1, h1, l1);
        ahi[mt][r] = lab::pack2(h0, h1);
        alo[mt][r] = lab::pack2(l0, l1);
      }
  }
}

// Groups p0 .. p1 - 1 (p0 < p1) of a tile's walk (order_row: its
// shortlist; ent_row: its sorted entries) folded into the thread's bests
// (tb, ib), through the ring: the first one or two loads start here, each
// later one once its stage is free. After a group (unless no_exit, or
// gate after the range's last group, or `once` on the folded blocks: L1's
// and L2's split control path, whose range is a tile's only group) the
// settle test: stop once the next group's entry lies past the block's
// largest min(best t, root exit). Loads may be in flight at the end: the
// caller drains.
template <int PASSES, int G, int L, int NR>
__device__ __forceinline__ void walk_groups(
    cw::Ring& ring, const LabArgs& a, const float* __restrict__ K,
    const float* __restrict__ aux, const int32_t* order_row,
    const float* ent_row, int p0, int p1, const float (&texit)[NR],
    const float (&f)[kFeat], const uint32_t (&ahi)[2][4],
    const uint32_t (&alo)[2][4], float (&tb)[NR], int32_t (&ib)[NR],
    float (*s_red)[kWarps], bool once) {
  constexpr int S = stages_of(L, G);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  fetch_group<L>(ring, K, aux, order_row, p0, G, a);
  if (S == 2 && p1 - p0 > 1)
    fetch_group<L>(ring, K, aux, order_row, p0 + 1, G, a);
  for (int p = p0; p < p1; ++p) {
    const float* st = ring.wait();
    if constexpr (PASSES == 3)
      mma_group<G, L>(st, ahi, alo, a, tb, ib);
    else
      scalar_group<G, L>(st, f, a, tb[0], ib[0]);
    const bool last = p + 1 >= p1;
    if (!(L == kFolded && once) && !a.no_exit && !(a.gate && last)) {
      // the settle bound: the tile's largest min(best t, root exit)
      float v = lab::min_nan(tb[0], texit[0]);
#pragma unroll
      for (int k = 1; k < NR; ++k)
        v = lab::max_nan(v, lab::min_nan(tb[k], texit[k]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = lab::max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) s_red[p & 1][warp] = v;
      __syncthreads();  // also: every thread is done with this stage
      float settle = s_red[p & 1][0];
      for (int w = 1; w < kWarps; ++w)
        settle = lab::max_nan(settle, s_red[p & 1][w]);
      const int nxt = min((p + 1) * G, a.C);
      if (ent_row[nxt] > settle) break;
    } else if (!last) {
      __syncthreads();  // every thread is done with this stage
    }
    if (last) break;
    if (p + S < p1) fetch_group<L>(ring, K, aux, order_row, p + S, G, a);
  }
}

// The split walk's scratch, written by lab_split_init inside each call
// (`split_work` lays it out in the wrapper's buffer): each ray's best key
// (lab::best_key), the work items' prefix sums (lab::item_at), the next
// item to take and the root box.
struct SplitWork {
  unsigned long long* keys;  // [n_tiles 256]
  int32_t* full_off;         // [n_tiles + 1]
  int32_t* rest_off;         // [n_tiles + 1]
  int32_t* next;             // [1]
  float* root;               // [6]: lo, hi
  int L;                     // groups per item at most
};

// A persistent block: takes work items (a tile and a range of its groups)
// from the counter until none is left, walks each as the whole tile's walk
// would go (the settle test from the item's own bests: a best can only
// lower the bound, so an item stops only where the whole walk would), and
// merges each ray's best into its key with a 64-bit atomicMin, exact and
// independent of the order of the items.
template <int PASSES, int G, int L>
__device__ __forceinline__ void lab_items(
    const LabArgs& a, const float* __restrict__ feats,
    const int32_t* __restrict__ order, const int32_t* __restrict__ counts,
    const float* __restrict__ ent, const float* __restrict__ K,
    const float* __restrict__ aux, const SplitWork& w) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t s_bar[2];
  __shared__ float s_red[2][kWarps];
  __shared__ int s_item[2][3];  // tile (-1: none left), p0, p1
  constexpr int NR = PASSES == 3 ? 4 : 1;
  const int tid = threadIdx.x;
  const int T = a.n_tiles;
  int ray[NR];
  thread_rows<PASSES>(ray);
  const bool writer = PASSES == 3 ? ((tid % 32) & 3) == 0 : true;

  constexpr int S = stages_of(L, G);
  float* stage_buf = reinterpret_cast<float*>(smem4);
  cw::Ring ring{stage_buf, s_bar, S == 2 ? G * cluster_floats(a.cs, L) : 0};
  ring.init();
  for (int k = 0;; ++k) {
    int* si = s_item[k & 1];
    if (tid == 0) {
      const int it = atomicAdd(w.next, 1);
      si[0] = -1;
      if (it < w.full_off[T] + w.rest_off[T]) {
        const lab::Item item =
            lab::item_at(it, w.full_off, w.rest_off, counts, T, G, w.L);
        si[0] = item.tile;
        si[1] = item.p0;
        si[2] = item.p1;
      }
    }
    // the item; the ring's barriers (first time); every thread is done
    // with the previous item's stages and with s_item[(k + 1) & 1]
    __syncthreads();
    const int tile = si[0];
    if (tile < 0) break;
    const size_t base = (size_t)tile * lab::TILE;
    float tb[NR];
    int32_t ib[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      tb[r] = mm::BIG;
      ib[r] = mm::BIG_I;
    }
    float texit[NR];
    float f[kFeat];
    uint32_t ahi[2][4], alo[2][4];
    load_rays<PASSES>(feats, base, ray, w.root, w.root + 3, texit, f, ahi,
                      alo);
    bool once = false;  // L1, L2: the split control path
    if constexpr (L == kFolded) once = a.split && counts[tile] <= G;
    walk_groups<PASSES, G, L>(ring, a, K, aux, order + (size_t)tile * a.C,
                              ent + (size_t)tile * (a.C + 1), si[1], si[2],
                              texit, f, ahi, alo, tb, ib, s_red, once);
    ring.drain();
    if (writer)
#pragma unroll
      for (int r = 0; r < NR; ++r)
        if (tb[r] < mm::BIG)  // a miss leaves the key as it is
          atomicMin(w.keys + base + ray[r],
                    (unsigned long long)lab::best_key(tb[r], ib[r]));
  }
}

// The split walk's first kernel: every key the miss's; block 0 also the
// root box (the union of the cluster boxes), the counter and the items'
// prefix sums over the tiles (each thread a run of tiles, a scan over the
// threads).
__global__ void __launch_bounds__(kThreads)
    lab_split_init(int T, int C, int G, const int32_t* __restrict__ counts,
                   const float* __restrict__ lo,
                   const float* __restrict__ hi, SplitWork w) {
  __shared__ int s_full[kThreads], s_rest[kThreads];
  const int tid = threadIdx.x;
  const size_t R = (size_t)T * lab::TILE;
  const unsigned long long miss = lab::best_key(mm::BIG, mm::BIG_I);
  for (size_t i = (size_t)blockIdx.x * kThreads + tid; i < R;
       i += (size_t)gridDim.x * kThreads)
    w.keys[i] = miss;
  if (blockIdx.x != 0) return;
  if (tid < 3) {
    float m = lo[tid];
    for (int c = 1; c < C; ++c) m = lab::min_nan(m, lo[c * 3 + tid]);
    w.root[tid] = m;
  } else if (tid < 6) {
    float m = hi[tid - 3];
    for (int c = 1; c < C; ++c) m = lab::max_nan(m, hi[c * 3 + tid - 3]);
    w.root[tid] = m;
  } else if (tid == 6) {
    *w.next = 0;
  }
  const int run = (T + kThreads - 1) / kThreads;
  const int t0 = min(T, tid * run), t1 = min(T, t0 + run);
  int nf = 0, nr = 0;
  for (int t = t0; t < t1; ++t) {
    const int g = lab::tile_groups(counts[t], G);
    nf += lab::full_items(g, w.L);
    nr += lab::rest_items(g, w.L);
  }
  s_full[tid] = nf;
  s_rest[tid] = nr;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {  // inclusive scan
    const int vf = tid >= off ? s_full[tid - off] : 0;
    const int vr = tid >= off ? s_rest[tid - off] : 0;
    __syncthreads();
    s_full[tid] += vf;
    s_rest[tid] += vr;
    __syncthreads();
  }
  int of = s_full[tid] - nf, orr = s_rest[tid] - nr;
  for (int t = t0; t < t1; ++t) {
    w.full_off[t] = of;
    w.rest_off[t] = orr;
    const int g = lab::tile_groups(counts[t], G);
    of += lab::full_items(g, w.L);
    orr += lab::rest_items(g, w.L);
  }
  if (tid == kThreads - 1) {
    w.full_off[T] = s_full[tid];
    w.rest_off[T] = s_rest[tid];
  }
}

// The split walk's last kernel: each ray's key as (t, index).
__global__ void __launch_bounds__(kThreads)
    lab_split_unpack(int R, const unsigned long long* __restrict__ keys,
                     float* __restrict__ out_t, int32_t* __restrict__ out_i) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < R;
       i += gridDim.x * kThreads)
    lab::unpack_key(keys[i], out_t[i], out_i[i]);
}

// ---- one group per tile (L4's full1 and mm stages) -----------------------

// passes = 3: every constant of the landed group (its clusters' 9 rows of
// 4 cs floats; not the pads or the aux rows) rewritten in place as L6's
// word (lab::presplit_word), so that each value is split once per block
// where mma_group<G, kKc> splits it once per warp; the caller's barrier
// publishes the words. lab::hi_pair and lo_pair of the words are L3's
// fragments bit for bit (lab_math_host.cpp lab_fragments_host). Each
// thread's proxy fence orders its writes before the bulk copy that later
// refills the stage (fetch_group, after a block barrier).
template <int G>
__device__ __forceinline__ void split_in_place(float* st, int cs) {
  const int row4 = lab::PLANES * cs / 4;  // float4s of a row
  const int srs = lab::PLANES * cs + kPad;
  const int cl = cluster_floats(cs, kKc);
  for (int i = threadIdx.x; i < G * lab::ROWS_KC * row4; i += kThreads) {
    const int r = i / row4;  // cluster r / 9, row r % 9
    float4* p = reinterpret_cast<float4*>(st + (r / lab::ROWS_KC) * cl +
                                          (r % lab::ROWS_KC) * srs) +
                i % row4;
    float4 v = *p;
    v.x = lab::from_bits(lab::presplit_word(v.x));
    v.y = lab::from_bits(lab::presplit_word(v.y));
    v.z = lab::from_bits(lab::presplit_word(v.z));
    v.w = lab::from_bits(lab::presplit_word(v.w));
    *p = v;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// L4's full1 and mm stages (a.stage): group 0 of every tile's shortlist
// (a tile whose shortlist is empty too, as the TPU kernel takes it), with
// no loop, no settle test and no root box. Block b of the persistent grid
// takes tiles lab::stream_tile(b, gridDim.x, k) in turn; the ring holds
// the next tile's group in flight while the current one's product runs,
// and each ray's answer goes straight to out_t, out_i (its one writer).
template <int PASSES, int G>
__device__ __forceinline__ void lab_stream(
    const LabArgs& a, const float* __restrict__ feats,
    const int32_t* __restrict__ order, const float* __restrict__ K,
    const float* __restrict__ aux, float* __restrict__ out_t,
    int32_t* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t s_bar[2];
  constexpr int NR = PASSES == 3 ? 4 : 1;
  const int b = blockIdx.x, grid = gridDim.x;
  const int n = lab::stream_tiles(b, grid, a.n_tiles);
  const auto order_row = [&](int k) {
    return order + (size_t)lab::stream_tile(b, grid, k) * a.C;
  };
  int ray[NR];
  thread_rows<PASSES>(ray);
  const bool writer = PASSES == 3 ? ((threadIdx.x % 32) & 3) == 0 : true;
  cw::Ring ring{reinterpret_cast<float*>(smem4), s_bar,
                G * cluster_floats(a.cs, kKc)};
  ring.init();
  __syncthreads();  // the ring's barriers
  for (int k = 0; k < n && k < 2; ++k)
    fetch_group<kKc>(ring, K, aux, order_row(k), 0, G, a);
  for (int k = 0; k < n; ++k) {
    const size_t base = (size_t)lab::stream_tile(b, grid, k) * lab::TILE;
    float tb[NR];
    int32_t ib[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      tb[r] = mm::BIG;
      ib[r] = mm::BIG_I;
    }
    float texit[NR];  // not computed: no settle test
    float f[kFeat];
    uint32_t ahi[2][4], alo[2][4];
    load_rays<PASSES, NR, false>(feats, base, ray, nullptr, nullptr, texit, f,
                                 ahi, alo);
    float* st = const_cast<float*>(ring.wait());
    if constexpr (PASSES == 6) {
      scalar_group<G, kKc>(st, f, a, tb[0], ib[0]);
    } else {
      split_in_place<G>(st, a.cs);
      __syncthreads();  // the words
      mma_group<G, kPresplit>(st, ahi, alo, a, tb, ib);
    }
    if (writer)
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        out_t[base + ray[r]] = tb[r];
        out_i[base + ray[r]] = ib[r];
      }
    if (k + 2 < n) {
      __syncthreads();  // every thread is done with this stage
      fetch_group<kKc>(ring, K, aux, order_row(k + 2), 0, G, a);
    }
  }
}

#define ITEM_ARGS                                                         \
  LabArgs a, const float* __restrict__ feats,                             \
      const int32_t* __restrict__ order, const int32_t* __restrict__ counts, \
      const float* __restrict__ ent, const float* __restrict__ K,         \
      const float* __restrict__ aux, SplitWork w
#define ITEM_PASS a, feats, order, counts, ent, K, aux, w
#define STREAM_ARGS                                                       \
  LabArgs a, const float* __restrict__ feats,                             \
      const int32_t* __restrict__ order, const float* __restrict__ K,     \
      const float* __restrict__ aux, float* __restrict__ out_t,           \
      int32_t* __restrict__ out_i
#define STREAM_PASS a, feats, order, K, aux, out_t, out_i

// L1: folded blocks, the split control path always, per_group; the split
// walk.
template <int PASSES, int G>
__global__ void __launch_bounds__(kThreads) lab_v6_kernel(ITEM_ARGS) {
  lab_items<PASSES, G, kFolded>(ITEM_PASS);
}

// L2: folded blocks, the split control path as a switch; the split walk.
template <int PASSES, int G>
__global__ void __launch_bounds__(kThreads) lab_v5_kernel(ITEM_ARGS) {
  lab_items<PASSES, G, kFolded>(ITEM_PASS);
}

// L3: unfolded blocks; thin, gate, no_exit; the split walk.
template <int PASSES, int G>
__global__ void __launch_bounds__(kThreads) lab_base_kernel(ITEM_ARGS) {
  lab_items<PASSES, G, kKc>(ITEM_PASS);
}

// L4 at its full1 and mm stages: unfolded blocks, one group per tile,
// streamed (p3: the landed group split in place into L6's words). At its
// loop stage L4 is L3's walk with gate_settle off, so it launches
// lab_base_kernel (kernel_of).
template <int PASSES, int G>
__global__ void __launch_bounds__(kThreads)
    lab_probe_stream_kernel(STREAM_ARGS) {
  lab_stream<PASSES, G>(STREAM_PASS);
}

// L5: unfolded blocks padded to 16 rows on the host (K = kcf); the split
// walk.
template <int PASSES, int G>
__global__ void __launch_bounds__(kThreads) lab_flat_kernel(ITEM_ARGS) {
  lab_items<PASSES, G, kFlat>(ITEM_PASS);
}

// L6, bf16x3 only: unfolded blocks split on the host (K = the words); the
// split walk.
template <int G>
__global__ void __launch_bounds__(kThreads) lab_presplit_kernel(ITEM_ARGS) {
  lab_items<3, G, kPresplit>(ITEM_PASS);
}

using ItemFn = void (*)(ITEM_ARGS);
using StreamFn = void (*)(STREAM_ARGS);

// A kind's kernel at (passes, G, stage): the split walk, or L4's stream at
// its full1 and mm stages; neither where the kind is not built so.
struct Kernel {
  ItemFn item = nullptr;
  StreamFn stream = nullptr;
  const void* fn() const {
    return item != nullptr ? (const void*)item : (const void*)stream;
  }
};

template <int PASSES, int G>
Kernel kernel_of(int kind, int stage) {
  Kernel k;
  switch (kind) {
    case 0:
      k.item = lab_v6_kernel<PASSES, G>;
      break;
    case 1:
      k.item = lab_v5_kernel<PASSES, G>;
      break;
    case 2:
      k.item = lab_base_kernel<PASSES, G>;
      break;
    case 3:  // the loop stage is L3's walk (gate off)
      if (stage == lab::kLoop)
        k.item = lab_base_kernel<PASSES, G>;
      else
        k.stream = lab_probe_stream_kernel<PASSES, G>;
      break;
    case 4:
      k.item = lab_flat_kernel<PASSES, G>;
      break;
    case 5:
      if constexpr (PASSES == 3) k.item = lab_presplit_kernel<G>;
      break;
  }
  return k;
}

template <int PASSES>
Kernel kernel_of(int kind, int G, int stage) {
  switch (G) {
    case 1:
      return kernel_of<PASSES, 1>(kind, stage);
    case 2:
      return kernel_of<PASSES, 2>(kind, stage);
    case 4:
      return kernel_of<PASSES, 4>(kind, stage);
  }
  return Kernel{};
}

Kernel kernel_of(int kind, int passes, int G, int stage) {
  return passes == 6 ? kernel_of<6>(kind, G, stage)
         : passes == 3 ? kernel_of<3>(kind, G, stage)
                       : Kernel{};
}

// Each kind's block layout (kinds as culled_lab's `kind`).
constexpr int layout_of(int kind) {
  return kind < 2 ? kFolded : kind < 4 ? kKc : kind == 4 ? kFlat : kPresplit;
}

// Dynamic shared memory of a launch: the ring's stages of group_c staged
// clusters (ops/cuda/lab.py `launch_shape`).
size_t smem_bytes(int kind, int group_c, int cs) {
  const int L = layout_of(kind);
  return stages_of(L, group_c) * sizeof(float) * (size_t)group_c *
         cluster_floats(cs, L);
}

// Sets the dynamic shared memory a launch of `kern` needs above the
// default 48 KB.
cudaError_t allow_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Blocks of `kern` one SM holds at once with `smem` bytes of dynamic
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
cudaError_t occupancy(const void* kern, size_t smem, int* blocks) {
  cudaError_t e = allow_smem(kern, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, kThreads,
                                                      smem);
  return e;
}

// The grid of a launch of `k` (as culled_lab launches it): the blocks one
// SM holds (at most sm_blocks > 0) times the SMs, at most the stream's
// tiles or the split walk's items there can be.
cudaError_t launch_grid(const Kernel& k, size_t smem, int n_tiles, int C,
                        int group_c, int item_groups, int sm_blocks,
                        int* grid) {
  int blocks = 0, dev = 0, sms = 0;
  cudaError_t e = occupancy(k.fn(), smem, &blocks);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (sm_blocks > 0) blocks = std::min(blocks, sm_blocks);
  const long long most =
      k.stream != nullptr
          ? (long long)n_tiles
          : (long long)n_tiles *
                ((lab::tile_groups(C, group_c) + item_groups - 1) /
                 item_groups);
  *grid = (int)std::max(
      1LL, std::min((long long)std::max(blocks, 1) * sms, most));
  return cudaSuccess;
}

// The split walk's scratch in `work` (culled_lab_workspace bytes): the
// keys, then the int32 tables, then the root box.
SplitWork split_work(void* work, int n_tiles, int item_groups) {
  SplitWork w;
  w.keys = static_cast<unsigned long long*>(work);
  w.full_off = reinterpret_cast<int32_t*>(w.keys + (size_t)n_tiles * lab::TILE);
  w.rest_off = w.full_off + n_tiles + 1;
  w.next = w.rest_off + n_tiles + 1;
  w.root = reinterpret_cast<float*>(w.next + 1);
  w.L = item_groups;
  return w;
}

}  // namespace

// Bytes of the scratch buffer the split walk (every kind but L4 at its
// full1 and mm stages) takes for n_tiles tiles (SplitWork); 8-byte aligned.
extern "C" long long culled_lab_workspace(int n_tiles) {
  return 8LL * n_tiles * lab::TILE + 4LL * (2 * (n_tiles + 1) + 1 + 6);
}

// Blocks of lab kernel `kind` (as `culled_lab`, at its stage) that one SM
// holds at once at this launch shape
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor: registers, shared
// memory), or minus a CUDA error: the blocks per SM of the kernel's
// persistent grid.
extern "C" int culled_lab_occupancy(int kind, int passes, int group_c,
                                    int cs, int stage) {
  const Kernel k = kernel_of(kind, passes, group_c, stage);
  if (k.fn() == nullptr || cs <= 0 || cs % 8 != 0)
    return -(int)cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t e = occupancy(k.fn(), smem_bytes(kind, group_c, cs),
                                  &blocks);
  return e == cudaSuccess ? blocks : -(int)e;
}

// The blocks of the grid that `culled_lab` launches with these arguments
// (launch_grid: for the split walk its walk's grid), or minus a CUDA error.
extern "C" int culled_lab_grid(int kind, int passes, int group_c,
                               int n_tiles, int C, int cs, int stage,
                               int item_groups, int sm_blocks) {
  const Kernel k = kernel_of(kind, passes, group_c, stage);
  if (k.fn() == nullptr || n_tiles <= 0 || C <= 0 || cs <= 0 ||
      cs % 8 != 0 || (k.item != nullptr && item_groups < 1))
    return -(int)cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t e =
      launch_grid(k, smem_bytes(kind, group_c, cs), n_tiles, C, group_c,
                  item_groups, sm_blocks, &grid);
  return e == cudaSuccess ? grid : -(int)e;
}

// Launches lab kernel `kind` (0 lab_v6, 1 lab_v5, 2 lab_base, 3 lab_probe,
// 4 lab_flat, 5 lab_presplit) at `passes` (6 or 3; lab_presplit 3 only)
// and group_c (1, 2 or 4) clusters per group over n_tiles tiles of 256
// rays: feats [n_tiles 256, 10], order [n_tiles, C], counts [n_tiles], ent
// [n_tiles, C + 1], lo/hi [C, 3], K [C, rows, 4, cs] (kinds 0-1: k10, rows
// 10; 2-3: kc, rows 9; 4: kcf, rows 16; 5: kc's words, rows 9), aux
// [C, aux rows, cs] (kinds 0-1: org; else aux). Writes t [n_tiles 256]
// (BIG = miss) and the original index (BIG_I = miss). Both take a
// persistent grid of blocks per SM times the SMs (with sm_blocks > 0 at
// most sm_blocks per SM, for measurement; culled_lab_grid). Kind 3 at
// stages full1 and mm (`stage` 1, 2): one kernel, lab_probe_stream_kernel,
// at most one block per tile. Every
// other kind and stage (the split walk): three kernels, lab_split_init,
// the walk (at most the items there can be) taking items of at most
// item_groups (>= 1) groups, and lab_split_unpack, with the scratch
// `work` (culled_lab_workspace bytes) and t_clip >= 0. cs must be a
// multiple of 8 and every table 16-byte aligned; anything else returns
// cudaErrorInvalidValue. Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError().
extern "C" int culled_lab(int kind, int passes, int group_c, int n_tiles,
                          int C, int cs, int thin, int gate, int no_exit,
                          int split, int per_group, int stage,
                          int item_groups, int sm_blocks, float t_clip,
                          const float* feats,
                          const int32_t* order, const int32_t* counts,
                          const float* ent, const float* lo, const float* hi,
                          const float* K, const float* aux, float* out_t,
                          int32_t* out_i, void* work, void* stream) {
  if (n_tiles <= 0) return (int)cudaGetLastError();
  if (cs <= 0 || cs % 8 != 0 || C <= 0 || kind < 0 || kind > 5)
    return (int)cudaErrorInvalidValue;
  const Kernel k = kernel_of(kind, passes, group_c, stage);
  if (k.fn() == nullptr) return (int)cudaErrorInvalidValue;
  if (k.item != nullptr &&
      (item_groups < 1 || work == nullptr || !(t_clip >= 0.0f)))
    return (int)cudaErrorInvalidValue;
  const LabArgs a{n_tiles, C,     cs,        thin,  gate,
                  no_exit, split, per_group, stage, t_clip};
  const size_t smem = smem_bytes(kind, group_c, cs);
  const cudaStream_t s = (cudaStream_t)stream;
  int grid = 0;
  const cudaError_t e = launch_grid(k, smem, n_tiles, C, group_c,
                                    item_groups, sm_blocks, &grid);
  if (e != cudaSuccess) return (int)e;
  if (k.stream != nullptr) {
    k.stream<<<grid, kThreads, smem, s>>>(a, feats, order, K, aux, out_t,
                                          out_i);
    return (int)cudaGetLastError();
  }
  const SplitWork w = split_work(work, n_tiles, item_groups);
  const int R = n_tiles * lab::TILE;
  lab_split_init<<<std::min((R + 4 * kThreads - 1) / (4 * kThreads), 1024),
                   kThreads, 0, s>>>(n_tiles, C, group_c, counts, lo, hi, w);
  k.item<<<grid, kThreads, smem, s>>>(a, feats, order, counts, ent, K, aux,
                                      w);
  lab_split_unpack<<<std::min((R + kThreads - 1) / kThreads, 1024), kThreads,
                     0, s>>>(R, w.keys, out_t, out_i);
  return (int)cudaGetLastError();
}
