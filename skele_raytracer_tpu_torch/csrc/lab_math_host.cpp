// Host build of the kernel lab's per-pair math (lab_math.cuh), for the CPU
// tests: g++ -O2 -ffp-contract=off -shared -fPIC. Each function runs, pair
// by pair or value by value, the header functions that culled_lab.cu calls
// (its passes = 6 columns and numerators, its passes = 3 epilogue on the
// product's plane sums, the bf16 split of its fragments and L6's fragments
// from host-split words, the settle bound's root exit), so that the tests hold them bitwise against the plain
// version (ops/cuda/lab.py) on a machine with no GPU. The kernels' control
// path (groups, settle, stages) and their tensor-core product are held
// against the plain version on the card only.

#include "lab_math.cuh"

// passes = 6: t [n, W] of rays feats [n, 10] against the W columns (a
// multiple of 4) of one block K [rows][4][W] with its aux rows A
// [aux rows][W] (folded: k10 and org; else kc and aux): lab::columns4,
// mm::planes and lab::pair_t (thin: the sign-bit epilogue); with `mm`, the
// probe's product stage, det + t_num before kof.
extern "C" void lab_pairs6_host(int n, int W, int folded, int thin, int mm,
                                float t_clip, const float* feats,
                                const float* K, const float* A,
                                float* out) {
  const int rs = lab::PLANES * W;
  for (int r = 0; r < n; ++r)
    for (int j = 0; j < W; j += 4) {
      float rec[4][mm::REC];
      bool in[4];
      lab::columns4(K, rs, A, W, j, folded, !mm, rec, in);
      for (int e = 0; e < 4; ++e) {
        const mm::Planes q = mm::planes(feats + r * 10, rec[e], -1.0f);
        out[(size_t)r * W + j + e] =
            mm ? q.det + q.t : lab::pair_t(q, thin, in[e], t_clip);
      }
    }
}

// passes = 3: t [n, W] from the bf16x3 product's plane sums det, u, v, t
// [n, W] of the same pairs (the tensor cores' accumulators in the kernel)
// and the block's aux rows A: lab::column_aux, lab::planes3 and
// lab::pair_t.
extern "C" void lab_epilogue3_host(int n, int W, int folded, int thin,
                                   float t_clip, const float* det,
                                   const float* u, const float* v,
                                   const float* t, const float* A,
                                   float* out) {
  for (int r = 0; r < n; ++r)
    for (int j = 0; j < W; ++j) {
      const size_t k = (size_t)r * W + j;
      float kof, orig;
      bool in;
      lab::column_aux(A, W, j, folded, kof, in, orig);
      const mm::Planes p = lab::planes3(det[k], u[k], v[k], t[k], folded, kof);
      out[k] = lab::pair_t(p, thin, in, t_clip);
    }
}

// The bf16x3 split (lab::split) of n floats.
extern "C" void lab_split_host(int n, const float* x, float* hi, float* lo) {
  for (int i = 0; i < n; ++i) lab::split(x[i], hi[i], lo[i]);
}

// B-fragment registers of n row pairs (x0[i], x1[i]), both ways: L3's
// (lab::split of each value, lab::pack2 of the two hi and the two lo) into
// bh3, bl3, and L6's (lab::presplit_word of each value, as the host table
// holds it, then lab::hi_pair, lo_pair) into bh6, bl6; `words` gets the
// x0 words.
extern "C" void lab_fragments_host(int n, const float* x0, const float* x1,
                                   uint32_t* bh3, uint32_t* bl3,
                                   uint32_t* bh6, uint32_t* bl6,
                                   uint32_t* words) {
  for (int i = 0; i < n; ++i) {
    float h0, l0, h1, l1;
    lab::split(x0[i], h0, l0);
    lab::split(x1[i], h1, l1);
    bh3[i] = lab::pack2(h0, h1);
    bl3[i] = lab::pack2(l0, l1);
    const uint32_t w0 = lab::presplit_word(x0[i]);
    const uint32_t w1 = lab::presplit_word(x1[i]);
    bh6[i] = lab::hi_pair(w0, w1);
    bl6[i] = lab::lo_pair(w0, w1);
    words[i] = w0;
  }
}

// Each ray's exit from the root box [root_lo, root_hi] (lab::root_exit).
extern "C" void lab_root_exit_host(int n, const float* feats,
                                   const float* root_lo,
                                   const float* root_hi, float* out) {
  for (int r = 0; r < n; ++r)
    out[r] = lab::root_exit(feats + r * 10, root_lo, root_hi);
}

// The split walk's keys (lab::best_key) of n pairs (t[i], idx[i]).
extern "C" void lab_keys_host(int n, const float* t, const int32_t* idx,
                              uint64_t* keys) {
  for (int i = 0; i < n; ++i) keys[i] = lab::best_key(t[i], idx[i]);
}

// The split walk's merge of m partial answers t, idx [m, n] per ray: the
// least key (lab::min_key) from the miss's, unpacked (lab::unpack_key).
extern "C" void lab_key_min_host(int n, int m, const float* t,
                                 const int32_t* idx, float* out_t,
                                 int32_t* out_i) {
  for (int r = 0; r < n; ++r) {
    uint64_t key = lab::best_key(mm::BIG, mm::BIG_I);
    for (int k = 0; k < m; ++k)
      key = lab::min_key(key, lab::best_key(t[(size_t)k * n + r],
                                            idx[(size_t)k * n + r]));
    lab::unpack_key(key, out_t[r], out_i[r]);
  }
}

// The split walk's work items of T tiles with shortlists counts [T] at G
// clusters per group and at most L groups per item, in the kernel's order
// (lab::item_at over the prefix sums of lab::full_items and
// lab::rest_items): (tile, p0, p1) into items [cap, 3]. Returns how many
// there are (-1 if more than cap).
extern "C" int lab_items_host(int T, const int32_t* counts, int G, int L,
                              int cap, int32_t* items) {
  int32_t* full_off = new int32_t[T + 1];
  int32_t* rest_off = new int32_t[T + 1];
  full_off[0] = rest_off[0] = 0;
  for (int t = 0; t < T; ++t) {
    const int g = lab::tile_groups(counts[t], G);
    full_off[t + 1] = full_off[t] + lab::full_items(g, L);
    rest_off[t + 1] = rest_off[t] + lab::rest_items(g, L);
  }
  const int n = full_off[T] + rest_off[T];
  for (int it = 0; it < n && n <= cap; ++it) {
    const lab::Item item =
        lab::item_at(it, full_off, rest_off, counts, T, G, L);
    items[3 * it] = item.tile;
    items[3 * it + 1] = item.p0;
    items[3 * it + 2] = item.p1;
  }
  delete[] full_off;
  delete[] rest_off;
  return n <= cap ? n : -1;
}

// L4's stream of tiles over a persistent grid of `grid` blocks: how many
// times each of T tiles is taken (lab::stream_tiles, lab::stream_tile),
// into taken [T]; returns the most tiles one block takes.
extern "C" int lab_stream_host(int T, int grid, int32_t* taken) {
  int most = 0;
  for (int t = 0; t < T; ++t) taken[t] = 0;
  for (int b = 0; b < grid; ++b) {
    const int n = lab::stream_tiles(b, grid, T);
    most = n > most ? n : most;
    for (int k = 0; k < n; ++k) ++taken[lab::stream_tile(b, grid, k)];
  }
  return most;
}
