// Host build of the kernels' per-sample math (frame_math.cuh and its
// adjoint frame_adjoint.cuh), for the CPU tests: g++ -O2 -ffp-contract=off
// -shared -fPIC. It runs exactly the functions the CUDA kernels
// (pathtrace.cu, pathtrace_bwd.cu) run, on host arrays, so indexing faults,
// or float promotions that change rounding, in the headers show on a
// machine with no GPU. `recs` non-null selects the records variant of the
// forward. The adjoint runs the backward kernel's whole schedule serially
// (blocks, warps, lanes per sample, the group sum and every reduction in
// the kernel's order).

#include <stdint.h>

#include <vector>

#include "frame_adjoint.cuh"

extern "C" void frame_math_host(const fm::Params* p, const float* sph,
                                const float* tri, const float* misc,
                                const float* pl, const float* dl,
                                const int32_t* ids, const float* xs,
                                const float* ys, const float* cj,
                                const float* ci, float* out_r, float* out_g,
                                float* out_b, int32_t* recs) {
  const fm::Tables tb{sph, tri, misc, pl, dl};
  for (int i = 0; i < p->n; ++i) {
    float out[3];
    if (recs != nullptr)
      fm::frame_sample<true>(*p, tb, (uint32_t)ids[i], xs[i], ys[i], cj[i],
                             ci[i], out, recs + i, p->n);
    else
      fm::frame_sample<false>(*p, tb, (uint32_t)ids[i], xs[i], ys[i], cj[i],
                              ci[i], out, nullptr, 0);
    out_r[i] = out[0];
    out_g[i] = out[1];
    out_b[i] = out[2];
  }
}

namespace {

constexpr int kThreads = fm::BWD_THREADS;
constexpr int kWarps = fm::BWD_WARPS;

struct RowRec {
  int key;  // fm::row_key, 0 for none
  float v[fm::TRI_W];
};

// pathtrace_bwd.cu's accumulator for one thread, run serially: dense
// values into the thread's own vector; committed rows into the lane's
// list, which commit_rounds then adds as the warp does.
struct HostLaneAcc {
  float* col;
  std::vector<RowRec>* rows;
  float row[fm::TRI_W];
  bool active;

  void dense(int e, const float* v, int n) {
    if (active)
      for (int c = 0; c < n; ++c) col[e + c] += v[c];
  }
  float* row_begin() {
    for (int c = 0; c < fm::TRI_W; ++c) row[c] = 0.0f;
    return row;
  }
  void row_commit(int kind, int idx) {
    RowRec r;
    r.key = active ? fm::row_key(kind, idx) : 0;
    for (int c = 0; c < fm::TRI_W; ++c) r.v[c] = row[c];
    rows->push_back(r);
  }
};

// A warp's committed rows, call by call, into its row table (the kernel's
// LaneAcc::row_commit): within a call, each group of lanes with one key,
// taken in the order of its lowest lane, is summed column by column in lane
// order and added to the table row.
void commit_rounds(const fm::GradLayout& lay, std::vector<RowRec>* rows,
                   float* table) {
  for (size_t r = 0; r < rows[0].size(); ++r) {
    uint32_t done = 0;
    for (int l = 0; l < 32; ++l) {
      const int key = rows[l][r].key;
      if (key == 0 || ((done >> l) & 1u)) continue;
      uint32_t grp = 0;
      for (int m = l; m < 32; ++m)
        if (rows[m][r].key == key) grp |= 1u << m;
      done |= grp;
      int width;
      const int off = fm::row_offset(lay, key, &width);
      for (int c = 0; c < width; ++c) {
        float s = 0.0f;
        for (int m = 0; m < 32; ++m)
          if ((grp >> m) & 1u) s += rows[m][r].v[c];
        table[off + c] += s;
      }
    }
  }
  for (int l = 0; l < 32; ++l) rows[l].clear();
}

}  // namespace

// The backward kernel's schedule (pathtrace_bwd.cu) on the host: `blocks`
// blocks of kThreads threads, G lanes per sample (a power of two <= 32),
// each block's warps and threads summed in the kernel's order into its
// partial table, then the partials in block order. Writes the flat
// gradient (fm::grad_layout) of sum(radiance * (gr, gg, gb)) with respect
// to the tables into `grad`, for the samples whose [K, n] records are
// `recs`.
extern "C" void frame_math_host_bwd(const fm::Params* p, int G, int blocks,
                                    const float* sph, const float* tri,
                                    const float* misc, const float* pl,
                                    const float* dl, const int32_t* ids,
                                    const float* xs, const float* ys,
                                    const float* cj, const float* ci,
                                    const int32_t* recs, const float* gr,
                                    const float* gg, const float* gb,
                                    float* grad) {
  const fm::Tables tb{sph, tri, misc, pl, dl};
  const fm::GradLayout lay = fm::grad_layout(*p);
  const fm::DenseLayout dense_lay = fm::dense_layout(*p);
  const int spb = kThreads / G;  // samples per block and stride step
  std::vector<float> partial((size_t)blocks * lay.total);
  std::vector<float> table((size_t)kWarps * lay.misc);
  std::vector<float> dense((size_t)kThreads * dense_lay.total);
  std::vector<RowRec> rows[32];
  for (int b = 0; b < blocks; ++b) {
    for (float& v : table) v = 0.0f;
    for (float& v : dense) v = 0.0f;
    for (int base = b * spb; base < p->n; base += blocks * spb) {
      for (int w = 0; w < kWarps; ++w) {
        HostLaneAcc acc[32];
        fm::PrimaryG pg[32];
        int js[32];
        bool act[32];
        for (int l = 0; l < 32; ++l) {
          const int t = w * 32 + l;
          const int i = base + t / G;
          act[l] = i < p->n;
          const int j = js[l] = act[l] ? i : base;
          acc[l].col = dense.data() + (size_t)t * dense_lay.total;
          acc[l].rows = &rows[l];
          acc[l].active = act[l];
          pg[l] = fm::lane_bwd(*p, tb, (uint32_t)ids[j], xs[j], ys[j], cj[j],
                               ci[j], recs + j, p->n,
                               fm::v3(gr[j], gg[j], gb[j]), t % G, G, acc[l]);
        }
        // the group sum: the kernel's xor butterfly
        for (int k = 1; k < G; k <<= 1) {
          fm::PrimaryG before[32];
          for (int l = 0; l < 32; ++l) before[l] = pg[l];
          for (int l = 0; l < 32; ++l)
            fm::zip_primaryg(pg[l], before[l ^ k],
                             [](float& a, const float& o) { a += o; });
        }
        for (int l = 0; l < 32; ++l) {
          const int j = js[l];
          acc[l].active = act[l] && l % G == 0;
          fm::finish_bwd(*p, tb, (uint32_t)ids[j], xs[j], ys[j], cj[j], ci[j],
                         (uint32_t)recs[j], pg[l], acc[l]);
        }
        commit_rounds(lay, rows, table.data() + (size_t)w * lay.misc);
      }
    }
    for (int e = 0; e < lay.total; ++e) {
      float s = 0.0f;
      if (e < lay.misc) {
        for (int w = 0; w < kWarps; ++w) s += table[(size_t)w * lay.misc + e];
      } else {
        const int di = fm::dense_index(lay, dense_lay, e);
        if (di >= 0)
          for (int t = 0; t < kThreads; ++t)
            s += dense[(size_t)t * dense_lay.total + di];
      }
      partial[(size_t)b * lay.total + e] = s;
    }
  }
  for (int e = 0; e < lay.total; ++e) {
    float s = 0.0f;
    for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * lay.total + e];
    grad[e] = s;
  }
}

// Bytes of shared memory a block of the backward kernel takes for p.
extern "C" long long pathtrace_bwd_smem_bytes(const fm::Params* p) {
  return 4 * fm::bwd_smem_floats(fm::grad_layout(*p), fm::dense_layout(*p));
}

extern "C" int pathtrace_params_size() { return (int)sizeof(fm::Params); }
