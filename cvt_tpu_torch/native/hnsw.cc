// Native HNSW graph index for the host-side runtime.
//
// Capability parity target: the reference's vendored hnswlib usage —
// build/query/save/load of a layered proximity graph over raw float
// vectors (hnsw_sifts_retrieval/hnswlib/hnswalg.h, brute_force_search/
// src/brutoforce.hpp give the API surface: addPoint / searchKnn /
// saveIndex / loadIndex). This is a from-scratch implementation of the
// published HNSW algorithm (Malkov & Yashunin, TPAMI 2018): geometric
// level sampling, greedy descent through upper layers, ef-bounded beam
// search at each layer, and the "keep if closer to query than to any
// already-kept neighbor" diversity heuristic for link selection.
//
// A copy of cvt_tpu/native/hnsw.cc (the same graph, the same file
// format, so either package loads the other's saved graphs). On the card
// the graph ANN's counterpart is the flat ADC scan (csrc/adc_scan.cu):
// device-memory bandwidth beats pointer chasing. This module exists for
// the host-side runtime: small/latency-sensitive indexes, CPU-only
// deployments, and parity experiments against the reference operating
// point (M=32, efConstruction=80, IP space). Exposed to Python through
// ctypes (cvt_tpu_torch/index/hnsw.py); OpenMP parallel batch add/search.
//
// Build: g++ -O3 -fopenmp -shared -fPIC, by cvt_tpu_torch/native/__init__.py
// into cvt_tpu_torch/_build/.

#include <omp.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

enum Metric : int32_t { METRIC_L2 = 0, METRIC_IP = 1 };

// Distance = "smaller is better". IP returns 1 - <a,b> like hnswlib's
// InnerProductSpace so both metrics minimize.
static inline float dist_l2(const float* __restrict a,
                            const float* __restrict b, int d) {
  float acc = 0.f;
  for (int i = 0; i < d; ++i) {
    const float t = a[i] - b[i];
    acc += t * t;
  }
  return acc;
}

static inline float dist_ip(const float* __restrict a,
                            const float* __restrict b, int d) {
  float acc = 0.f;
  for (int i = 0; i < d; ++i) acc += a[i] * b[i];
  return 1.f - acc;
}

struct Candidate {
  float dist;
  int32_t node;
};
struct ByDistAsc {  // min-heap on dist when used with priority_queue
  bool operator()(const Candidate& a, const Candidate& b) const {
    return a.dist > b.dist;
  }
};
struct ByDistDesc {  // max-heap on dist (result set, evict worst)
  bool operator()(const Candidate& a, const Candidate& b) const {
    return a.dist < b.dist;
  }
};

// Per-thread scratch: epoch-tagged visited marks (no clearing between
// queries; bump the epoch instead). Sized to the index CAPACITY, not the
// current count: during concurrent inserts another thread may publish a
// node id beyond the count observed at reset time, and marking it must
// never write out of bounds.
struct Scratch {
  std::vector<uint32_t> mark;
  std::vector<int32_t> nbrs;  // neighbor-list copy buffer (locked reads)
  uint32_t epoch = 0;
  void reset(size_t cap, size_t max_links) {
    if (mark.size() < cap) mark.resize(cap, 0);
    if (nbrs.size() < max_links) nbrs.resize(max_links);
    if (++epoch == 0) {  // wrapped: clear once
      std::fill(mark.begin(), mark.end(), 0);
      epoch = 1;
    }
  }
  bool visited(int32_t v) const { return mark[v] == epoch; }
  void visit(int32_t v) { mark[v] = epoch; }
};

class HnswIndex {
 public:
  HnswIndex(int dim, int metric, int64_t capacity, int m, int ef_construction,
            uint64_t seed)
      : dim_(dim),
        metric_(metric),
        cap_(capacity),
        m_(m),
        m0_(2 * m),
        efc_(std::max(ef_construction, m)),
        level_mult_(1.0 / std::log(double(m))),
        rng_(seed) {
    data_.resize(size_t(cap_) * dim_);
    labels_.resize(cap_);
    levels_.resize(cap_, -1);
    links0_.resize(size_t(cap_) * (m0_ + 1), 0);
    upper_.resize(cap_);
    node_locks_ = std::vector<std::mutex>(kLockStripes);
  }

  int64_t size() const { return count_.load(); }
  int dim() const { return dim_; }
  int metric() const { return metric_; }
  int m() const { return m_; }
  int efc() const { return efc_; }

  float dist(const float* a, const float* b) const {
    return metric_ == METRIC_L2 ? dist_l2(a, b, dim_) : dist_ip(a, b, dim_);
  }
  const float* vec(int32_t v) const { return &data_[size_t(v) * dim_]; }

  // ---- link accessors -------------------------------------------------
  int32_t* links(int32_t v, int level) {
    if (level == 0) return &links0_[size_t(v) * (m0_ + 1)];
    return &upper_[v][size_t(level - 1) * (m_ + 1)];
  }
  const int32_t* links(int32_t v, int level) const {
    return const_cast<HnswIndex*>(this)->links(v, level);
  }
  std::mutex& lock_of(int32_t v) const {
    return node_locks_[v % kLockStripes];
  }

  // ---- beam search at one level (algorithm 2 of the paper) ------------
  // Returns up to `ef` nearest candidates as a max-heap vector.
  // `locked=true` copies each neighbor list under its node lock — the
  // insert path must use this (concurrent writers mutate the lists);
  // read-only queries skip the locks (single-writer contract, like the
  // reference Database's documented single-thread usage, database.h:51).
  void search_layer(const float* q, int32_t entry, float entry_d, int level,
                    int ef, Scratch& s, std::vector<Candidate>& out,
                    bool locked) const {
    std::priority_queue<Candidate, std::vector<Candidate>, ByDistAsc> grow;
    std::priority_queue<Candidate, std::vector<Candidate>, ByDistDesc> best;
    s.reset(size_t(cap_), size_t(m0_ + 1));
    s.visit(entry);
    grow.push({entry_d, entry});
    best.push({entry_d, entry});
    while (!grow.empty()) {
      Candidate c = grow.top();
      if (c.dist > best.top().dist && int(best.size()) >= ef) break;
      grow.pop();
      const int32_t* lk;  // points at the first neighbor id
      int n;
      if (locked) {
        std::lock_guard<std::mutex> g(lock_of(c.node));
        const int32_t* src = links(c.node, level);
        n = src[0];
        std::memcpy(s.nbrs.data(), src + 1, sizeof(int32_t) * n);
        lk = s.nbrs.data();
      } else {
        const int32_t* src = links(c.node, level);
        n = src[0];
        lk = src + 1;
      }
      for (int i = 0; i < n; ++i) {
        const int32_t u = lk[i];
        if (s.visited(u)) continue;
        s.visit(u);
        const float du = dist(q, vec(u));
        if (int(best.size()) < ef || du < best.top().dist) {
          grow.push({du, u});
          best.push({du, u});
          if (int(best.size()) > ef) best.pop();
        }
      }
    }
    out.clear();
    out.reserve(best.size());
    while (!best.empty()) {
      out.push_back(best.top());
      best.pop();
    }
    // out is now worst-to-best; callers that need best-first reverse it.
  }

  // ---- diversity heuristic (algorithm 4): keep candidates that are
  // closer to q than to any already-kept neighbor ----------------------
  void select_neighbors(std::vector<Candidate>& cand, int max_m) const {
    // cand arrives worst-to-best; process best-first.
    std::reverse(cand.begin(), cand.end());
    std::vector<Candidate> kept;
    kept.reserve(max_m);
    for (const Candidate& c : cand) {
      if (int(kept.size()) >= max_m) break;
      bool ok = true;
      for (const Candidate& k : kept) {
        if (dist(vec(c.node), vec(k.node)) < c.dist) {
          ok = false;
          break;
        }
      }
      if (ok) kept.push_back(c);
    }
    cand.swap(kept);  // best-first, diverse, size <= max_m
  }

  // ---- insert (algorithm 1) -------------------------------------------
  int64_t add(const float* x, int64_t label, Scratch& s) {
    const int32_t v = int32_t(count_.fetch_add(1));
    if (v >= cap_) throw std::runtime_error("hnsw: capacity exceeded");
    std::memcpy(&data_[size_t(v) * dim_], x, sizeof(float) * dim_);
    labels_[v] = label;

    int level;
    {
      std::lock_guard<std::mutex> g(rng_mu_);
      std::uniform_real_distribution<double> u(0.0, 1.0);
      level = int(-std::log(std::max(u(rng_), 1e-12)) * level_mult_);
    }
    levels_[v] = level;
    if (level > 0)
      upper_[v].assign(size_t(level) * (m_ + 1), 0);

    int32_t ep;
    int top;
    {
      std::lock_guard<std::mutex> g(entry_mu_);
      ep = entry_;
      top = max_level_;
      if (ep < 0 || level > top) {
        entry_ = v;
        max_level_ = std::max(level, top);
      }
      if (ep < 0) return label;  // first element: no links to make
    }

    float epd = dist(x, vec(ep));
    // greedy descent through layers above the new node's level
    for (int lvl = top; lvl > level; --lvl) {
      bool moved = true;
      while (moved) {
        moved = false;
        std::lock_guard<std::mutex> g(lock_of(ep));
        const int32_t* lk = links(ep, lvl);
        for (int i = 1; i <= lk[0]; ++i) {
          const float d2 = dist(x, vec(lk[i]));
          if (d2 < epd) {
            epd = d2;
            ep = lk[i];
            moved = true;
          }
        }
      }
    }
    // beam + connect at each level from min(level, top) down to 0
    std::vector<Candidate> cand;
    for (int lvl = std::min(level, top); lvl >= 0; --lvl) {
      search_layer(x, ep, epd, lvl, efc_, s, cand, /*locked=*/true);
      if (!cand.empty()) {
        ep = cand.back().node;  // best-so-far seeds the next level down
        epd = cand.back().dist;
      }
      std::vector<Candidate> sel = cand;
      const int max_m = lvl == 0 ? m0_ : m_;
      select_neighbors(sel, m_);
      {
        std::lock_guard<std::mutex> g(lock_of(v));
        int32_t* lk = links(v, lvl);
        lk[0] = int32_t(sel.size());
        for (size_t i = 0; i < sel.size(); ++i) lk[i + 1] = sel[i].node;
      }
      for (const Candidate& nb : sel) {
        std::lock_guard<std::mutex> g(lock_of(nb.node));
        int32_t* lk = links(nb.node, lvl);
        if (lk[0] < max_m) {
          // write the entry BEFORE bumping the count: lock-free readers
          // (query path) must never observe a count covering an
          // unwritten slot
          lk[lk[0] + 1] = v;
          ++lk[0];
        } else {
          // re-select among existing links + v (shrink step)
          std::vector<Candidate> pool;
          pool.reserve(max_m + 1);
          pool.push_back({nb.dist, v});
          for (int i = 1; i <= lk[0]; ++i)
            pool.push_back({dist(vec(nb.node), vec(lk[i])), lk[i]});
          std::sort(pool.begin(), pool.end(),
                    [](const Candidate& a, const Candidate& b) {
                      return a.dist > b.dist;  // worst-to-best
                    });
          select_neighbors(pool, max_m);
          lk[0] = int32_t(pool.size());
          for (size_t i = 0; i < pool.size(); ++i) lk[i + 1] = pool[i].node;
        }
      }
    }
    return label;
  }

  // ---- query (algorithm 5) ---------------------------------------------
  int search(const float* q, int k, int ef, Scratch& s, int64_t* out_labels,
             float* out_dists) const {
    int32_t ep;
    int top;
    {
      std::lock_guard<std::mutex> g(entry_mu_);
      ep = entry_;
      top = max_level_;
    }
    if (ep < 0) return 0;
    float epd = dist(q, vec(ep));
    for (int lvl = top; lvl > 0; --lvl) {
      bool moved = true;
      while (moved) {
        moved = false;
        const int32_t* lk = links(ep, lvl);
        for (int i = 1; i <= lk[0]; ++i) {
          const float d2 = dist(q, vec(lk[i]));
          if (d2 < epd) {
            epd = d2;
            ep = lk[i];
            moved = true;
          }
        }
      }
    }
    std::vector<Candidate> cand;
    search_layer(q, ep, epd, 0, std::max(ef, k), s, cand,
                 /*locked=*/false);
    const int n = std::min<int>(k, int(cand.size()));
    // cand is worst-to-best; emit the best n in ascending-dist order
    for (int i = 0; i < n; ++i) {
      const Candidate& c = cand[cand.size() - 1 - i];
      out_labels[i] = labels_[c.node];
      out_dists[i] = c.dist;
    }
    return n;
  }

  // ---- persistence ------------------------------------------------------
  // Little-endian sections: header, labels, levels, data, links0, upper.
  bool save(const char* path) const {
    FILE* f = std::fopen(path, "wb");
    if (!f) return false;
    const int64_t n = count_.load();
    const int64_t header[8] = {0x48565354u /*"TSVH"*/, 1,       dim_,
                               metric_,               n,        m_,
                               efc_,                  int64_t(max_level_)};
    std::fwrite(header, sizeof(int64_t), 8, f);
    const int64_t entry64 = entry_;
    std::fwrite(&entry64, sizeof(int64_t), 1, f);
    std::fwrite(labels_.data(), sizeof(int64_t), n, f);
    std::fwrite(levels_.data(), sizeof(int32_t), n, f);
    std::fwrite(data_.data(), sizeof(float), size_t(n) * dim_, f);
    std::fwrite(links0_.data(), sizeof(int32_t), size_t(n) * (m0_ + 1), f);
    for (int64_t v = 0; v < n; ++v) {
      if (levels_[v] > 0)
        std::fwrite(upper_[v].data(), sizeof(int32_t),
                    size_t(levels_[v]) * (m_ + 1), f);
    }
    std::fclose(f);
    return true;
  }

  static HnswIndex* load(const char* path, int64_t capacity) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    int64_t header[8];
    if (std::fread(header, sizeof(int64_t), 8, f) != 8 ||
        header[0] != 0x48565354u || header[1] != 1) {
      std::fclose(f);
      return nullptr;
    }
    const int dim = int(header[2]), metric = int(header[3]);
    const int64_t n = header[4];
    const int m = int(header[5]), efc = int(header[6]);
    const int max_level = int(header[7]);
    int64_t entry64;
    if (std::fread(&entry64, sizeof(int64_t), 1, f) != 1) {
      std::fclose(f);
      return nullptr;
    }
    HnswIndex* idx =
        new HnswIndex(dim, metric, std::max(capacity, n), m, efc, 0);
    idx->count_.store(n);
    idx->entry_ = int32_t(entry64);
    idx->max_level_ = max_level;
    bool ok = true;
    ok &= std::fread(idx->labels_.data(), sizeof(int64_t), n, f) == size_t(n);
    ok &= std::fread(idx->levels_.data(), sizeof(int32_t), n, f) == size_t(n);
    ok &= std::fread(idx->data_.data(), sizeof(float), size_t(n) * dim, f) ==
          size_t(n) * dim;
    ok &= std::fread(idx->links0_.data(), sizeof(int32_t),
                     size_t(n) * (idx->m0_ + 1), f) ==
          size_t(n) * (idx->m0_ + 1);
    for (int64_t v = 0; ok && v < n; ++v) {
      if (idx->levels_[v] > 0) {
        idx->upper_[v].resize(size_t(idx->levels_[v]) * (m + 1));
        ok &= std::fread(idx->upper_[v].data(), sizeof(int32_t),
                         idx->upper_[v].size(), f) == idx->upper_[v].size();
      }
    }
    std::fclose(f);
    if (!ok) {
      delete idx;
      return nullptr;
    }
    return idx;
  }

 private:
  static constexpr int kLockStripes = 4096;
  const int dim_, metric_;
  const int64_t cap_;
  const int m_, m0_, efc_;
  const double level_mult_;
  std::atomic<int64_t> count_{0};
  int32_t entry_ = -1;
  int max_level_ = 0;
  std::vector<float> data_;
  std::vector<int64_t> labels_;
  std::vector<int32_t> levels_;
  std::vector<int32_t> links0_;
  std::vector<std::vector<int32_t>> upper_;
  mutable std::vector<std::mutex> node_locks_;
  mutable std::mutex entry_mu_;
  std::mutex rng_mu_;
  std::mt19937_64 rng_;
};

}  // namespace

// ---------------------------------------------------------------------
// C API (ctypes surface)
// ---------------------------------------------------------------------
extern "C" {

void* cvt_hnsw_new(int dim, int metric, int64_t capacity, int m,
                   int ef_construction, uint64_t seed) {
  try {
    return new HnswIndex(dim, metric, capacity, m, ef_construction, seed);
  } catch (...) {
    return nullptr;
  }
}

void cvt_hnsw_free(void* h) { delete static_cast<HnswIndex*>(h); }

int64_t cvt_hnsw_size(void* h) { return static_cast<HnswIndex*>(h)->size(); }
int cvt_hnsw_dim(void* h) { return static_cast<HnswIndex*>(h)->dim(); }

// vectors [n, dim] f32 row-major; labels [n] i64. Returns n added, -1 on
// error. Parallel insert with per-node lock striping.
int64_t cvt_hnsw_add(void* h, const float* vectors, const int64_t* labels,
                     int64_t n, int num_threads) {
  HnswIndex* idx = static_cast<HnswIndex*>(h);
  std::atomic<int64_t> done{0};
  std::atomic<bool> failed{false};
  // num_threads(0) is invalid OpenMP; <=0 means "library default"
  const int nt = num_threads > 0 ? num_threads : omp_get_max_threads();
#pragma omp parallel num_threads(nt)
  {
    Scratch s;
#pragma omp for schedule(dynamic, 64)
    for (int64_t i = 0; i < n; ++i) {
      if (failed.load(std::memory_order_relaxed)) continue;
      try {
        idx->add(vectors + size_t(i) * idx->dim(), labels[i], s);
        done.fetch_add(1, std::memory_order_relaxed);
      } catch (...) {
        failed.store(true);
      }
    }
  }
  return failed.load() ? -1 : done.load();
}

// queries [n, dim]; out_labels/out_dists [n, k]. Unfilled slots get
// label -1 / dist +inf. Returns 0 on success.
int cvt_hnsw_search(void* h, const float* queries, int64_t n, int k, int ef,
                    int num_threads, int64_t* out_labels, float* out_dists) {
  const HnswIndex* idx = static_cast<HnswIndex*>(h);
  const int nt = num_threads > 0 ? num_threads : omp_get_max_threads();
#pragma omp parallel num_threads(nt)
  {
    Scratch s;
#pragma omp for schedule(dynamic, 8)
    for (int64_t i = 0; i < n; ++i) {
      int64_t* lab = out_labels + size_t(i) * k;
      float* dst = out_dists + size_t(i) * k;
      const int got =
          idx->search(queries + size_t(i) * idx->dim(), k, ef, s, lab, dst);
      for (int j = got; j < k; ++j) {
        lab[j] = -1;
        dst[j] = HUGE_VALF;
      }
    }
  }
  return 0;
}

int cvt_hnsw_save(void* h, const char* path) {
  return static_cast<HnswIndex*>(h)->save(path) ? 0 : -1;
}

void* cvt_hnsw_load(const char* path, int64_t capacity) {
  return HnswIndex::load(path, capacity);
}

}  // extern "C"
