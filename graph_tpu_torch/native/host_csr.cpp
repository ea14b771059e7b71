// Host-resident CSR build + triangle-count orientation for
// graph_tpu_torch (its own copy of graph_tpu's builder; the code is the
// same).
//
// numpy's lexsort is slow at Graph500 scale 20+; an LSD radix sort over
// (row, col) powers both the host undirected build
// (graph/build.py build_undirected_host, for graphs whose next consumer
// reads the edge list on the host) and the TC orientation pass (degree
// rank + forward filter + (a, b) sort).
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread host_csr.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// LSD radix passes over key[i] (int32), permuting the key array and up
// to two payload arrays together each pass: sequential reads, no
// id-indirection (an indirect `key(ids[i])` variant measured ~4x
// slower — every lookup was a cache miss at Graph500 sizes).
void radix_passes(std::vector<int32_t>& key, std::vector<int32_t>& p1,
                  std::vector<float>* p2, int64_t key_max) {
    int64_t m = key.size();
    std::vector<int32_t> kt(m), p1t(m);
    std::vector<float> p2t(p2 ? m : 0);
    int bits = 1;
    while ((key_max - 1) >> bits) bits++;
    for (int shift = 0; shift < bits; shift += 11) {
        int64_t cnt[2049] = {0};
        for (int64_t i = 0; i < m; i++)
            cnt[((key[i] >> shift) & 2047) + 1]++;
        for (int k = 1; k <= 2048; k++) cnt[k] += cnt[k - 1];
        for (int64_t i = 0; i < m; i++) {
            int64_t d = cnt[(key[i] >> shift) & 2047]++;
            kt[d] = key[i];
            p1t[d] = p1[i];
            if (p2) p2t[d] = (*p2)[i];
        }
        key.swap(kt);
        p1.swap(p1t);
        if (p2) p2->swap(p2t);
    }
}

}  // namespace

extern "C" {

struct GtHostCsr {
    int64_t m_out;      // kept edges (after optional dedup)
    int32_t* offsets;   // (n+1)
    int32_t* rows;      // (m_out)
    int32_t* cols;      // (m_out)
    float* vals;        // (m_out) or nullptr
};

// Undirected build: both directions of (src, dst), sorted by (row, col)
// (layout >= 1) or stably by row only (layout 0); layout 2 additionally
// drops duplicate (row, col) pairs and self-loops.
GtHostCsr* gt_build_undirected(const int64_t* src, const int64_t* dst,
                               const float* values, int64_t m, int64_t n,
                               int layout) {
    int64_t m2 = 2 * m;
    std::vector<int32_t> rows(m2), cols(m2);
    std::vector<float> vals(values ? m2 : 0);
    for (int64_t i = 0; i < m; i++) {
        rows[i] = (int32_t)src[i];
        cols[i] = (int32_t)dst[i];
        rows[m + i] = (int32_t)dst[i];
        cols[m + i] = (int32_t)src[i];
        if (values) {
            vals[i] = values[i];
            vals[m + i] = values[i];
        }
    }
    int64_t kmax = n > 1 ? n : 2;
    if (layout >= 1)  // (row, col): LSD — minor key first
        radix_passes(cols, rows, values ? &vals : nullptr, kmax);
    radix_passes(rows, cols, values ? &vals : nullptr, kmax);

    auto* out = (GtHostCsr*)std::calloc(1, sizeof(GtHostCsr));
    out->rows = (int32_t*)std::malloc(m2 * sizeof(int32_t));
    out->cols = (int32_t*)std::malloc(m2 * sizeof(int32_t));
    if (values) out->vals = (float*)std::malloc(m2 * sizeof(float));
    int64_t k = 0;
    int64_t pr = -1, pc = -1;
    for (int64_t i = 0; i < m2; i++) {
        int64_t r = rows[i], c = cols[i];
        if (layout == 2) {
            if (r == c) continue;                    // self-loop
            if (r == pr && c == pc) continue;        // duplicate
            pr = r;
            pc = c;
        }
        out->rows[k] = (int32_t)r;
        out->cols[k] = (int32_t)c;
        if (values) out->vals[k] = vals[i];
        k++;
    }
    out->m_out = k;
    out->offsets = (int32_t*)std::malloc((n + 1) * sizeof(int32_t));
    int64_t cur = 0;
    for (int64_t r = 0; r <= n; r++) {
        while (cur < k && out->rows[cur] < r) cur++;
        out->offsets[r] = (int32_t)cur;
    }
    return out;
}

void gt_host_csr_free(GtHostCsr* c) {
    if (!c) return;
    std::free(c->offsets);
    std::free(c->rows);
    std::free(c->cols);
    std::free(c->vals);
    std::free(c);
}

// Triangle-count orientation: ascending-degree rank, forward filter
// (rank(src) < rank(dst)), sort by (a, b).  In/out int32; returns the
// forward edge count, writing into caller-allocated a/b of size m.
int64_t gt_tc_orient(const int32_t* srcs, const int32_t* tgts, int64_t m,
                     int64_t n, int32_t* a_out, int32_t* b_out) {
    // degree + rank by (degree, id): counting sort over degree
    std::vector<int64_t> deg(n, 0);
    for (int64_t i = 0; i < m; i++) deg[srcs[i]]++;
    int64_t dmax = 0;
    for (int64_t v = 0; v < n; v++)
        if (deg[v] > dmax) dmax = deg[v];
    std::vector<int64_t> cnt(dmax + 2, 0);
    for (int64_t v = 0; v < n; v++) cnt[deg[v] + 1]++;
    for (int64_t d = 1; d <= dmax + 1; d++) cnt[d] += cnt[d - 1];
    std::vector<int64_t> rank(n);
    for (int64_t v = 0; v < n; v++) rank[v] = cnt[deg[v]]++;  // stable by id

    // forward filter
    std::vector<int32_t> a, b;
    a.reserve(m / 2 + 1);
    b.reserve(m / 2 + 1);
    for (int64_t i = 0; i < m; i++) {
        int64_t ra = rank[srcs[i]], rb = rank[tgts[i]];
        if (ra < rb) {
            a.push_back((int32_t)ra);
            b.push_back((int32_t)rb);
        }
    }
    int64_t mf = (int64_t)a.size();
    // sort by (a, b): LSD radix, minor key first
    int64_t kmax = n > 1 ? n : 2;
    radix_passes(b, a, nullptr, kmax);
    radix_passes(a, b, nullptr, kmax);
    std::memcpy(a_out, a.data(), mf * sizeof(int32_t));
    std::memcpy(b_out, b.data(), mf * sizeof(int32_t));
    return mf;
}
}
