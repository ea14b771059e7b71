// Section routing of the TPU plan's K2 layout, for the K2 stage probes.
//
// The port's own copy of the JAX package's native router (its
// native/edge_plan.cpp), with the section's row count R a parameter: 512
// (sections of 65,536 slots, destinations a mid of 65,536, as the TPU
// plan) or 128 (sections of 16,384 slots, mids of 16,384, as
// scripts/perf_k2_sec128.py).  Per section: a stable counting sort of the
// slots by destination key (-1 lead pad, MID tail pads), TWO Clos/Benes
// stage decompositions by recursive Euler-split bipartite edge coloring
// (route 1: slot order -> destination-sorted, with a pad bit at the input
// layout; route 2: segment-end positions -> destination output positions,
// with a present bit at the output layout), and each sorted slot's
// segment start.  At R = 512 its output is the original's bit for bit.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread edge_plan.cpp

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Shape {
    int r;    // rows of a section
    int r1;   // r / 128
    int sec;  // slots of a section
    int mid;  // destinations of a mid; tail pad key
};

struct Scratch {
    std::vector<int32_t> ladj, radj, lcnt, rcnt, lptr, rptr;
    std::vector<uint8_t> used;
    std::vector<int32_t> target, cnt;
    std::vector<int32_t> l_buf, r_buf, ids0;
    std::vector<uint8_t> color;
    std::vector<int32_t> qinv;
    std::vector<uint8_t> color2;
    std::vector<int32_t> l2, r2, ids2;
};

// Split a d-regular bipartite multigraph (nodes [0,n) on both sides,
// edges ids[0..e) indexing l/r) into two d/2-regular halves.
void euler_split(const int32_t* l, const int32_t* r, int n, int d,
                 const int32_t* ids, int e, uint8_t* half_out, Scratch& s) {
    s.ladj.assign((size_t)n * d, 0);
    s.radj.assign((size_t)n * d, 0);
    s.lcnt.assign(n, 0);
    s.rcnt.assign(n, 0);
    for (int i = 0; i < e; i++) {
        int32_t eid = ids[i];
        s.ladj[(size_t)l[eid] * d + s.lcnt[l[eid]]++] = i;
        s.radj[(size_t)r[eid] * d + s.rcnt[r[eid]]++] = i;
    }
    s.used.assign(e, 0);
    s.lptr.assign(n, 0);
    s.rptr.assign(n, 0);
    for (int i0 = 0; i0 < e; i0++) {
        if (s.used[i0]) continue;
        int i = i0;
        uint8_t h = 0;
        for (;;) {
            s.used[i] = 1;
            half_out[i] = h;
            h ^= 1;
            int rn = r[ids[i]];
            int32_t* rp = &s.rptr[rn];
            while (*rp < d && s.used[s.radj[(size_t)rn * d + *rp]]) (*rp)++;
            if (*rp == d) break;
            i = s.radj[(size_t)rn * d + *rp];
            s.used[i] = 1;
            half_out[i] = h;
            h ^= 1;
            int ln = l[ids[i]];
            int32_t* lp = &s.lptr[ln];
            while (*lp < d && s.used[s.ladj[(size_t)ln * d + *lp]]) (*lp)++;
            if (*lp == d) break;
            i = s.ladj[(size_t)ln * d + *lp];
        }
    }
}

// d-edge-coloring (d a power of two) by recursive Euler splits:
// colors[eid] in [0, d).
void edge_color(const int32_t* l, const int32_t* r, int n, int d,
                int32_t* ids, int e, uint8_t* colors, Scratch& s,
                std::vector<uint8_t>& half_buf) {
    if (d == 1) {
        for (int i = 0; i < e; i++) colors[ids[i]] = 0;
        return;
    }
    half_buf.resize(e);
    euler_split(l, r, n, d, ids, e, half_buf.data(), s);
    std::vector<int32_t> tmp(e);
    int n0 = 0;
    for (int i = 0; i < e; i++)
        if (half_buf[i] == 0) tmp[n0++] = ids[i];
    int n1 = n0;
    for (int i = 0; i < e; i++)
        if (half_buf[i] == 1) tmp[n1++] = ids[i];
    std::memcpy(ids, tmp.data(), sizeof(int32_t) * e);
    std::vector<uint8_t> hb2;
    edge_color(l, r, n, d / 2, ids, n0, colors, s, hb2);
    for (int i = 0; i < n0; i++) colors[ids[i]] = colors[ids[i]] * 2 + 0;
    edge_color(l, r, n, d / 2, ids + n0, e - n0, colors, s, hb2);
    for (int i = n0; i < e; i++) colors[ids[i]] = colors[ids[i]] * 2 + 1;
}

// Decompose one permutation (target[i] = output position of input
// position i) and pack the stages: wa = A | E << 7 | flag << 15 (flags at
// their own array position, may be null), wb = B | C << 7 | D << 9.
void route_perm(const Shape& sh, const int32_t* target, const uint16_t* flags,
                uint16_t* wa, uint16_t* wb, Scratch& s) {
    const int SEC = sh.sec, R = sh.r, R1 = sh.r1;
    s.l_buf.resize(SEC);
    s.r_buf.resize(SEC);
    s.ids0.resize(SEC);
    s.color.assign(SEC, 0);
    for (int i = 0; i < SEC; i++) {
        s.l_buf[i] = i >> 7;
        s.r_buf[i] = target[i] >> 7;
        s.ids0[i] = i;
    }
    std::vector<uint8_t> hb;
    edge_color(s.l_buf.data(), s.r_buf.data(), R, 128, s.ids0.data(), SEC,
               s.color.data(), s, hb);

    std::vector<uint8_t> A(SEC), E(SEC);
    for (int i = 0; i < SEC; i++) {
        int r_in = i >> 7, c_in = i & 127, k = s.color[i];
        int t = target[i];
        A[(size_t)r_in * 128 + k] = (uint8_t)c_in;
        E[(size_t)(t >> 7) * 128 + (t & 127)] = (uint8_t)k;
    }
    for (int i = 0; i < SEC; i++)
        wa[i] = (uint16_t)A[i] | ((uint16_t)E[i] << 7);
    if (flags) {
        for (int i = 0; i < SEC; i++)
            wa[i] |= (uint16_t)(flags[i] ? 1 : 0) << 15;
    }

    // inner routes, one per intermediate column: qinv[col][r_in] = r_out
    s.qinv.resize((size_t)128 * R);
    for (int i = 0; i < SEC; i++)
        s.qinv[(size_t)s.color[i] * R + (i >> 7)] = target[i] >> 7;
    s.color2.assign(R, 0);
    s.l2.resize(R);
    s.r2.resize(R);
    s.ids2.resize(R);
    std::vector<uint8_t> B(SEC), C(SEC), D(SEC);
    for (int col = 0; col < 128; col++) {
        const int32_t* qinv = &s.qinv[(size_t)col * R];
        for (int v = 0; v < R; v++) {
            s.l2[v] = v >> 7;
            s.r2[v] = qinv[v] >> 7;
            s.ids2[v] = v;
        }
        edge_color(s.l2.data(), s.r2.data(), R1, 128, s.ids2.data(), R,
                   s.color2.data(), s, hb);
        for (int v = 0; v < R; v++) {
            int g_in = v >> 7, lane_in = v & 127;
            int t = qinv[v];
            int g_out = t >> 7, lane_out = t & 127;
            int k2 = s.color2[v];
            B[((size_t)col * R1 + g_in) * 128 + k2] = (uint8_t)lane_in;
            C[((size_t)col * R1 + g_out) * 128 + k2] = (uint8_t)g_in;
            D[((size_t)col * R1 + g_out) * 128 + lane_out] = (uint8_t)k2;
        }
    }
    for (int i = 0; i < SEC; i++)
        wb[i] = (uint16_t)B[i] | ((uint16_t)C[i] << 7) | ((uint16_t)D[i] << 9);
}

// Route one section. keys: sec int32 (-1 lead pad, mid tail pad).
void build_one_section(const Shape& sh, const int32_t* keys, uint16_t* wa,
                       uint16_t* wb, uint16_t* sstart, uint16_t* wa2,
                       uint16_t* wb2, Scratch& s) {
    const int SEC = sh.sec, MID = sh.mid;
    // stable counting sort by key (+2 -> [1, MID + 3))
    s.cnt.assign(MID + 3, 0);
    for (int i = 0; i < SEC; i++) s.cnt[keys[i] + 2]++;
    for (int k = 1; k < MID + 3; k++) s.cnt[k] += s.cnt[k - 1];
    s.target.resize(SEC);
    {
        std::vector<int32_t> cursor(s.cnt.begin(), s.cnt.end() - 1);
        for (int i = 0; i < SEC; i++) {
            int32_t t = cursor[keys[i] + 1]++;
            s.target[i] = t;
            sstart[t] = (uint16_t)s.cnt[keys[i] + 1];  // segment start
        }
    }

    // route 1: slot order -> destination-sorted; pad bit at the input
    std::vector<uint16_t> flags(SEC);
    for (int i = 0; i < SEC; i++)
        flags[i] = (keys[i] == -1 || keys[i] == MID) ? 1 : 0;
    route_perm(sh, s.target.data(), flags.data(), wa, wb, s);

    // route 2: segment end e_d -> output d for every present destination
    // (count(keys <= d) = cnt[d + 2]); the rest fill the other outputs in
    // order
    std::vector<int32_t> target2(SEC, -1);
    for (int d = 0; d < MID; d++) {
        flags[d] = (s.cnt[d + 2] > s.cnt[d + 1]) ? 1 : 0;  // present
        if (flags[d]) target2[s.cnt[d + 2] - 1] = d;
    }
    {
        int out = 0;
        for (int p = 0; p < SEC; p++) {
            if (target2[p] >= 0) continue;
            while (flags[out]) out++;
            target2[p] = out++;
        }
    }
    route_perm(sh, target2.data(), flags.data(), wa2, wb2, s);
}

}  // namespace

extern "C" {

// keys: (nsec, r * 128) int32 with every key in [-1, r * 128] (-1 and
// r * 128 are pads); wa/wb/sstart/wa2/wb2: (nsec, r * 128) uint16.
// r is 128 or 512.  Returns 0 on success, 1 for a bad r.
int gtt_route_sections(const int32_t* keys, int64_t nsec, int r,
                       uint16_t* wa, uint16_t* wb, uint16_t* sstart,
                       uint16_t* wa2, uint16_t* wb2, int nthreads) {
    if (r != 128 && r != 512) return 1;
    const Shape sh{r, r / 128, r * 128, r * 128};
    if (nthreads < 1) nthreads = 1;
    std::vector<std::thread> pool;
    std::atomic<int64_t> next{0};
    auto worker = [&]() {
        Scratch s;
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= nsec) return;
            const int64_t o = i * sh.sec;
            build_one_section(sh, keys + o, wa + o, wb + o, sstart + o,
                              wa2 + o, wb2 + o, s);
        }
    };
    for (int t = 0; t < nthreads; t++) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return 0;
}
}
