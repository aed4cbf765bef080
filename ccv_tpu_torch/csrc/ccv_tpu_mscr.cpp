// MSCR — maximally stable color region evolution (twin of _ccv_mscr,
// lib/ccv_mser.c:570), for ccv_tpu_torch/detectors/mser.py; a copy of
// ccv_tpu/native/ccv_tpu_mscr.cpp (same entry point and arguments). The
// chi-distance edge maps and their Gaussian blur are computed on the device
// (the Python side); this native piece runs the
// inherently sequential part: sort the edge graph by chi, evolve the
// union-find under the chi-square threshold schedule, track per-root
// (size, chi) slopes, and emit margin-stable areas.
//
// The chi threshold table is passed in (computed as chi2inv(i/399, 3)/3 by
// the caller — the closed-form identity behind the reference's constant
// table).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Edge {
    float chi;
    int n0, n1;
};

struct Root {
    int size;
    int rank;
    int reinit;
    int step_now;
    int last_size;
    int prev_size;
    double chi;
    double prev_chi;
    double min_slope;
    int min_x, min_y, max_x, max_y;
    int last_mscr_area;
    int mscr_area;
};

struct Area {
    int head;
    int tail;
    double margin;
    int size;
    int seq_no;
};

}  // namespace

extern "C" int ccv_tpu_mscr(
    const float* bdx, const float* bdy, const float* bdxy,
    const float* bdxy2, int rows, int cols,
    const double* chitab, int chitab_size, int max_evolution,
    double area_threshold, double min_margin,
    int min_area, int max_area, double min_diversity,
    int32_t* out_b, int32_t* out_kp, int cap)
{
    const int n = rows * cols;
    const int ex = rows * (cols - 1);
    const int ey = (rows - 1) * cols;
    const int ed = (rows - 1) * (cols - 1);
    std::vector<Edge> edges;
    edges.reserve(ex + ey + 2 * ed);
    double mean = 0;
    for (int i = 0; i < rows; i++)
        for (int j = 0; j < cols - 1; j++) {
            float c = bdx[i * (cols - 1) + j];
            mean += c;
            edges.push_back({c, i * cols + j, i * cols + j + 1});
        }
    for (int i = 0; i < rows - 1; i++)
        for (int j = 0; j < cols; j++) {
            float c = bdy[i * cols + j];
            mean += c;
            edges.push_back({c, i * cols + j, (i + 1) * cols + j});
        }
    for (int i = 0; i < rows - 1; i++)
        for (int j = 0; j < cols - 1; j++) {
            float c = bdxy[i * (cols - 1) + j];
            mean += c;
            edges.push_back({c, i * cols + j, (i + 1) * cols + j + 1});
        }
    for (int i = 0; i < rows - 1; i++)
        for (int j = 0; j < cols - 1; j++) {
            float c = bdxy2[i * (cols - 1) + j];
            mean += c;
            edges.push_back({c, i * cols + j + 1, (i + 1) * cols + j});
        }
    mean /= (double)edges.size();
    std::stable_sort(edges.begin(), edges.end(),
                     [](const Edge& a, const Edge& b) { return a.chi < b.chi; });

    std::vector<int> shortcut(n), prev(n), next(n), root_of(n, -1);
    for (int i = 0; i < n; i++) {
        shortcut[i] = prev[i] = next[i] = i;
    }
    auto find_root = [&](int x) {
        int r = x;
        while (shortcut[r] != r) r = shortcut[r];
        while (shortcut[x] != r) { int nx = shortcut[x]; shortcut[x] = r; x = nx; }
        return r;
    };

    std::vector<Root> roots;
    std::vector<Area> areas;
    int seq_no = 0;
    size_t pe = 0;
    for (int i = 0; i < max_evolution && pe < edges.size(); i++) {
        double dk = (double)i / max_evolution * (chitab_size - 1);
        int k = (int)dk;
        double rk = dk - k;
        double thres = mean * (chitab[k] * (1.0 - rk) + chitab[k + 1] * rk);
        while (pe < edges.size() && edges[pe].chi < thres) {
            const Edge& e = edges[pe];
            int node0 = find_root(e.n0);
            int node1 = find_root(e.n1);
            if (node0 == node1) { ++pe; continue; }
            int r0 = root_of[node0], r1 = root_of[node1];
            bool swap;
            if (r0 >= 0 && r1 >= 0)
                swap = roots[r1].rank > roots[r0].rank
                    || (roots[r1].rank == roots[r0].rank
                        && roots[r1].size > roots[r0].size);
            else
                swap = (r1 >= 0 && r0 < 0);
            if (swap) { std::swap(node0, node1); std::swap(r0, r1); }
            if (r0 < 0) {
                Root nr;
                nr.reinit = 0x7FFFFFFF;
                nr.min_x = nr.max_x = node0 % cols;
                nr.min_y = nr.max_y = node0 / cols;
                nr.rank = nr.step_now = 0;
                nr.chi = nr.prev_chi = 0;
                nr.last_size = nr.size = nr.prev_size = 1;
                nr.last_mscr_area = nr.mscr_area = -1;
                nr.min_slope = 0;
                root_of[node0] = (int)roots.size();
                roots.push_back(nr);
                r0 = (int)roots.size() - 1;
            }
            Root& root0 = roots[r0];
            ++root0.rank;
            if (r1 >= 0 && roots[r1].last_mscr_area >= 0
                && root0.last_mscr_area == -1)
                root0.last_mscr_area = roots[r1].last_mscr_area;
            if (root0.step_now < i) {
                root0.last_size = root0.size;
                root0.step_now = i;
            }
            shortcut[node1] = node0;
            if (r1 >= 0) {
                const Root& root1 = roots[r1];
                root0.size += root1.size;
                root0.min_x = std::min(root0.min_x, root1.min_x);
                root0.min_y = std::min(root0.min_y, root1.min_y);
                root0.max_x = std::max(root0.max_x, root1.max_x);
                root0.max_y = std::max(root0.max_y, root1.max_y);
            } else {
                ++root0.size;
                root0.min_x = std::min(root0.min_x, node1 % cols);
                root0.min_y = std::min(root0.min_y, node1 / cols);
                root0.max_x = std::max(root0.max_x, node1 % cols);
                root0.max_y = std::max(root0.max_y, node1 / cols);
            }
            // splice the circular pixel lists
            int p0prev = prev[node0];
            next[p0prev] = node1;
            prev[node0] = prev[node1];
            next[prev[node1]] = node0;
            prev[node1] = p0prev;
            if (root0.size > root0.last_size * area_threshold) {
                if (root0.mscr_area >= 0) {
                    Area& a = areas[root0.mscr_area];
                    a.margin = root0.chi - root0.prev_chi;
                    if (a.margin > min_margin) a.seq_no = ++seq_no;
                    root0.mscr_area = -1;
                }
                root0.prev_size = root0.size;
                root0.prev_chi = e.chi;
                root0.reinit = i;
                root0.min_slope = 1e308;
            }
            root0.chi = e.chi;
            if (i > root0.reinit) {
                double slope = (double)(root0.size - root0.prev_size)
                    / (root0.chi - root0.prev_chi);
                if (slope < root0.min_slope) {
                    if (i > root0.reinit + 1 && root0.size >= min_area
                        && root0.size <= max_area
                        && root0.max_y - root0.min_y > 1
                        && root0.max_x - root0.min_x > 1) {
                        const Area* last = (root0.last_mscr_area >= 0)
                            ? &areas[root0.last_mscr_area] : nullptr;
                        if (!last
                            || (double)(root0.size - last->size)
                               / (double)last->size > min_diversity) {
                            if (root0.mscr_area >= 0) {
                                Area& a = areas[root0.mscr_area];
                                a.head = node0;
                                a.tail = prev[node0];
                                a.margin = 0;
                                a.size = root0.size;
                                a.seq_no = 0;
                            } else {
                                Area a;
                                a.head = node0;
                                a.tail = prev[node0];
                                a.margin = 0;
                                a.size = root0.size;
                                a.seq_no = 0;
                                root0.mscr_area = root0.last_mscr_area
                                    = (int)areas.size();
                                areas.push_back(a);
                            }
                        }
                    }
                    root0.min_slope = slope;
                }
            }
            ++pe;
        }
    }
    memset(out_b, 0, sizeof(int32_t) * (size_t)n);
    int out_n = 0;
    for (const Area& a : areas) {
        if (a.seq_no <= 0) continue;
        int node = a.head;
        int minx = node % cols, maxx = minx;
        int miny = node / cols, maxy = miny;
        const int kx = node % cols, ky = node / cols;
        for (int j = 0; j < a.size; j++) {
            const int x = node % cols, y = node / cols;
            if (out_b[node] == 0) out_b[node] = a.seq_no;
            minx = std::min(minx, x); maxx = std::max(maxx, x);
            miny = std::min(miny, y); maxy = std::max(maxy, y);
            node = next[node];
        }
        if (out_n < cap) {
            int32_t* kp = out_kp + (size_t)out_n * 8;
            kp[0] = a.size;
            kp[1] = kx; kp[2] = ky;
            kp[3] = minx; kp[4] = miny;
            kp[5] = maxx - minx + 1; kp[6] = maxy - miny + 1;
            kp[7] = a.seq_no;
        }
        ++out_n;
    }
    return out_n;
}
