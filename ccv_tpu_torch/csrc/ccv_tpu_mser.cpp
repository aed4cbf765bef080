// MSER component-tree build for ccv_tpu_torch/detectors/mser.py, a copy of
// ccv_tpu/native/ccv_tpu_mser.cpp (same entry point and arguments).
//
// Semantics twin of the reference's _ccv_set_union_mser
// (lib/ccv_mser.c:59-345): bucket-sorted gray-level sweep, union-find with
// an extremal-region history tree, delta-stability variance, the same
// swap/seal/diversity rules, and the same output order + label map.
// Written from the algorithm, not transcribed: plain index-based
// union-find and std::vector history instead of the reference's pointer
// arithmetic + intrusive linked lists (we keep a circular next[] list for
// region pixel enumeration).
//
// This is inherently sequential tree building, so it runs on the host.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct History {
    int rank;
    int size;
    int value;
    int shortcut;
    int parent;
    int head;      // node index of the region's pixel list head
    int tail;
    int stable;
    float variance;
};

}  // namespace

extern "C" int ccv_tpu_mser(
    const uint8_t* a, int rows, int cols, const uint8_t* h,
    int delta, int min_area, int max_area,
    double max_variance, double min_diversity,
    int direction,  /* 1 = dark->bright, -1 = bright->dark */
    int range,
    int32_t* out_b,         /* rows*cols label map, written */
    int32_t* out_kp,        /* cap * 8: size, x, y, rect(x,y,w,h), pad */
    int cap)
{
    if (range <= 0) range = 255;
    const int n = rows * cols;
    // per-pixel union-find + circular pixel list
    std::vector<int> shortcut(n), prev(n), next(n), root_of(n);
    std::vector<int> rnode(n);
    std::vector<int> buck(range + 2, 0);
    if (h) {
        for (int i = 0; i < n; i++)
            if (h[i] == 0) ++buck[a[i]];
    } else {
        for (int i = 0; i < n; i++) ++buck[a[i]];
    }
    for (int v = 1; v <= range; v++) buck[v] += buck[v - 1];
    buck[range + 1] = buck[range];
    // fill consumes from the top; after the loop fill[v] is the START of
    // bucket v (the reference decrements `buck` in place and then uses it
    // for segmentation, ccv_mser.c:137-140)
    std::vector<int> fill = buck;
    for (int i = 0; i < n; i++) {
        prev[i] = next[i] = i;  // self-referencing circular list
        root_of[i] = -1;
        if (h && h[i] != 0) {
            shortcut[i] = -2;   // void node (mask)
        } else {
            shortcut[i] = i;    // own root
            rnode[--fill[a[i]]] = i;
        }
    }

    std::vector<History> hist;
    hist.reserve(1024);

    auto find_root = [&](int x) {
        int r = x;
        while (shortcut[r] != r) r = shortcut[r];
        while (shortcut[x] != r) { int nx = shortcut[x]; shortcut[x] = r; x = nx; }
        return r;
    };

    const bool trace = getenv("MSER_TRACE") != nullptr;
    static const int dx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
    static const int dy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};

    for (int v = 0; v <= range; v++) {
        int seg = fill[direction == 1 ? v : range - v];
        int seg_cap = fill[direction == 1 ? v + 1 : range - v + 1];
        for (int i = seg; i < seg_cap; i++) {
            const int p = rnode[i];
            const int px = p % cols, py = p / cols;
            int node0 = find_root(p);
            for (int j = 0; j < 8; j++) {
                const int x = px + dx[j], y = py + dy[j];
                if (x < 0 || x >= cols || y < 0 || y >= rows) continue;
                const int q = y * cols + x;
                if (shortcut[q] == -2) continue;  // void (mask) node
                int node1 = find_root(q);
                if (node0 == node1) continue;
                int r0 = root_of[node0], r1 = root_of[node1];
                // swap so node0 owns the "better" region (same rule as ref)
                bool swap;
                if (r0 >= 0 && r1 >= 0) {
                    const History& h0 = hist[r0];
                    const History& h1 = hist[r1];
                    swap = h1.value > h0.value
                        || (h1.value == h0.value && h1.rank > h0.rank)
                        || (h1.value == h0.value && h1.rank == h0.rank
                            && h1.size > h0.size);
                } else {
                    swap = (r1 >= 0 && r0 < 0);
                }
                if (swap) { std::swap(node0, node1); std::swap(r0, r1); }
                if (r0 < 0) {
                    History nh;
                    nh.rank = 0; nh.size = 1; nh.value = v;
                    nh.shortcut = (int)hist.size();
                    nh.parent = (int)hist.size();
                    nh.head = node0; nh.tail = node1;
                    nh.stable = 0; nh.variance = 0.f;
                    root_of[node0] = (int)hist.size();
                    hist.push_back(nh);
                    r0 = (int)hist.size() - 1;
                } else if (hist[r0].value < v) {
                    // seal the old root into history, spawn the new one
                    hist[r0].shortcut = hist[r0].parent = (int)hist.size();
                    History nh = hist[r0];
                    nh.value = v;
                    root_of[node0] = (int)hist.size();
                    hist.push_back(nh);
                    int new_r0 = (int)hist.size() - 1;
                    int rank1 = (r1 >= 0) ? hist[r1].rank : 0;
                    hist[new_r0].rank = std::max(hist[new_r0].rank, rank1) + 1;
                    r0 = new_r0;
                }
                if (r1 >= 0) {
                    if (hist[r1].value < hist[r0].value)
                        hist[r1].parent = root_of[node0];
                    hist[r1].shortcut = root_of[node0];
                }
                // union + splice the circular pixel lists
                if (trace)
                    fprintf(stderr, "M v=%d p=(%d,%d) n0=(%d,%d) n1=(%d,%d) r0=%d r1=%d sz=%d\n",
                            v, px, py, node0 % cols, node0 / cols,
                            node1 % cols, node1 / cols,
                            root_of[node0], root_of[node1], hist[r0].size);
                shortcut[node1] = node0;
                hist[r0].size += (r1 >= 0) ? hist[r1].size : 1;
                int p0prev = prev[node0];
                next[p0prev] = node1;
                prev[node0] = prev[node1];
                next[prev[node1]] = node0;
                prev[node1] = p0prev;
                hist[r0].head = node0;
                hist[r0].tail = prev[node0];
            }
        }
    }
    const int m = (int)hist.size();
    // void non-extremal regions (merged but never sealed)
    for (int i = 0; i < m; i++)
        hist[i].stable = !(hist[i].parent == i && hist[i].shortcut != i);
    // delta-stability variance
    for (int i = 0; i < m; i++) {
        if (!hist[i].stable) continue;
        const int top_val = hist[i].value + delta;
        int top = hist[i].shortcut;
        for (;;) {
            int nxt = hist[top].parent;
            if (nxt == top || hist[nxt].value > top_val) break;
            top = nxt;
        }
        hist[i].variance = (float)(hist[top].size - hist[i].size)
            / hist[i].size;
        int par = hist[i].parent;
        hist[par].shortcut = std::max(top, hist[par].shortcut);
    }
    // keep the more stable of (region, parent) when only 1 level apart
    for (int i = 0; i < m; i++) {
        if (!hist[i].stable || i == hist[i].parent) continue;
        History& per = hist[hist[i].parent];
        if (per.value > hist[i].value + 1) continue;
        if (per.variance > hist[i].variance) per.stable = 0;
        else hist[i].stable = 0;
    }
    // parameter filters + minimum diversity vs the nearest stable ancestor
    for (int i = m - 1; i >= 0; i--) {
        History& er = hist[i];
        if (!er.stable || er.variance > max_variance
            || er.size > max_area || er.size < min_area) {
            er.stable = 0;
            continue;
        }
        int per = er.parent;
        if (per != i) {
            while (!hist[per].stable) {
                int nxt = hist[per].parent;
                if (nxt == per) break;
                per = nxt;
            }
            if (hist[per].stable) {
                float div = (float)(hist[per].size - er.size)
                    / hist[per].size;
                if (div < min_diversity) er.stable = 0;
            }
        }
    }
    // emit: label map + keypoints in history order
    memset(out_b, 0, sizeof(int32_t) * (size_t)n);
    int seq_no = 1, out_n = 0;
    for (int i = 0; i < m; i++) {
        if (!hist[i].stable) continue;
        int node = hist[i].head;
        int minx = node % cols, maxx = minx;
        int miny = node / cols, maxy = miny;
        const int kx = node % cols, ky = node / cols;
        for (int j = 0; j < hist[i].size; j++) {
            const int x = node % cols, y = node / cols;
            if (out_b[node] == 0) out_b[node] = seq_no;
            minx = std::min(minx, x); maxx = std::max(maxx, x);
            miny = std::min(miny, y); maxy = std::max(maxy, y);
            node = next[node];
        }
        if (out_n < cap) {
            int32_t* kp = out_kp + (size_t)out_n * 8;
            kp[0] = hist[i].size;
            kp[1] = kx; kp[2] = ky;
            kp[3] = minx; kp[4] = miny;
            kp[5] = maxx - minx + 1; kp[6] = maxy - miny + 1;
            kp[7] = 0;
        }
        ++out_n;
        ++seq_no;
    }
    return out_n;
}
