// Width-ratio-gated 8-connected components over a stroke-width map, for
// the SWT letter stage (ccv_tpu_torch/detectors/swt.py). A copy of
// ccv_tpu/native/ccv_tpu_swt.cpp: the reference's letter-component BFS
// (lib/ccv_swt.c:238-303) with the standard pairwise SWT join rule, two
// neighbours joining when each width is within `ratio` x of the other.
//
// swt:    (h, w) uint8 stroke widths, 0 = background
// labels: (h, w) int32 out, -1 = background, else a component id, numbered
//         in scan order of each component's first pixel
// returns the number of components, or -1 on bad arguments

#include <cstddef>
#include <cstdint>
#include <vector>

using std::size_t;

namespace {

int32_t find_root(std::vector<int32_t>& parent, int32_t x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];  // path halving
    x = parent[x];
  }
  return x;
}

inline void join(std::vector<int32_t>& parent, int32_t a, int32_t b) {
  a = find_root(parent, a);
  b = find_root(parent, b);
  if (a < b)
    parent[b] = a;
  else if (b < a)
    parent[a] = b;
}

}  // namespace

extern "C" int ccv_torch_swt_cc(const uint8_t* swt, int h, int w, int ratio,
                                int32_t* labels) {
  if (!swt || !labels || h <= 0 || w <= 0 || ratio <= 0) return -1;
  const int n = h * w;
  std::vector<int32_t> parent(n);
  for (int i = 0; i < n; i++) parent[i] = i;
  // forward 8-neighbourhood: E, S, SE, SW
  static const int dy[4] = {0, 1, 1, 1};
  static const int dx[4] = {1, 0, 1, -1};
  for (int y = 0; y < h; y++) {
    const uint8_t* row = swt + (size_t)y * w;
    for (int x = 0; x < w; x++) {
      const int a = row[x];
      if (!a) continue;
      const int32_t ia = y * w + x;
      for (int k = 0; k < 4; k++) {
        const int ny = y + dy[k], nx = x + dx[k];
        if (ny >= h || nx < 0 || nx >= w) continue;
        const int b = swt[(size_t)ny * w + nx];
        if (!b) continue;
        if (b <= ratio * a && a <= ratio * b) join(parent, ia, ny * w + nx);
      }
    }
  }
  // compact relabel
  std::vector<int32_t> remap(n, -1);
  int next = 0;
  for (int i = 0; i < n; i++) {
    if (!swt[i]) {
      labels[i] = -1;
      continue;
    }
    const int32_t r = find_root(parent, i);
    if (remap[r] < 0) remap[r] = next++;
    labels[i] = remap[r];
  }
  return next;
}
