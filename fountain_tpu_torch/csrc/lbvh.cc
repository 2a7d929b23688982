// Native LBVH builder (host side), the port's copy of native/lbvh.cc.
//
// Morton-ordered linear BVH with highest-differing-bit median splits,
// DFS-ordered node emission, and threaded miss links (the layout the BVH
// walk reads, fountain_tpu_torch/geometry/bvh.py). The same algorithm as
// the numpy build_lbvh of that module, with byte-identical output (the
// tests hold the two to it), built with g++ by fountain_tpu_torch/native.py.
//
// C ABI:
//   int lbvh_build(const float* bmin, const float* bmax, int n,
//                  int leaf_size, float* nodes_min, float* nodes_max,
//                  int32_t* meta, int32_t* order);
// Caller allocates nodes_min/max as [2n+1, 3], meta as [2n+1, 3],
// order as [n]. Returns the node count M (or -1 on error).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

inline uint32_t morton3(uint32_t x, uint32_t y, uint32_t z) {
  return (expand_bits(z) << 2) | (expand_bits(y) << 1) | expand_bits(x);
}

struct Builder {
  const float* bmin;
  const float* bmax;
  std::vector<uint32_t> codes;   // sorted
  std::vector<int32_t> order;    // sorted prim ids
  int leaf_size;
  float* nodes_min;
  float* nodes_max;
  int32_t* meta;                 // [M,3]: (subtree_size stash, first, count)
  int m = 0;

  int emit(const float* n_min, const float* n_max, int first, int count) {
    std::memcpy(nodes_min + 3 * m, n_min, 12);
    std::memcpy(nodes_max + 3 * m, n_max, 12);
    meta[3 * m + 0] = 0;
    meta[3 * m + 1] = first;
    meta[3 * m + 2] = count;
    return m++;
  }

  int split_pos(int start, int end) const {
    uint32_t c0 = codes[start], c1 = codes[end - 1];
    if (c0 == c1) return (start + end) / 2;
    uint32_t diff = c0 ^ c1;
    int split_bit = 31 - __builtin_clz(diff);
    uint32_t mask = 1u << split_bit;
    // first index whose bit differs from c0's (codes sorted: binary search)
    int lo = start, hi = end - 1;
    uint32_t want = c0 & mask;
    while (lo < hi) {
      int mid = (lo + hi) / 2;
      if ((codes[mid] & mask) == want)
        lo = mid + 1;
      else
        hi = mid;
    }
    int idx = lo - start;
    return start + std::max(idx, 1);
  }

  // returns subtree node count
  int rec(int start, int end) {
    float n_min[3] = {3e38f, 3e38f, 3e38f};
    float n_max[3] = {-3e38f, -3e38f, -3e38f};
    for (int i = start; i < end; ++i) {
      const float* lo = bmin + 3 * order[i];
      const float* hi = bmax + 3 * order[i];
      for (int k = 0; k < 3; ++k) {
        n_min[k] = std::min(n_min[k], lo[k]);
        n_max[k] = std::max(n_max[k], hi[k]);
      }
    }
    if (end - start <= leaf_size) {
      emit(n_min, n_max, start, end - start);
      return 1;
    }
    int mid = split_pos(start, end);
    int me = emit(n_min, n_max, 0, 0);
    int left = rec(start, mid);
    int right = rec(mid, end);
    meta[3 * me + 0] = 1 + left + right;  // stash subtree size
    return 1 + left + right;
  }
};

}  // namespace

extern "C" int lbvh_build(const float* bmin, const float* bmax, int n,
                          int leaf_size, float* nodes_min, float* nodes_max,
                          int32_t* meta, int32_t* order) {
  if (n <= 0) return -1;
  Builder b;
  b.bmin = bmin;
  b.bmax = bmax;
  b.leaf_size = leaf_size;
  b.nodes_min = nodes_min;
  b.nodes_max = nodes_max;
  b.meta = meta;

  // centroids -> 10-bit lattice morton codes
  float lo[3] = {3e38f, 3e38f, 3e38f}, hi[3] = {-3e38f, -3e38f, -3e38f};
  std::vector<float> cent(3 * (size_t)n);
  for (int i = 0; i < n; ++i)
    for (int k = 0; k < 3; ++k) {
      float c = 0.5f * (bmin[3 * i + k] + bmax[3 * i + k]);
      cent[3 * i + k] = c;
      lo[k] = std::min(lo[k], c);
      hi[k] = std::max(hi[k], c);
    }
  float ext[3];
  for (int k = 0; k < 3; ++k) ext[k] = std::max(hi[k] - lo[k], 1e-12f);

  std::vector<uint32_t> raw_codes((size_t)n);
  for (int i = 0; i < n; ++i) {
    uint32_t q[3];
    for (int k = 0; k < 3; ++k) {
      float t = (cent[3 * i + k] - lo[k]) / ext[k] * 1023.0f;
      t = std::min(std::max(t, 0.0f), 1023.0f);
      q[k] = (uint32_t)t;
    }
    raw_codes[i] = morton3(q[0], q[1], q[2]);
  }

  b.order.resize(n);
  for (int i = 0; i < n; ++i) b.order[i] = i;
  std::stable_sort(b.order.begin(), b.order.end(),
                   [&](int32_t a, int32_t c) {
                     return raw_codes[a] < raw_codes[c];
                   });
  b.codes.resize(n);
  for (int i = 0; i < n; ++i) b.codes[i] = raw_codes[b.order[i]];

  b.rec(0, n);

  // patch miss links: interior nodes stashed subtree size; leaves size 1
  for (int i = 0; i < b.m; ++i) {
    int size = (meta[3 * i + 2] > 0) ? 1 : meta[3 * i + 0];
    meta[3 * i + 0] = i + size;
  }
  std::memcpy(order, b.order.data(), sizeof(int32_t) * (size_t)n);
  return b.m;
}
